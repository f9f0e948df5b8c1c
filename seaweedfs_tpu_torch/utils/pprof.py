"""pprof-style live profiling endpoints.

Port of seaweedfs_tpu/utils/pprof.py, whole.

Reference: weed/util/grace/pprof.go (-cpuprofile flags) and Go's
/debug/pprof handlers. Python equivalents:

  dump_stacks()            — /debug/pprof/goroutine: one stack per
                             live thread (post-mortem for hangs)
  sample_profile(seconds)  — /debug/pprof/profile: statistical sampler
                             over sys._current_frames at ~100 Hz,
                             emitted as collapsed stacks (one
                             `frame;frame;frame count` line each),
                             directly flamegraph.pl-compatible.
"""

from __future__ import annotations

import sys
import threading
import time
import traceback
from collections import Counter


def dump_stacks() -> str:
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for tid, frame in sys._current_frames().items():
        out.append(f"thread {names.get(tid, '?')} (id {tid}):")
        out.extend(l.rstrip() for l in traceback.format_stack(frame))
        out.append("")
    return "\n".join(out)


def require_loopback(handler, what: str = "debug") -> bool:
    """Shared operator gate for /debug/* surfaces (pprof, traces):
    True when the caller is local; otherwise a 403 has been sent.
    One implementation so a future hardening change cannot leave the
    debug endpoints with inconsistent exposure."""
    peer = handler.client_address[0]
    if peer in ("127.0.0.1", "::1", "localhost"):
        return True
    body = f"{what} endpoints are loopback-only\n".encode()
    handler.send_response(403)
    handler.send_header("Content-Type", "text/plain")
    handler.send_header("Content-Length", str(len(body)))
    handler.end_headers()
    handler.wfile.write(body)
    return False


def handle_debug_endpoint(handler, parsed) -> bool:
    """Serve /debug/pprof/* on any BaseHTTPRequestHandler; True when
    the path was one of ours.

    Loopback-only: stack dumps leak internals and the sampler costs
    CPU, so remote callers get 403 (the reference gates profiling
    behind operator-only flags)."""
    from urllib.parse import parse_qs

    if not parsed.path.startswith("/debug/pprof"):
        return False
    if not require_loopback(handler, "pprof"):
        return True
    q = parse_qs(parsed.query)
    if parsed.path.endswith("/profile"):
        try:
            secs = float(q.get("seconds", ["5"])[0])
        except ValueError:
            secs = 5.0
        body = sample_profile(min(secs, 30.0)).encode()
    else:  # /debug/pprof and /debug/pprof/goroutine
        body = dump_stacks().encode()
    handler.send_response(200)
    handler.send_header("Content-Type", "text/plain; charset=utf-8")
    handler.send_header("Content-Length", str(len(body)))
    handler.end_headers()
    handler.wfile.write(body)
    return True


def sample_profile(seconds: float = 5.0, hz: int = 100) -> str:
    """Sample all thread stacks for `seconds`; collapsed-stack text."""
    me = threading.get_ident()
    period = 1.0 / hz
    counts: Counter[str] = Counter()
    deadline = time.monotonic() + max(0.1, min(seconds, 120.0))
    while time.monotonic() < deadline:
        for tid, frame in sys._current_frames().items():
            if tid == me:
                continue
            parts = []
            f = frame
            while f is not None:
                code = f.f_code
                parts.append(f"{code.co_name} ({code.co_filename.rsplit('/', 1)[-1]}:{f.f_lineno})")
                f = f.f_back
            counts[";".join(reversed(parts))] += 1
        time.sleep(period)
    return "\n".join(f"{stack} {n}" for stack, n in counts.most_common())
