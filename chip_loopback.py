"""Loopback connect probe for the card's host.

Serial HTTP POSTs of 1 MiB bodies over loopback, one connection each
(as urllib makes them), to the port's pooled front end
(`utils/http_pool.PooledHTTPServer`, the volume server's) and to the
stdlib `ThreadingHTTPServer` (the master's HTTP plane), in two passes per
server:

- "plain": `http.client.HTTPConnection`; a connect that gets no answer
  within `chip_smoke.CONNECT_S` is counted as a hang and dialled again;
- "smoke": `chip_smoke.http`, which dials again by itself
  (`RedialConnection`); its redials are counted, and any request that
  fails is.

One JSON line per pass (requests, hangs, the longest run of hangs in a
row, the slowest connect that went through, wall seconds), the card
line, and a last line {"ok": ...}: ok when no "smoke" request failed.

    python3 chip_loopback.py [--requests N]
"""

from __future__ import annotations

import argparse
import http.server
import json
import sys
import threading
import time
from http.client import HTTPConnection

import chip_smoke

BODY = b"x" * (1 << 20)


class Handler(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def do_POST(self):
        self.rfile.read(int(self.headers.get("Content-Length", "0")))
        self.send_response(201)
        self.send_header("Content-Length", "0")
        self.end_headers()

    def log_message(self, *args):
        pass


def serve(kind: str):
    if kind == "pooled":
        from seaweedfs_tpu_torch.utils.http_pool import PooledHTTPServer

        srv = PooledHTTPServer(("127.0.0.1", 0), Handler)
    else:
        srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def plain_pass(port: int, n: int) -> dict:
    hangs = run = longest = 0
    slowest = 0.0
    for _ in range(n):
        while True:
            conn = HTTPConnection("127.0.0.1", port, timeout=chip_smoke.CONNECT_S)
            t = time.perf_counter()
            try:
                conn.connect()
            except TimeoutError:
                hangs += 1
                run += 1
                longest = max(longest, run)
                continue
            slowest = max(slowest, time.perf_counter() - t)
            run = 0
            break
        conn.sock.settimeout(60)
        conn.request("POST", "/x", BODY, {"Connection": "close"})
        conn.getresponse().read()
        conn.close()
    return {"hangs": hangs, "longest_run_of_hangs": longest, "slowest_connect_s": slowest}


def smoke_pass(port: int, n: int) -> dict:
    redials0, failed = chip_smoke.CONNECT_RETRIES[0], []
    for i in range(n):
        try:
            status, _, _ = chip_smoke.http(f"http://127.0.0.1:{port}/x", "POST", BODY)
            if status != 201:
                failed.append((i, status))
        except AssertionError as e:
            failed.append((i, str(e)[:200]))
    return {"redials": chip_smoke.CONNECT_RETRIES[0] - redials0, "failed": failed}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=10000, help="requests per pass")
    args = ap.parse_args()
    ok = True
    for kind in ("pooled", "threading"):
        srv = serve(kind)
        port = srv.server_address[1]
        for name, fn in (("plain", plain_pass), ("smoke", smoke_pass)):
            t0 = time.perf_counter()
            out = fn(port, args.requests)
            out.update(server=kind, client=name, requests=args.requests,
                       seconds=time.perf_counter() - t0)
            ok &= not out.get("failed")
            print(json.dumps(out), flush=True)
        srv.shutdown()
        srv.server_close()
    print(chip_smoke.card_line())
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
