"""PyTorch port: the metrics registry and the EC flight recorder
(seaweedfs_tpu_torch/utils/{metrics,request_id,glog,trace}.py) and their
call sites, held against the JAX package on the CPU.

- The port's copies of tests/test_trace.py, run against the port's
  modules: the disarmed no-op singleton, span invariants over real EC
  ops, the ring bound, the overlap-efficiency math, the Chrome trace,
  gRPC-metadata continuity, the slow-op log, duplicate registration,
  adversarial label escaping, and the two lints (stage literals and
  metric names) over the port's package.
- Cross-package: one seeded sequence of counter, gauge and histogram
  operations (the `sw_net_*` families included) renders byte-identical
  exposition text from both registries; the span trees of encode, rebuild, a degraded read,
  decode, a leaf repair and a stream have the same ops and stage names
  in both packages (JAX `CpuBackend` against the port's `CpuBackend`,
  the JAX Pallas kernel in interpret mode against
  `TorchBackend(device="cpu")`), every difference named in
  `NOT_IN_PORT`; so do a peer-fetch rebuild's `ec.peer_rebuild` tree
  and the `rpc.ec_shard_read` roots its shard net plane's server adopts
  from the client's trace across the wire, on either plane; each scrub case of tests/test_torch_repair.py moves
  the leaf-repair and journal counters by the same amounts in both.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import pkgutil
import re
import shutil
import sys
import time

import numpy as np
import pytest
from test_ec_pipeline import make_volume
from test_torch_repair import CTX as RCTX
from test_torch_repair import JCTX as RJCTX
from test_torch_net_plane import FilePlane, wire_transports
from test_torch_net_plane import _peer_dir as peer_dir
from test_torch_peer_rebuild import CTX as PCTX
from test_torch_peer_rebuild import JCTX as PJCTX
from test_torch_peer_rebuild import LEAF as PLEAF
from test_torch_peer_rebuild import rot_leaf
from test_torch_peer_rebuild import synth as peer_synth
from test_torch_repair import SCRUB_CASES, synth

from seaweedfs_tpu.ec import CpuBackend as JaxCpuBackend
from seaweedfs_tpu.ec import ECContext as JaxECContext
from seaweedfs_tpu.ec import EcStreamEncoder as JaxStreamEncoder
from seaweedfs_tpu.ec import EcVolume as JaxEcVolume
from seaweedfs_tpu.ec import JaxBackend
from seaweedfs_tpu.ec import ec_decode_volume as jax_decode
from seaweedfs_tpu.ec import ec_encode_volume as jax_encode
from seaweedfs_tpu.ec import net_plane as jax_np
from seaweedfs_tpu.ec import rebuild_ec_files as jax_rebuild
from seaweedfs_tpu.ec.scrub import scrub_ec_volume as jax_scrub
from seaweedfs_tpu.utils import metrics as JM
from seaweedfs_tpu.utils import trace as jax_trace
from seaweedfs_tpu.utils.retry import RetryPolicy as JaxRetryPolicy
from seaweedfs_tpu_torch.ec import (
    CpuBackend,
    ECContext,
    EcStreamEncoder,
    EcVolume,
    TorchBackend,
    ec_decode_volume,
    ec_encode_volume,
    rebuild_ec_files,
    scrub_ec_volume,
)
from seaweedfs_tpu_torch.ec import net_plane
from seaweedfs_tpu_torch.utils import metrics as M
from seaweedfs_tpu_torch.utils import request_id as rid
from seaweedfs_tpu_torch.utils import trace
from seaweedfs_tpu_torch.utils.retry import RetryPolicy

CTX = ECContext(10, 4)
JCTX = JaxECContext(10, 4)


@pytest.fixture
def recorder():
    trace.configure(enabled=True, ring_size=256, slow_op_s=0.0)
    trace.reset()
    yield trace
    trace.configure(enabled=False, slow_op_s=0.0)
    trace.reset()


def walk(doc):
    yield doc
    for ch in doc["children"]:
        yield from walk(ch)


# ---------------------------------------------------------------- disarmed


def test_disarmed_fast_path_is_noop_singleton():
    """Span-enter/exit when disarmed must be one flag/is-None check and
    ZERO allocations: every helper returns the same singleton or None."""
    assert not trace.armed
    assert trace.start("ec.encode") is None
    assert trace.current() is None
    noop = trace.stage(None, "disk_read")
    assert noop is trace.stage(None, "h2d_dispatch")
    assert noop is trace.activate(None)
    with noop:
        pass
    trace.add_stage(None, "disk_read", 1.0)
    trace.event(None, "x", a=1)
    trace.finish(None)
    assert trace.traces() == []
    rid.clear()
    assert trace.grpc_metadata() is None
    # an active request id still rides: id propagation is not gated on
    # the tracer
    rid.ensure("req-123")
    md = dict(trace.grpc_metadata())
    assert md == {trace.REQUEST_ID_KEY: "req-123"}
    rid.clear()


# ------------------------------------------------------- span invariants


def test_span_tree_invariants_on_real_ec_ops(recorder, tmp_path):
    """Encode + degraded read + rebuild of the port under the armed
    recorder: every child span nests inside its root's wall time, every
    stage total is bounded by its span's duration, and the per-op
    histograms and gauges populate."""
    TOL = 0.25  # clock-read ordering slack

    base, payloads = make_volume(tmp_path, needles=20)
    ec_encode_volume(base, CTX, backend=CpuBackend(CTX))

    for i in (0, 3):
        os.unlink(base + CTX.to_ext(i))
    ev = EcVolume(str(tmp_path), 1, backend="cpu")
    try:
        for i in list(payloads)[:3]:
            assert ev.read_needle(i).data == payloads[i]
    finally:
        ev.close()

    assert rebuild_ec_files(base, CTX, backend=CpuBackend(CTX)) == [0, 3]

    docs = trace.traces()
    by_op = {}
    for d in docs:
        by_op.setdefault(d["op"], []).append(d)
    assert {"ec.encode_volume", "ec.degraded_read", "ec.rebuild"} <= set(by_op)

    for root in docs:
        r_lo = root["start_ts"] - TOL
        r_hi = root["start_ts"] + root["duration_s"] + TOL
        for node in walk(root):
            assert node["trace_id"] == root["trace_id"]
            assert node["duration_s"] >= 0.0
            assert node["start_ts"] >= r_lo
            assert node["start_ts"] + node["duration_s"] <= r_hi
            for name, acc in node["stages"].items():
                assert acc["count"] >= 1, (root["op"], name)
                if name == "queue_wait":
                    # accumulated from both pipeline threads: may exceed
                    # the op wall under two-sided backpressure
                    continue
                assert acc["seconds"] <= node["duration_s"] + TOL, (root["op"], name, acc)

    enc = by_op["ec.encode_volume"][0]
    pipe = [n for n in walk(enc) if n["op"] == "ec.encode"]
    assert pipe and {"disk_read", "write_sink"} <= set(pipe[0]["stages"])
    dr_stages = set()
    for d in by_op["ec.degraded_read"]:
        dr_stages |= set(d["stages"])
    assert "sibling_read" in dr_stages
    assert "fsync_publish" in by_op["ec.rebuild"][0]["stages"]

    text = M.REGISTRY.render().decode()
    for op in ("ec.encode", "ec.degraded_read", "ec.rebuild"):
        assert f'op="{op}"' in text
    assert "sw_ec_stage_seconds_count" in text
    assert "sw_ec_overlap_efficiency" in text
    assert 'sw_ec_traces_total{op="ec.rebuild"}' in text


def test_ring_is_bounded(recorder):
    trace.configure(ring_size=4)
    for i in range(10):
        trace.finish(trace.start("ec.encode", name=f"op{i}"))
    docs = trace.traces()
    assert len(docs) == 4
    assert docs[-1]["name"] == "op9"  # newest kept, oldest dropped


# --------------------------------------------------------------- overlap


def _doc(dur, stages):
    return {
        "duration_s": dur,
        "stages": {k: {"seconds": v, "count": 1, "chip": ""} for k, v in stages.items()},
        "children": [],
    }


def test_overlap_efficiency_math():
    # fully serial: every device second exposed
    assert trace.overlap_efficiency(_doc(2.0, {
        "disk_read": 1.0, "h2d_dispatch": 0.5, "device_drain": 0.5,
    })) == 0.0
    # fully overlapped: wall = host alone and the drain never blocked
    assert trace.overlap_efficiency(_doc(1.0, {
        "disk_read": 1.0, "h2d_dispatch": 0.5, "device_drain": 0.0,
    })) == 1.0
    # half hidden
    assert trace.overlap_efficiency(_doc(1.25, {
        "disk_read": 1.0, "h2d_dispatch": 0.25, "device_drain": 0.25,
    })) == pytest.approx(0.5)
    # host stages overlapping each other zero the residue, but a 0.9 s
    # measured drain is exposed by definition
    assert trace.overlap_efficiency(_doc(1.1, {
        "disk_read": 1.0, "write_sink": 1.0,
        "h2d_dispatch": 0.1, "device_drain": 0.9,
    })) == pytest.approx(0.1)
    # no device work: undefined, not 0
    assert trace.overlap_efficiency(_doc(1.0, {"disk_read": 1.0})) is None


# ---------------------------------------------------------------- export


def test_chrome_trace_export_structure(recorder):
    sp = trace.start("ec.encode", name="vol1", base="/x/1")
    with trace.activate(sp):
        with trace.stage(sp, "disk_read"):
            pass
        child = trace.start("ec.peer_fetch", name="shard 2")
        trace.event(child, "placement", chip="chip0")
        trace.finish(child)
    trace.finish(sp)

    doc = trace.chrome_trace()
    json.loads(json.dumps(doc))
    evs = doc["traceEvents"]
    metas = [e for e in evs if e["ph"] == "M"]
    assert any(e["name"] == "process_name" for e in metas)
    assert any(e["name"] == "thread_name" for e in metas)
    xs = [e for e in evs if e["ph"] == "X"]
    assert {e["name"] for e in xs} == {"vol1", "shard 2"}
    for e in xs:
        assert e["dur"] > 0 and e["ts"] > 0
        assert {"pid", "tid", "cat", "args"} <= set(e)
    root_ev = next(e for e in xs if e["name"] == "vol1")
    assert root_ev["args"]["trace_id"] == sp.trace_id
    assert "disk_read" in root_ev["args"]["stages_ms"]
    assert any(e["ph"] == "i" and e["name"] == "placement" for e in evs)
    assert trace.chrome_trace("feedfeedfeedfeed")["traceEvents"] == []


def test_grpc_metadata_continuity(recorder):
    """Client-side metadata -> server-side adoption keeps ONE trace id
    with parent/child linkage (the wire-format contract of the header
    helpers, unused until the port has servers)."""
    rid.ensure("req-xyz")
    try:
        sp = trace.start("ec.peer_rebuild", name="v7")
        with trace.activate(sp):
            md = dict(trace.grpc_metadata())
        assert md[trace.TRACE_ID_KEY] == sp.trace_id
        assert md[trace.PARENT_SPAN_KEY] == sp.span_id
        assert md[trace.REQUEST_ID_KEY] == "req-xyz"
        adopted = trace.start_from_metadata("rpc.ec_shard_read", md, server="peer:8080")
        assert adopted.trace_id == sp.trace_id
        assert adopted.parent_id == sp.span_id
        assert adopted.server == "peer:8080"
        hdr = trace.http_headers(sp)
        via_http = trace.start_from_headers("http.volume", hdr, server="volume")
        assert (via_http.trace_id, via_http.parent_id) == (sp.trace_id, sp.span_id)
        trace.finish(via_http)
        trace.finish(adopted)
        trace.finish(sp)
        assert len(trace.traces(sp.trace_id)) == 3  # three local roots, one trace
    finally:
        rid.clear()


def test_slow_op_log_fires_and_counts(recorder, capfd):
    trace.configure(slow_op_s=0.001)
    line = 'sw_ec_slow_ops_total{op="ec.rebuild"}'

    def count(text):
        for ln in text.splitlines():
            if ln.startswith(line):
                return float(ln.rsplit(" ", 1)[1])
        return 0.0

    before = count(M.REGISTRY.render().decode())
    sp = trace.start("ec.rebuild", name="slowpoke")
    with trace.stage(sp, "disk_read"):
        time.sleep(0.01)
    trace.finish(sp)
    err = capfd.readouterr().err
    assert "slow op ec.rebuild" in err
    assert "slowpoke" in err and "disk_read" in err
    after = count(M.REGISTRY.render().decode())
    assert after == before + 1
    trace.finish(trace.start("ec.rebuild", name="fast"))
    assert count(M.REGISTRY.render().decode()) == after


# ------------------------------------------------- metrics hardening


def test_duplicate_metric_registration_raises():
    reg = M.Registry()
    reg.counter("sw_dup_total", "first", ("a",))
    with pytest.raises(ValueError, match="already registered"):
        reg.counter("sw_dup_total", "second")
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("sw_dup_total", "third")


_SAMPLE = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})? (\S+)$')
_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _unescape(v: str) -> str:
    return v.replace("\\n", "\n").replace('\\"', '"').replace("\\\\", "\\")


def parse_exposition(text: str) -> dict:
    """Every sample line of a text exposition, lexed: {(name, sorted
    label pairs): value}. Raises on a line that does not lex."""
    parsed = {}
    for ln in text.splitlines():
        assert ln.strip(), "blank line inside exposition"
        if ln.startswith("#"):
            assert ln.startswith("# HELP") or ln.startswith("# TYPE"), ln
            continue
        m = _SAMPLE.match(ln)
        assert m, f"unparseable sample line: {ln!r}"
        labels = {k: _unescape(v) for k, v in _LABEL.findall(m.group(2) or "")}
        parsed[(m.group(1), tuple(sorted(labels.items())))] = float(m.group(3))
    return parsed


def test_exposition_escaping_roundtrip_adversarial_labels():
    evil = 'quote:" backslash:\\ newline:\nend'
    reg = M.Registry()
    c = reg.counter("sw_esc_total", 'help with "quotes", \\slashes\n and newline', ("lbl",))
    c.inc(lbl=evil)
    c.inc(2, lbl="plain")
    g = reg.gauge("sw_esc_gauge", "g", ("a", "b"))
    g.set(1.5, a="x\\", b='"\n"')
    parsed = parse_exposition(reg.render().decode())
    assert parsed[("sw_esc_total", (("lbl", evil),))] == 1.0
    assert parsed[("sw_esc_total", (("lbl", "plain"),))] == 2.0
    assert parsed[("sw_esc_gauge", (("a", "x\\"), ("b", '"\n"')))] == 1.5


_STAGE_PATTERNS = [
    # trace.stage(sp, "name"): the first arg may be a call like trace.current()
    re.compile(r'\bstage\(\s*[A-Za-z_][\w.\[\]]*(?:\(\))?\s*,\s*"([a-z0-9_.]+)"'),
    re.compile(r'\.stage\(\s*"([a-z0-9_.]+)"'),
    re.compile(r'add_stage\(\s*"([a-z0-9_.]+)"'),
    re.compile(r'add_stage\(\s*[A-Za-z_][\w.]*\s*,\s*"([a-z0-9_.]+)"'),
    re.compile(r'(?:read_stage|write_stage)\s*=\s*"([a-z0-9_.]+)"'),
    # the port's stage helpers that time into a dict and the span at
    # once: self._stage("name") and _stage(stages, "name", span)
    re.compile(r'\b_stage\(\s*(?:[A-Za-z_][\w.]*\s*,\s*)?"([a-z0-9_.]+)"'),
]
_STAGE_TUPLE = re.compile(r"stage_names\s*=\s*\(([^)]*)\)")
# A backend's own add_stage keys its CUDA-event/wall table
# (`TorchBackend.stage_seconds`: pin, h2d, kernel, d2h, write), which is
# not a span stage; those calls are left out of the scan.
_BACKEND_TABLE = re.compile(r"\b(?:backend|self)\.add_stage\(")


def test_stage_name_registry_lint():
    """Every stage-name literal in the port's package must be in
    trace.STAGES: a typo'd label would fork a sw_ec_stage_seconds series
    instead of failing here."""
    import seaweedfs_tpu_torch

    pkg_root = seaweedfs_tpu_torch.__path__[0]
    built = os.path.join(pkg_root, "build")  # libraries and unpacked trees, not the package
    found: dict[str, set] = {}
    for dirpath, _dirnames, filenames in os.walk(pkg_root):
        if "__pycache__" in dirpath or dirpath.startswith(built):
            continue
        for fn in filenames:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            with open(path) as f:
                src = _BACKEND_TABLE.sub("backend_table(", f.read())
            names = set()
            for pat in _STAGE_PATTERNS:
                names.update(pat.findall(src))
            for tup in _STAGE_TUPLE.findall(src):
                names.update(re.findall(r'"([a-z0-9_.]+)"', tup))
            for n in names:
                found.setdefault(n, set()).add(os.path.relpath(path, pkg_root))
    unknown = {n: sorted(files) for n, files in found.items() if n not in trace.STAGES}
    assert not unknown, f"stage literals outside trace.STAGES: {unknown}"
    # the scan sees the call sites: a broken regex must not pass vacuously
    assert len(found) >= 12, sorted(found)
    for required in (
        "disk_read", "h2d_dispatch", "device_drain", "write_sink", "fsync_publish",
        "verify", "crc_verify", "sibling_read", "reconstruct", "stage_batch",
        "index_sort", "repair_patch", "parity_update",
    ):
        assert required in found, required


def test_metrics_lint_package_wide():
    """Import every module of the port, then lint every sw_* registration:
    unique names, `sw_<subsystem>_<name>`, non-empty help, counters end
    in _total, timing histograms in _seconds."""
    import seaweedfs_tpu_torch

    for mod in pkgutil.walk_packages(seaweedfs_tpu_torch.__path__, "seaweedfs_tpu_torch."):
        importlib.import_module(mod.name)
        # and its counterpart, whose import registers the JAX families the
        # port's module registers (the master's fleet gauges live in its
        # topology module, in both packages)
        twin = "seaweedfs_tpu." + mod.name.split(".", 1)[1]
        if importlib.util.find_spec(twin) is not None:
            importlib.import_module(twin)
    # the filer server's modules and their counterparts among them
    for name in ("server.filer_server", "filer.lock_ring", "filer.tus", "client.filer_client"):
        assert f"seaweedfs_tpu_torch.{name}" in sys.modules and f"seaweedfs_tpu.{name}" in sys.modules
    # S3's gateway, its libraries and IAM, with their counterparts
    # (s3/auth registers sw_s3_auth_memo_total in both packages)
    for name in ("iam.policy", "iam.sts", "s3.auth", "s3.chunked", "s3.post_policy", "s3.config",
                 "s3.versioning", "s3.sse", "s3.server", "s3.lifecycle"):
        assert f"seaweedfs_tpu_torch.{name}" in sys.modules and f"seaweedfs_tpu.{name}" in sys.modules
    assert "sw_s3_auth_memo_total" in {m.name for m in M.REGISTRY._metrics}

    metrics = list(M.REGISTRY._metrics)
    assert len(metrics) >= 15
    names = [m.name for m in metrics]
    assert len(names) == len(set(names)), "duplicate metric names"
    pat = re.compile(r"^sw(_[a-z0-9]+)+$")
    for m in metrics:
        assert pat.match(m.name), f"bad metric name {m.name!r}"
        assert m.help and m.help.strip(), f"{m.name} has no help text"
        if isinstance(m, M.Counter):
            assert m.name.endswith("_total"), f"counter {m.name} must end in _total"
        if isinstance(m, M.Histogram):
            assert m.name.endswith("_seconds"), f"timing histogram {m.name} must end in _seconds"
    # every family the port registers is the JAX package's, with its help
    # text and type (the JAX registry also holds families of modules the
    # port does not have yet)
    theirs = {m.name: m for m in JM.REGISTRY._metrics}
    for m in metrics:
        assert m.name in theirs, m.name
        assert (type(m).__name__, m.help, m.label_names) == (
            type(theirs[m.name]).__name__, theirs[m.name].help, theirs[m.name].label_names
        ), m.name


# ------------------------------------------- cross-package: exposition


def _script(pkg, seed: int) -> bytes:
    """One seeded sequence of registry operations, labels adversarial
    included; returns the rendered exposition."""
    rng = np.random.default_rng(seed)
    reg = pkg.Registry()
    labels = ["a", "b\\c", 'q"uote', "new\nline", ""]
    c = reg.counter("sw_x_ops_total", 'ops with "quotes"\nand a newline', ("op", "code"))
    g = reg.gauge("sw_x_level", "a level", ("chip",))
    h = reg.histogram("sw_x_seconds", "latency", ("op",))
    hb = reg.histogram("sw_x_lag_seconds", "lag", buckets=(0.001, 0.01, 0.1, 1.0))
    # the network byte plane's families, as the package registers them
    net = [reg.counter(f.name, f.help, f.label_names) for f in (
        pkg.net_bytes_sent_total, pkg.net_bytes_received_total, pkg.net_bytes_copied_total)]
    samples = [({"chip": lab}, float(i) * 0.5) for i, lab in enumerate(labels)]
    reg.gauge("sw_x_open", "callback gauge", ("chip",), fn=lambda: iter(samples))
    for _ in range(200):
        kind = int(rng.integers(0, 7))
        lab = labels[int(rng.integers(0, len(labels)))]
        v = float(rng.exponential(0.05))
        if kind == 0:
            c.inc(op=lab, code=str(int(rng.integers(200, 204))))
        elif kind == 1:
            c.inc(float(rng.integers(1, 1 << 20)), op=lab, code="200")
        elif kind == 2:
            g.set(v * 1e3, chip=lab)
        elif kind == 3:
            (g.inc if rng.integers(0, 2) else g.dec)(float(rng.integers(1, 5)), chip=lab)
        elif kind == 4:
            h.observe(v, op=lab)
        elif kind == 5:
            hb.observe(v * 10)
        else:
            net[int(rng.integers(0, 3))].inc(
                float(rng.integers(1, 1 << 22)), plane=("native", "python")[int(rng.integers(0, 2))],
                direction=("read", "write", lab)[int(rng.integers(0, 3))])
    return reg.render()


@pytest.mark.parametrize("seed", range(5))
def test_exposition_byte_identical_to_jax(seed):
    ours = _script(M, seed)
    assert ours == _script(JM, seed)
    parse_exposition(ours.decode())


def test_quantiles_and_summaries_match_jax():
    for pkg in (M, JM):
        assert pkg.bucket_quantile((0.1, 0.5, 1.0, 5.0), [0, 0, 100, 100], 100, 0.5) == 0.75
    rng = np.random.default_rng(3)
    vals = rng.exponential(0.05, 500)
    got = []
    for pkg in (M, JM):
        h = pkg.Registry().histogram("sw_q_seconds", "q", ("op",))
        for v in vals:
            h.observe(float(v), op="x")
        got.append([h.quantile(q, ("x",)) for q in (0.5, 0.9, 0.99)])
    assert got[0] == got[1]
    for pkg in (M, JM):
        for v in vals[:50]:
            pkg.request_seconds.observe(float(v), server="trace-test", op="get")
    assert M.slo_summary()["trace-test.get"] == JM.slo_summary()["trace-test.get"]
    assert set(M.gateway_summary()) == set(JM.gateway_summary())


# --------------------------------------------- cross-package: span trees

# Stages the JAX package records that the port does not, each with why.
NOT_IN_PORT = {
    # recorded only when a bounded queue's put actually blocks, so its
    # presence follows timing in either package, not the code path
    "queue_wait": "timing-dependent backpressure",
}
OPS = ("ec.encode_volume", "ec.rebuild", "ec.degraded_read", "ec.decode",
       "ec.leaf_repair", "ec.stream_encode")


def _shape(doc) -> tuple:
    stages = frozenset(s for s in doc["stages"] if s not in NOT_IN_PORT)
    return (doc["op"], stages, tuple(sorted({_shape(c) for c in doc["children"]})))


def _lifecycle(side: str, pair: str, d) -> dict[str, set]:
    """Encode, rebuild, degraded reads, a leaf repair, decode and a
    stream under the armed recorder of one package; returns each root
    op's set of tree shapes."""
    jax_side = side == "jax"
    T = jax_trace if jax_side else trace
    if jax_side:
        ctx = JCTX
        be = JaxCpuBackend(ctx) if pair == "cpu" else JaxBackend(
            ctx, impl="pallas", interpret=True, n_devices=1)
    else:
        ctx = CTX
        be = CpuBackend(ctx) if pair == "cpu" else TorchBackend(ctx, device="cpu")
    T.configure(enabled=True, ring_size=256, slow_op_s=0.0)
    T.reset()
    try:
        base, payloads = make_volume(d, needles=20)
        (jax_encode if jax_side else ec_encode_volume)(base, ctx, backend=be)
        for i in (0, 3):
            os.unlink(base + ctx.to_ext(i))
        assert (jax_rebuild if jax_side else rebuild_ec_files)(base, ctx, backend=be) == [0, 3]
        if jax_side:
            ev = JaxEcVolume(str(d), 1, backend_name="cpu")
            ev.backend = be
        else:
            ev = EcVolume(str(d), 1, backend=be)
        try:
            ev.unmount_shards([0])
            for nid in list(payloads)[:3]:
                assert ev.read_needle(nid).data == payloads[nid]
        finally:
            ev.close()
        with open(base + ctx.to_ext(3), "r+b") as f:
            f.seek(100)
            b = f.read(1)
            f.seek(100)
            f.write(bytes([b[0] ^ 0x42]))
        scrub = jax_scrub if jax_side else scrub_ec_volume
        report = scrub(base, ctx, backend=be, repair=True)
        assert list(report.leaf_repaired) == [3]
        os.unlink(base + ctx.to_ext(3))
        assert (jax_decode if jax_side else ec_decode_volume)(base, ctx, backend=be)
        enc = (JaxStreamEncoder if jax_side else EcStreamEncoder)(
            os.path.join(str(d), "s"), ctx, backend=be, block_size=8192, small_block_size=1024)
        enc.append(b"z" * 30_000)
        enc.flush()
        enc.append(b"y" * 100_000)
        enc.close()
        out: dict[str, set] = {}
        for doc in T.traces():
            out.setdefault(doc["op"], set()).add(_shape(doc))
        return out
    finally:
        T.configure(enabled=False)
        T.reset()


@pytest.fixture(scope="module", params=["cpu", "kernel"])
def trees(request, tmp_path_factory):
    """(pair, {side: trees}): JAX `CpuBackend` against the port's, or the
    JAX Pallas kernel in interpret mode against TorchBackend(cpu)."""
    out = {}
    for side in ("jax", "port"):
        out[side] = _lifecycle(side, request.param, tmp_path_factory.mktemp(f"{side}-{request.param}"))
    return request.param, out


@pytest.mark.parametrize("op", OPS)
def test_span_trees_match_jax(trees, op):
    _pair, t = trees
    assert op in t["port"], sorted(t["port"])
    assert t["port"][op] == t["jax"][op]
    assert set(t["port"]) == set(t["jax"]) == set(OPS)


PEER_STAGES = {"verify", "peer_fetch", "crc_verify", "write_sink", "fsync_publish",
               "repair_fetch"}


def _peer_rebuild_trees(side: str, pair: str, plane: str, d) -> tuple[dict, list]:
    """One peer-fetch rebuild over one package's own shard net plane
    under its armed recorder: shard 2 of a 4+2 volume (v2 sidecar) held
    locally with one rotten leaf (ranged repair), shard 5 rebuilt from
    shards fetched from the peer on `plane`. Returns each root op's set
    of tree shapes and the completed roots."""
    jax_side = side == "jax"
    T = jax_trace if jax_side else trace
    mod = jax_np if jax_side else net_plane
    if jax_side:
        from seaweedfs_tpu.ec.peer_rebuild import PeerFetchTransient as transient
        from seaweedfs_tpu.ec.peer_rebuild import rebuild_from_peers as rebuild

        ctx, policy = PJCTX, JaxRetryPolicy(max_attempts=3, base_delay=0.0, jitter=0.0)
        be = JaxCpuBackend(ctx) if pair == "cpu" else JaxBackend(
            ctx, impl="pallas", interpret=True, n_devices=1)
    else:
        from seaweedfs_tpu_torch.ec.peer_rebuild import PeerFetchTransient as transient
        from seaweedfs_tpu_torch.ec.peer_rebuild import rebuild_from_peers as rebuild

        ctx, policy = PCTX, RetryPolicy(max_attempts=3, base_delay=0.0, jitter=0.0)
        be = CpuBackend(ctx) if pair == "cpu" else TorchBackend(ctx, device="cpu")
    base, blobs = peer_synth(d / "local", local=(0, 1, 2), leaf=PLEAF, seed=21)
    rot_leaf(base, 2, 1)
    peer = FilePlane(mod, peer_dir(d, blobs))
    client = mod.NetPlaneClient(timeout=5.0, connect_timeout=1.0)
    T.configure(enabled=True, ring_size=256, slow_op_s=0.0)
    T.reset()
    try:
        fetch, fetch_into = wire_transports(client, {"p": peer.addr}, mod, transient)
        rep = rebuild(base, {s: ["p"] for s in range(ctx.total)}, fetch, ctx=ctx, targets=[5],
                      backend=be, policy=policy,
                      fetch_into=fetch_into if plane == "native" else None)
        assert rep.leaf_repaired == {2: [1]} and rep.rebuilt == [5]
        assert set(rep.fetched_plane.values()) == {plane}
        assert open(base + ctx.to_ext(5), "rb").read() == blobs[5]
        # the server's spans finish after their last byte is out
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            docs = T.traces()
            if sum(doc["op"] == "rpc.ec_shard_read" for doc in docs) == peer.server.requests:
                break
            time.sleep(0.01)
        out: dict[str, set] = {}
        for doc in docs:
            out.setdefault(doc["op"], set()).add(_shape(doc))
        return out, docs
    finally:
        T.configure(enabled=False)
        T.reset()
        client.close()
        peer.close()


@pytest.mark.parametrize("plane", ["native", "python"])
@pytest.mark.parametrize("pair", ["cpu", "kernel"])
def test_peer_rebuild_span_trees_match_jax(tmp_path, pair, plane):
    """`ec.peer_rebuild` (its `ec.peer_fetch` children, the ranged
    repair's stages and the nested `ec.rebuild`) and the server's
    adopted `rpc.ec_shard_read` roots have the same shapes in both
    packages, and every server root carries the client's trace id
    across the wire, its parent a span of the client's tree."""
    got = {}
    for side in ("jax", "port"):
        got[side] = _peer_rebuild_trees(side, pair, plane, tmp_path / side)
    trees, docs = got["port"]
    assert trees == got["jax"][0]
    assert set(trees) == {"ec.peer_rebuild", "rpc.ec_shard_read"}
    (root,) = [doc for doc in docs if doc["op"] == "ec.peer_rebuild"]
    seen = set()
    for node in walk(root):
        seen |= set(node["stages"])
    assert PEER_STAGES <= seen, sorted(seen)
    assert {c["op"] for c in root["children"]} >= {"ec.peer_fetch", "ec.rebuild"}
    served = [doc for doc in docs if doc["op"] == "rpc.ec_shard_read"]
    assert served and all(doc["trace_id"] == root["trace_id"] for doc in served)
    ids = {node["span_id"] for node in walk(root)}
    assert all(doc["parent_span_id"] in ids for doc in served)


def test_device_stages_carry_the_backend_chip(recorder, tmp_path):
    """The port's device stages carry the labels the JAX package's call
    sites give them: a pool's chip ("cuda:i" on the card; `ChipBackend`
    on "cpu" here) on every device stage; a backend that is no pool chip
    (`TorchBackend`, `CpuBackend`, as a single-device `JaxBackend`) has
    no chip label, so the scheduled dispatch stages carry its device
    queue's label and the encoder's drain carries ""."""
    from seaweedfs_tpu_torch.ec import device_queue
    from seaweedfs_tpu_torch.ec.chip_pool import ChipBackend

    base, _ = make_volume(tmp_path, needles=10)
    for be, want in ((ChipBackend(CTX, "cpu"), ("cpu", "cpu")),
                     (TorchBackend(CTX, device="cpu"), (None, ""))):
        trace.reset()
        ec_encode_volume(base, CTX, backend=be)
        label = device_queue.for_backend(be).label
        assert label == (want[0] or f"TorchBackend:10+4@{label.rsplit('@', 1)[1]}")
        enc = next(n for d in trace.traces() for n in walk(d) if n["op"] == "ec.encode")
        batches = enc["stages"]["disk_read"]["count"]
        for s, chip in zip(("h2d_dispatch", "device_drain"), (label, want[1])):
            assert (enc["stages"][s]["count"], enc["stages"][s]["chip"]) == (batches, chip)
        assert enc["stages"]["admission_wait"]["count"] == batches
        assert 0.0 <= trace.overlap_efficiency(enc) <= 1.0
    trace.reset()
    for i in (1, 12):
        os.unlink(base + CTX.to_ext(i))
    cpu = CpuBackend(CTX)
    rebuild_ec_files(base, CTX, backend=cpu)
    (rb,) = trace.traces()
    label = device_queue.for_backend(cpu).label
    assert label.startswith("CpuBackend:10+4@")
    assert rb["stages"]["h2d_dispatch"]["chip"] == rb["stages"]["device_drain"]["chip"] == label


def test_outputs_identical_armed_and_disarmed(tmp_path):
    """The recorder changes no byte: an armed encode and rebuild give the
    files a disarmed run gives."""
    src, _ = make_volume(tmp_path, needles=15)
    outs = []
    for armed in (False, True):
        d = tmp_path / str(armed)
        d.mkdir()
        base = str(d / "1")
        for ext in (".dat", ".idx"):  # one volume: needle timestamps differ between two
            shutil.copy(src + ext, base + ext)
        trace.configure(enabled=armed)
        try:
            ec_encode_volume(base, CTX, backend=CpuBackend(CTX))
            os.unlink(base + CTX.to_ext(2))
            rebuild_ec_files(base, CTX, backend=CpuBackend(CTX))
        finally:
            trace.configure(enabled=False)
            trace.reset()
        outs.append([(d / f"1.ec{i:02d}").read_bytes() for i in range(CTX.total)])
    assert outs[0] == outs[1]


# ------------------------------------------ cross-package: scrub counters


def _counter_values() -> tuple[dict, dict]:
    return tuple(
        {
            name: pkg_counter.snapshot()
            for name, pkg_counter in (
                ("leaf_repairs", pkg.ec_leaf_repairs_total),
                ("journal", pkg.ec_repair_journal_total),
            )
        }
        for pkg in (M, JM)
    )


def _delta(after: dict, before: dict) -> dict:
    return {
        name: {k: v - before[name].get(k, 0.0) for k, v in vals.items() if v != before[name].get(k, 0.0)}
        for name, vals in after.items()
    }


@pytest.mark.parametrize("case", sorted(SCRUB_CASES))
def test_scrub_counters_match_jax(tmp_path, case):
    damage, synth_kw, scrub_kw, passes = SCRUB_CASES[case]
    synth(tmp_path / "seed", seed=11, **synth_kw)
    damage(tmp_path / "seed")
    jdir = shutil.copytree(tmp_path / "seed", tmp_path / "jax")
    pdir = shutil.copytree(tmp_path / "seed", tmp_path / "port")
    port0, jax0 = _counter_values()
    for _ in range(passes):
        jax_scrub(str(jdir / "1"), RJCTX, backend=JaxCpuBackend(RJCTX), repair=True,
                  rebuild_policy=JaxRetryPolicy(max_attempts=1), **scrub_kw)
        scrub_ec_volume(str(pdir / "1"), RCTX, backend=TorchBackend(RCTX, device="cpu"),
                        repair=True, rebuild_policy=RetryPolicy(max_attempts=1), **scrub_kw)
    port1, jax1 = _counter_values()
    assert _delta(port1, port0) == _delta(jax1, jax0)
