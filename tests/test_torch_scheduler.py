"""PyTorch port: the device scheduler (ec/device_queue.py) and stream
placement (ec/chip_pool.py) held against the JAX package on the CPU.

Each case feeds the same seeded, scripted inputs to both packages and
asserts equal results, exactly (tolerance 0):

- `DeviceQueue`: grant order and `stats()` under class shares, window 1,
  every arrival queued behind a held slot, on an injected clock (so
  every wait is a number the script chose), and the liveness timeout;
- `ResidencyLedger`: grants, `shed_level`, `shed_advice`, `snapshot()`
  and the starvation bound, on an injected clock;
- `ChipPool.acquire`, `loads` and `idle` over fake chips, and the live
  routing signal `_live_loads_for`;
- the exposition text of every new family (`sw_ec_queue_*`,
  `sw_ec_residency_*`, `sw_ec_placement_decisions_total`), byte-identical;
- rebuild, decode, scrub with repair, degraded reads and a stream under a
  `QueueScope`, each giving the JAX package's bytes and the same
  per-class admissions.

That the two packages' schedulers share no state in one process is
held in tests/test_torch_ec.py, beside the import guards.
"""

import os
import queue
import shutil
import threading
import time

import numpy as np
import pytest

from seaweedfs_tpu.ec import CpuBackend as JaxCpuBackend
from seaweedfs_tpu.ec import EcStreamEncoder as JaxStreamEncoder
from seaweedfs_tpu.ec import EcVolume as JaxEcVolume
from seaweedfs_tpu.ec import chip_pool as jax_pool
from seaweedfs_tpu.ec import device_queue as jax_dq
from seaweedfs_tpu.ec import ec_decode_volume as jax_decode
from seaweedfs_tpu.ec import ec_encode_volume as jax_encode
from seaweedfs_tpu.ec import rebuild_ec_files as jax_rebuild
from seaweedfs_tpu.ec import ECContext as JaxECContext
from seaweedfs_tpu.ec.scrub import scrub_ec_volume as jax_scrub
from seaweedfs_tpu.utils import metrics as jax_metrics
from seaweedfs_tpu_torch.ec import (
    BitrotProtection,
    CpuBackend,
    ECContext,
    ECError,
    EcStreamEncoder,
    EcVolume,
    TorchBackend,
    chip_pool,
    device_queue,
    ec_decode_volume,
    ec_encode_volume,
    rebuild_ec_files,
    scrub_ec_volume,
)
from seaweedfs_tpu_torch.utils import metrics

from test_ec_chaos import make_volume

CTX = ECContext(10, 4)
JCTX = JaxECContext(10, 4)


class FakeClock:
    """A monotonic clock that moves only when the script moves it."""

    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


class FakeChip:
    """A pinned chip's stand-in: a chip label and, optionally, a breaker."""

    def __init__(self, label, breaker=None):
        self.chip_label = label
        if breaker is not None:
            self.breaker = breaker


class FakeBreaker:
    def __init__(self, state="closed"):
        self.state = state


def _wait_for(cond, what: str, timeout: float = 10.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.001)


# ------------------------------------------------------------- DeviceQueue


def _arrivals(seed: int, n: int = 14):
    rng = np.random.default_rng(seed)
    classes = ("foreground", "recovery", "scrub")
    return [
        (classes[int(rng.integers(0, 3))], int(rng.integers(1, 5)) * 4096, float(rng.integers(1, 4)) / 8)
        for _ in range(n)
    ]


def _queue_script(dq, seed: int, shares: dict):
    """Window 1: one held slot, every arrival queued behind it in the
    seeded order, then one release at a time (the clock advanced by the
    arrival's hold time before it). Returns the grant order, the stats
    after every grant, and the final stats and load."""
    clock = FakeClock()
    q = dq.DeviceQueue(window=1, shares=shares, clock=clock, label=f"script-{seed}")
    hold = q._admit("foreground", 1)
    granted: "queue.Queue" = queue.Queue()
    threads = []
    arrivals = _arrivals(seed)
    for n, (cls, cost, _hold_s) in enumerate(arrivals):
        def run(n=n, cls=cls, cost=cost):
            granted.put((n, q._admit(cls, cost)))

        t = threading.Thread(target=run)
        t.start()
        threads.append(t)
        _wait_for(lambda: q.stats()[cls]["depth"] == sum(1 for c, *_ in arrivals[: n + 1] if c == cls),
                  f"arrival {n} queued")
        clock.advance(0.125)
    order, stats_trail = [], []
    ticket = hold
    for _ in arrivals:
        q._release(ticket)
        n, ticket = granted.get(timeout=10)
        order.append(n)
        stats_trail.append(q.stats())
        clock.advance(arrivals[n][2])
    q._release(ticket)
    for t in threads:
        t.join(timeout=10)
    return order, stats_trail, q.stats(), q.load(), q.inflight


@pytest.mark.parametrize("shares", [
    {"recovery": 0.10, "scrub": 0.02},
    {"recovery": 0.5, "scrub": 0.25},
    {"recovery": 0.0, "scrub": 0.0},
], ids=["default", "wide", "strict"])
@pytest.mark.parametrize("seed", range(3))
def test_device_queue_grant_order_and_stats_match_jax(seed, shares):
    port = _queue_script(device_queue, seed, shares)
    jax = _queue_script(jax_dq, seed, shares)
    assert port == jax
    order, _trail, final, load, inflight = port
    assert sorted(order) == list(range(len(order))) and load == 0 and inflight == 0
    assert sum(c["admitted"] for c in final.values()) == len(order) + 1


def test_device_queue_admission_timeout_matches_jax():
    msgs = []
    for dq in (device_queue, jax_dq):
        q = dq.DeviceQueue(window=1, admit_timeout=0.05)
        q._admit("recovery", 10)
        with pytest.raises(ECError if dq is device_queue else jax_dq.ECError) as e:
            q._admit("foreground", 10)
        msgs.append(str(e.value))
        assert q.stats()["foreground"]["depth"] == 0
    assert msgs[0] == msgs[1]


def test_device_stream_and_admission_surface_match_jax():
    """The stream's dispatch / release / close and the one-shot
    admission leave the same counters in both packages, a raising
    dispatch included."""
    out = []
    for dq in (device_queue, jax_dq):
        clock = FakeClock()
        q = dq.DeviceQueue(window=3, clock=clock, label="surface")
        s = q.stream("recovery", label="r")
        t1, h1 = s.dispatch(lambda: "h1", dq.batch_cost(2, 4096))
        t2, _ = s.dispatch(lambda: None, dq.batch_cost(1, 10))
        with pytest.raises(RuntimeError):
            s.dispatch(lambda: (_ for _ in ()).throw(RuntimeError("refused")), 5)
        s.release(t1)
        with q.admission("foreground", dq.batch_cost(1, 65536)) as t3:
            mid = (q.inflight, q.load(), t3.cost)
        s.close()  # releases t2
        s.close()
        for bad in (lambda: q.stream("urgent"), lambda: q.admission("urgent", 1).__enter__()):
            with pytest.raises(Exception, match="unknown priority class"):
                bad()
        out.append((h1, mid, q.stats(), q.inflight, q.load(), dq.batch_cost(0, 0),
                    dq.batch_cost(4, 1 << 20)))
    assert out[0] == out[1]


# ------------------------------------------------------------- ResidencyLedger


def _ledger_script(dq, seed: int):
    """One physical chip of budget 2 (and a second chip with an open
    breaker): saturation raises the shed level step by step, shed
    advice names only the over-share tenant, a scrub waiter is deferred
    on the breaker-open chip until the starvation bound lets it through,
    and a recovery waiter is granted in rank order."""
    clock = FakeClock(500.0 + seed)
    led = dq.ResidencyLedger(budget=2, starve_s=10.0, shed_after_s=1.0, shed_retry_s=2.0,
                             tenant_window_s=5.0, clock=clock)
    rec = []
    a1 = led.acquire(("chip:0",), "storm", "foreground", 100 + seed)
    a2 = led.acquire(("chip:0",), "storm", "foreground", 100)
    rec.append(("full", led.shed_level(), led.snapshot()))
    granted: "queue.Queue" = queue.Queue()

    def waiter(name, keys, tenant, prio, cost):
        granted.put((name, led.acquire(keys, tenant, prio, cost, timeout=60)))

    threads = [threading.Thread(target=waiter, args=("quiet", ("chip:0",), "quiet", "foreground", 7))]
    threads[0].start()
    _wait_for(lambda: led.snapshot()["waiters"] == 1, "the quiet tenant queued")
    for dt in (0.5, 1.0, 2.0, 3.0):
        clock.advance(dt)
        rec.append(("saturated", dt, led.shed_level(), led.shed_advice("storm"),
                    led.shed_advice("quiet"), led.shed_advice("nobody"), led.snapshot()))
    led.release(a1)
    name, q1 = granted.get(timeout=10)
    rec.append(("granted", name, q1.keys, q1.tenant, q1.priority, q1.cost, q1.wait_s,
                led.shed_level(), led.snapshot()))
    # a chip whose breaker is open: a scrub waiter is deferred with slots free
    brk = FakeBreaker("open")
    led.register_breaker("chip:1", brk)
    led.register_breaker("chip:1", brk)  # duplicates are fine
    led.register_breaker("chip:1", None)
    threads.append(threading.Thread(target=waiter, args=("scrub", ("chip:1",), "quiet", "scrub", 3)))
    threads[-1].start()
    _wait_for(lambda: led.snapshot()["waiters"] == 1, "the scrub waiter queued")
    clock.advance(5.0)
    with led._cond:
        led._cond.notify_all()
    time.sleep(0.05)
    rec.append(("deferred", granted.empty(), led.shed_level(), led.snapshot()))
    clock.advance(6.0)  # past the starvation bound
    with led._cond:
        led._cond.notify_all()
    name, q2 = granted.get(timeout=10)
    rec.append(("starved through", name, q2.keys, q2.wait_s, led.snapshot()))
    for t in (a2, q1, q2, q2):
        led.release(t)
    for t in threads:
        t.join(timeout=10)
    rec.append(("drained", led.loads(), led.shed_level(), led.snapshot()))
    return rec


@pytest.mark.parametrize("seed", range(2))
def test_residency_ledger_matches_jax(seed):
    port = _ledger_script(device_queue, seed)
    jax = _ledger_script(jax_dq, seed)
    assert port == jax
    levels = [r[2] for r in port if r[0] == "saturated"]
    assert levels == [0, 1, 2, 3]  # 0.5 s, 1.5 s, 3.5 s, 6.5 s of saturation
    assert [r[3] for r in port if r[0] == "saturated"][-1] == 2.0  # the storm is shed
    assert all(r[4] is None for r in port if r[0] == "saturated")  # the quiet one never


def test_two_scopes_one_chip_share_the_ledger_budget_like_jax():
    """Two scopes, window 4 each, on one chip of budget 2: the second
    admission phase holds both to the chip's bound; grants and the
    ledger watermark equal the JAX package's."""
    out = []
    for dq in (device_queue, jax_dq):
        clock = FakeClock()
        led = dq.ResidencyLedger(budget=2, clock=clock)
        scopes = [dq.QueueScope(window=4, tenant=t, residency=led) for t in ("a", "b")]
        queues = [s.for_backend(FakeChip("chip:0", FakeBreaker())) for s in scopes]
        held = [queues[i % 2]._admit("foreground", 10) for i in range(2)]
        got: "queue.Queue" = queue.Queue()
        t = threading.Thread(target=lambda: got.put(queues[1]._admit("recovery", 30)))
        t.start()
        _wait_for(lambda: led.snapshot()["waiters"] == 1, "the third batch waiting on the ledger")
        blocked = got.empty()
        queues[0]._release(held[0])
        third = got.get(timeout=10)
        t.join(timeout=10)
        snap = led.snapshot()
        for tk in (held[1], third):
            tk_q = queues[1] if tk is third else queues[1]
            tk_q._release(tk)
        # the scope queues time waits on the host clock: compare counts
        stats = [{c: {k: v for k, v in st.items() if not k.startswith("wait_s")}
                  for c, st in q.stats().items()} for q in queues]
        out.append((blocked, snap, stats, [q.label for q in queues],
                    [q.res_keys for q in queues], led.snapshot()))
    assert out[0] == out[1]
    assert out[0][1]["chips"]["chip:0"]["max_inflight"] == 2


def test_scope_configure_and_registry_match_jax():
    out = []
    for dq in (device_queue, jax_dq):
        scope = dq.QueueScope(residency=False)
        chip = FakeChip("chip:7", FakeBreaker("open"))
        q = scope.for_backend(chip)
        step = [q is scope.for_backend(chip), q.window, dict(q.shares), scope.placement]
        step.append(scope.configure(window=6, shares={"recovery": 0.3}, placement="chip"))
        step.append((q.window, dict(q.shares)))
        step.append(scope.configure(shares={}))
        for bad in ({"shares": {"bogus": 0.5}}, {"placement": "ring"}):
            with pytest.raises(Exception, match="unknown"):
                scope.configure(**bad)
        step.append(scope.configure(enabled=False))
        step.append(scope.for_backend(chip) is None and scope.for_backend(None) is None)
        scope.configure(enabled=True)
        step.append(scope.stats_snapshot())
        step.append(scope.queue_loads())
        step.append(scope.residency_loads())
        step.append(dq._residency_keys(chip))
        step.append(dq._residency_keys(type("Wrapped", (), {"chip_label": "", "primary": chip})()))
        out.append(step)
    assert out[0] == out[1]


# ------------------------------------------------------------- placement


def _pool_script(cp, seed: int):
    rng = np.random.default_rng(seed)
    built = []
    pool = cp.ChipPool(["d0", "d1", "d2"], lambda d: built.append(d) or f"chip({d})",
                       labels=["fake:0", "fake:1", "fake:2"])
    rec, live_releases = [], []
    for step in range(16):
        op = int(rng.integers(0, 5))
        if op <= 1 or not live_releases:
            live = [int(x) for x in rng.integers(0, 3, 3) * 1000] if op == 1 else None
            i, be, rel = pool.acquire(int(rng.integers(0, 4)) * 500, live_loads=live)
            live_releases.append(rel)
            rec.append(("acquire", i, be))
        elif op == 2:
            i, be, rel = pool.acquire(700, prefer_mesh=True)
            live_releases.append(rel)
            rec.append(("prefer_mesh", i, be))
        elif op == 3:
            i, be, rel = pool.acquire(300, force_mesh=True)
            live_releases.append(rel)
            rec.append(("force_mesh", i, be))
        else:
            rel = live_releases.pop(int(rng.integers(0, len(live_releases))))
            rel()
            rel()  # idempotent
            rec.append(("release",))
        rec.append((pool.loads(), pool.idle(), pool.n_chips))
    for rel in live_releases:
        rel()
    rec.append((pool.loads(), pool.idle(), built))
    return rec


@pytest.mark.parametrize("seed", range(4))
def test_chip_pool_acquire_and_loads_match_jax(seed):
    port = _pool_script(chip_pool, seed)
    assert port == _pool_script(jax_pool, seed)
    assert port[-1][:2] == ([0, 0, 0], True)


def test_live_loads_and_breaker_penalty_match_jax():
    out = []
    for dq, cp in ((device_queue, chip_pool), (jax_dq, jax_pool)):
        led = dq.ResidencyLedger(budget=4, clock=FakeClock())
        mine = dq.QueueScope(tenant="mine", residency=led)
        other = dq.QueueScope(tenant="other", residency=led)
        chips = [FakeChip(f"fake:{i}", FakeBreaker("open" if i == 2 else "closed")) for i in range(3)]
        held = [mine.for_backend(chips[0])._admit("foreground", 100),
                other.for_backend(chips[1])._admit("recovery", 40),
                mine.for_backend(chips[1])._admit("foreground", 5)]
        mine.for_backend(chips[2])  # a queue whose chip's breaker is open
        pool = cp.ChipPool(range(3), lambda d: chips[d], labels=[c.chip_label for c in chips])
        live = cp._live_loads_for(pool, mine)
        idx, be, rel = pool.acquire(10, live_loads=live)
        out.append((live, idx, be.chip_label, cp.chip_load_hint(mine), cp.BREAKER_OPEN_PENALTY))
        rel()
        for q, t in zip((mine.for_backend(chips[0]), other.for_backend(chips[1]),
                         mine.for_backend(chips[1])), held):
            q._release(t)
    assert out[0] == out[1]
    assert out[0][0][2] >= chip_pool.BREAKER_OPEN_PENALTY and out[0][1] == 1


def test_place_stream_single_device_branches_match_jax():
    """No pool (every backend of the port): the original backend and the
    scope's queue; a disabled scope gives no queue; "mesh" mode too."""
    out = []
    for dq, cp, be in ((device_queue, chip_pool, CpuBackend(CTX)),
                       (jax_dq, jax_pool, JaxCpuBackend(JCTX))):
        rec = [cp.pool_for(be), cp.pool_for(None)]
        for kw in ({}, {"placement": "mesh"}, {"placement": "chip"}, {"enabled": False}):
            scope = dq.QueueScope(residency=False, **kw)
            p = cp.place_stream(be, "foreground", scope=scope, cost_hint=123, wide=True)
            rec.append((p.backend is be, p.queue is scope.for_backend(be), p.chip))
            p.close()
            p.close()
        p = cp.place_stream(None, "recovery")
        rec.append((p.backend, p.queue))
        out.append(rec)
    assert out[0] == out[1]
    assert out[0][2] == (True, True, None) and out[0][-2] == (True, True, None)


# ------------------------------------------------------------- exposition

FAMILIES = (
    "sw_ec_queue_depth", "sw_ec_queue_inflight", "sw_ec_queue_admitted_total",
    "sw_ec_queue_admitted_cost_total", "sw_ec_queue_wait_seconds_total",
    "sw_ec_residency_budget", "sw_ec_residency_inflight", "sw_ec_residency_pressure",
    "sw_ec_residency_admitted_total", "sw_ec_residency_admitted_cost_total",
    "sw_ec_residency_wait_seconds_total", "sw_ec_residency_shed_total",
    "sw_ec_placement_decisions_total",
)


def _family_text(registry, tag: str) -> str:
    """The HELP and TYPE lines of every new family, and its samples
    whose labels carry `tag` (both registries are process-wide)."""
    keep = []
    for ln in registry.render().decode().splitlines():
        name = ln.split()[2] if ln.startswith("# ") else ln.split("{")[0].split(" ")[0]
        if name in FAMILIES and (ln.startswith("# ") or tag in ln):
            keep.append(ln)
    return "\n".join(keep)


@pytest.mark.parametrize("seed", range(3))
def test_new_families_render_byte_identical_to_jax(seed):
    tag = f"expo-{seed}"
    for dq in (device_queue, jax_dq):
        clock = FakeClock()
        led = dq.ResidencyLedger(budget=3, clock=clock, shed_after_s=0.5)
        q = dq.DeviceQueue(window=2, clock=clock, label=f"{tag}:chip", residency=led,
                           res_keys=(f"{tag}:chip",), tenant=f"{tag}-tenant")
        rng = np.random.default_rng(seed)
        held = []
        for _ in range(int(rng.integers(2, 6))):
            cls = ("foreground", "recovery", "scrub")[int(rng.integers(0, 3))]
            clock.advance(float(rng.integers(1, 4)) / 4)
            if len(held) == 2:  # the window is full: free its oldest slot
                q._release(held.pop(0))
            held.append(q._admit(cls, int(rng.integers(1, 9)) * 1024))
        led.snapshot()  # sets the pressure gauge
        dq._res_shed.inc(tenant=f"{tag}-tenant")
    assert len(FAMILIES) == 13
    ours = _family_text(metrics.REGISTRY, tag)
    assert ours == _family_text(jax_metrics.REGISTRY, tag)
    assert ours.count("# HELP ") == len(FAMILIES) and tag in ours


# ------------------------------------------------------------- scheduled paths


@pytest.fixture(scope="module")
def encoded(tmp_path_factory):
    """One volume of real needles, encoded by the JAX package."""
    d = tmp_path_factory.mktemp("sched-src")
    base, payloads = make_volume(d, needles=24, seed=11)
    jax_encode(base, JCTX, backend=JaxCpuBackend(JCTX))
    return base, payloads


def _copy(base: str, dst, exts) -> str:
    os.makedirs(dst, exist_ok=True)
    out = os.path.join(str(dst), "1")
    for ext in exts:
        if os.path.exists(base + ext):
            shutil.copy(base + ext, out + ext)
    return out


SHARD_EXTS = tuple(f".ec{i:02d}" for i in range(14))
VOL_EXTS = (".ecx", ".ecj", ".vif", ".ecsum", ".dat", ".idx") + SHARD_EXTS


def _classes(scope) -> dict:
    """Per-class admitted batches and cost over every queue of a scope."""
    out: dict = {}
    for q in scope.stats_snapshot():
        for cls, st in q["classes"].items():
            acc = out.setdefault(cls, [0, 0])
            acc[0] += st["admitted"]
            acc[1] += st["admitted_cost"]
    return out


def _pair(tmp_path, encoded, name):
    base, _ = encoded
    return (_copy(base, tmp_path / f"{name}-port", VOL_EXTS),
            _copy(base, tmp_path / f"{name}-jax", VOL_EXTS))


def _files(b: str) -> dict:
    d = os.path.dirname(b)
    return {n: open(os.path.join(d, n), "rb").read() for n in sorted(os.listdir(d))
            if not n.endswith((".heat", ".scrubpos"))}


def test_scheduled_rebuild_matches_jax(tmp_path, encoded):
    pb, jb = _pair(tmp_path, encoded, "rebuild")
    for b in (pb, jb):
        for i in (2, 11):
            os.unlink(b + f".ec{i:02d}")
    ps, js = device_queue.QueueScope(window=2), jax_dq.QueueScope(window=2)
    pbe, jbe = TorchBackend(CTX, device="cpu"), JaxCpuBackend(JCTX)  # the scopes key queues weakly
    got = rebuild_ec_files(pb, CTX, backend=pbe, batch_size=8192, priority="recovery", scheduler=ps)
    want = jax_rebuild(jb, JCTX, backend=jbe, batch_size=8192, priority="recovery", scheduler=js)
    assert got == want == [2, 11]
    assert _files(pb) == _files(jb)
    assert _classes(ps) == _classes(js) and _classes(ps)["recovery"][0] > 1


def test_scheduled_decode_matches_jax(tmp_path, encoded):
    pb, jb = _pair(tmp_path, encoded, "decode")
    for b in (pb, jb):
        os.unlink(b + ".dat")
        os.unlink(b + ".ec04")
    ps, js = device_queue.QueueScope(), jax_dq.QueueScope()
    pbe, jbe = CpuBackend(CTX), JaxCpuBackend(JCTX)
    assert ec_decode_volume(pb, CTX, backend=pbe, scheduler=ps)
    assert jax_decode(jb, JCTX, backend=jbe, scheduler=js)
    assert _files(pb) == _files(jb)
    assert _classes(ps) == _classes(js) and _classes(ps)["recovery"][0] >= 1


def test_scheduled_scrub_repair_matches_jax(tmp_path, encoded):
    pb, jb = _pair(tmp_path, encoded, "scrub")
    for b in (pb, jb):
        os.truncate(b + ".ec06", 4096)  # cut short: quarantined and rebuilt
    ps, js = device_queue.QueueScope(), jax_dq.QueueScope()
    pbe, jbe = CpuBackend(CTX), JaxCpuBackend(JCTX)
    pr = scrub_ec_volume(pb, CTX, backend=pbe, repair=True, scheduler=ps)
    jr = jax_scrub(jb, JCTX, backend=jbe, repair=True, scheduler=js)
    assert (pr.rebuilt, pr.corrupt_shards, pr.refused) == (jr.rebuilt, jr.corrupt_shards, jr.refused)
    assert pr.rebuilt == [6]
    assert _files(pb) == _files(jb)
    assert _classes(ps) == _classes(js) and _classes(ps)["scrub"][0] >= 1


def test_scheduled_reads_match_jax(tmp_path, encoded):
    """Degraded reads under one-shot foreground admission: the same
    needles, the same per-class admissions, the same admission_wait
    stage on both packages' spans."""
    _, payloads = encoded
    pb, jb = _pair(tmp_path, encoded, "reads")
    ps, js = device_queue.QueueScope(), jax_dq.QueueScope()
    pe = EcVolume(os.path.dirname(pb), 1, backend=TorchBackend(CTX, device="cpu", impl="cuda_planes"),
                  scheduler=ps)
    je = JaxEcVolume(os.path.dirname(jb), 1, backend_name="cpu", scheduler=js)
    try:
        for ev in (pe, je):
            ev.unmount_shards([0])  # a small volume's needles lie in shard 0
        for nid, data in payloads.items():
            assert pe.read_needle(nid).data == je.read_needle(nid).data == data
        assert pe.bytes_reconstructed == je.bytes_reconstructed > 0
    finally:
        pe.close()
        je.close()
    assert _classes(ps) == _classes(js) and _classes(ps)["foreground"][0] >= 1


def test_scheduled_stream_matches_jax(tmp_path):
    payload = np.random.default_rng(4).bytes(300_000)
    ctx, jctx = ECContext(4, 2), JaxECContext(4, 2)
    ps, js = device_queue.QueueScope(window=1), jax_dq.QueueScope(window=1)
    encs = {}
    for side, cls, be, scope in (
        ("port", EcStreamEncoder, TorchBackend(ctx, device="cpu"), ps),
        ("jax", JaxStreamEncoder, JaxCpuBackend(jctx), js),
    ):
        d = tmp_path / side
        d.mkdir()
        enc = cls(str(d / "s"), ctx if side == "port" else jctx, backend=be,
                  block_size=16384, small_block_size=4096, scheduler=scope)
        enc.uuid = b"\x07" * 16
        for off in range(0, len(payload), 7000):
            enc.append(payload[off : off + 7000])
            if off % 21000 == 0:
                enc.flush()
        enc.close()
        encs[side] = enc
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    for name in names:
        if name.endswith(".ecsum"):  # its generation is a timestamp: compare the CRC lists
            a, b = (BitrotProtection.load(str(tmp_path / side / name)) for side in ("port", "jax"))
            assert (a.shard_sizes, a.shard_crcs, a.shard_leaf_crcs) == (b.shard_sizes, b.shard_crcs,
                                                                      b.shard_leaf_crcs)
            continue
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name
    assert _classes(ps) == _classes(js) and _classes(ps)["foreground"][0] > 10
    assert encs["port"]._placement.queue is ps.for_backend(encs["port"]._backend)


# ------------------------------------------------------------- the disabled scope


class _Span:
    def __init__(self):
        self.stages = []

    def add_stage(self, name, seconds, chip=""):
        self.stages.append((name, chip))


def test_direct_stream_dispatches_at_once():
    """With no queue (the scheduler disabled) a call site's stream is a
    DirectStream: DeviceStream's surface, no admission, the dispatch
    stage labeled with the chip; `admission(None, ...)` admits at once."""
    span = _Span()
    s = device_queue.open_stream(None, "recovery", label="x", span=span, chip="cuda:1")
    assert isinstance(s, device_queue.DirectStream)
    ticket, out = s.dispatch(lambda: "handle", 7)
    assert (out, ticket.priority, ticket.cost, ticket.wait_s) == ("handle", "recovery", 7, 0.0)
    with pytest.raises(RuntimeError, match="refused"):
        s.dispatch(lambda: (_ for _ in ()).throw(RuntimeError("refused")), 5)
    s.release(ticket)
    s.close()
    assert span.stages == [("h2d_dispatch", "cuda:1")] * 2
    with device_queue.admission(None, "foreground", 10, span=span) as t:
        assert t is None
    assert len(span.stages) == 2
    q = device_queue.DeviceQueue(window=1, label="q")
    assert isinstance(device_queue.open_stream(q, "scrub"), device_queue.DeviceStream)


@pytest.mark.parametrize("op", ["encode", "rebuild", "reads", "stream"])
def test_disabled_scope_matches_jax(tmp_path, encoded, op):
    """A disabled QueueScope: every call site dispatches through its
    DirectStream and gives the JAX package's bytes, admitting nothing."""
    ps, js = device_queue.QueueScope(enabled=False), jax_dq.QueueScope(enabled=False)
    pbe, jbe = TorchBackend(CTX, device="cpu"), JaxCpuBackend(JCTX)
    base, payloads = encoded
    if op == "stream":
        payload = np.random.default_rng(5).bytes(120_000)
        for side, cls, ctx in (("port", EcStreamEncoder, CTX), ("jax", JaxStreamEncoder, JCTX)):
            (tmp_path / side).mkdir()
            enc = cls(str(tmp_path / side / "s"), ctx, backend=pbe if side == "port" else jbe,
                      block_size=16384, small_block_size=4096, scheduler=ps if side == "port" else js)
            enc.uuid = b"\x05" * 16
            for off in range(0, len(payload), 7000):
                enc.append(payload[off : off + 7000])
            enc.close()
        for i in range(CTX.total):
            name = f"s.ec{i:02d}"
            assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    elif op == "reads":
        pb, jb = _pair(tmp_path, encoded, "reads")
        pe = EcVolume(os.path.dirname(pb), 1, backend=pbe, scheduler=ps)
        je = JaxEcVolume(os.path.dirname(jb), 1, backend_name="cpu", scheduler=js)
        try:
            for ev in (pe, je):
                ev.unmount_shards([0])
            for nid, data in payloads.items():
                assert pe.read_needle(nid).data == je.read_needle(nid).data == data
            assert pe.bytes_reconstructed == je.bytes_reconstructed > 0
        finally:
            pe.close()
            je.close()
    else:
        pb, jb = _pair(tmp_path, encoded, op)
        if op == "encode":
            ec_encode_volume(pb, CTX, backend=pbe, batch_size=8192, scheduler=ps)
            jax_encode(jb, JCTX, backend=jbe, batch_size=8192, scheduler=js)
        else:
            for b in (pb, jb):
                for i in (2, 11):
                    os.unlink(b + f".ec{i:02d}")
            assert rebuild_ec_files(pb, CTX, backend=pbe, batch_size=8192, scheduler=ps) \
                == jax_rebuild(jb, JCTX, backend=jbe, batch_size=8192, scheduler=js) == [2, 11]
        for name, blob in _files(jb).items():
            if not name.endswith((".ecsum", ".vif")):  # they carry the encode's timestamp
                assert _files(pb)[name] == blob, name
    assert ps.stats_snapshot() == js.stats_snapshot() == []
