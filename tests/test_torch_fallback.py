"""PyTorch port: `FallbackBackend` and `get_backend("auto")` held against
the JAX package on the CPU.

The port's `FallbackBackend(TorchBackend(ctx, device="cpu"), CpuBackend)`
runs beside the JAX `FallbackBackend(JaxBackend, CpuBackend)` under the
same fault points, armed in each package's own registry: the same shard
bytes, `fallback_batches`, breaker state and breaker-gauge sample
(tolerance 0). Also: caller errors pass through without charging the
breaker, `InjectedCrash` is not absorbed, a half-open probe closes the
breaker, a scheduled stream fails over mid-batch, a kernel or CUDA error
re-raises where the JAX package fails over, and `auto` on this box (no
card) resolves to the native `CpuBackend`, counted in `backend.AUTO_CPU`.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from seaweedfs_tpu import faults as jax_faults
from seaweedfs_tpu.ec import CpuBackend as JaxCpuBackend
from seaweedfs_tpu.ec import ECContext as JaxECContext
from seaweedfs_tpu.ec import FallbackBackend as JaxFallbackBackend
from seaweedfs_tpu.ec import JaxBackend
from seaweedfs_tpu.ec import backend as jax_backend
from seaweedfs_tpu.ec import device_queue as jax_dq
from seaweedfs_tpu.ec import write_ec_files as jax_write_ec_files
from seaweedfs_tpu.ec.pipeline import run_staged_apply as jax_run_staged_apply
from seaweedfs_tpu.utils.retry import CircuitBreaker as JaxCircuitBreaker
from seaweedfs_tpu_torch import faults
from seaweedfs_tpu_torch.ec import (
    CpuBackend,
    ECContext,
    ECError,
    FallbackBackend,
    TorchBackend,
    backend,
    device_queue,
    get_backend,
    write_ec_files,
)
from seaweedfs_tpu_torch.ec.encoder import batch_plan
from seaweedfs_tpu_torch.ec.pipeline import run_staged_apply
from seaweedfs_tpu_torch.utils import devices
from seaweedfs_tpu_torch.utils.retry import CircuitBreaker

from test_ec_chaos import make_volume

CTX = ECContext(10, 4)
JCTX = JaxECContext(10, 4)
SIZES = dict(batch_size=16384, large_block_size=65536, small_block_size=4096)


@pytest.fixture(autouse=True)
def _clean_registries():
    """The port's fault registry is its own (tests/conftest.py clears only
    the JAX one)."""
    faults.clear()
    jax_faults.clear()
    yield
    faults.clear()
    jax_faults.clear()


def _pair(threshold=3, reset=60.0, clock=None):
    kw = {} if clock is None else {"clock": clock}
    port = FallbackBackend(TorchBackend(CTX, device="cpu"), CpuBackend(CTX),
                           breaker=CircuitBreaker(threshold, reset, **kw))
    jax = JaxFallbackBackend(JaxBackend(JCTX, impl="xla", n_devices=1), JaxCpuBackend(JCTX),
                             breaker=JaxCircuitBreaker(threshold, reset, **kw))
    return port, jax


def _gauge(mod, be) -> float:
    label = be.chip_label or f"{type(be.primary).__name__}@{be._seq}"
    return dict((lab["chip"], v) for lab, v in mod._breaker_samples())[label]


def _state(mod, be) -> tuple:
    return be.fallback_batches, be.breaker.state, _gauge(mod, be)


@pytest.fixture(scope="module")
def volume(tmp_path_factory):
    base, _ = make_volume(tmp_path_factory.mktemp("fb-vol"), needles=30, seed=5)
    return base


def _encode(side: str, be, src: str, d) -> list[bytes]:
    os.makedirs(d, exist_ok=True)
    base = os.path.join(str(d), "1")
    shutil.copy(src + ".dat", base + ".dat")
    if side == "port":
        write_ec_files(base, CTX, be, **SIZES)
    else:
        jax_write_ec_files(base, JCTX, be, **SIZES)
    return [open(base + f".ec{i:02d}", "rb").read() for i in range(14)]


# point, fault count (None = every call), expected (fallback_batches, state) or None
STAGED_CASES = [
    ("ec.backend.device.to_host", None, "open"),
    ("ec.backend.device.to_host", 2, "closed"),
    ("ec.backend.device.to_device", None, "open"),
    ("ec.backend.device.encode_staged", None, "open"),
    ("ec.backend.device.encode_staged", 1, "closed"),
]


@pytest.mark.parametrize("point,count,state", STAGED_CASES,
                         ids=[f"{p.rsplit('.', 1)[1]}-{c}" for p, c, _ in STAGED_CASES])
def test_staged_encode_failover_matches_jax(tmp_path, volume, point, count, state):
    port, jax = _pair()
    clean = _encode("port", CpuBackend(CTX), volume, tmp_path / "clean")
    with faults.injected(point, faults.io_error(), count=count):
        got = _encode("port", port, volume, tmp_path / "port")
    with jax_faults.injected(point, jax_faults.io_error(), count=count):
        want = _encode("jax", jax, volume, tmp_path / "jax")
    assert got == want == clean
    assert _state(backend, port) == _state(jax_backend, jax)
    assert port.breaker.state == state
    if count is not None:
        assert port.fallback_batches == count
    else:
        # every batch was served by the CPU: failed on the device, or
        # sent straight to the CPU past the opened breaker
        n = len(list(batch_plan(os.path.getsize(volume + ".dat"), 10, SIZES["batch_size"],
                                SIZES["large_block_size"], SIZES["small_block_size"])))
        assert port.fallback_batches == n > 3 and _gauge(backend, port) == 1.0


@pytest.mark.parametrize("point", ["ec.backend.device.apply_staged", "ec.backend.device.to_host"])
def test_staged_apply_failover_matches_jax(point):
    """run_staged_apply (the rebuild / decode / wide-read driver) under a
    QueueScope, its batches failing on the device: the CPU replays each
    one, and the queue's slots all come back."""
    rng = np.random.default_rng(8)
    coeffs = rng.integers(0, 256, (2, 10), dtype=np.uint8)
    batches = [rng.integers(0, 256, (10, w), dtype=np.uint8) for w in (4096, 1000, 4096, 17, 333)]
    want = [JaxCpuBackend(JCTX).apply(coeffs, b) for b in batches]
    out = []
    for side, be, run, fx, dq in (
        ("port", _pair()[0], run_staged_apply, faults, device_queue),
        ("jax", _pair()[1], jax_run_staged_apply, jax_faults, jax_dq),
    ):
        got = {}
        scope = dq.QueueScope(window=2, residency=False)
        with fx.injected(point, fx.io_error()):
            run(be, coeffs, lambda: iter(enumerate(batches)),
                lambda tag, o: got.__setitem__(tag, o.copy()), scheduler=scope)
        assert [got[i].tolist() for i in range(len(batches))] == [w.tolist() for w in want]
        (q,) = scope.stats_snapshot()
        out.append((_state(backend if side == "port" else jax_backend, be),
                    q["classes"]["recovery"]["admitted"], q["classes"]["recovery"]["inflight"]))
    assert out[0] == out[1] == ((5, "open", 1.0), 5, 0)


@pytest.mark.parametrize("op,point", [
    ("encode", "ec.backend.device.encode"),
    ("apply", "ec.backend.device.apply"),
    ("reconstruct", "ec.backend.device.reconstruct"),
])
@pytest.mark.parametrize("count", [None, 1])
def test_synchronous_failover_matches_jax(op, point, count):
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, (10, 777), dtype=np.uint8)
    coeffs = rng.integers(0, 256, (3, 10), dtype=np.uint8)
    shards = {10 + i: s for i, s in enumerate(JaxCpuBackend(JCTX).encode(data))}
    shards.update({i: data[i] for i in range(10)})
    for i in (0, 5, 12):
        shards.pop(i)
    port, jax = _pair()
    outs = []
    for be, fx in ((port, faults), (jax, jax_faults)):
        res = []
        with fx.injected(point, fx.io_error(), count=count):
            for _ in range(4):
                if op == "encode":
                    res.append(be.encode(data).tolist())
                elif op == "apply":
                    res.append(be.apply(coeffs, data).tolist())
                else:
                    res.append({k: v.tolist() for k, v in be.reconstruct(dict(shards)).items()})
        outs.append(res)
    assert outs[0] == outs[1]
    assert _state(backend, port) == _state(jax_backend, jax)
    assert port.fallback_batches == (4 if count is None else 1)
    assert port.breaker.state == ("open" if count is None else "closed")


class _Refusing:
    """A primary that raises `exc` from every call."""

    chip_label = ""

    def __init__(self, ctx, exc):
        self.ctx = ctx
        self.exc = exc

    def __getattr__(self, name):
        def refuse(*a, **kw):
            raise self.exc

        return refuse


@pytest.mark.parametrize("exc", [ValueError("bad shape"), TypeError("bad dtype"), "ECError"])
def test_caller_errors_pass_through_like_jax(exc):
    data = np.zeros((10, 64), dtype=np.uint8)
    out = []
    for fb, cpu, ctx, err in (
        (FallbackBackend, CpuBackend, CTX, ECError),
        (JaxFallbackBackend, JaxCpuBackend, JCTX, jax_backend.ECError),
    ):
        e = err("bad ratio") if exc == "ECError" else exc
        be = fb(_Refusing(ctx, e), cpu(ctx))
        for call in (lambda: be.encode(data), lambda: be.to_host(be.encode_staged(be.to_device(data)))):
            with pytest.raises(type(e)):
                call()
        out.append((be.fallback_batches, be.breaker.state, be.breaker._failures))
    assert out[0] == out[1] == (0, "closed", 0)


KERNEL_ERRORS = {
    "launch": RuntimeError("gf2_apply kernel launch failed: CUDA error 700"),
    "build": RuntimeError("build failed: gf2_apply (exit 1)"),
    "cuda": torch.cuda.OutOfMemoryError("CUDA out of memory"),
}


@pytest.mark.parametrize("kind", sorted(KERNEL_ERRORS))
def test_kernel_and_cuda_errors_are_not_hidden(kind):
    """A kernel that does not build or launch, or a CUDA error, re-raises
    from every entry point without charging the breaker or serving a
    batch on the CPU. Here the port is narrower than the JAX package,
    which fails over on them; a lost device (an OSError, as the fault
    points raise) still fails over in both."""
    exc = KERNEL_ERRORS[kind]
    data = np.zeros((10, 64), dtype=np.uint8)
    coeffs = np.ones((2, 10), dtype=np.uint8)
    be = FallbackBackend(_Refusing(CTX, exc), CpuBackend(CTX))
    for call in (
        lambda: be.encode(data),
        lambda: be.apply(coeffs, data),
        lambda: be.reconstruct({i: data[i] for i in range(10)}),
        lambda: be.to_device(data),
    ):
        with pytest.raises(type(exc)):
            call()
    staged = (data, object())  # a device handle, as to_device returns one
    for call in (lambda: be.encode_staged(staged), lambda: be.apply_staged(coeffs, staged),
                 lambda: be.to_host(("encode", data, object(), None))):
        with pytest.raises(type(exc)):
            call()
    assert (be.fallback_batches, be.breaker.state, be.breaker._failures) == (0, "closed", 0)
    jax = JaxFallbackBackend(_Refusing(JCTX, exc), JaxCpuBackend(JCTX))
    assert jax.encode(data).tolist() == be.fallback.encode(data).tolist()
    assert jax.fallback_batches == 1
    lost = FallbackBackend(_Refusing(CTX, faults.InjectedIOError("device lost")), CpuBackend(CTX))
    assert lost.encode(data).tolist() == be.fallback.encode(data).tolist()
    assert (lost.fallback_batches, lost.breaker._failures) == (1, 1)


def test_kernel_library_that_does_not_load_is_a_runtime_error(monkeypatch):
    """ctypes reports an unloadable library as an OSError; the kernel
    wrappers turn it into a RuntimeError, so the failover cannot take a
    kernel that does not load for a lost device."""
    from seaweedfs_tpu_torch.ops import _build, rs_kernels

    def unloadable(name):
        raise OSError(f"lib{name}.so: invalid ELF header")

    monkeypatch.setattr(_build, "load", unloadable)
    with pytest.raises(RuntimeError, match="did not build or load: .*invalid ELF header"):
        rs_kernels._kernel_lib()


def test_injected_crash_is_not_absorbed_like_jax():
    data = np.random.default_rng(2).integers(0, 256, (10, 100), dtype=np.uint8)
    port, jax = _pair()
    for be, fx in ((port, faults), (jax, jax_faults)):
        with fx.injected("ec.backend.device.to_host", fx.crash()):
            with pytest.raises(fx.InjectedCrash):
                be.to_host(be.encode_staged(be.to_device(data)))
        with fx.injected("ec.backend.device.encode", fx.crash()):
            with pytest.raises(fx.InjectedCrash):
                be.encode(data)
    assert _state(backend, port) == _state(jax_backend, jax) == (0, "closed", 0.0)


def test_half_open_probe_closes_the_breaker_like_jax():
    now = [0.0]
    port, jax = _pair(threshold=2, reset=5.0, clock=lambda: now[0])
    data = np.random.default_rng(6).integers(0, 256, (10, 200), dtype=np.uint8)
    trail = []
    for be, fx, mod in ((port, faults, backend), (jax, jax_faults, jax_backend)):
        now[0] = 0.0
        steps = []
        with fx.injected("ec.backend.device.to_host", fx.io_error()):
            for _ in range(3):
                be.to_host(be.encode_staged(be.to_device(data)))
                steps.append(_state(mod, be))
        now[0] = 4.0
        steps.append(be.breaker.state)
        now[0] = 5.5
        steps.append(be.breaker.state)
        out = be.to_host(be.encode_staged(be.to_device(data)))  # the probe
        steps.append((_state(mod, be), out.tolist() == JaxCpuBackend(JCTX).encode(data).tolist()))
        trail.append(steps)
    assert trail[0] == trail[1]
    assert trail[0][-1] == ((3, "closed", 0.0), True)


def test_backend_surface_and_stage_table():
    """The wrapper's stage table is both backends' together, and its
    device, pin count and matrix are the primary's."""
    port, _ = _pair()
    data = np.random.default_rng(1).integers(0, 256, (10, 4096), dtype=np.uint8)
    port.reset_stages()
    with faults.injected("ec.backend.device.to_host", faults.io_error(), count=1):
        a = port.to_host(port.encode_staged(port.to_device(data)))
    b = port.to_host(port.encode_staged(port.to_device(data)))
    assert a.tolist() == b.tolist() == CpuBackend(CTX).encode(data).tolist()
    st = port.stage_seconds
    assert st["kernel"] == port.primary.stage_seconds["kernel"] + port.fallback.stage_seconds["kernel"]
    assert port.fallback.stage_seconds["kernel"] > 0 and port.primary.stage_seconds["kernel"] > 0
    port.add_stage("disk_read", 1.5)
    assert port.primary.stage_seconds["disk_read"] == port.stage_seconds["disk_read"] == 1.5
    assert port.device == port.primary.device and port.pin_skips == 0
    assert np.array_equal(port.matrix, port.primary.matrix) and port.chip_label == ""
    assert port.verify(np.concatenate([data, b]))
    port.reset_stages()
    assert not any(port.stage_seconds.values())


def test_gauge_samples_are_one_per_chip():
    """Several wrappers of one chip give one sample, open if any is."""
    from seaweedfs_tpu_torch.ec.chip_pool import ChipBackend

    a = FallbackBackend(ChipBackend(CTX, "cpu"), CpuBackend(CTX))
    b = FallbackBackend(ChipBackend(CTX, "cpu"), CpuBackend(CTX))
    assert a.chip_label == b.chip_label == "cpu"
    b.breaker.record_failure()
    b.breaker.record_failure()
    b.breaker.record_failure()
    samples = [(lab["chip"], v) for lab, v in backend._breaker_samples()]
    assert samples.count(("cpu", 1.0)) == 1 and not any(c == "cpu" and v == 0.0 for c, v in samples)
    text = backend._M.REGISTRY.render().decode()
    assert 'sw_ec_chip_breaker_open{chip="cpu"} 1' in text
    helps = [ln for ln in text.splitlines() if ln.startswith("# ") and "sw_ec_chip_breaker_open" in ln]
    jax_text = jax_backend._M.REGISTRY.render().decode()
    assert helps == [ln for ln in jax_text.splitlines()
                     if ln.startswith("# ") and "sw_ec_chip_breaker_open" in ln]


# ------------------------------------------------------------- auto


def test_auto_resolves_to_a_counted_cpu_backend_without_a_card(monkeypatch):
    """This box has no card: the bounded probe (a subprocess, never the
    device in-process) finds none, and `auto` resolves to the native
    CpuBackend, counted, as the JAX package resolves to its CpuBackend."""
    monkeypatch.setattr(devices, "_cached", None)
    before = dict(backend.AUTO_CPU)
    be = get_backend("auto", 9, 3)  # a geometry no other test caches
    assert type(be) is CpuBackend and be is get_backend("auto", 9, 3)
    assert backend.AUTO_CPU == {**before, "no_card": before["no_card"] + 1}
    assert devices.probe_accelerators() == 0 and not devices.accelerator_available()
    jax_be = jax_backend.get_backend("auto", 9, 3)
    assert type(jax_be).__name__ == type(be).__name__ == "CpuBackend"
    data = np.random.default_rng(9).integers(0, 256, (9, 500), dtype=np.uint8)
    assert be.encode(data).tolist() == jax_be.encode(data).tolist()
    with pytest.raises(ECError, match="cuda|cpu|auto"):
        get_backend("tpu", 9, 3)


def test_auto_counts_a_device_backend_that_does_not_build(monkeypatch):
    """A probe that sees a card while the in-process backend cannot build
    raises, as `cuda` does, and counts no CPU resolution: the CPU never
    stands in for a card that is there (the JAX package's silent
    `except Exception: pass` falls to its CpuBackend here)."""
    monkeypatch.setattr(devices, "_cached", 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = dict(backend.AUTO_CPU)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_backend("auto", 8, 3)
    assert backend.AUTO_CPU == before


def test_probe_timeout_and_cache(monkeypatch):
    monkeypatch.setattr(devices, "_cached", None)
    monkeypatch.setenv("SEAWEED_DEVICE_PROBE_TIMEOUT", "0.001")
    assert devices.probe_accelerators() == 0  # timed out: no card
    monkeypatch.setattr(devices, "_cached", 3)
    assert devices.probe_accelerators() == 3 and devices.accelerator_available()
