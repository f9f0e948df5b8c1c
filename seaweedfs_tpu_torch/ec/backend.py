"""Reed-Solomon compute backends: `TorchBackend`, `CpuBackend` and
`FallbackBackend`.

Port of seaweedfs_tpu/ec/backend.py (`_BackendBase`, `CpuBackend`,
`JaxBackend`, `FallbackBackend` and `get_backend`, ec/backend.py:85-494),
with the whole RSBackend surface the EC pipeline is written against:
encode, apply, reconstruct, verify and the staged hooks to_device ->
encode_staged | apply_staged -> to_host. All of them take and return
numpy uint8 arrays of shape (rows, n).

- `CpuBackend`: the native C++ GF(2^8) apply of the port's host library
  (csrc/seaweed_native.cpp: PSHUFB nibble tables, AVX2 or SSSE3), the
  klauspost-equivalent CPU path. Reached only by name
  (`get_backend("cpu", k, m)`), by passing one in, or as the fallback
  of a `FallbackBackend`.
- `TorchBackend`: the GF(2) bit-matrix kernels on a torch device
  (ops/rs_kernels.py), on "cuda" unless the caller passes device="cpu"
  (then the kernels' plain versions run). Like a single-device
  `JaxBackend` it carries no `chip_label`: its device-queue label and
  residency key are its own (ec/device_queue.py `_queue_label`), so two
  backends on one card are two queues, as in the JAX package. A chip of
  a pool (ec/chip_pool.py `ChipBackend`) carries "cuda:i".
- `FallbackBackend`: a primary device backend and the native
  `CpuBackend` behind a circuit breaker, failing over mid-batch (the
  host copy of a dispatched batch is replayed on the CPU). Every batch
  it serves on the CPU is counted (`fallback_batches`), and the seven
  `ec.backend.device.*` fault points sit in front of the primary.

On CUDA the staged hooks overlap copy and compute:

- `to_device` issues a non-blocking H2D copy on the backend's own CUDA
  stream, from the batch itself when it already lies in page-locked
  memory (a matrix of native_io.BufferPool on cuda; `pin_skips` counts
  these), else from a pinned host buffer it copies the batch into;
- `encode_staged` / `apply_staged` launch the kernel (ops/rs_kernels.py)
  on that stream and record an event;
- `to_host` is the only place that waits: a second stream waits for the
  kernel's event, copies the result into pinned host memory, and the
  host blocks on that copy alone.

`stage_seconds` accumulates where a run's time went: "h2d", "kernel"
and "d2h" are device time from CUDA events (on the CPU, wall time of the
calls: `CpuBackend`'s "kernel" is the wall of its applies, and its "pin",
"h2d" and "d2h" stay 0); "pin" is the host copy into pinned memory, where
one was made; "disk_read" and "write" are wall time of the reader and
writer stages, recorded by the encoder and rebuild through `add_stage`.

`impl` picks the kernel (RSTorch's impl): "cuda" applies the bit-major
matrix through `gf2_apply` (JaxBackend impl="pallas"), "cuda_planes" the
plane stack through `gf2_apply_planes` (JaxBackend impl="pallas_aligned").

Entry points run on "cuda" unless the caller names the CPU; with no
card, a default-constructed `TorchBackend` raises. `get_backend("auto")`
is reached only by name: it takes the card when the bounded probe
(utils/devices.py) finds one, wrapped in a `FallbackBackend`, else the
native `CpuBackend`; every CPU resolution is counted in `AUTO_CPU` and
logged. A card the probe finds and the backend cannot use raises;
`FallbackBackend` fails over only on a lost device (an OSError), never
on a kernel or CUDA error.
"""

from __future__ import annotations

import functools
import itertools
import threading
import time
import weakref
from dataclasses import dataclass

import numpy as np
import torch

from .. import faults
from ..ops import gf256
from ..ops.rs_torch import RSTorch
from ..utils import metrics as _M
from ..utils import native
from ..utils.glog import logger
from ..utils.retry import CircuitBreaker
from .context import ECContext, ECError

STAGES = ("disk_read", "pin", "h2d", "kernel", "d2h", "write")
IMPLS = ("cuda", "cuda_planes")


def _decode_coeffs(
    matrix: np.ndarray, out_rows: tuple[int, ...], src_rows: tuple[int, ...]
) -> np.ndarray:
    """Rows mapping shards[src_rows] (k of them) -> shards[out_rows]."""
    inv = gf256.invert(matrix[list(src_rows), :])
    return gf256.matmul(matrix[list(out_rows), :], inv)


@dataclass
class _Staged:
    """Input batch on the device, with the events around its H2D copy."""

    data: torch.Tensor
    h2d: tuple | None


@dataclass
class _Pending:
    """A launched kernel's output and the events around its copy and
    launch (None on the CPU, where the work already ran)."""

    out: torch.Tensor
    h2d: tuple | None
    kernel: tuple | None


class _BackendBase:
    """What every backend shares: the generator matrix, reconstruct and
    verify over `apply` and `encode`, the synchronous staged hooks (a
    device backend overrides them) and the stage accounting.

    `chip_label` is the chip identity of a pool's chip ("cuda:i",
    ec/chip_pool.py `ChipBackend`): the `chip` label of the flight
    recorder's device stages (utils/trace.py) and the device queue's
    label. A backend that is not a pool's chip has none ("")."""

    chip_label = ""

    def __init__(self, ctx: ECContext):
        self.ctx = ctx
        self.matrix = gf256.build_matrix(ctx.data_shards, ctx.total)
        self._stats_lock = threading.Lock()
        self.stage_seconds = dict.fromkeys(STAGES, 0.0)
        self.pin_skips = 0

    # -- stage accounting ----------------------------------------------------

    def add_stage(self, stage: str, seconds: float) -> None:
        with self._stats_lock:
            self.stage_seconds[stage] = self.stage_seconds.get(stage, 0.0) + seconds

    def reset_stages(self) -> None:
        with self._stats_lock:
            self.stage_seconds = dict.fromkeys(STAGES, 0.0)
            self.pin_skips = 0

    # -- synchronous staged hooks: the work runs in encode_staged and
    # apply_staged, so staged output is apply()'s by construction --------------

    def to_device(self, data: np.ndarray):
        return data

    def encode_staged(self, staged):
        return self.encode(staged)

    def apply_staged(self, coeffs: np.ndarray, staged):
        return self.apply(coeffs, staged)

    def to_host(self, result) -> np.ndarray:
        return np.asarray(result, dtype=np.uint8)

    # -- reconstruct and verify ------------------------------------------------

    def reconstruct(
        self, shards: dict[int, np.ndarray], want: list[int] | None = None
    ) -> dict[int, np.ndarray]:
        """Any >= k present shards -> the missing shards (all of them, or
        just `want`)."""
        k, total = self.ctx.data_shards, self.ctx.total
        present = tuple(sorted(i for i in shards if 0 <= i < total))
        if len(present) < k:
            raise ECError(f"need {k} shards to reconstruct, have {len(present)}")
        targets = range(total) if want is None else want
        missing = tuple(i for i in targets if i not in shards)
        if not missing:
            return {}
        src = present[:k]
        coeffs = _decode_coeffs(self.matrix, missing, src)
        data = np.stack([np.asarray(shards[i], dtype=np.uint8) for i in src])
        out = self.apply(coeffs, data)
        return {idx: out[i] for i, idx in enumerate(missing)}

    def verify(self, shards: np.ndarray) -> bool:
        shards = np.asarray(shards, dtype=np.uint8)
        k = self.ctx.data_shards
        return bool(np.array_equal(self.encode(shards[:k]), shards[k:]))


class CpuBackend(_BackendBase):
    """RS encode/apply on the host through the native GF(2^8) apply of
    the port's host library (utils/native.rs_apply; rs_apply_mt, columns
    split over the library's worker pool, at widths of 1 MiB and more).

    Departure from the JAX CpuBackend, which computes with the numpy
    tables (gf256.matrix_apply) when its library is unavailable: this one
    raises. Building and loading the library happens at construction, so
    a failed build raises here; nothing computes the bytes another way."""

    # Below this width, splitting the columns costs more than it wins;
    # single-interval read recovery stays on the calling thread.
    _MT_MIN_WIDTH = 1 << 20

    def __init__(self, ctx: ECContext):
        super().__init__(ctx)
        self.avx2 = native.has_avx2()  # builds and loads the library
        self._parity = np.ascontiguousarray(self.matrix[ctx.data_shards :])

    def apply(self, coeffs: np.ndarray, data: np.ndarray) -> np.ndarray:
        """out[r] = sum_j coeffs[r,j] * data[j] over GF(256)."""
        coeffs = np.asarray(coeffs, np.uint8)
        data = np.asarray(data, np.uint8)
        t0 = time.perf_counter()
        if data.ndim == 2 and data.shape[1] >= self._MT_MIN_WIDTH:
            out = native.rs_apply_mt(coeffs, data)
        else:
            out = native.rs_apply(coeffs, data)
        self.add_stage("kernel", time.perf_counter() - t0)
        return out

    def encode(self, data: np.ndarray) -> np.ndarray:
        """(k, n) data -> (m, n) parity."""
        return self.apply(self._parity, data)


class TorchBackend(_BackendBase):
    """RS encode/apply on one torch device through the GF(2) kernel."""

    def __init__(self, ctx: ECContext, device="cuda", impl: str = "cuda"):
        if impl not in IMPLS:
            raise ECError(f"unknown TorchBackend impl {impl!r} (want cuda|cuda_planes)")
        self.impl = impl
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "TorchBackend: no CUDA device is available; pass "
                    "device='cpu' to run the plain version on the CPU"
                )
            if self.device.index is None:
                self.device = torch.device("cuda", torch.cuda.current_device())
            self._stream = torch.cuda.Stream(self.device)
            self._d2h_stream = torch.cuda.Stream(self.device)
        elif self.device.type == "cpu":
            self._stream = self._d2h_stream = None
        else:
            raise ECError(f"TorchBackend runs on cuda or cpu, not {self.device}")
        super().__init__(ctx)
        self._rs = RSTorch(
            ctx.data_shards, ctx.parity_shards, impl=impl, device=self.device
        )

    def _event(self) -> torch.cuda.Event:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    # -- staged pipeline hooks -------------------------------------------------

    def to_device(self, data: np.ndarray) -> _Staged:
        """Start the batch's copy to the device. A batch in page-locked
        memory is copied from where it lies, so its caller must not
        reuse it before `to_host` of this batch's result has returned
        (the D2H event that `to_host` waits on is ordered after the
        kernel, and the kernel after this copy, on one stream)."""
        data = np.ascontiguousarray(data, dtype=np.uint8)
        if self._stream is None:
            return _Staged(torch.from_numpy(data), None)
        host = torch.from_numpy(data)
        if host.is_pinned():
            with self._stats_lock:
                self.pin_skips += 1
        else:
            t0 = time.perf_counter()
            # torch's caching host allocator recycles pinned blocks, and
            # keeps one from reuse until the copy recorded on it has finished.
            host = torch.empty(data.shape, dtype=torch.uint8, pin_memory=True)
            np.copyto(host.numpy(), data)
            self.add_stage("pin", time.perf_counter() - t0)
        with torch.cuda.stream(self._stream):
            dev = torch.empty(data.shape, dtype=torch.uint8, device=self.device)
            start = self._event()
            dev.copy_(host, non_blocking=True)
            return _Staged(dev, (start, self._event()))

    def _launch(self, staged: _Staged, fn) -> _Pending:
        if self._stream is None:
            t0 = time.perf_counter()
            out = fn(staged.data)
            self.add_stage("kernel", time.perf_counter() - t0)
            return _Pending(out, None, None)
        with torch.cuda.stream(self._stream):
            start = self._event()
            out = fn(staged.data)
            return _Pending(out, staged.h2d, (start, self._event()))

    def encode_staged(self, staged: _Staged) -> _Pending:
        return self._launch(staged, self._rs.encode)

    def apply_staged(self, coeffs: np.ndarray, staged: _Staged) -> _Pending:
        coeffs = np.ascontiguousarray(coeffs, dtype=np.uint8)
        return self._launch(staged, functools.partial(self._rs.apply, coeffs))

    def to_host(self, result: _Pending) -> np.ndarray:
        if self._stream is None:
            return result.out.numpy()
        host = torch.empty(result.out.shape, dtype=torch.uint8, pin_memory=True)
        self._d2h_stream.wait_event(result.kernel[1])
        with torch.cuda.stream(self._d2h_stream):
            start = self._event()
            host.copy_(result.out, non_blocking=True)
            end = self._event()
        end.synchronize()
        with self._stats_lock:
            s = self.stage_seconds
            if result.h2d is not None:
                s["h2d"] += result.h2d[0].elapsed_time(result.h2d[1]) / 1e3
            s["kernel"] += result.kernel[0].elapsed_time(result.kernel[1]) / 1e3
            s["d2h"] += start.elapsed_time(end) / 1e3
        return host.numpy()

    # -- synchronous surface ---------------------------------------------------

    def encode(self, data: np.ndarray) -> np.ndarray:
        """(k, n) data -> (m, n) parity."""
        return self.to_host(self.encode_staged(self.to_device(data)))

    def apply(self, coeffs: np.ndarray, data: np.ndarray) -> np.ndarray:
        """out[r] = sum_j coeffs[r,j] * data[j] over GF(256)."""
        return self.to_host(self.apply_staged(coeffs, self.to_device(data)))


# Live FallbackBackend registry for the breaker gauge: sampled at
# /metrics render time (a callback gauge), so an open breaker shows
# without any code path publishing it. Weak refs: the gauge must never
# keep a dead backend (and its device state) alive.
_FALLBACKS: "weakref.WeakSet" = weakref.WeakSet()
_fallback_seq = itertools.count()
_log = logger("ec.backend")


def _breaker_samples():
    # One sample per chip label: several live FallbackBackends can wrap
    # the same chip, and duplicate series in one exposition are invalid
    # Prometheus. Any open breaker marks the chip degraded.
    by_chip: dict[str, float] = {}
    for be in list(_FALLBACKS):
        label = be.chip_label or f"{type(be.primary).__name__}@{be._seq}"
        is_open = 1.0 if be.breaker.state == "open" else 0.0
        by_chip[label] = max(by_chip.get(label, 0.0), is_open)
    for label, val in sorted(by_chip.items()):
        yield {"chip": label}, val


_M.REGISTRY.gauge(
    "sw_ec_chip_breaker_open",
    "EC device fallback breaker open per chip (1 = streams on CPU)",
    ("chip",),
    fn=_breaker_samples,
)


class FallbackBackend(_BackendBase):
    """Device backend with a CPU escape hatch, mid-batch.

    Wraps a primary (`TorchBackend`, or a pool's `ChipBackend`) and the
    native `CpuBackend`, whose outputs are bit-identical by
    construction. Every staged handle carries the host copy of its batch
    beside the device handle, so when the device fails between dispatch
    and drain (`to_host` is where a reset or hung card surfaces), the
    batch is recomputed on the CPU and the stream goes on without loss.

    A circuit breaker (utils/retry.py) stops feeding a failing device:
    after `failure_threshold` consecutive device errors every batch goes
    to the CPU until the reset timeout admits a probe. Each batch the
    CPU serves is counted in `fallback_batches`.

    Only a device that stopped answering fails over: an OSError, the
    class the `ec.backend.device.*` fault points raise (and a hung
    card's TimeoutError). Everything else re-raises untouched and does
    not charge the breaker: caller errors (TypeError, ValueError,
    ECError), which the CPU would raise alike; a kernel that does not
    build or launch, and any CUDA error (RuntimeErrors), which must show
    rather than hide behind the CPU; and InjectedCrash (a
    BaseException), a simulated process death. The JAX package fails
    over on any Exception but its caller errors; the port is narrower
    so that a broken kernel cannot pass for a working one.

    The stage table is the two backends' together: `add_stage` (the
    pipeline's "disk_read" and "write") goes to the primary, and
    `stage_seconds` sums the primary's device stages and the CPU's
    "kernel" wall. `device` and `pin_skips` are the primary's, so the
    native plane lands batches page-locked for it."""

    def __init__(self, primary, fallback: CpuBackend, breaker=None):
        self.ctx = primary.ctx
        self.primary = primary
        self.fallback = fallback
        # both backends derive from one ctx, so they share the matrix
        self.matrix = fallback.matrix
        self.breaker = breaker or CircuitBreaker(failure_threshold=3, reset_timeout=60.0)
        self.fallback_batches = 0  # batches served by the CPU
        # a pool chip's identity ("cuda:i"): fault-point context, queue
        # and gauge label
        self.chip_label = getattr(primary, "chip_label", "")
        self._seq = next(_fallback_seq)
        self._count_lock = threading.Lock()
        _FALLBACKS.add(self)

    # -- the two stage tables as one ------------------------------------------

    @property
    def device(self):
        return getattr(self.primary, "device", None)

    @property
    def stage_seconds(self) -> dict:
        out = dict(self.primary.stage_seconds)
        for k, v in self.fallback.stage_seconds.items():
            out[k] = out.get(k, 0.0) + v
        return out

    @property
    def pin_skips(self) -> int:
        return self.primary.pin_skips

    def add_stage(self, stage: str, seconds: float) -> None:
        self.primary.add_stage(stage, seconds)

    def reset_stages(self) -> None:
        self.primary.reset_stages()
        self.fallback.reset_stages()

    # What fails over: a lost device. Caller errors, kernel build and
    # launch errors and CUDA errors are none of it (see the class
    # docstring), so they re-raise untouched.
    _DEVICE_LOST = (OSError,)

    def _device_failed(self, stage: str, e: Exception) -> None:
        if not isinstance(e, self._DEVICE_LOST):
            raise e
        self.breaker.record_failure()
        _log.warning(
            "device backend failed in %s (%s); falling back to CPU (breaker %s)",
            stage, e, self.breaker.state,
        )

    def _served_on_cpu(self) -> None:
        with self._count_lock:
            self.fallback_batches += 1

    # -- synchronous surface -----------------------------------------------------

    def encode(self, data: np.ndarray) -> np.ndarray:
        if self.breaker.allows():
            try:
                faults.fire("ec.backend.device.encode", width=data.shape[1])
                out = self.primary.encode(data)
                self.breaker.record_success()
                return out
            except Exception as e:
                self._device_failed("encode", e)
        self._served_on_cpu()
        return self.fallback.encode(data)

    def apply(self, coeffs: np.ndarray, data: np.ndarray) -> np.ndarray:
        if self.breaker.allows():
            try:
                faults.fire("ec.backend.device.apply")
                out = self.primary.apply(coeffs, data)
                self.breaker.record_success()
                return out
            except Exception as e:
                self._device_failed("apply", e)
        self._served_on_cpu()
        return self.fallback.apply(coeffs, data)

    def reconstruct(
        self, shards: dict[int, np.ndarray], want: list[int] | None = None
    ) -> dict[int, np.ndarray]:
        if self.breaker.allows():
            try:
                faults.fire("ec.backend.device.reconstruct")
                out = self.primary.reconstruct(shards, want=want)
                self.breaker.record_success()
                return out
            except Exception as e:
                self._device_failed("reconstruct", e)
        self._served_on_cpu()
        return self.fallback.reconstruct(shards, want=want)

    # -- staged pipeline ---------------------------------------------------------
    #
    # to_device handles are (host_batch, device_handle | None); dispatched
    # handles are (kind, host_batch, device_result | None, coeffs | None),
    # so to_host knows which computation to replay on the CPU when the
    # device fails between dispatch and drain.

    def to_device(self, data: np.ndarray):
        data = np.ascontiguousarray(data, dtype=np.uint8)
        if self.breaker.allows():
            try:
                faults.fire(
                    "ec.backend.device.to_device",
                    width=data.shape[1], chip=self.chip_label,
                )
                return (data, self.primary.to_device(data))
            except Exception as e:
                self._device_failed("to_device", e)
        return (data, None)

    def encode_staged(self, staged):
        host, dev = staged
        if dev is not None:
            try:
                faults.fire("ec.backend.device.encode_staged", chip=self.chip_label)
                return ("encode", host, self.primary.encode_staged(dev), None)
            except Exception as e:
                self._device_failed("encode_staged", e)
        return ("encode", host, None, None)

    def apply_staged(self, coeffs: np.ndarray, staged):
        host, dev = staged
        coeffs = np.ascontiguousarray(coeffs, dtype=np.uint8)
        if dev is not None:
            try:
                faults.fire("ec.backend.device.apply_staged", chip=self.chip_label)
                return ("apply", host, self.primary.apply_staged(coeffs, dev), coeffs)
            except Exception as e:
                self._device_failed("apply_staged", e)
        return ("apply", host, None, coeffs)

    def to_host(self, result) -> np.ndarray:
        kind, host, dev, coeffs = result
        if dev is not None:
            try:
                faults.fire("ec.backend.device.to_host", chip=self.chip_label)
                out = np.asarray(self.primary.to_host(dev), dtype=np.uint8)
                self.breaker.record_success()
                return out
            except Exception as e:
                self._device_failed("to_host", e)
        # mid-batch failover: the host copy is recomputed on the CPU,
        # bit-identical to what the device would have produced
        self._served_on_cpu()
        if kind == "apply":
            return self.fallback.apply(coeffs, host)
        return self.fallback.encode(host)


# CPU resolutions of get_backend("auto"), counted where they happen, as
# rs_kernels.MASKED counts the masked path: "no_card" when the probe
# finds no card. A probe that finds a card never resolves to the CPU.
AUTO_CPU = {"no_card": 0}


@functools.lru_cache(maxsize=16)
def get_backend(
    name: str, data_shards: int, parity_shards: int, impl: str = "cuda"
) -> _BackendBase:
    """name: cuda (`TorchBackend` on the card; impl: cuda | cuda_planes,
    the kernel), cpu (the native `CpuBackend`, which has one apply, so an
    impl other than the default raises) or auto (the card wrapped in a
    `FallbackBackend` when the bounded probe finds one, else
    `CpuBackend`, counted in `AUTO_CPU` and logged). Where the probe
    finds a card and the device backend does not build, auto raises, as
    cuda does: the CPU never stands in for a card that is there. "cuda"
    stays the default of every entry point; "auto" is reached only by
    name. The plain torch versions on the CPU are
    `TorchBackend(ctx, device="cpu", impl=...)`."""
    ctx = ECContext(data_shards, parity_shards)
    if name == "cpu":
        if impl != "cuda":
            raise ECError(f"the cpu backend takes no kernel impl (got {impl!r})")
        return CpuBackend(ctx)
    if name == "cuda":
        return TorchBackend(ctx, impl=impl)
    if name == "auto":
        # never ask the device in-process here: a wedged driver would
        # hang the caller; the probe is a bounded subprocess
        from ..utils.devices import accelerator_available

        if accelerator_available():
            return FallbackBackend(TorchBackend(ctx, impl=impl), CpuBackend(ctx))
        AUTO_CPU["no_card"] += 1
        _log.warning("auto EC backend: no CUDA device found by the probe; using the CPU")
        return CpuBackend(ctx)
    raise ECError(f"unknown EC backend {name!r} (want cuda|cpu|auto)")
