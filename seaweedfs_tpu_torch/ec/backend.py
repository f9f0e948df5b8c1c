"""Reed-Solomon compute backends: `TorchBackend` and `CpuBackend`.

Port of seaweedfs_tpu/ec/backend.py (`_BackendBase`, `CpuBackend` and
`JaxBackend`, ec/backend.py:85-277), with the whole RSBackend surface the
EC pipeline is written against: encode, apply, reconstruct, verify and
the staged hooks to_device -> encode_staged | apply_staged -> to_host.
All of them take and return numpy uint8 arrays of shape (rows, n).

- `CpuBackend`: the native C++ GF(2^8) apply of the port's host library
  (csrc/seaweed_native.cpp: PSHUFB nibble tables, AVX2 or SSSE3), the
  klauspost-equivalent CPU path. Reached only by name
  (`get_backend("cpu", k, m)`) or by passing one in.
- `TorchBackend`: the GF(2) bit-matrix kernels on a torch device
  (ops/rs_kernels.py), on "cuda" unless the caller passes device="cpu"
  (then the kernels' plain versions run).

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
card, a default-constructed `TorchBackend` raises. There is no "auto":
no default and no error path resolves to `CpuBackend`.
"""

from __future__ import annotations

import functools
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import gf256
from ..ops.rs_torch import RSTorch
from ..utils import native
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

    `chip_label` is the `chip` label of the flight recorder's device
    stages (utils/trace.py): the torch device string of a
    `TorchBackend`, "" for a backend on no device."""

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
        self.chip_label = str(self.device)
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


@functools.lru_cache(maxsize=16)
def get_backend(
    name: str, data_shards: int, parity_shards: int, impl: str = "cuda"
) -> _BackendBase:
    """name: cuda (`TorchBackend` on the card; impl: cuda | cuda_planes,
    the kernel) or cpu (the native `CpuBackend`, which has one apply, so
    an impl other than the default raises). There is no "auto": a
    missing card raises rather than falling back to the CPU. The plain
    torch versions on the CPU are `TorchBackend(ctx, device="cpu",
    impl=...)`."""
    ctx = ECContext(data_shards, parity_shards)
    if name == "cpu":
        if impl != "cuda":
            raise ECError(f"the cpu backend takes no kernel impl (got {impl!r})")
        return CpuBackend(ctx)
    if name == "cuda":
        return TorchBackend(ctx, impl=impl)
    raise ECError(f"unknown EC backend {name!r} (want cuda|cpu)")
