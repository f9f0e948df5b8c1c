"""Durable-parity MQ log segments: the partition side of streaming EC.

Port of seaweedfs_tpu/mq/stream_parity.py, local roots only. A
durable-parity partition feeds every appended record (the segment
files' `[len|offset|ts|key|value]` wire bytes) into an
:class:`~seaweedfs_tpu_torch.ec.stream_encode.EcStreamEncoder`, so
parity trails the append head by a bounded lag (the flusher's
bytes/deadline policy). After a crash, the unsealed tail is replayed
from the EC stream: the stripe-cursor journal fences what was durable,
a dense-offset frame scan finds the true head, and parity that
disagrees with the data is re-derived before anything is published
(`ec/stream_encode.recover_stream`).

Generations: one encoder writes one `gen-%08d` stream in the large
stripe layout (never finalized); when a generation reaches
``rotate_bytes`` it is flushed, closed, and the next opens at the next
record's offset. Generations wholly below the prune floor are deleted.

What the port leaves out: the broker and its `ParityFlusher`, and remote
shard placement. A non-empty ``SEAWEED_EC_STREAM_REMOTE_ROOTS`` raises
`ECError` at construction instead of being ignored.
``SEAWEED_EC_STREAM_BACKEND`` names the backend, ``cuda`` (the default),
``cpu`` (the native `CpuBackend`) or ``auto`` (`get_backend("auto")`:
the card behind a `FallbackBackend` when the probe finds one, else the
native `CpuBackend`, counted). As in the JAX package, the partition builds
its backend when it first needs one, at its first generation or
recovery: without a card, a partition that never takes a record runs,
and the first append or recovery raises.
"""

from __future__ import annotations

import logging
import os
import shutil
import struct
import threading

from ..ec.backend import get_backend
from ..ec.context import ECContext, ECError
from ..ec.stream_encode import (
    EcStreamEncoder,
    load_stream_journal,
    recover_stream,
    stream_block_size,
    stream_small_block_size,
)

log = logging.getLogger(__name__)

GEN_PREFIX = "gen-"

# Record wire format (seaweedfs_tpu/mq/log_buffer.py), LE:
# [len u32 | offset i64 | ts_ns i64 | key_len u16 | key | value]
_REC = struct.Struct("<IqqH")


def encode_record(offset: int, ts_ns: int, key: bytes, value: bytes) -> bytes:
    body_len = _REC.size - 4 + len(key) + len(value)
    return _REC.pack(body_len, offset, ts_ns, len(key)) + key + value


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, str(default)))
    except ValueError:
        return default


def flush_bytes_default() -> int:
    """SEAWEED_EC_STREAM_FLUSH_KB: pending bytes that trigger a parity
    flush ahead of the lag deadline (default 256 KiB)."""
    return max(_env_int("SEAWEED_EC_STREAM_FLUSH_KB", 256), 1) << 10


def max_lag_s_default() -> float:
    """SEAWEED_EC_STREAM_MAX_LAG_MS: the bounded parity lag (default
    200 ms)."""
    return max(_env_int("SEAWEED_EC_STREAM_MAX_LAG_MS", 200), 1) / 1000.0


def rotate_bytes_default() -> int:
    """SEAWEED_EC_STREAM_ROTATE_MB: stream-generation rotation size
    (default 64 MiB)."""
    return max(_env_int("SEAWEED_EC_STREAM_ROTATE_MB", 64), 1) << 20


def parity_context() -> ECContext:
    """SEAWEED_EC_STREAM_SHARDS ("k+m", default 4+2): the EC geometry of
    log streams."""
    spec = os.environ.get("SEAWEED_EC_STREAM_SHARDS", "4+2")
    try:
        k_s, m_s = spec.split("+", 1)
        return ECContext(int(k_s), int(m_s))
    except (ValueError, ECError):
        log.warning("bad SEAWEED_EC_STREAM_SHARDS %r; using 4+2", spec)
        return ECContext(4, 2)


def _stream_backend_name() -> str:
    """The backend named by SEAWEED_EC_STREAM_BACKEND: cuda (default), cpu
    (the native CpuBackend) or auto (get_backend("auto")). A name
    get_backend does not know raises here, before any backend is built."""
    name = os.environ.get("SEAWEED_EC_STREAM_BACKEND", "cuda")
    if name not in ("cuda", "cpu", "auto"):
        raise ECError(f"unknown EC backend {name!r} (want cuda|cpu|auto)")
    return name


def _iter_dense(raw: bytes, base_offset: int):
    """The dense-frame parser (one acceptance rule for scan and decode):
    yield (end_pos, offset, ts_ns, key, value) for the longest prefix of
    complete record frames whose offsets are dense from `base_offset`."""
    pos = 0
    want = base_offset
    n = len(raw)
    while pos + _REC.size <= n:
        body_len, offset, ts_ns, key_len = _REC.unpack_from(raw, pos)
        end = pos + 4 + body_len
        if end > n or body_len < _REC.size - 4 + key_len:
            return
        if offset != want:
            return
        p = pos + _REC.size
        yield end, offset, ts_ns, raw[p : p + key_len], raw[p + key_len : end]
        want += 1
        pos = end


def dense_frame_scan(base_offset: int):
    """frame_scan for `recover_stream`: the byte length of the dense
    record prefix; everything past it is rolled back."""

    def scan(raw: bytes) -> int:
        pos = 0
        for end, *_rec in _iter_dense(raw, base_offset):
            pos = end
        return pos

    return scan


def decode_dense(raw: bytes, base_offset: int):
    """Yield (offset, ts_ns, key, value) for the dense prefix (the same
    parser `dense_frame_scan` measures with)."""
    for _end, off, ts_ns, key, value in _iter_dense(raw, base_offset):
        yield off, ts_ns, key, value


class PartitionParity:
    """One partition's durable-parity stream (rotating generations)."""

    def __init__(
        self,
        root: str,
        ns: str,
        name: str,
        partition: int,
        ctx: ECContext | None = None,
        backend=None,
        block_size: int | None = None,
        small_block_size: int | None = None,
        flush_bytes: int | None = None,
        max_lag_s: float | None = None,
        rotate_bytes: int | None = None,
    ):
        if os.environ.get("SEAWEED_EC_STREAM_REMOTE_ROOTS", "").strip():
            raise ECError(
                "SEAWEED_EC_STREAM_REMOTE_ROOTS is set, but the port has no "
                "remote shard placement (ec/placement.py, ec/net_plane.py): "
                "every stream shard would stay local"
            )
        self.ns, self.topic_name, self.partition = ns, name, partition
        self.ctx = ctx or parity_context()
        # None: the named one, built at the first generation or recovery
        self.backend = backend
        self._backend_name = _stream_backend_name() if backend is None else None
        self.dir = os.path.join(root, ns, name, f"{partition:04d}")
        os.makedirs(self.dir, exist_ok=True)
        self.block_size = int(block_size or stream_block_size())
        # tail blocks can never exceed the stripe row block
        self.small_block_size = min(
            int(small_block_size or stream_small_block_size()), self.block_size
        )
        self.flush_bytes = int(flush_bytes or flush_bytes_default())
        self.max_lag_s = float(max_lag_s or max_lag_s_default())
        self.rotate_bytes = int(rotate_bytes or rotate_bytes_default())
        self._lock = threading.RLock()
        self._enc: EcStreamEncoder | None = None
        self._gen = self._max_gen() + 1
        self._gen_base = -1  # first record offset of the open gen
        self.closed = False

    # --------------------------------------------------------- gen layout

    def _gen_base_path(self, gen: int) -> str:
        return os.path.join(self.dir, f"{GEN_PREFIX}{gen:08d}")

    def _gens(self) -> list[int]:
        out = []
        try:
            names = os.listdir(self.dir)
        except OSError:
            return out
        for n in names:
            if n.startswith(GEN_PREFIX):
                stem = n[len(GEN_PREFIX) :].split(".", 1)[0]
                try:
                    out.append(int(stem))
                except ValueError:
                    continue
        return sorted(set(out))

    def _max_gen(self) -> int:
        gens = self._gens()
        return gens[-1] if gens else -1

    def _backend_resolved(self):
        if self.backend is None:
            self.backend = get_backend(
                self._backend_name, self.ctx.data_shards, self.ctx.parity_shards
            )
        return self.backend

    # ------------------------------------------------------------ append

    def append_record(self, offset: int, ts_ns: int, key: bytes, value: bytes) -> None:
        """Feed one appended record's wire bytes to the open stream:
        buffering only; the parity math and fsync run on the flusher's
        schedule. The first record of a generation pays the stream's
        construction (shard file opens, the initial journal)."""
        with self._lock:
            if self.closed:
                return
            if self._enc is None:
                self._open_gen(offset)
            elif offset != self._gen_base + self._gen_records:
                # non-dense feed: the recovery contract is dense
                # offsets, so cut a fresh generation at the new base
                self._rotate_locked(offset)
            self._enc.append(encode_record(offset, ts_ns, key, value))
            self._gen_records += 1

    def _open_gen(self, base_offset: int) -> None:
        self._gen_base = base_offset
        self._gen_records = 0
        self._enc = EcStreamEncoder(
            self._gen_base_path(self._gen),
            self.ctx,
            backend=self._backend_resolved(),
            block_size=self.block_size,
            small_block_size=self.small_block_size,
            meta=base_offset,
        )

    def _rotate_locked(self, next_base: int) -> None:
        if self._enc is not None:
            self._enc.close(finalize=False)
            self._enc = None
        self._gen += 1
        self._open_gen(next_base)

    # ------------------------------------------------------------- flush

    def pending_bytes(self) -> int:
        with self._lock:
            return self._enc.pending_bytes if self._enc else 0

    def parity_lag_s(self) -> float:
        with self._lock:
            return self._enc.parity_lag_s() if self._enc else 0.0

    def needs_flush(self) -> bool:
        with self._lock:
            if self._enc is None:
                return False
            if self._enc.pending_bytes >= self.flush_bytes:
                return True
            return self._enc.pending_bytes > 0 and self._enc.parity_lag_s() >= self.max_lag_s

    def flush(self) -> None:
        # The slow half (parity math and fsync) runs outside this
        # object's lock, so appends are not stalled behind the fsync;
        # the encoder serializes flush against flush.
        with self._lock:
            enc = self._enc
        if enc is None:
            return
        enc.flush()
        with self._lock:
            if self._enc is enc and enc.head >= self.rotate_bytes:
                # rotate at a flush boundary so the closed gen's journal
                # covers its whole extent; the next gen opens at the next
                # appended record. Appends that raced in since the flush
                # land in the closing generation, which close() flushes.
                self._enc.close(finalize=False)
                self._enc = None
                self._gen += 1

    def prune(self, keep_from_offset: int) -> int:
        """Delete closed generations whose records are all below
        `keep_from_offset`. A gen's coverage ends where the next gen
        begins (its journal `meta`)."""
        removed = 0
        with self._lock:
            gens = self._gens()
            open_gen = self._gen if self._enc is not None else None
            for g, nxt in zip(gens, gens[1:]):
                if g == open_gen:
                    continue
                nj = load_stream_journal(self._gen_base_path(nxt))
                if nj is None or nj.meta > keep_from_offset:
                    break
                self._remove_gen(g)
                removed += 1
        return removed

    def _remove_gen(self, gen: int) -> None:
        base = self._gen_base_path(gen)
        for i in range(self.ctx.total):
            _unlink_quiet(base + self.ctx.to_ext(i))
        _unlink_quiet(base + ".stream")
        _unlink_quiet(base + ".ecsum")

    # ---------------------------------------------------------- recovery

    def recover(self) -> list[tuple[int, int, bytes, bytes]]:
        """Replay every recoverable record from the on-disk generations,
        in offset order, verifying and repairing parity as it goes.
        Leaves the partition on a fresh generation; old generations stay
        until pruned."""
        records: list[tuple[int, int, bytes, bytes]] = []
        backend = self._backend_resolved()
        with self._lock:
            for g in self._gens():
                base = self._gen_base_path(g)
                j = load_stream_journal(base)
                if j is None:
                    continue
                rec = recover_stream(
                    base, self.ctx, backend, frame_scan=dense_frame_scan(j.meta)
                )
                if rec is None:
                    continue
                records.extend(decode_dense(rec.data, j.meta))
            self._gen = self._max_gen() + 1
        records.sort(key=lambda r: r[0])
        # global density across gens: a hole ends the replay
        dense: list[tuple[int, int, bytes, bytes]] = []
        for r in records:
            if dense and r[0] > dense[-1][0] + 1:
                break
            if dense and r[0] <= dense[-1][0]:
                continue
            dense.append(r)
        return dense

    # ------------------------------------------------------------- close

    def close(self) -> None:
        with self._lock:
            if self.closed:
                return
            self.closed = True
            if self._enc is not None:
                self._enc.close(finalize=False)
                self._enc = None

    def delete(self) -> None:
        self.close()
        for g in self._gens():
            self._remove_gen(g)
        shutil.rmtree(self.dir, ignore_errors=True)


def _unlink_quiet(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        pass
