"""Rebuild missing EC shards from surviving ones.

Port of seaweedfs_tpu/ec/rebuild.py (reference ec_encoder.go
generateMissingEcFiles), with the three publish-seam fault points
(`ec.rebuild.before_fsync`, `ec.rebuild.before_rename`,
`ec.rebuild.after_rename`), the armed-registry byte path below, and the
`priority` and `scheduler` of the staged stream (a "recovery" client of
the per-chip scheduler, ec/device_queue.py, by default). The
correctness envelope it keeps:

- bitrot sidecar verify-and-exclude: present-but-corrupt shards are
  reclassified as missing and regenerated, never fed to Reed-Solomon;
- fail-closed rules: a malformed sidecar refuses; more than `parity`
  mismatches means the *sidecar* is suspect and refuses; fewer than k
  verified-good shards refuses;
- regenerated shards are verified against the sidecar before publish;
- temp file + fsync + atomic rename (+ dir fsync) publication.

The k source shards are read into one (k, width) matrix per batch, their
sidecar CRCs rolled inline while the bytes are hot, and one precomputed
decode-coefficient apply per batch runs through `run_staged_apply`, so
batch N computes on the device while N+1 uploads and N-1 drains to disk.
Non-source present shards get a dedicated parallel verify.

The byte path is the native plane (ec/native_io.py): one batched native
read per batch lands the k sources in a pooled matrix (page-locked on
cuda) and rolls their CRCs on the C++ side, and the fused native sink
writes the rebuilt shards. With SEAWEED_EC_NATIVE=0, k preadv loops,
Python CRC rollers and `PyShardSink` give the same bytes.

An armed fault registry takes the JAX package's chaos byte path: every
present shard is verified up front, each source read goes through the
`ec.rebuild.read_shard` mutate point and each rebuilt row through
`ec.rebuild.shard_bytes`, one `backend.reconstruct` per batch, into
`PyShardSink`. A mutated read is caught by the output verification
against the sidecar, which raises and publishes nothing.

Flight recorder (utils/trace.py): the root span `ec.rebuild` (a child
under a decode) with stages `verify`, the pipeline's `disk_read`,
`admission_wait`, `h2d_dispatch`, `device_drain`, `write_sink`, `queue_wait` (on the chaos
path `reconstruct` in place of the two device stages) and
`fsync_publish`.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .. import faults
from ..utils import trace
from ..utils.crc import crc32c
from ..utils.fs import fsync_dir
from . import native_io
from .backend import _BackendBase, _decode_coeffs, get_backend
from .bitrot import BitrotError, BitrotProtection
from .context import BITROT_BLOCK_SIZE, DEFAULT_EC_CONTEXT, ECContext, ECError
from .encoder import DEFAULT_BATCH, WIDE_STREAM_BYTES
from .pipeline import make_shard_sink, run_pipeline, run_staged_apply
from .volume_info import VolumeInfo


class _SourceReadError(Exception):
    """A source shard failed mid-pipeline (unreadable/short read)."""

    def __init__(self, shards: list[int]):
        super().__init__(f"source shards {shards} unreadable")
        self.shards = shards


class _BlockCrcRoller:
    """Rolling per-block CRC32C over numpy rows (inline source check)."""

    def __init__(self, block_size: int):
        self.block_size = block_size
        self.crcs: list[int] = []
        self._crc = 0
        self._filled = 0

    def update(self, arr: np.ndarray) -> None:
        pos, n = 0, len(arr)
        while pos < n:
            take = min(self.block_size - self._filled, n - pos)
            self._crc = crc32c(arr[pos : pos + take], self._crc)
            self._filled += take
            pos += take
            if self._filled == self.block_size:
                self.crcs.append(self._crc)
                self._crc = 0
                self._filled = 0

    def finish(self) -> list[int]:
        if self._filled:
            self.crcs.append(self._crc)
            self._crc = 0
            self._filled = 0
        return self.crcs


class _ReadCrcs:
    """The same rolling per-block CRC32C over the k sources, advanced by
    the native batched read itself (its `granule` arguments) while the
    bytes are hot."""

    def __init__(self, k: int, block_size: int, batch_size: int):
        self.block_size = block_size
        self.state = np.zeros(k, np.uint32)
        self.filled = np.zeros(k, np.uint64)
        self.out = np.empty((k, batch_size // block_size + 2), np.uint32)
        self.counts = np.empty(k, np.int32)
        self.crcs: list[list[int]] = [[] for _ in range(k)]

    def read_args(self) -> dict:
        return dict(
            granule=self.block_size, crc_state=self.state, filled_state=self.filled,
            out_crcs=self.out, out_counts=self.counts,
        )

    def collect(self) -> None:
        for row, crcs in enumerate(self.crcs):
            crcs.extend(int(x) for x in self.out[row, : int(self.counts[row])])

    def finish(self) -> list[list[int]]:
        for row, crcs in enumerate(self.crcs):
            if self.filled[row]:  # the partial tail block
                crcs.append(int(self.state[row]))
        return self.crcs


def _pread_exact(fd: int, buf: np.ndarray, offset: int) -> None:
    """Fill `buf` from fd at `offset` in place; a short read raises."""
    mv = memoryview(buf)
    filled = 0
    want = len(buf)
    while filled < want:
        got = os.preadv(fd, [mv[filled:]], offset + filled)
        if got == 0:
            raise OSError(f"short shard read at offset {offset + filled}")
        filled += got


def rebuild_ec_files(
    base: str,
    ctx: ECContext | None = None,
    backend: _BackendBase | None = None,
    unsafe_ignore_sidecar: bool = False,
    batch_size: int = DEFAULT_BATCH,
    only_shards: list[int] | None = None,
    priority: str = "recovery",
    scheduler=None,
) -> list[int]:
    """Regenerate missing/corrupt shard files; returns regenerated ids.

    `only_shards` restricts which ABSENT shards are regenerated (a
    subset-holding server must not mint local copies of shards placed on
    peers); present-but-corrupt shards are always replaced.

    `priority` tags the staged stream's class on the shared per-chip
    scheduler (ec/device_queue.py): "recovery" by default (rebuild and
    decode self-heal restore redundancy behind serving traffic); a
    scrub passes "scrub". `scheduler` is the QueueScope the stream runs
    under (None = the process-wide default scope).
    """
    # Sidecar first: it records the shard ratio too, which backs up the
    # .vif for config resolution and cross-checks it.
    prot: BitrotProtection | None = None
    ecsum = base + ".ecsum"
    if os.path.exists(ecsum):
        try:
            prot = BitrotProtection.load(ecsum)
        except BitrotError as e:
            if not unsafe_ignore_sidecar:
                raise ECError(
                    f"bitrot sidecar for {base} is malformed ({e}); refusing "
                    f"to rebuild (pass unsafe_ignore_sidecar to override)"
                ) from e
            prot = None

    if ctx is None:
        vif_path = base + ".vif"
        if os.path.exists(vif_path):
            # .vif present but unreadable fails closed: silently falling
            # back to 10+4 would rebuild a custom-ratio volume with the
            # wrong layout.
            ctx = VolumeInfo.load(vif_path).ec_ctx
        if ctx is None and prot is not None:
            ctx = prot.ctx
        if ctx is None:
            ctx = DEFAULT_EC_CONTEXT
    if prot is not None and prot.ctx != ctx:
        if not unsafe_ignore_sidecar:
            raise ECError(
                f"bitrot sidecar for {base} records ratio {prot.ctx} but the "
                f"volume config says {ctx}; refusing to rebuild"
            )
        prot = None

    total = ctx.total
    present = [i for i in range(total) if os.path.exists(base + ctx.to_ext(i))]
    missing = [i for i in range(total) if i not in present]
    if only_shards is not None:
        missing = [i for i in missing if i in only_shards]

    # root span of the rebuild (a child when a decode span is active)
    sp = trace.start(
        "ec.rebuild", name=os.path.basename(base), base=base,
        present=len(present), missing=sorted(missing), priority=priority,
    )
    try:
        return _rebuild_ec_files_traced(
            base, ctx, backend, unsafe_ignore_sidecar, batch_size,
            prot, present, missing, priority, scheduler, sp,
        )
    finally:
        trace.finish(sp)


def _rebuild_ec_files_traced(
    base, ctx, backend, unsafe_ignore_sidecar, batch_size,
    prot, present, missing, priority, scheduler, sp,
) -> list[int]:
    k = ctx.data_shards
    # An armed fault registry takes the chaos byte path: mutating faults
    # need materialized bytes at the read and write seams, and the chaos
    # contract (every present shard verified up front, fail closed on
    # read corruption mid-rebuild) is held against that shape.
    chaos = faults.active()
    checked = prot is not None and not unsafe_ignore_sidecar and not chaos

    present0 = len(present)
    all_corrupt: list[int] = []
    verified_ok: set[int] = set()

    def _verify_full(ids: list[int]) -> list[int]:
        """Whole-shard sidecar verification, in parallel across shards."""
        if prot is None or not ids:
            return []

        def check(i: int) -> bool:
            try:
                return bool(
                    prot.verify_shard_file(base + ctx.to_ext(i), i, stop_early=True)
                )
            except OSError:
                return True  # unreadable = untrustworthy RS input

        with trace.stage(sp, "verify"):
            with ThreadPoolExecutor(max_workers=min(len(ids), 8)) as ex:
                flags = list(ex.map(check, ids))
        bad = [i for i, f in zip(ids, flags) if f]
        verified_ok.update(i for i in ids if i not in bad)
        return bad

    def _reclassify(new_bad: list[int]) -> None:
        """Corrupt bookkeeping and the fail-closed guards."""
        for i in new_bad:
            if i not in all_corrupt:
                all_corrupt.append(i)
        if unsafe_ignore_sidecar:
            return  # tolerate corrupt inputs, as the flag promises
        if len(all_corrupt) > ctx.parity_shards:
            raise ECError(
                f"bitrot sidecar suspect for {base}: {len(all_corrupt)}/"
                f"{present0} present shards mismatch (> parity "
                f"{ctx.parity_shards}); refusing to rebuild"
            )
        if present0 - len(all_corrupt) < k:
            raise ECError(
                f"bitrot: only {present0 - len(all_corrupt)} verified-good "
                f"shards for {base}, need {k} data shards"
            )
        for i in new_bad:
            if i in present:
                present.remove(i)
                missing.append(i)

    if prot is not None and chaos:
        # verify-and-exclude every present shard before any
        # reconstruction input is chosen
        _reclassify(_verify_full(list(present)))

    while True:
        if len(present) < k:
            raise ECError(
                f"not enough shards to rebuild {base}: found {len(present)}, "
                f"need {k}, missing {sorted(missing)}"
            )
        if not missing:
            # Nothing absent, but a present shard may still be rotten on
            # disk: every still-unverified shard gets the dedicated verify.
            if checked:
                bad = _verify_full([i for i in present if i not in verified_ok])
                if bad:
                    _reclassify(bad)
                    continue
            return []

        sizes = {i: os.path.getsize(base + ctx.to_ext(i)) for i in present}
        if checked:
            # size-vs-sidecar is the cheap half of verification
            size_bad = [i for i in present if sizes[i] != prot.shard_sizes[i]]
            if size_bad:
                _reclassify(size_bad)
                continue
        shard_size = max(sizes.values())
        if any(s != shard_size for s in sizes.values()):
            raise ECError(f"present shards have unequal sizes: {sizes}")

        src = sorted(present)[:k]
        if checked:
            # Sources are verified inline by the read stage; the rest here.
            bad = _verify_full(
                [i for i in present if i not in src and i not in verified_ok]
            )
            if bad:
                _reclassify(bad)
                continue

        targets = sorted(missing)
        if backend is None:
            backend = get_backend("cuda", ctx.data_shards, ctx.parity_shards)
        bad_src = _attempt_rebuild(
            base, ctx, backend, prot, src, targets, shard_size, batch_size,
            chaos, inline_verify=checked, verified_ok=verified_ok,
            priority=priority, scheduler=scheduler, span=sp,
        )
        if bad_src:
            # Confirmed on-disk rot in a source: exclude it and retry.
            _reclassify(bad_src)
            continue
        return targets


def _attempt_rebuild(
    base: str,
    ctx: ECContext,
    backend: _BackendBase,
    prot: BitrotProtection | None,
    src: list[int],
    targets: list[int],
    shard_size: int,
    batch_size: int,
    chaos: bool,
    inline_verify: bool,
    verified_ok: set[int],
    priority: str = "recovery",
    scheduler=None,
    span=None,
) -> list[int]:
    """One pipelined reconstruction attempt. Publishes and returns [] on
    success; returns confirmed-corrupt source ids for the caller to
    exclude and retry; raises fail-closed otherwise."""
    k = ctx.data_shards
    fds = {i: os.open(base + ctx.to_ext(i), os.O_RDONLY) for i in src}
    tmp_paths = {i: base + ctx.to_ext(i) + ".rebuilding" for i in targets}
    outs = {i: open(p, "wb", buffering=0) for i, p in tmp_paths.items()}
    crc_block = prot.block_size if prot is not None else BITROT_BLOCK_SIZE
    sink = make_shard_sink(list(outs.values()), block_size=crc_block)
    coeffs = _decode_coeffs(backend.matrix, tuple(targets), tuple(src))
    pool = None
    if native_io.enabled() and not chaos:
        pool = native_io.BufferPool(k, device=getattr(backend, "device", None))
    rollers = read_crcs = None
    if inline_verify and pool is None:
        rollers = {i: _BlockCrcRoller(crc_block) for i in src}
    elif inline_verify:
        read_crcs = _ReadCrcs(k, crc_block, batch_size)

    def read_native(off: int, width: int) -> np.ndarray:
        src_fds = [fds[i] for i in src]
        nxt = off + width
        if nxt < shard_size:
            for fd in src_fds:
                native_io.prefetch(fd, nxt, min(batch_size, shard_size - nxt))
        buf = pool.get(width)
        try:
            native_io.read_batch(
                src_fds, [off] * k, buf, pad_eof=False,
                **(read_crcs.read_args() if read_crcs is not None else {}),
            )
        except OSError as e:
            if not hasattr(e, "sn_row"):
                raise
            raise _SourceReadError([src[e.sn_row]]) from e
        if read_crcs is not None:
            read_crcs.collect()
        return buf

    def produce():
        for off in range(0, shard_size, batch_size):
            width = min(batch_size, shard_size - off)
            if pool is not None:
                buf = read_native(off, width)
            else:
                buf = np.empty((k, width), dtype=np.uint8)
                for row, i in enumerate(src):
                    try:
                        _pread_exact(fds[i], buf[row], off)
                    except OSError as e:
                        raise _SourceReadError([i]) from e
                    if rollers is not None:
                        rollers[i].update(buf[row])
            yield buf, buf

    def consume(buf, out):
        sink.append_rows([out[p] for p in range(len(targets))])
        if pool is not None:
            pool.put(buf)  # written, and its H2D copy long done

    def chaos_produce():
        for off in range(0, shard_size, batch_size):
            width = min(batch_size, shard_size - off)
            block = {
                i: np.frombuffer(
                    faults.mutate(
                        "ec.rebuild.read_shard", os.pread(fds[i], width, off),
                        base=base, shard=i, offset=off,
                    ),
                    dtype=np.uint8,
                )
                for i in src
            }
            if any(len(b) != width for b in block.values()):
                raise ECError(f"short shard read at offset {off}")
            yield off, block

    def chaos_reconstruct(item):
        off, block = item
        return off, backend.reconstruct(block, want=targets)

    def chaos_consume(item):
        off, rec = item
        sink.append_rows([
            faults.mutate(
                "ec.rebuild.shard_bytes",
                np.ascontiguousarray(rec[i], dtype=np.uint8).tobytes(),
                base=base, shard=i, offset=off,
            )
            for i in targets
        ])

    def _cleanup_temps() -> None:
        for f in outs.values():
            f.close()
        for p in tmp_paths.values():
            if os.path.exists(p):
                os.unlink(p)

    def _confirm_from_disk(suspects: list[int]) -> list[int]:
        """Re-verify suspect sources from disk: confirmed rot is
        excludable; a clean disk copy means the pipeline's read was
        transiently corrupted and publishing anything would launder it."""
        confirmed, transient = [], []
        with trace.stage(span, "verify"):
            for i in suspects:
                try:
                    still_bad = bool(
                        prot.verify_shard_file(base + ctx.to_ext(i), i, stop_early=True)
                    )
                except OSError:
                    still_bad = True
                (confirmed if still_bad else transient).append(i)
        if transient:
            raise ECError(
                f"source shards {transient} for {base} failed read-time "
                f"sidecar verification but verify clean on disk (transient "
                f"read corruption); refusing to publish"
            )
        return confirmed

    join_timeout = 60.0 + 4.0 * batch_size / (16 << 20)
    try:
        if chaos:
            run_pipeline(
                chaos_produce, chaos_reconstruct, chaos_consume,
                join_timeout=join_timeout, describe="ec rebuild pipeline",
                span=span, stage_names=("disk_read", "reconstruct", "write_sink"),
            )
        else:
            run_staged_apply(
                backend, coeffs, produce, consume,
                join_timeout=join_timeout, describe="ec rebuild pipeline",
                priority=priority, scheduler=scheduler, span=span,
                # total stream cost for least-loaded routing: every
                # target row spans the whole shard extent
                cost_hint=len(targets) * shard_size,
                # a lone huge rebuild on an idle pod keeps a mesh, as a
                # wide encode does
                wide=k * shard_size >= WIDE_STREAM_BYTES,
            )
    except _SourceReadError as e:
        _cleanup_temps()
        if inline_verify:
            return e.shards  # unreadable = untrustworthy; exclude + retry
        # No exclusion machinery active: the same attempt would spin
        # forever, so propagate.
        raise ECError(str(e)) from e
    except BaseException:
        _cleanup_temps()
        raise
    finally:
        for fd in fds.values():
            os.close(fd)

    # --- inline source verification verdict --------------------------------
    if rollers is not None or read_crcs is not None:
        if read_crcs is not None:
            got = dict(zip(src, read_crcs.finish()))
        else:
            got = {i: rollers[i].finish() for i in src}
        suspects = [i for i in src if got[i] != prot.shard_crcs[i]]
        # the inline roller IS the block-CRC check _verify_full performs:
        # a retry after an exclusion must not re-read clean sources
        verified_ok.update(i for i in src if i not in suspects)
        if suspects:
            _cleanup_temps()
            return _confirm_from_disk(suspects)

    try:
        # crash window: temp .rebuilding files written, not yet durable
        faults.fire("ec.rebuild.before_fsync", base=base)
        with trace.stage(span, "fsync_publish"):
            for f in outs.values():
                f.flush()
                os.fsync(f.fileno())
    except BaseException:
        _cleanup_temps()
        raise
    for f in outs.values():
        f.close()

    # --- verify regenerated shards against the sidecar (fail closed) --------
    if prot is not None:
        out_sizes = sink.sizes
        out_crcs = sink.block_crcs()
        for pos, i in enumerate(targets):
            if (
                out_sizes[pos] != prot.shard_sizes[i]
                or out_crcs[pos] != prot.shard_crcs[i]
            ):
                for p in tmp_paths.values():
                    if os.path.exists(p):
                        os.unlink(p)
                raise ECError(
                    f"regenerated shard {i} for {base} fails sidecar "
                    f"verification; refusing to publish"
                )

    # crash window: temps durable + sidecar-verified, renames pending; a
    # crash here (or between renames) leaves a mix of published shards
    # and .rebuilding temps, and a restarted rebuild regenerates the rest
    faults.fire("ec.rebuild.before_rename", base=base)
    with trace.stage(span, "fsync_publish"):
        for i in targets:
            os.replace(tmp_paths[i], base + ctx.to_ext(i))
            faults.fire("ec.rebuild.after_rename", base=base, shard=i)
        fsync_dir(base + ".dat")
    return []
