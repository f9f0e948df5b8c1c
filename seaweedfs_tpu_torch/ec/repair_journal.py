"""Crash-consistent in-place leaf repair: the write-ahead repair journal.

Port of seaweedfs_tpu/ec/repair_journal.py. The `.repair` file is the
JAX package's format byte for byte, so a journal left by a repair that
either package crashed is replayed or rolled back by the other, to the
same bytes. The fault points keep the JAX package's names and fire in
the port's own registry (seaweedfs_tpu_torch.faults).

A v2 (leaf-CRC) sidecar pins rot to a 64 KiB leaf; this module patches
just the rotten leaves of a shard file IN PLACE, with a write-ahead
journal making the patch atomic across power loss.

Protocol (one journal file `<shard>.repair` next to the shard):

  1. INTENT   — write the journal: shard id, sidecar generation + uuid
                fence, leaf ranges, the full NEW leaf bytes and their
                CRCs, all self-checksummed; fsync file + directory.
  2. PATCH    — pwrite the new leaf bytes into the shard file at their
                leaf offsets; fsync the shard.
  3. FLIP     — if the new leaf CRCs differ from the sidecar's current
                row, publish the updated sidecar (atomic_write; block
                CRCs re-folded from the leaf row via crc32c_combine).
  4. RETIRE   — unlink the journal; fsync the directory.

Crash windows and why recovery converges (one fault point each):

  window                      | on-disk evidence      | recovery
  ----------------------------+-----------------------+-----------------
  torn journal write (1)      | journal fails its own | ROLL BACK: delete
                              | checksum              | journal; patch
                              |                       | never started, the
                              |                       | shard is fully-OLD
  crash after intent (1->2)   | valid journal, shard  | REPLAY: re-patch
                              | untouched             | all leaves -> NEW
  torn patch (2)              | valid journal, shard  | REPLAY: pwrite is
                              | partially patched     | idempotent -> NEW
  crash patch->flip (2->3)    | valid journal, shard  | REPLAY + FLIP
                              | fully patched, stale  | -> NEW
                              | sidecar               |
  crash flip->retire (3->4)   | valid journal, shard  | REPLAY (no-op
                              | + sidecar both new    | bytes) + RETIRE
                              |                       | -> NEW

The shard is therefore ALWAYS either fully-old-verified or fully-new-
verified against its sidecar, never a mix: a valid journal always
carries every byte needed to roll the whole patch set forward, and a
torn journal proves the patch never began (step 2 starts only after the
journal is durable).

`reconstruct_leaves` is the companion math: rebuild only the rotten
leaves' byte ranges from k range-verified sibling sources (the caller
supplies `read_range`) through the backend (on the card, one
`gf2_apply` launch per contiguous leaf range), verify the output
against the target's own leaf CRCs, and hand back patches ready for
`apply_leaf_repair`. Repair cost is ~k·64 KiB per rotten leaf instead of
~k·shard.

`stages`, where a function takes it, is a dict that gains wall seconds
under the JAX package's stage names: "crc_verify" (sibling and output
CRC checks), "reconstruct" (the backend call) and "repair_patch" (the
journal protocol), which `apply_leaf_repair` also splits into
"repair_patch.fsync" (its fsyncs) and "repair_patch.work" (the rest).
Those two keys are the stages dict's only: the span tree keeps the JAX
package's stages. `span` is the flight recorder's span of the repair
(utils/trace.py), which gets "crc_verify" and "repair_patch" as in the
JAX module; recovery and the sweep count their actions in
`sw_ec_repair_journal_total{action}` (utils/metrics.py).
"""

from __future__ import annotations

import logging
import os
import struct
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

import numpy as np

from .. import faults
from ..utils import metrics as M
from ..utils import trace
from ..utils.crc import crc32c
from ..utils.fs import fsync, fsync_dir, fsync_seconds
from .bitrot import BitrotError, BitrotProtection, fold_leaf_crcs
from .context import ECContext, ECError

log = logging.getLogger(__name__)

JOURNAL_SUFFIX = ".repair"

MAGIC = 0x5357524A  # "SWRJ" — same self-checksummed header idiom as .ecsum
FORMAT_VERSION = 1
_HEADER = struct.Struct(">I")
_HEADER_REST = struct.Struct("<HII")


class JournalError(ECError):
    """The journal file is torn/malformed (fails its own checksum)."""


@contextmanager
def _stage(stages: dict | None, name: str, span=None):
    """Add the block's wall seconds to stages[name] and to the span's
    stage (no-op for None)."""
    if stages is None and span is None:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if stages is not None:
            stages[name] = stages.get(name, 0.0) + dt
        trace.add_stage(span, name, dt)


@dataclass(frozen=True)
class LeafPatch:
    """One leaf's replacement bytes. `offset` is the byte position in
    the shard file (leaf * leaf_size); `crc` is crc32c(data) — the CRC
    the sidecar's leaf row must carry once the patch is published."""

    leaf: int
    offset: int
    data: bytes
    crc: int


@dataclass
class RepairJournal:
    """Decoded `<shard>.repair` contents: the full intent record."""

    shard_id: int
    generation: int  # sidecar generation fence at intent time
    uuid: bytes  # sidecar uuid fence at intent time
    leaf_size: int
    shard_size: int  # sanity fence: in-place patches never resize
    patches: list[LeafPatch] = field(default_factory=list)

    def to_bytes(self) -> bytes:
        parts = [
            struct.pack(
                "<IQIQI",
                self.shard_id,
                self.generation,
                self.leaf_size,
                self.shard_size,
                len(self.patches),
            ),
            self.uuid,
        ]
        for p in self.patches:
            parts.append(struct.pack("<IQII", p.leaf, p.offset, len(p.data), p.crc))
        for p in self.patches:
            parts.append(p.data)
        payload = b"".join(parts)
        return (
            _HEADER.pack(MAGIC)
            + _HEADER_REST.pack(FORMAT_VERSION, len(payload), crc32c(payload))
            + payload
        )

    @classmethod
    def from_bytes(cls, raw: bytes) -> "RepairJournal":
        hs = _HEADER.size + _HEADER_REST.size
        if len(raw) < hs:
            raise JournalError("repair journal too short")
        (magic,) = _HEADER.unpack(raw[: _HEADER.size])
        version, plen, pcrc = _HEADER_REST.unpack(raw[_HEADER.size : hs])
        if magic != MAGIC:
            raise JournalError(f"bad repair-journal magic {magic:08x}")
        if version != FORMAT_VERSION:
            raise JournalError(f"unsupported repair-journal version {version}")
        payload = raw[hs : hs + plen]
        if len(payload) != plen or crc32c(payload) != pcrc:
            # the torn-write verdict: a crash mid-journal-write leaves a
            # short or corrupt payload, which proves the patch phase
            # never began (it only starts after the journal fsync)
            raise JournalError("repair journal torn (payload checksum mismatch)")
        try:
            sid, gen, lsize, ssize, count = struct.unpack("<IQIQI", payload[:28])
            uid = payload[28:44]
            pos = 44
            metas = []
            for _ in range(count):
                leaf, off, dlen, crc = struct.unpack("<IQII", payload[pos : pos + 20])
                pos += 20
                metas.append((leaf, off, dlen, crc))
            patches = []
            for leaf, off, dlen, crc in metas:
                data = payload[pos : pos + dlen]
                if len(data) != dlen:
                    raise JournalError("repair journal truncated patch data")
                pos += dlen
                patches.append(LeafPatch(leaf, off, data, crc))
            if pos != plen:
                raise JournalError("trailing bytes in repair journal")
        except struct.error as e:
            raise JournalError(f"malformed repair journal: {e}") from None
        return cls(sid, gen, uid, lsize, ssize, patches)

    @classmethod
    def load(cls, path: str) -> "RepairJournal":
        try:
            with open(path, "rb") as f:
                return cls.from_bytes(f.read())
        except OSError as e:
            raise JournalError(f"unreadable repair journal {path}: {e}") from e


def journal_path(shard_path: str) -> str:
    return shard_path + JOURNAL_SUFFIX


def volume_journals(base: str, ctx: ECContext) -> list[tuple[int, str]]:
    """(shard_id, journal_path) for every `<shard>.repair` on disk."""
    out = []
    for sid in range(ctx.total):
        jp = journal_path(base + ctx.to_ext(sid))
        if os.path.exists(jp):
            out.append((sid, jp))
    return out


# ----------------------------------------------------------- publication


def _write_journal(jpath: str, journal: RepairJournal) -> None:
    data = journal.to_bytes()
    # torn-journal chaos: a mutate tears/corrupts the journal bytes the
    # way a power cut mid-write would; recovery must classify the file
    # torn and roll back
    data = faults.mutate("ec.repair.journal_bytes", data, path=jpath)
    with open(jpath, "wb") as f:
        f.write(data)
        # crash window: journal bytes written, not yet durable
        faults.fire("ec.repair.journal_write", path=jpath)
        f.flush()
        fsync(f.fileno())
    fsync_dir(jpath)


def _patch_shard(shard_path: str, patches: list[LeafPatch]) -> None:
    fd = os.open(shard_path, os.O_WRONLY)
    try:
        for p in patches:
            data = faults.mutate(
                "ec.repair.patch_bytes", p.data, path=shard_path, leaf=p.leaf
            )
            os.pwrite(fd, data, p.offset)
        # crash window: leaf bytes (possibly torn) written, not yet
        # durable — recovery replays the journal over them
        faults.fire("ec.repair.patch_write", path=shard_path)
        fsync(fd)
    finally:
        os.close(fd)


def _flip_sidecar(
    prot: BitrotProtection, ecsum_path: str, shard_id: int, patches: list[LeafPatch]
) -> bool:
    """Publish the sidecar with the patched leaves' CRCs (and block CRCs
    re-folded from the leaf row). Returns False when every patch CRC
    already matches — the repair-to-match-sidecar case."""
    row = prot.shard_leaf_crcs[shard_id]
    if all(p.leaf < len(row) and row[p.leaf] == p.crc for p in patches):
        return False
    for p in patches:
        row[p.leaf] = p.crc
    prot.shard_crcs[shard_id] = fold_leaf_crcs(
        row, prot.shard_sizes[shard_id], prot.leaf_size, prot.block_size
    )
    prot.save(ecsum_path)  # atomic_write: temp + fsync + rename
    return True


def apply_leaf_repair(
    shard_path: str,
    shard_id: int,
    prot: BitrotProtection,
    patches: list[LeafPatch],
    *,
    ecsum_path: str | None = None,
    stages: dict | None = None,
    span=None,
) -> None:
    """Run the full journal protocol for one shard's leaf patch set:
    intent -> in-place patch -> sidecar flip (when the CRCs change) ->
    retire. A crash at ANY point leaves the shard recoverable to a
    fully-verified state by `recover_volume_journals` (see the window
    table in the module docstring)."""
    if not patches:
        return
    if not prot.has_leaves:
        raise ECError(f"leaf repair of {shard_path} needs a v2 (leaf-CRC) sidecar")
    if ecsum_path is None:
        # <base>.ec00 -> <base>.ecsum (shard extensions are .ecNN)
        ecsum_path = shard_path[: shard_path.rfind(".ec")] + ".ecsum"
    jpath = journal_path(shard_path)
    journal = RepairJournal(
        shard_id=shard_id,
        generation=prot.generation,
        uuid=prot.uuid,
        leaf_size=prot.leaf_size,
        shard_size=prot.shard_sizes[shard_id],
        patches=list(patches),
    )
    t0 = time.perf_counter()
    with _stage(stages, "repair_patch", span), fsync_seconds() as fsynced:
        _write_journal(jpath, journal)
        # crash window: intent durable, shard untouched
        faults.fire("ec.repair.after_journal", path=shard_path, shard=shard_id)
        _patch_shard(shard_path, patches)
        # crash window: shard patched + durable, sidecar flip pending
        faults.fire("ec.repair.after_patch", path=shard_path, shard=shard_id)
        _flip_sidecar(prot, ecsum_path, shard_id, patches)
        # crash window: sidecar published, journal retire pending
        faults.fire("ec.repair.after_sidecar", path=shard_path, shard=shard_id)
        os.unlink(jpath)
        fsync_dir(jpath)
    if stages is not None:
        # repair_patch split: its fsyncs (journal, shard, sidecar, the
        # directory after each publish) apart from the journal's own work
        work = time.perf_counter() - t0 - fsynced[0]
        stages["repair_patch.fsync"] = stages.get("repair_patch.fsync", 0.0) + fsynced[0]
        stages["repair_patch.work"] = stages.get("repair_patch.work", 0.0) + work


# --------------------------------------------------------------- recovery


def _journal_live(
    journal: RepairJournal, sid: int, shard_path: str, prot: BitrotProtection | None
) -> bool:
    """The journal's fences match the mounted sidecar and its shard."""
    return (
        prot is not None
        and journal.shard_id == sid
        and journal.generation == prot.generation
        and journal.uuid == prot.uuid
        and os.path.exists(shard_path)
        and os.path.getsize(shard_path) == journal.shard_size
    )


def _load_sidecar(base: str) -> BitrotProtection | None:
    try:
        return BitrotProtection.load(base + ".ecsum")
    except (OSError, BitrotError):
        return None


def recover_volume_journals(
    base: str, ctx: ECContext, prot: BitrotProtection | None = None
) -> dict:
    """Mount/scrub-time recovery: replay or roll back every pending
    `<shard>.repair` of this volume so serving never starts over a
    half-applied patch.

    - torn journal (fails its own checksum): the patch never began —
      ROLL BACK by deleting the journal; the shard is fully-old.
    - valid journal matching the current sidecar's generation + uuid:
      REPLAY the whole patch set (idempotent pwrites), re-publish the
      sidecar if its leaf row still differs, retire the journal; the
      shard is fully-new.
    - valid journal that does NOT match the mounted sidecar (volume
      re-encoded since) or whose shard file is gone/resized: the intent
      is STALE/ORPHANED — kept on disk for forensics until scrub's TTL
      sweep (`sweep_stale_journals`) retires it.

    Returns {"replayed": {sid: [leaf, ...]}, "rolled_back": [path],
    "kept": [path]}.
    """
    out: dict = {"replayed": {}, "rolled_back": [], "kept": []}
    pending = volume_journals(base, ctx)
    if not pending:
        return out
    if prot is None:
        prot = _load_sidecar(base)
    for sid, jpath in pending:
        try:
            journal = RepairJournal.load(jpath)
        except JournalError as e:
            # torn intent: the protocol guarantees the shard was never
            # touched — deleting the journal IS the rollback
            log.warning("rolling back torn repair journal %s: %s", jpath, e)
            try:
                os.unlink(jpath)
                fsync_dir(jpath)
            except OSError:
                continue
            out["rolled_back"].append(jpath)
            M.ec_repair_journal_total.inc(action="rolled_back")
            continue
        shard_path = base + ctx.to_ext(sid)
        if not _journal_live(journal, sid, shard_path, prot):
            log.warning(
                "keeping stale/orphaned repair journal %s (sidecar or "
                "shard no longer matches the recorded intent)", jpath,
            )
            out["kept"].append(jpath)
            M.ec_repair_journal_total.inc(action="kept")
            continue
        try:
            _patch_shard(shard_path, journal.patches)
            if prot.has_leaves:
                _flip_sidecar(prot, base + ".ecsum", sid, journal.patches)
            os.unlink(jpath)
            fsync_dir(jpath)
        except OSError as e:
            log.error("repair-journal replay of %s failed: %s", jpath, e)
            out["kept"].append(jpath)
            M.ec_repair_journal_total.inc(action="kept")
            continue
        out["replayed"][sid] = sorted(p.leaf for p in journal.patches)
        M.ec_repair_journal_total.inc(action="replayed")
        log.warning("replayed repair journal %s (leaves %s)", jpath, out["replayed"][sid])
    return out


def sweep_stale_journals(
    base: str, ctx: ECContext, ttl_s: float, now: float | None = None
) -> list[str]:
    """Retire stale/orphaned `<shard>.repair` files older than `ttl_s`
    (recovery keeps them for forensics — see recover_volume_journals).
    Valid journals that still match the sidecar are NEVER swept: they
    are pending recovery work, not litter."""
    swept: list[str] = []
    pending = volume_journals(base, ctx)
    if not pending:
        return swept
    prot = _load_sidecar(base)
    if now is None:
        now = time.time()
    for sid, jpath in pending:
        try:
            if now - os.path.getmtime(jpath) < ttl_s:
                continue
        except OSError:
            continue
        try:
            live = _journal_live(
                RepairJournal.load(jpath), sid, base + ctx.to_ext(sid), prot
            )
        except JournalError:
            live = False  # torn: recovery will roll it back, but a torn
            # journal older than the TTL is also sweepable litter
        if live:
            continue
        try:
            os.unlink(jpath)
        except OSError:
            continue
        fsync_dir(jpath)
        swept.append(jpath)
        M.ec_repair_journal_total.inc(action="swept")
        log.info("swept stale repair journal %s", jpath)
    return swept


# ------------------------------------------------- leaf reconstruction


def leaf_verdict(
    path: str, shard_id: int, prot: BitrotProtection, on_block=None
) -> list[int] | None:
    """Leaf-granular verdict for one shard file: the list of leaf
    indices whose bytes mismatch the sidecar ([] = clean). None means
    the shard is NOT leaf-repairable — no leaf row in the sidecar, the
    file is missing/unreadable, or its size mismatches (truncation is
    not a patchable defect: the leaf offsets themselves are suspect)."""
    if not prot.has_leaves or shard_id >= len(prot.shard_leaf_crcs):
        return None
    lsize = prot.leaf_size
    crcs = prot.shard_leaf_crcs[shard_id]
    try:
        if os.path.getsize(path) != prot.shard_sizes[shard_id]:
            return None
        bad: list[int] = []
        with open(path, "rb") as f:
            for li, want in enumerate(crcs):
                chunk = f.read(lsize)
                if on_block is not None:
                    on_block(len(chunk))
                if crc32c(chunk) != want:
                    bad.append(li)
        return bad
    except OSError:
        return None


def patched_byte_ranges(
    prot: BitrotProtection, shard_id: int, leaves: list[int]
) -> list[tuple[int, int]]:
    """Byte ranges [(lo, hi), ...] covering the given leaves of one
    shard — the shape cache invalidation hooks consume."""
    return [
        (lo, hi)
        for lo, hi, _ in leaf_ranges(leaves, prot.leaf_size, prot.shard_sizes[shard_id])
    ]


def leaf_ranges(
    leaves: list[int], leaf_size: int, shard_size: int
) -> list[tuple[int, int, list[int]]]:
    """Group leaf indices into contiguous byte ranges: [(lo, hi,
    [leaf, ...]), ...] with hi clamped to the shard tail."""
    out: list[tuple[int, int, list[int]]] = []
    run: list[int] = []
    for li in sorted(set(leaves)):
        if run and li != run[-1] + 1:
            lo = run[0] * leaf_size
            out.append((lo, min(run[-1] * leaf_size + leaf_size, shard_size), run))
            run = []
        run.append(li)
    if run:
        lo = run[0] * leaf_size
        out.append((lo, min(run[-1] * leaf_size + leaf_size, shard_size), run))
    return out


def reconstruct_leaves(
    prot: BitrotProtection,
    ctx: ECContext,
    shard_id: int,
    leaves: list[int],
    read_range,
    candidates: list[int],
    backend=None,
    on_bytes=None,
    stages: dict | None = None,
    span=None,
) -> list[LeafPatch]:
    """Rebuild ONLY the rotten leaves of `shard_id` from k verified
    sibling sources and return them as journal-ready patches.

    `read_range(sid, lo, size) -> bytes | None` supplies sibling bytes
    (local pread or a ranged peer fetch); every returned range is
    verified here against the sibling's own granule CRCs before it is
    fed to Reed-Solomon — a rotten sibling is skipped, never trusted.
    `candidates` orders the sibling ids to try. Fail-closed: fewer than
    k verified sources for any range, or reconstructed bytes that fail
    the target's own leaf CRCs, raise ECError with nothing returned.

    `backend` defaults to the card (`get_backend("cuda", k, m)`), which
    raises where there is none. `on_bytes(n)` observes every sibling
    byte consumed (scrub's rate limiter).
    """
    if not prot.has_leaves:
        raise ECError("leaf reconstruction needs a v2 (leaf-CRC) sidecar")
    if backend is None:
        from .backend import get_backend

        backend = get_backend("cuda", ctx.data_shards, ctx.parity_shards)
    k = ctx.data_shards
    lsize = prot.leaf_size
    ssize = prot.shard_sizes[shard_id]
    target_crcs = prot.shard_leaf_crcs[shard_id]

    patches: list[LeafPatch] = []
    for lo, hi, range_leaves in leaf_ranges(leaves, lsize, ssize):
        size = hi - lo
        sources: dict[int, np.ndarray] = {}
        for sid in candidates:
            if len(sources) >= k:
                break
            if sid == shard_id:
                continue
            got = read_range(sid, lo, size)
            if got is None or len(got) != size:
                continue
            if on_bytes is not None:
                on_bytes(len(got))
            with _stage(stages, "crc_verify", span):
                if not prot.verify_range(sid, lo, got):
                    continue
            sources[sid] = np.frombuffer(got, dtype=np.uint8)
        if len(sources) < k:
            raise ECError(
                f"leaf repair of shard {shard_id} range [{lo}:{hi}): only "
                f"{len(sources)} verified sibling sources (need {k}); "
                f"refusing"
            )
        with _stage(stages, "reconstruct"):
            rec = backend.reconstruct(sources, want=[shard_id])
            out = np.asarray(rec[shard_id], dtype=np.uint8).tobytes()
        with _stage(stages, "crc_verify", span):
            for li in range_leaves:
                blk = out[li * lsize - lo : min((li + 1) * lsize, ssize) - lo]
                crc = crc32c(blk)
                if li >= len(target_crcs) or crc != target_crcs[li]:
                    raise ECError(
                        f"reconstructed leaf {li} of shard {shard_id} fails "
                        f".ecsum verification; refusing to patch"
                    )
                patches.append(LeafPatch(leaf=li, offset=li * lsize, data=blk, crc=crc))
    return patches
