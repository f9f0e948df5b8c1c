"""EC scrub: walk one EC volume, verify its shards against the .ecsum
sidecar, patch rotten leaves in place, quarantine what leaf repair
cannot fix and rebuild it — the self-healing pass the reference runs as
ec_volume scrubbing plus shell-driven ec.rebuild.

Port of seaweedfs_tpu/ec/scrub.py (`RateLimiter`, `ScrubCursor`,
`ScrubReport`, `_quarantine`, `scrub_ec_volume` with its `scheduler`,
and `ScrubDaemon`, which walks the EC volumes a `Store` has mounted
(storage/store.py), one breaker per volume, and unmounts and remounts
shards on the live `EcVolume`). Leaf reconstruction and the quarantine rebuild
run on the backend given, by default the card: on CUDA each contiguous
range of rotten leaves is one `gf2_apply` launch, and the rebuild runs
its batches through the same kernel. Each leaf repair is one
`ec.leaf_repair` root span of the flight recorder (utils/trace.py) and
one count of `sw_ec_leaf_repairs_total{outcome}` (utils/metrics.py:
repaired, refused or failed).

Design points:

- incremental + resumable: verification walks (shard, block) positions
  with a persisted cursor (<base>.scrubpos), so a restart resumes
  mid-volume instead of rescanning from zero; a budget (`max_blocks`)
  time-slices huge volumes. On a v2 sidecar the walk runs at 64 KiB LEAF
  granularity: pauses resume mid-block, and a mismatch is pinned to its
  leaf (recorded in the report and in a .bad.leaves forensic marker next
  to a quarantine). v1 sidecars keep the block walk.
- rate-limited: a token bucket caps read bandwidth so scrubbing never
  starves foreground traffic.
- repair at the finest granularity the evidence allows: rot pinned to
  specific leaves (v2 sidecar) with k verified-good local sources is
  reconstructed and patched IN PLACE under the write-ahead repair
  journal (ec/repair_journal.py); pending journals from a crashed repair
  are replayed/rolled back at pass start, and stale journal litter is
  TTL-swept at pass end.
- quarantine, never trust: a corrupt shard file that leaf repair cannot
  fix (size rot, v1 sidecar, too few sources) is renamed to <shard>.bad
  so it can NEVER be fed to Reed-Solomon.
- fail closed: a malformed sidecar or >parity mismatches stops the
  self-heal (the sidecar itself is suspect) and reports refusal instead
  of "repairing" with untrustworthy inputs.
- rebuild runs under the retry policy (utils/retry.py) and an optional
  circuit breaker shared across volumes.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from dataclasses import dataclass, field

from .. import faults
from ..utils import metrics as M
from ..utils import trace
from ..utils.crc import crc32c
from ..utils.fs import atomic_write, fsync_dir
from ..utils.retry import (
    CircuitBreaker,
    CircuitOpenError,
    RetryError,
    RetryPolicy,
    retry_call,
)
from .bitrot import BitrotError, BitrotProtection
from .context import QUARANTINE_SUFFIX, ECContext, ECError
from .rebuild import rebuild_ec_files
from .repair_journal import (
    apply_leaf_repair,
    leaf_verdict,
    patched_byte_ranges,
    reconstruct_leaves,
    recover_volume_journals,
    sweep_stale_journals,
)

log = logging.getLogger(__name__)

CURSOR_SUFFIX = ".scrubpos"

# Rebuilds are retried gently for TRANSIENT failures only (OSError: I/O
# flakes). ECError is deterministic (not-enough-shards, sidecar refusal)
# — retrying it just burns disk and poisons the breaker.
DEFAULT_REBUILD_POLICY = RetryPolicy(
    max_attempts=3, base_delay=0.2, max_delay=2.0, retry_on=(OSError,)
)


class RateLimiter:
    """Token-bucket byte limiter (injectable clock/sleep for tests)."""

    def __init__(
        self,
        bytes_per_sec: float,
        burst: float | None = None,
        clock=time.monotonic,
        sleep=time.sleep,
    ):
        self.rate = float(bytes_per_sec)
        self.burst = float(burst if burst is not None else bytes_per_sec)
        self._tokens = self.burst
        self._clock = clock
        self._sleep = sleep
        self._last = clock()
        self._lock = threading.Lock()

    def consume(self, n: int) -> None:
        if self.rate <= 0:  # unlimited
            return
        with self._lock:
            now = self._clock()
            self._tokens = min(self.burst, self._tokens + (now - self._last) * self.rate)
            self._last = now
            self._tokens -= n
            deficit = -self._tokens
        if deficit > 0:
            self._sleep(deficit / self.rate)


@dataclass
class ScrubCursor:
    """Resumable (shard, block[, leaf]) position, pinned to a sidecar
    generation so a re-encode restarts the walk. Carries the corrupt
    shards (and, on v2 sidecars, their corrupt leaf indices) found in
    earlier budget slices of the same pass — quarantine only happens
    once the pass completes, so mid-pass findings must survive a pause
    (and a process restart). `leaf` is the position WITHIN `block` when
    the sidecar records leaves."""

    generation: int = 0
    shard: int = 0
    block: int = 0
    leaf: int = 0
    corrupt: list[int] = field(default_factory=list)
    corrupt_leaves: dict[int, list[int]] = field(default_factory=dict)

    @classmethod
    def load(cls, base: str) -> "ScrubCursor | None":
        try:
            with open(base + CURSOR_SUFFIX) as f:
                doc = json.load(f)
            return cls(
                generation=int(doc["generation"]),
                shard=int(doc["shard"]),
                block=int(doc["block"]),
                leaf=int(doc.get("leaf", 0)),
                corrupt=[int(x) for x in doc.get("corrupt", [])],
                corrupt_leaves={
                    int(k): [int(x) for x in v]
                    for k, v in doc.get("corrupt_leaves", {}).items()
                },
            )
        except (OSError, ValueError, KeyError):
            return None

    def save(self, base: str) -> None:
        atomic_write(
            base + CURSOR_SUFFIX,
            json.dumps(
                {
                    "generation": self.generation,
                    "shard": self.shard,
                    "block": self.block,
                    "leaf": self.leaf,
                    "corrupt": self.corrupt,
                    "corrupt_leaves": {str(k): v for k, v in self.corrupt_leaves.items()},
                }
            ).encode(),
        )

    @staticmethod
    def drop(base: str) -> None:
        try:
            os.unlink(base + CURSOR_SUFFIX)
        except OSError:
            pass


@dataclass
class ScrubReport:
    base: str
    complete: bool = False  # full pass finished (vs budget-paused)
    checked_blocks: int = 0
    checked_leaves: int = 0  # v2 sidecars: leaves walked
    checked_bytes: int = 0
    checked_shards: list[int] = field(default_factory=list)  # ids walked
    corrupt_shards: list[int] = field(default_factory=list)
    # v2 sidecars: shard -> leaf indices that mismatched
    corrupt_leaves: dict[int, list[int]] = field(default_factory=dict)
    missing_shards: list[int] = field(default_factory=list)
    quarantined: list[str] = field(default_factory=list)
    rebuilt: list[int] = field(default_factory=list)
    aged_out: list[str] = field(default_factory=list)  # .bad files retired
    # Leaf-granular in-place repairs this pass (shard -> patched leaf
    # indices): the shard was NEVER quarantined.
    leaf_repaired: dict[int, list[int]] = field(default_factory=dict)
    # Crash recovery at pass start: journals replayed (shard -> leaves)
    # and torn journals rolled back.
    journal_replayed: dict[int, list[int]] = field(default_factory=dict)
    journal_rolled_back: list[str] = field(default_factory=list)
    swept_journals: list[str] = field(default_factory=list)  # TTL litter
    refused: str = ""  # non-empty = fail-closed, nothing was touched

    @property
    def healthy(self) -> bool:
        return (
            self.complete
            and not self.corrupt_shards
            and not self.missing_shards
            and not self.refused
        )


def _quarantine(path: str) -> str:
    """Rename a corrupt shard out of Reed-Solomon's reach, atomically.
    An existing old quarantine of the same shard is replaced — the
    freshest corrupt bytes are the forensically interesting ones."""
    dest = path + QUARANTINE_SUFFIX
    os.replace(path, dest)
    try:
        # rename preserves the ORIGINAL shard's mtime; retention aging
        # must count from the quarantine event, so stamp it.
        os.utime(dest)
    except OSError:
        pass
    fsync_dir(path)
    return dest


def scrub_ec_volume(
    base: str,
    ctx: ECContext | None = None,
    *,
    backend=None,
    repair: bool = True,
    rate_limiter: RateLimiter | None = None,
    resumable: bool = True,
    max_blocks: float | None = None,
    rebuild_policy: RetryPolicy = DEFAULT_REBUILD_POLICY,
    breaker: CircuitBreaker | None = None,
    expected_shards: list[int] | None = None,
    on_quarantine=None,
    on_rebuilt=None,
    on_leaf_patched=None,
    bad_retention_s: float | None = None,
    journal_ttl_s: float | None = 86400.0,
    stages: dict | None = None,
    scheduler=None,
) -> ScrubReport:
    """One scrub pass (possibly budget-sliced) over one EC volume.

    Verifies every present shard against the .ecsum sidecar, patches
    rotten leaves in place, quarantines what leaf repair cannot fix
    (rename to .bad), and — when `repair` — regenerates quarantined/
    missing shards via rebuild_ec_files under the retry policy.
    `on_quarantine(shard_id, new_path)` and `on_rebuilt(shard_ids)` let
    a serving layer unmount/remount shards around the repair.

    `backend` runs leaf reconstruction and the rebuild. With none, each
    resolves the card's (`get_backend("cuda", k, m)`) when it runs, as
    the JAX package resolves its default there: a pass that repairs
    nothing needs no card, and a repair without one raises (no repair
    quietly runs on the CPU).

    `expected_shards` bounds which ABSENT shards count as missing (and
    so get rebuilt): on a balanced cluster a server legitimately holds a
    subset, and an absent shard usually lives on a peer. Default None =
    all shards expected.

    `bad_retention_s` ages out quarantined <shard>.bad forensic copies
    once a VERIFIED replacement shard has been published (this pass saw
    the shard present and clean, rebuilt it, or leaf-repaired it) and
    the quarantine file is older than the retention. None (default)
    keeps quarantines forever.

    `on_leaf_patched(shard_id, byte_ranges)` fires whenever this pass
    changes a shard's bytes IN PLACE — a replayed crash journal at pass
    start, or a leaf-granular repair — so a serving layer can drop
    cached reconstructions over exactly those ranges.

    `journal_ttl_s` retires stale/orphaned `<shard>.repair` journals
    older than the TTL at pass completion (valid pending journals are
    replayed at pass START, never swept); None disables the sweep.

    `stages` gains the leaf repairs' wall seconds: "crc_verify",
    "reconstruct" and "repair_patch", and repair_patch split into
    "repair_patch.fsync" and "repair_patch.work" (ec/repair_journal.py).

    `scheduler` is the QueueScope the repair rebuild's stream runs under
    (None = the process-wide default scope); scrub-initiated repair is
    the lowest class ("scrub") on the shared device queue.
    """
    report = ScrubReport(base=base)
    ecsum = base + ".ecsum"
    if not os.path.exists(ecsum):
        report.refused = "no .ecsum sidecar; cannot verify shards"
        return report
    try:
        prot = BitrotProtection.load(ecsum)
    except BitrotError as e:
        # Fail closed: an unreadable sidecar means no trustworthy ground
        # truth; rebuilding from unverified shards could launder rot.
        report.refused = f"sidecar malformed: {e}"
        return report
    if ctx is not None and prot.ctx != ctx:
        report.refused = f"sidecar ratio {prot.ctx} != expected {ctx}"
        return report
    ctx = prot.ctx

    # Crash recovery BEFORE any verification: a pending repair journal
    # is replayed (or a torn one rolled back) so the walk below sees
    # fully-old or fully-new bytes, never a half-applied patch. The
    # replay may flip sidecar leaf CRCs — `prot` is updated in place.
    rec = recover_volume_journals(base, ctx, prot)
    report.journal_replayed = rec["replayed"]
    report.journal_rolled_back = rec["rolled_back"]
    if on_leaf_patched is not None and prot.has_leaves:
        for sid, leaves in rec["replayed"].items():
            on_leaf_patched(sid, patched_byte_ranges(prot, sid, leaves))

    cursor = ScrubCursor.load(base) if resumable else None
    if cursor is None or cursor.generation != prot.generation:
        cursor = ScrubCursor(generation=prot.generation)
    # Verdicts carried from earlier budget slices of this pass are
    # re-verified at completion (below) before any quarantine. A shard
    # whose slice PAUSED mid-walk carries only corrupt_leaves.
    carried = set(cursor.corrupt) | set(cursor.corrupt_leaves)
    report.corrupt_shards.extend(cursor.corrupt)
    report.corrupt_leaves.update({s: list(ls) for s, ls in cursor.corrupt_leaves.items()})

    want_local = set(range(ctx.total)) if expected_shards is None else set(expected_shards)
    budget = max_blocks if max_blocks is not None else float("inf")
    paused = False
    present_files = 0
    for shard_id in range(ctx.total):
        path = base + ctx.to_ext(shard_id)
        if not os.path.exists(path):
            if shard_id in want_local:
                report.missing_shards.append(shard_id)
            continue
        present_files += 1
        if shard_id < cursor.shard:
            report.checked_shards.append(shard_id)
            continue  # verified in an earlier slice of this pass
        # Finest granularity the sidecar records: v2 walks its leaves,
        # v1 its blocks. The budget stays denominated in blocks either
        # way — a leaf read consumes its byte-proportional fraction.
        gsize, gcrcs = prot.verify_granularity(shard_id)
        leafwise = gsize != prot.block_size
        per_block = prot.block_size // gsize if leafwise else 1
        granule_cost = gsize / prot.block_size if leafwise else 1
        start_g = 0
        if shard_id == cursor.shard:
            start_g = cursor.block * per_block + (cursor.leaf if leafwise else 0)
        corrupt = False
        try:
            if os.path.getsize(path) != prot.shard_sizes[shard_id]:
                corrupt = True  # truncation/growth is corruption
            else:
                with open(path, "rb") as f:
                    f.seek(start_g * gsize)
                    for g in range(start_g, len(gcrcs)):
                        if budget <= 0:
                            cursor.shard = shard_id
                            cursor.block, cursor.leaf = divmod(g, per_block)
                            if resumable:
                                cursor.save(base)
                            paused = True
                            break
                        block = f.read(gsize)
                        block = faults.mutate(
                            "ec.scrub.read_block", block, path=path, shard=shard_id
                        )
                        if rate_limiter is not None:
                            rate_limiter.consume(len(block))
                        if leafwise:
                            report.checked_leaves += 1
                            if (g + 1) % per_block == 0 or g + 1 == len(gcrcs):
                                report.checked_blocks += 1
                        else:
                            report.checked_blocks += 1
                        report.checked_bytes += len(block)
                        budget -= granule_cost
                        if crc32c(block) != gcrcs[g]:
                            corrupt = True
                            if not leafwise:
                                break  # v1: one verdict per shard
                            # leafwise walks keep scanning: the repair
                            # and the .bad.leaves marker need EVERY
                            # rotten leaf, not just the first
                            report.corrupt_leaves.setdefault(shard_id, []).append(g)
                            cursor.corrupt_leaves.setdefault(shard_id, []).append(g)
        except OSError:
            corrupt = True  # unreadable = untrustworthy RS input
        if paused:
            break
        if leafwise and cursor.corrupt_leaves.get(shard_id):
            # bad leaves found in an EARLIER slice of this shard still
            # condemn it, even if this slice's resumed tail read clean
            corrupt = True
        if corrupt:
            report.corrupt_shards.append(shard_id)
            cursor.corrupt.append(shard_id)
        report.checked_shards.append(shard_id)
        cursor.shard, cursor.block, cursor.leaf = shard_id + 1, 0, 0
        # Persist progress only when a mid-pass pause is possible at all
        # (a block budget is set): an unbounded pass can never resume.
        if resumable and max_blocks is not None:
            cursor.save(base)

    if paused:
        return report
    report.complete = True
    if resumable:
        ScrubCursor.drop(base)

    consume = rate_limiter.consume if rate_limiter else None

    # Cursor-carried verdicts are stale across slices: the shard may
    # have been repaired or removed since its slice ran. Re-verify
    # before trusting; a leaf-pinned verdict re-reads ONLY the flagged
    # leaves to confirm, but clearing one takes a full verify.
    def _leaves_still_bad(path: str, sid: int, leaves: list[int]) -> bool:
        if os.path.getsize(path) != prot.shard_sizes[sid]:
            return True
        lsize, lcrcs = prot.verify_granularity(sid)
        with open(path, "rb") as f:
            for li in leaves:
                f.seek(li * lsize)
                chunk = f.read(lsize)
                if consume is not None:
                    consume(len(chunk))
                if li >= len(lcrcs) or crc32c(chunk) != lcrcs[li]:
                    return True
        return False

    for sid in [s for s in report.corrupt_shards if s in carried]:
        path = base + ctx.to_ext(sid)
        flagged = report.corrupt_leaves.get(sid)
        try:
            still_bad = bool(
                flagged and prot.has_leaves and _leaves_still_bad(path, sid, flagged)
            ) or bool(prot.verify_shard_file(path, sid, on_block=consume, stop_early=True))
        except FileNotFoundError:
            still_bad = False  # gone: the missing-walk owns it now
        except OSError:
            still_bad = True
        if not still_bad:
            report.corrupt_shards.remove(sid)
            report.corrupt_leaves.pop(sid, None)

    # ---- fail-closed gates mirror rebuild's verify-and-exclude rules ----
    if len(report.corrupt_shards) > ctx.parity_shards:
        # The sidecar is the suspect when "everything" mismatches; do NOT
        # quarantine good shards on its say-so.
        report.refused = (
            f"{len(report.corrupt_shards)} shards mismatch (> parity "
            f"{ctx.parity_shards}); sidecar suspect, refusing to quarantine"
        )
        return report

    # ---- leaf-granular in-place repair ----------------------------------
    # A shard whose rot is pinned to specific leaves (v2 sidecar) and
    # whose siblings still muster k verified-good sources is patched IN
    # PLACE under the repair journal instead of being quarantined.
    # Anything leaf repair cannot fix (size rot, v1 sidecar, <k sources,
    # reconstruction refusal) falls through to quarantine + rebuild.
    if repair and prot.has_leaves and report.corrupt_shards:
        good_sids = sorted(
            sid
            for sid in range(ctx.total)
            if sid not in report.corrupt_shards and os.path.exists(base + ctx.to_ext(sid))
        )

        def read_range(src: int, lo: int, size: int) -> bytes | None:
            try:
                faults.fire("ec.repair.source_read", shard=src, offset=lo)
                with open(base + ctx.to_ext(src), "rb") as f:
                    f.seek(lo)
                    got = f.read(size)
            except OSError:
                return None
            return faults.mutate("ec.repair.source_read", got, shard=src, offset=lo)

        for sid in [s for s in report.corrupt_shards if s in report.corrupt_leaves]:
            path = base + ctx.to_ext(sid)
            if len(good_sids) < ctx.data_shards:
                M.ec_leaf_repairs_total.inc(outcome="refused")
                break  # below the floor for every remaining shard
            # The walk's leaf set may be a stale slice verdict; pin the
            # repair to a FRESH full-leaf verdict.
            fresh = leaf_verdict(path, sid, prot, on_block=consume)
            if fresh is None:
                continue  # size rot / unreadable: not patchable in place
            if not fresh:
                # verifies clean now (repaired since its slice)
                report.corrupt_shards.remove(sid)
                report.corrupt_leaves.pop(sid, None)
                continue
            # one flight-recorder root per repair op
            sp = trace.start(
                "ec.leaf_repair", name=f"{os.path.basename(base)}.{sid:02d}",
                shard=sid, leaves=sorted(fresh),
            )
            try:
                with trace.activate(sp):
                    patches = reconstruct_leaves(
                        prot, ctx, sid, fresh, read_range, good_sids,
                        backend=backend, on_bytes=consume, stages=stages, span=sp,
                    )
                    apply_leaf_repair(
                        path, sid, prot, patches, ecsum_path=ecsum, stages=stages, span=sp,
                    )
            except (ECError, OSError) as e:
                M.ec_leaf_repairs_total.inc(outcome="failed")
                log.warning(
                    "leaf repair of shard %d failed (%s); falling back to quarantine",
                    sid, e,
                )
                continue
            finally:
                trace.finish(sp)
            report.corrupt_shards.remove(sid)
            report.corrupt_leaves.pop(sid, None)
            report.leaf_repaired[sid] = sorted(fresh)
            M.ec_leaf_repairs_total.inc(outcome="repaired")
            log.warning(
                "leaf-repaired shard %d in place (leaves %s); quarantine avoided",
                sid, sorted(fresh),
            )
            if on_leaf_patched is not None:
                on_leaf_patched(sid, patched_byte_ranges(prot, sid, fresh))

    present_good = present_files - len(report.corrupt_shards)
    if report.corrupt_shards and present_good < ctx.data_shards:
        report.refused = (
            f"only {present_good} verified-good shards (need "
            f"{ctx.data_shards}); refusing to quarantine below rebuild floor"
        )
        return report

    for shard_id in report.corrupt_shards:
        path = base + ctx.to_ext(shard_id)
        try:
            dest = _quarantine(path)
        except FileNotFoundError:
            continue  # vanished since re-verify; missing-walk owns it now
        report.quarantined.append(dest)
        leaves = report.corrupt_leaves.get(shard_id)
        if leaves and prot.has_leaves:
            # which leaves of the .bad forensic copy mismatched
            try:
                atomic_write(
                    dest + ".leaves",
                    json.dumps({"leaf_size": prot.leaf_size, "leaves": sorted(leaves)}).encode(),
                )
            except OSError:  # forensics must not block the repair
                pass
        log.warning(
            "quarantined corrupt shard %s -> %s%s", path, dest,
            f" (leaves {sorted(leaves)})" if leaves else "",
        )
        if on_quarantine is not None:
            on_quarantine(shard_id, dest)

    want_rebuild = sorted(set(report.corrupt_shards) | set(report.missing_shards))
    if repair and want_rebuild:
        def attempt() -> list[int]:
            # the lowest class on the shared device queue: it yields the
            # chip to serving and to recovery rebuilds, keeping only its
            # minimum share under contention
            return rebuild_ec_files(
                base, ctx, backend=backend, only_shards=want_rebuild,
                priority="scrub", scheduler=scheduler,
            )

        def run() -> list[int]:
            return retry_call(attempt, rebuild_policy, describe=f"rebuild {base}")

        try:
            rebuilt = breaker.call(run) if breaker is not None else run()
            report.rebuilt = rebuilt
            if on_rebuilt is not None and rebuilt:
                on_rebuilt(rebuilt)
        except CircuitOpenError as e:
            report.refused = f"rebuild skipped: {e}"
        except (RetryError, ECError) as e:
            report.refused = f"rebuild failed: {e}"

    # ---- age out retired quarantine files -------------------------------
    # A .bad forensic copy is eligible once a verified replacement is
    # published: this pass walked the live shard clean, rebuilt it, or
    # leaf-repaired it. Eligibility is never inferred from absence.
    if bad_retention_s is not None and not report.refused:
        verified_now = (
            (set(report.checked_shards) - set(report.corrupt_shards))
            | set(report.rebuilt)
            | set(report.leaf_repaired)
        )
        now = time.time()
        for sid in sorted(verified_now):
            bad_path = base + ctx.to_ext(sid) + QUARANTINE_SUFFIX
            try:
                age = now - os.path.getmtime(bad_path)
            except OSError:
                # no .bad — but an ORPHANED .bad.leaves marker must not
                # outlive the retention either
                lpath = bad_path + ".leaves"
                try:
                    lage = now - os.path.getmtime(lpath)
                except OSError:
                    continue  # no quarantine artifacts for this shard
                if lage < bad_retention_s:
                    continue
                try:
                    os.unlink(lpath)
                except OSError:
                    continue
                fsync_dir(lpath)
                report.aged_out.append(lpath)
                log.info("retired orphaned leaf marker %s", lpath)
                continue
            if age < bad_retention_s:
                continue
            try:
                os.unlink(bad_path)
            except OSError:
                continue
            try:  # the leaf forensic marker retires with its .bad
                os.unlink(bad_path + ".leaves")
            except OSError:
                pass
            fsync_dir(bad_path)
            report.aged_out.append(bad_path)
            log.info("retired quarantine %s (age %.0fs)", bad_path, age)

    # ---- sweep stale repair-journal litter ------------------------------
    if journal_ttl_s is not None:
        report.swept_journals = sweep_stale_journals(base, ctx, journal_ttl_s)
    return report


class ScrubDaemon:
    """Background scrub loop over a Store's mounted EC volumes.

    Walks every EC volume each `interval`, slicing work by `max_blocks`
    per volume per wakeup. Quarantine/rebuild events unmount and remount
    the affected shard on the live EcVolume so reads degrade to
    reconstruction (never a stale fd on a renamed file) and pick the
    regenerated shard back up once it verifies.
    """

    def __init__(
        self,
        store,
        interval: float = 3600.0,
        bytes_per_sec: float = 64 << 20,
        max_blocks_per_volume: float | None = None,
        repair: bool = True,
        breaker: CircuitBreaker | None = None,
        backend=None,
        bad_retention_s: float | None = None,
        journal_ttl_s: float | None = 86400.0,
    ):
        self.store = store
        self.interval = interval
        self.repair = repair
        self.backend = backend
        self.bad_retention_s = bad_retention_s
        self.journal_ttl_s = journal_ttl_s
        self.limiter = RateLimiter(bytes_per_sec)
        self.max_blocks = max_blocks_per_volume
        # One breaker PER VOLUME: a permanently-unrebuildable volume
        # (e.g. a subset holder below k local files) must not starve
        # every other volume's repair on this server. `breaker`, when
        # given, is the template whose thresholds new ones copy.
        self._breaker_template = breaker or CircuitBreaker(
            failure_threshold=3, reset_timeout=300.0
        )
        self.breakers: dict[int, CircuitBreaker] = {}
        self.reports: dict[int, ScrubReport] = {}  # vid -> last report
        self.passes = 0
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="ec-scrub", daemon=True
        )

    # ------------------------------------------------------------ control

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread.is_alive():
            self._thread.join(timeout=5)

    def kick(self) -> None:
        """Request an immediate pass (ops hook / tests)."""
        self._wake.set()

    def breaker_for(self, vid: int) -> CircuitBreaker:
        b = self.breakers.get(vid)
        if b is None:
            t = self._breaker_template
            b = CircuitBreaker(
                failure_threshold=t.failure_threshold,
                reset_timeout=t.reset_timeout,
            )
            self.breakers[vid] = b
        return b

    # -------------------------------------------------------------- loop

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.scrub_once()
            except Exception as e:  # pragma: no cover - daemon must survive
                log.error("scrub pass failed: %s", e)
            self.passes += 1
            self._wake.wait(self.interval)
            self._wake.clear()

    def scrub_once(self) -> dict[int, ScrubReport]:
        """One pass over every mounted EC volume; returns vid->report."""
        out: dict[int, ScrubReport] = {}
        for loc in self.store.locations:
            for vid, ev in list(loc.ec_volumes.items()):
                if self._stop.is_set():
                    return out
                # This server's legitimate shard set = served + on-disk
                # quarantined (EcVolume.legitimate_shards): a shard
                # quarantined+unmounted last pass whose rebuild then
                # failed stays on the repair list instead of vanishing
                # from the mounted set and being reported healthy. An
                # absent shard outside this set lives on a peer; a local
                # rebuild of it would mint a duplicate copy the master
                # never placed (and below k local files, fail every
                # pass and wedge the shared breaker).
                mounted = set(ev.legitimate_shards())
                report = scrub_ec_volume(
                    ev.base,
                    ev.ctx,
                    backend=self.backend,
                    repair=self.repair,
                    rate_limiter=self.limiter,
                    max_blocks=self.max_blocks,
                    breaker=self.breaker_for(vid),
                    expected_shards=sorted(mounted),
                    bad_retention_s=self.bad_retention_s,
                    journal_ttl_s=self.journal_ttl_s,
                    # the Store's own scheduler scope (per-tenant
                    # placement/shares); falls back to the process-wide
                    # default for bare stores
                    scheduler=getattr(self.store, "ec_scheduler", None),
                    # Unmount BEFORE rebuild: the serving fd still points
                    # at the renamed .bad inode and would happily serve
                    # rot; degraded reads reconstruct meanwhile.
                    on_quarantine=lambda sid, dest, ev=ev: ev.unmount_shards([sid]),
                    # Remount only what this server served going in —
                    # rebuild may have regenerated peers' shards too.
                    on_rebuilt=lambda sids, ev=ev, m=mounted: ev.reopen_shards(
                        [s for s in sids if s in m]
                    ),
                    # In-place patches (journal replay, leaf repair)
                    # keep the inode — no fd swap, but any cached
                    # reconstruction over the patched bytes is stale.
                    on_leaf_patched=lambda sid, ranges, ev=ev: (
                        ev.invalidate_shard_ranges(sid, ranges)
                    ),
                )
                out[vid] = report
                self.reports[vid] = report
                if report.refused:
                    log.warning("scrub vol %d refused: %s", vid, report.refused)
                elif report.quarantined or report.rebuilt or report.leaf_repaired:
                    log.warning(
                        "scrub vol %d: quarantined=%s rebuilt=%s "
                        "leaf_repaired=%s",
                        vid, report.quarantined, report.rebuilt,
                        report.leaf_repaired,
                    )
        return out
