"""Peer-fetch EC rebuild: recover when no single server holds k shards.

Port of seaweedfs_tpu/ec/peer_rebuild.py, whole. Per-server rebuild
(ec/rebuild.py) refuses when fewer than k source shards are on local
disk; on a balanced cluster every holder is a subset holder, so a lost
shard could never be regenerated anywhere. This module fetches just
enough sibling shards from peer holders through the shard-read
transport, rebuilds locally on the card through the staged, scheduled
path, and publishes only the regenerated targets.

Present-but-corrupt local shards whose rot is pinned to specific 64 KiB
leaves (v2 sidecar) are repaired at LEAF granularity first: only the
rotten leaves' byte ranges are fetched from k range-verified sources
(local good shards from disk, the rest over the ranged shard read) and
patched in place under the crash-consistent repair journal
(ec/repair_journal.py): about k * 64 KiB of wire per rotten leaf instead
of about k * shard. Only what leaf repair cannot fix takes the
whole-shard fetch, rebuild and publish path below.

Correctness envelope (the verify-and-exclude rules of the local
rebuild, extended across the wire):

- every fetched stream is verified against the .ecsum sidecar at the
  sidecar's own granularity WHILE it streams; a peer serving corrupt
  bytes is excluded (after one immediate re-read of the bad granule, to
  rule out transient wire corruption) and the plan re-routes to another
  holder or another shard; transient failures (transport errors, torn
  or short streams) retry under utils/retry.py before the holder is
  abandoned;
- fewer than k verified sources reachable = clean refusal: staging is
  wiped, nothing is published, the canonical files are untouched;
- fetched sources live ONLY in a staging directory next to the volume
  (hard links for verified-good local shards, downloads for the rest),
  so the local server never holds publishable copies of shards placed
  on peers, even across crashes;
- regenerated targets publish with the local rebuild's own machinery
  (temp, fsync, sidecar re-verify and atomic rename inside staging,
  then one rename per target into the canonical directory), so a re-run
  after any crash window converges idempotently.

The byte transport is injected (`fetch`, and the optional native
`fetch_into` of ec/net_plane.make_fetch_into), so the core runs without
servers. `backend=None` resolves as the local rebuild does: the card,
or an error where there is none.
"""

from __future__ import annotations

import os
import shutil
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np

from .. import faults
from ..utils import metrics as M
from ..utils import trace
from ..utils.crc import crc32c
from ..utils.fs import fsync_dir
from ..utils.glog import logger
from ..utils.retry import RetryError, RetryPolicy, retry_call
from .bitrot import BitrotError, BitrotProtection
from .context import ECContext, ECError
from .rebuild import rebuild_ec_files
from .repair_journal import (
    apply_leaf_repair,
    leaf_verdict,
    patched_byte_ranges,
    reconstruct_leaves,
)
from .volume_info import VolumeInfo

log = logger("ec.peer")

# Transient fetch failures (RPC errors, torn/short streams) retry
# quickly and give up fast: with several candidate holders per shard, a
# dead peer should cost milliseconds, not a backoff tail. ECError is
# never retried — refusals are deterministic.
DEFAULT_FETCH_POLICY = RetryPolicy(
    max_attempts=3, base_delay=0.05, max_delay=0.5,
)

# Fetch request size: granule-aligned so the sidecar CRC verdict lands
# per chunk (bounded memory, early corrupt-peer detection).
FETCH_CHUNK = 1 << 20

# The native ingress lands in pooled reusable buffers, so it can afford
# a wider window per request: fewer header round trips and Python-level
# chunk turnarounds on the zero-copy path (memory cost is one pooled
# matrix per in-flight stream, reused forever).
NATIVE_FETCH_CHUNK = 4 << 20

STAGING_PREFIX = ".peerfetch-"


class PeerFetchTransient(Exception):
    """One fetch attempt failed in a retryable way (RPC error, short or
    torn stream). `fetch` implementations raise this for transport
    errors; persistent transients abandon the holder, not the plan."""


class PeerPlaneUnavailable(Exception):
    """The peer serves no native shard byte plane (ec/net_plane.py):
    `fetch_into` implementations raise this so the stream falls back to
    the Python `fetch` transport — a capability miss, not a failure,
    so it is never retried and never excludes the holder."""


class PeerCorruptError(Exception):
    """A peer served bytes that fail sidecar verification even on a
    re-read: the holder is serving rot and is excluded from the plan."""

    def __init__(self, peer: str, shard: int, granule: int):
        super().__init__(
            f"peer {peer} serves corrupt bytes for shard {shard} "
            f"(granule {granule})"
        )
        self.peer = peer
        self.shard = shard


@dataclass
class PeerRebuildReport:
    """What one peer-fetch rebuild attempt did."""

    rebuilt: list[int] = field(default_factory=list)
    fetched: dict[int, str] = field(default_factory=dict)  # sid -> peer
    # Which byte plane carried each fetched stream ("native" = zero-copy
    # net-plane ingress straight into pooled aligned buffers, "python" =
    # the bit-identical bytes fallback).
    fetched_plane: dict[int, str] = field(default_factory=dict)
    local_sources: list[int] = field(default_factory=list)
    corrupt_local: list[int] = field(default_factory=list)
    excluded_peers: list[str] = field(default_factory=list)
    # Present-but-corrupt local shards whose rot was leaf-localized and
    # repaired IN PLACE under the repair journal, fetching only the
    # rotten leaves' byte ranges from peers (shard -> patched leaves).
    # These never enter the whole-shard rebuild.
    leaf_repaired: dict[int, list[int]] = field(default_factory=dict)
    # Bytes actually pulled over the wire for those ranged repairs
    # (including granule re-reads) — the ~k·64 KiB-per-leaf acceptance
    # number, vs ~k·shard for a full peer-fetch rebuild.
    repair_wire_bytes: int = 0
    # In-place patches applied this run (shard -> [(lo, hi), ...]): the
    # serving layer drops cached reconstructions over exactly these.
    patched_ranges: dict[int, list[tuple[int, int]]] = field(
        default_factory=dict
    )


def staging_dir(base: str) -> str:
    """Staging directory for one volume's peer-fetch rebuild (same
    filesystem as the volume, so hard links and renames work)."""
    d, name = os.path.split(base)
    return os.path.join(d, STAGING_PREFIX + name)


def _clear_staging(sdir: str) -> None:
    shutil.rmtree(sdir, ignore_errors=True)


def _verify_local(
    base: str, ctx: ECContext, prot: BitrotProtection, present: list[int]
) -> tuple[list[int], list[int]]:
    """(verified-good, corrupt) split of the local present shards. An
    unreadable or size-mismatched shard counts corrupt — it must never
    be fed to Reed-Solomon."""

    def check(i: int) -> bool:
        p = base + ctx.to_ext(i)
        try:
            if os.path.getsize(p) != prot.shard_sizes[i]:
                return True
            return bool(prot.verify_shard_file(p, i, stop_early=True))
        except OSError:
            return True

    if len(present) <= 1:
        flags = [check(i) for i in present]
    else:
        with ThreadPoolExecutor(max_workers=min(len(present), 8)) as ex:
            flags = list(ex.map(check, present))
    corrupt = [i for i, bad in zip(present, flags) if bad]
    return [i for i in present if i not in corrupt], corrupt


def _fetch_shard_verified(
    sbase: str,
    peer: str,
    sid: int,
    prot: BitrotProtection,
    ctx: ECContext,
    fetch,
    policy: RetryPolicy,
    fetch_into=None,
) -> str:
    """Stream one whole shard from `peer` into staging, verifying the
    sidecar CRC per granule as the bytes land, and return the plane
    that carried it ("native" | "python"). Raises PeerCorruptError when
    a granule mismatches even after one immediate re-read (the
    transient-wire-corruption escape), PeerFetchTransient/RetryError
    when the peer stays unreachable. Publishes atomically INSIDE
    staging; a partial download never looks like a shard.

    The native plane (`fetch_into` provided, native_io enabled, fault
    registry disarmed) lands each chunk DIRECTLY in a pooled aligned
    buffer with the granule CRC fused into the copy-in; the Python
    plane is the bit-identical `fetch`-based fallback, which also
    carries every stream whenever chaos is armed (byte-mutating fault
    points need materialized bytes)."""
    if fetch_into is not None:
        from . import native_io

        if native_io.enabled() and not faults.active():
            try:
                _fetch_shard_stream_native(
                    sbase, peer, sid, prot, ctx, fetch, fetch_into, policy
                )
                return "native"
            except PeerPlaneUnavailable as e:
                log.info(
                    "peer %s has no native shard plane (%s); falling back "
                    "to the python fetch", peer, e,
                )
    _fetch_shard_stream_python(sbase, peer, sid, prot, ctx, fetch, policy)
    return "python"


def _fetch_shard_stream_native(
    sbase: str,
    peer: str,
    sid: int,
    prot: BitrotProtection,
    ctx: ECContext,
    fetch,
    fetch_into,
    policy: RetryPolicy,
) -> None:
    """Native ingress: `fetch_into(peer, sid, off, size, dst, granule)`
    lands each granule-aligned chunk straight into a pooled 4096-aligned
    buffer and returns the granule CRCs rolled DURING the copy-in, so
    the verify-and-exclude pass below compares integers against the
    sidecar instead of re-reading bytes. A mismatched granule gets one
    immediate byte-level re-read through `fetch` (the transient-wire-
    corruption escape); a repeat mismatch excludes the holder. The
    staging file is written with raw unbuffered I/O straight from the
    landing buffer — socket to matrix to disk, one userspace copy
    total."""
    gsize, gcrcs = prot.verify_granularity(sid)
    size = prot.shard_sizes[sid]
    chunk = max(NATIVE_FETCH_CHUNK - NATIVE_FETCH_CHUNK % gsize, gsize)
    dest = sbase + ctx.to_ext(sid)
    tmp = dest + ".fetching"
    from .native_io import landing_pool

    pool = landing_pool()
    buf = pool.get(chunk)
    sp = trace.start(
        "ec.peer_fetch", name=f"shard {sid} <- {peer}",
        peer=peer, shard=sid, bytes=size, plane="native",
    )
    try:
        with open(tmp, "wb", buffering=0) as f:
            off = 0
            gi = 0
            while off < size:
                n = min(chunk, size - off)
                row = buf[0, :n]

                def attempt(off=off, n=n, row=row):
                    return fetch_into(peer, sid, off, n, row, gsize)

                with trace.stage(sp, "peer_fetch"):
                    crcs = retry_call(
                        attempt, policy, retry_on=(PeerFetchTransient,),
                        describe=f"peer fetch {peer} shard {sid}",
                    )
                with trace.stage(sp, "crc_verify"):
                    ngr = (n + gsize - 1) // gsize
                    if crcs is None or len(crcs) != ngr:
                        raise PeerFetchTransient(
                            f"native ingress returned {0 if crcs is None else len(crcs)} "
                            f"granule CRCs for {ngr} granules"
                        )
                    for j in range(ngr):
                        if gi + j < len(gcrcs) and int(crcs[j]) == gcrcs[gi + j]:
                            continue
                        # one immediate byte-level re-read of ONLY this
                        # granule rules out transient wire corruption; a
                        # repeat mismatch is the peer serving rot
                        lo = j * gsize
                        glen = min(gsize, n - lo)

                        def reread(off=off, lo=lo, glen=glen):
                            return fetch(peer, sid, off + lo, glen)

                        g2 = retry_call(
                            reread, policy, retry_on=(PeerFetchTransient,),
                            describe=f"peer fetch {peer} shard {sid}",
                        )
                        if gi + j >= len(gcrcs) or crc32c(g2) != gcrcs[gi + j]:
                            raise PeerCorruptError(peer, sid, gi + j)
                        row[lo : lo + glen] = np.frombuffer(g2, dtype=np.uint8)
                    gi += ngr
                with trace.stage(sp, "write_sink"):
                    mv = memoryview(row)
                    while mv:
                        mv = mv[f.write(mv):]
                off += n
            with trace.stage(sp, "fsync_publish"):
                os.fsync(f.fileno())
        os.replace(tmp, dest)
    finally:
        pool.put(buf)
        if os.path.exists(tmp):
            os.unlink(tmp)
        trace.finish(sp)


def _fetch_shard_stream_python(
    sbase: str,
    peer: str,
    sid: int,
    prot: BitrotProtection,
    ctx: ECContext,
    fetch,
    policy: RetryPolicy,
) -> None:
    """Python-plane whole-shard stream: `fetch` materializes bytes, the
    granule CRC is rolled over them as they land, and byte-mutating
    chaos points apply at the seams."""
    gsize, gcrcs = prot.verify_granularity(sid)
    size = prot.shard_sizes[sid]
    chunk = max(FETCH_CHUNK - FETCH_CHUNK % gsize, gsize)
    dest = sbase + ctx.to_ext(sid)
    tmp = dest + ".fetching"
    # Child span per fetched shard stream (parent: the ec.peer_rebuild
    # root active in this thread) — wire time vs CRC time per peer.
    sp = trace.start(
        "ec.peer_fetch", name=f"shard {sid} <- {peer}",
        peer=peer, shard=sid, bytes=size,
    )

    def get(off: int, n: int) -> bytes:
        def attempt() -> bytes:
            try:
                # Named client-side chaos point: a raised IOError is a
                # transient fetch failure; a mutate corrupts the stream
                # the way a rotten peer (or a bad NIC) would, which the
                # granule CRC below must catch.
                faults.fire(
                    "ec.peer_fetch.read", peer=peer, shard=sid, offset=off
                )
                data = fetch(peer, sid, off, n)
            except (PeerFetchTransient, PeerCorruptError):
                raise
            except (IOError, OSError) as e:
                raise PeerFetchTransient(str(e)) from e
            data = faults.mutate(
                "ec.peer_fetch.read", data, peer=peer, shard=sid, offset=off
            )
            if len(data) != n:
                raise PeerFetchTransient(
                    f"short read from {peer} for shard {sid}: "
                    f"{len(data)}/{n} bytes at {off}"
                )
            return data

        with trace.stage(sp, "peer_fetch"):
            return retry_call(
                attempt, policy, retry_on=(PeerFetchTransient,),
                describe=f"peer fetch {peer} shard {sid}",
            )

    try:
        with open(tmp, "wb") as f:
            off = 0
            gi = 0
            while off < size:
                n = min(chunk, size - off)
                data = get(off, n)
                # granule-level sidecar verdict while the chunk is hot
                with trace.stage(sp, "crc_verify"):
                    for j in range(0, n, gsize):
                        g = data[j : j + gsize]
                        if gi >= len(gcrcs) or crc32c(g) != gcrcs[gi]:
                            # one immediate re-read rules out transient
                            # wire corruption; a repeat mismatch is the
                            # PEER serving rot. Re-read ONLY this
                            # granule's byte range: the rest of `data`
                            # already passed its CRCs, and re-pulling
                            # the whole chunk would cost up to
                            # chunk/gsize times the wire traffic to
                            # splice out one granule.
                            g2 = get(off + j, len(g))
                            if gi >= len(gcrcs) or crc32c(g2) != gcrcs[gi]:
                                raise PeerCorruptError(peer, sid, gi)
                            data = data[:j] + g2 + data[j + gsize :]
                        gi += 1
                with trace.stage(sp, "write_sink"):
                    f.write(data)
                off += n
            with trace.stage(sp, "fsync_publish"):
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, dest)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
        trace.finish(sp)


def _fetch_range_verified(
    peer: str,
    sid: int,
    lo: int,
    size: int,
    prot: BitrotProtection,
    fetch,
    policy: RetryPolicy,
    counter: list,
    sp=None,
) -> bytes:
    """Fetch ONE leaf-aligned byte range [lo, lo+size) of a sibling
    shard from `peer`, verifying every granule against the sidecar as
    it lands — the ranged analog of `_fetch_shard_verified`. A granule
    that mismatches gets one immediate re-read (transient wire
    corruption); a repeat mismatch raises PeerCorruptError so the
    caller excludes the holder. `counter[0]` accumulates the bytes
    actually pulled over the wire (re-reads included)."""
    gsize, _ = prot.verify_granularity(sid)

    def get(off: int, n: int) -> bytes:
        def attempt() -> bytes:
            try:
                faults.fire(
                    "ec.peer_fetch.read", peer=peer, shard=sid, offset=off
                )
                data = fetch(peer, sid, off, n)
            except (PeerFetchTransient, PeerCorruptError):
                raise
            except (IOError, OSError) as e:
                raise PeerFetchTransient(str(e)) from e
            data = faults.mutate(
                "ec.peer_fetch.read", data, peer=peer, shard=sid, offset=off
            )
            if len(data) != n:
                raise PeerFetchTransient(
                    f"short read from {peer} for shard {sid}: "
                    f"{len(data)}/{n} bytes at {off}"
                )
            return data

        with trace.stage(sp, "repair_fetch"):
            got = retry_call(
                attempt, policy, retry_on=(PeerFetchTransient,),
                describe=f"peer range fetch {peer} shard {sid}",
            )
        counter[0] += len(got)
        return got

    data = get(lo, size)
    with trace.stage(sp, "crc_verify"):
        if not prot.verify_range(sid, lo, data):
            # pin the mismatch to its granule(s): one immediate re-read
            # each (transient wire corruption); a repeat mismatch is
            # the peer serving rot
            for j in range(0, size, gsize):
                g = data[j : j + gsize]
                if prot.verify_range(sid, lo + j, g):
                    continue
                g2 = get(lo + j, len(g))
                if not prot.verify_range(sid, lo + j, g2):
                    raise PeerCorruptError(peer, sid, (lo + j) // gsize)
                data = data[:j] + g2 + data[j + len(g) :]
    return data


def rebuild_from_peers(
    base: str,
    holders: dict[int, list[str]],
    fetch,
    *,
    ctx: ECContext | None = None,
    targets: list[int] | None = None,
    backend=None,
    scheduler=None,
    priority: str = "recovery",
    policy: RetryPolicy = DEFAULT_FETCH_POLICY,
    fetch_into=None,
) -> PeerRebuildReport:
    """Regenerate `targets` for the volume at `base`, fetching sibling
    source shards from peer holders when fewer than k verified-good
    shards are on local disk.

    `holders` maps shard id -> peer ids that serve it (the LOCAL server
    must already be excluded); `fetch(peer, shard_id, offset, size)`
    returns exactly `size` bytes or raises PeerFetchTransient.
    `fetch_into(peer, shard_id, offset, size, dst, granule)` is the
    OPTIONAL native-plane transport (ec/net_plane.make_fetch_into):
    lands the range directly in `dst` and returns the granule CRCs
    rolled during the copy-in, raises PeerPlaneUnavailable for peers
    without the plane — whole-shard streams then ride it whenever the
    native plane is enabled and the fault registry is disarmed, with
    the `fetch` path as the bit-identical fallback.
    `targets=None` regenerates every shard that is not locally
    verified-good; an explicit list restricts regeneration to those ids
    (the server passes its legitimate-set union cluster-lost, the same
    no-duplicate-minting contract as the local rebuild RPC) —
    present-but-corrupt local shards are always replaced regardless.

    Fail-closed: no (or malformed) .ecsum refuses — peer bytes cannot
    be trusted unverified; fewer than k reachable verified sources
    refuses with nothing published and staging wiped.
    """
    ecsum = base + ".ecsum"
    if not os.path.exists(ecsum):
        raise ECError(
            f"peer-fetch rebuild for {base} needs the .ecsum sidecar to "
            f"verify fetched streams; refusing"
        )
    try:
        prot = BitrotProtection.load(ecsum)
    except BitrotError as e:
        raise ECError(
            f"bitrot sidecar for {base} is malformed ({e}); refusing "
            f"peer-fetch rebuild"
        ) from e
    if ctx is None:
        vif = base + ".vif"
        if os.path.exists(vif):
            vi = VolumeInfo.load(vif)
            ctx = vi.ec_ctx
        if ctx is None:
            ctx = prot.ctx
    if prot.ctx != ctx:
        raise ECError(
            f"bitrot sidecar for {base} records ratio {prot.ctx} but the "
            f"volume config says {ctx}; refusing peer-fetch rebuild"
        )
    k = ctx.data_shards

    # Flight-recorder root for the whole peer-fetch rebuild (a child
    # when the holder's RPC span is active in this thread): per-peer
    # fetch child spans, the nested local rebuild, and the publish
    # renames all hang off it, so one cluster heal reads as one tree.
    sp = trace.start(
        "ec.peer_rebuild", name=os.path.basename(base), base=base,
        targets=("auto" if targets is None else sorted(targets)),
    )
    try:
        with trace.activate(sp):
            return _rebuild_from_peers_span(
                base, holders, fetch, ctx, targets, backend, scheduler,
                priority, policy, prot, ecsum, k, sp, fetch_into,
            )
    finally:
        trace.finish(sp)


def _rebuild_from_peers_span(
    base, holders, fetch, ctx, targets, backend, scheduler, priority,
    policy, prot, ecsum, k, sp, fetch_into=None,
) -> PeerRebuildReport:
    report = PeerRebuildReport()
    present = [
        i for i in range(ctx.total) if os.path.exists(base + ctx.to_ext(i))
    ]
    with trace.stage(sp, "verify"):
        good_local, corrupt_local = _verify_local(base, ctx, prot, present)
    report.local_sources = list(good_local)
    report.corrupt_local = list(corrupt_local)
    excluded: set[str] = set()

    # ---- leaf-granular ranged repair of present-but-corrupt locals ----
    # When the rot is pinned to specific leaves (v2 sidecar, full-length
    # file), fetch ONLY those leaves' byte ranges from k verified
    # sources — local good shards read from disk, the remainder pulled
    # from peers through the ranged shard-read RPC — and patch the
    # canonical file in place under the repair journal. Wire cost:
    # ~k·64 KiB per rotten leaf instead of ~k·shard. Anything this
    # cannot fix stays in corrupt_local and takes the whole-shard path.
    if prot.has_leaves and corrupt_local:
        for sid in list(corrupt_local):
            path = base + ctx.to_ext(sid)
            bad = leaf_verdict(path, sid, prot)
            if bad is None:
                continue  # size rot / unreadable: whole-shard replacement
            if not bad:
                # whole-shard verify failed but every leaf now verifies:
                # repaired between the two walks — treat as good
                corrupt_local.remove(sid)
                good_local.append(sid)
                report.corrupt_local.remove(sid)
                report.local_sources = sorted(
                    set(report.local_sources) | {sid}
                )
                continue
            wire = [0]

            def read_range(src: int, lo: int, size: int) -> bytes | None:
                if src in good_local:
                    try:
                        faults.fire(
                            "ec.repair.source_read", shard=src, offset=lo
                        )
                        with open(base + ctx.to_ext(src), "rb") as f:
                            f.seek(lo)
                            got = f.read(size)
                        if len(got) == size:
                            return faults.mutate(
                                "ec.repair.source_read", got,
                                shard=src, offset=lo,
                            )
                    except (OSError, IOError):
                        pass  # transient local I/O: the same shard may
                        # still be servable by a peer holder below —
                        # don't forfeit the cheap ranged path over it
                for peer in holders.get(src, []):
                    if peer in excluded:
                        continue
                    try:
                        return _fetch_range_verified(
                            peer, src, lo, size, prot, fetch, policy,
                            wire, sp,
                        )
                    except PeerCorruptError as e:
                        log.warning("excluding peer: %s", e)
                        trace.event(
                            sp, "peer_excluded", peer=peer, shard=src
                        )
                        excluded.add(peer)
                        continue
                    except (PeerFetchTransient, RetryError) as e:
                        log.warning(
                            "peer %s unreachable for shard %d range "
                            "[%d:+%d): %s", peer, src, lo, size, e,
                        )
                        continue
                return None

            candidates = sorted(good_local) + sorted(
                s for s in holders
                if s not in good_local and s != sid and 0 <= s < ctx.total
            )
            try:
                patches = reconstruct_leaves(
                    prot, ctx, sid, bad, read_range, candidates,
                    backend=backend, span=sp,
                )
                apply_leaf_repair(path, sid, prot, patches, span=sp)
            except (ECError, OSError) as e:
                M.ec_leaf_repairs_total.inc(outcome="failed")
                log.warning(
                    "ranged leaf repair of shard %d failed (%s); falling "
                    "back to whole-shard peer rebuild", sid, e,
                )
                continue
            corrupt_local.remove(sid)
            good_local.append(sid)
            report.corrupt_local.remove(sid)
            report.local_sources = sorted(set(report.local_sources) | {sid})
            report.leaf_repaired[sid] = sorted(bad)
            report.repair_wire_bytes += wire[0]
            report.patched_ranges[sid] = patched_byte_ranges(prot, sid, bad)
            M.ec_leaf_repairs_total.inc(outcome="repaired")
            log.warning(
                "leaf-repaired shard %d in place (leaves %s, %d wire "
                "bytes)", sid, sorted(bad), wire[0],
            )
        report.excluded_peers = sorted(excluded)

    if targets is None:
        want = sorted(set(range(ctx.total)) - set(good_local))
    else:
        # present-but-corrupt shards are always replaced, like the
        # local rebuild's verify-and-exclude contract
        want = sorted(set(targets) | set(corrupt_local))
        want = [i for i in want if i not in good_local]
    if not want:
        return report

    sdir = staging_dir(base)
    _clear_staging(sdir)  # leftovers from a crashed attempt
    os.makedirs(sdir, exist_ok=True)
    sbase = os.path.join(sdir, os.path.basename(base))

    # `excluded` carries over from the ranged-repair stage: a holder
    # that served rot for a 64 KiB range serves rot, full stop.
    try:
        # ---- assemble k verified sources: local links + peer streams --
        sources = set(good_local)
        candidates = sorted(
            sid
            for sid, peers in holders.items()
            if peers and sid not in sources and sid not in want
            and 0 <= sid < ctx.total
        )
        for sid in candidates:
            if len(sources) >= k:
                break
            for peer in holders[sid]:
                if peer in excluded:
                    continue
                try:
                    plane = _fetch_shard_verified(
                        sbase, peer, sid, prot, ctx, fetch, policy,
                        fetch_into=fetch_into,
                    )
                except PeerCorruptError as e:
                    # verify-and-exclude across the wire: this holder
                    # serves rot; nothing it sends is trustworthy
                    log.warning("excluding peer: %s", e)
                    trace.event(sp, "peer_excluded", peer=peer, shard=sid)
                    excluded.add(peer)
                    continue
                except (PeerFetchTransient, RetryError) as e:
                    log.warning(
                        "peer %s unreachable for shard %d: %s", peer, sid, e
                    )
                    continue
                sources.add(sid)
                report.fetched[sid] = peer
                report.fetched_plane[sid] = plane
                break
        report.excluded_peers = sorted(excluded)
        if len(sources) < k:
            raise ECError(
                f"peer-fetch rebuild for {base}: only {len(sources)} "
                f"verified source shards reachable (local "
                f"{sorted(good_local)}, fetched "
                f"{sorted(report.fetched)}, excluded peers "
                f"{sorted(excluded)}); need {k} — refusing, nothing "
                f"published"
            )

        # ---- stage local sources + sidecars, rebuild, publish ---------
        # exactly k staged inputs: linking surplus local shards would
        # only buy extra verification reads inside the rebuild
        for sid in sorted(good_local)[: k - len(report.fetched)]:
            os.link(base + ctx.to_ext(sid), sbase + ctx.to_ext(sid))
        os.link(ecsum, sbase + ".ecsum")
        if os.path.exists(base + ".vif"):
            os.link(base + ".vif", sbase + ".vif")

        rebuilt = rebuild_ec_files(
            sbase,
            ctx,
            backend=backend,
            only_shards=want,
            scheduler=scheduler,
            priority=priority,
        )

        # Crash window: regenerated targets are durable in staging but
        # not yet at the canonical paths. A crash here (or between the
        # per-target renames below) republishes idempotently on re-run:
        # already-renamed targets verify good and drop out of `want`.
        faults.fire("ec.peer_rebuild.before_publish", base=base)
        for sid in sorted(rebuilt):
            os.replace(sbase + ctx.to_ext(sid), base + ctx.to_ext(sid))
            faults.fire("ec.peer_rebuild.after_publish", base=base, shard=sid)
            report.rebuilt.append(sid)
        fsync_dir(base + ".ecsum")
    finally:
        _clear_staging(sdir)
    return report
