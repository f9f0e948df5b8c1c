"""Durable-parity MQ log segments: the partition side of streaming EC.

Port of seaweedfs_tpu/mq/stream_parity.py. A durable-parity partition
feeds every appended record (the segment files'
`[len|offset|ts|key|value]` wire bytes) into an
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

``SEAWEED_EC_STREAM_REMOTE_ROOTS`` places some of a generation's stream
shards on other hosts (`remote_roots`): on a mounted path through a
symlink, or on a volume server's net plane, pushed at every flush over
the blob-write opcode. That is what lets an unsealed tail outlive the
broker's host.

`ParityFlusher` is the broker's one daemon that bounds every
partition's lag (`MqBroker.parity_sweep`), as in the JAX package.
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
import threading

from ..ec.backend import get_backend
from ..ec.context import ECContext, ECError
from ..ec.net_plane import NetPlaneClient, NetPlaneError, NetPlaneUnavailable, derive_port
from ..ec.placement import NodeView, plan_shard_placement
from ..ec.stream_encode import (
    EcStreamEncoder,
    load_stream_journal,
    recover_stream,
    stream_block_size,
    stream_small_block_size,
)

from ..utils.security import sign_jwt
from .log_buffer import _REC, encode_record

log = logging.getLogger(__name__)

GEN_PREFIX = "gen-"


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


def remote_roots() -> dict[str, str]:
    """SEAWEED_EC_STREAM_REMOTE_ROOTS ("name=root[,name=root...]"):
    remote-host roots that a durable-parity partition's stream shards may
    be placed on, spread by `plan_shard_placement`. Two root forms:

    - ``name=/path``: a mounted path (another host's disk): the planned
      shard becomes a symlink the encoder's O_CREAT follows,
      headroom-gated by statvfs;
    - ``name=net:host:grpcport[/subdir]``: a volume server's net plane.
      The shard stays a local file and every flush pushes its newly
      durable extent over the blob-write opcode (`write_blob`, fsync
      before the ACK), under the peer's stream-blob root. Pruned
      generations unlink their remote blobs.

    Unset (the default) keeps every shard in the local parity dir."""
    spec = os.environ.get("SEAWEED_EC_STREAM_REMOTE_ROOTS", "")
    roots: dict[str, str] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part or "=" not in part:
            continue
        name, _, path = part.partition("=")
        if name.strip() and path.strip():
            roots[name.strip()] = path.strip()
    return roots


def _statvfs_free(path: str) -> int:
    try:
        st = os.statvfs(path)
        return int(st.f_bavail) * int(st.f_frsize)
    except OSError:
        return -1


def _parse_net_root(spec: str):
    """``net:host:grpcport[/subdir]`` -> ((host, plane_port), subdir).
    Raises ValueError on a malformed spec."""
    rest = spec[len("net:"):]
    hostport, _, sub = rest.partition("/")
    host, _, port = hostport.rpartition(":")
    if not host or not port:
        raise ValueError(f"malformed net root {spec!r}")
    return (host, derive_port(int(port))), sub.strip("/")


_NET_CLIENT = None
_NET_CLIENT_LOCK = threading.Lock()


def _net_client() -> NetPlaneClient:
    """The shared NetPlaneClient of net: shard pushes, built lazily: one
    cached connection per peer, shared by every partition."""
    global _NET_CLIENT
    with _NET_CLIENT_LOCK:
        if _NET_CLIENT is None:
            _NET_CLIENT = NetPlaneClient()
        return _NET_CLIENT


def _net_jwt() -> str:
    """Blob-scoped token for keyed clusters (SEAWEED_JWT_KEY): the
    receiving server's blob resolver verifies scope "blob"."""
    key = os.environ.get("SEAWEED_JWT_KEY", "")
    if not key:
        return ""
    return sign_jwt(key, "blob", ttl_seconds=60)


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
        self.ns, self.topic_name, self.partition = ns, name, partition
        # remote shard placement (see remote_roots), snapshot at
        # construction so one partition's generations place consistently
        self.remote_roots = remote_roots()
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
        # net: roots: per-gen plan of local shard path -> ((host, port),
        # remote path), and the per-path byte watermark already pushed
        # and fsynced on the peer
        self._net_shards: dict[int, dict[str, tuple]] = {}
        self._net_pushed: dict[str, int] = {}

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
        self._place_gen_shards(self._gen_base_path(self._gen))
        self._enc = EcStreamEncoder(
            self._gen_base_path(self._gen),
            self.ctx,
            backend=self._backend_resolved(),
            block_size=self.block_size,
            small_block_size=self.small_block_size,
            meta=base_offset,
        )

    def _remote_dir(self, sub: str) -> str:
        """The partition's directory under a net: root's blob root."""
        parts = (sub, self.ns, self.topic_name, f"{self.partition:04d}")
        return "/".join(p for p in parts if p)

    def _place_gen_shards(self, base: str) -> None:
        """Plan this generation's shard files across the local parity dir
        and the remote roots with `plan_shard_placement` (spread by
        count, headroom-gated). A shard planned on a mounted root becomes
        a symlink the encoder's O_CREAT follows, so the encoder's and
        recovery's byte paths are untouched; one planned on a net: root
        stays a local file whose durable extents flushes push. No roots
        (the default) is a no-op; a root without headroom for its share
        of `rotate_bytes` is never chosen. Idempotent: existing links and
        files are left alone."""
        if not self.remote_roots:
            return
        views = [NodeView(id="", free_slots=1 << 20, free_bytes=_statvfs_free(self.dir))]
        targets: dict[str, str] = {}
        net_targets: dict[str, tuple] = {}  # name -> (addr, remote dir)
        for name, root in sorted(self.remote_roots.items()):
            if root.startswith("net:"):
                # no mount to probe: headroom is unknowable here, and the
                # peer refuses when full
                try:
                    addr, sub = _parse_net_root(root)
                except ValueError as e:
                    log.warning("remote parity root %s unusable: %s", root, e)
                    continue
                net_targets[name] = (addr, self._remote_dir(sub))
                views.append(NodeView(id=name, free_slots=1 << 20, free_bytes=1 << 50))
                continue
            # absolute: the symlink target must resolve the same from the
            # parity dir and from the process cwd
            tdir = os.path.abspath(
                os.path.join(root, self.ns, self.topic_name, f"{self.partition:04d}")
            )
            try:
                os.makedirs(tdir, exist_ok=True)
            except OSError as e:
                log.warning("remote parity root %s unusable: %s", root, e)
                continue
            targets[name] = tdir
            views.append(NodeView(id=name, free_slots=1 << 20, free_bytes=_statvfs_free(tdir)))
        if len(views) < 2:
            return
        shard_b = max(self.rotate_bytes // self.ctx.data_shards, 1)
        plan = plan_shard_placement(views, self._gen, list(range(self.ctx.total)),
                                    shard_bytes=shard_b)
        net_plan: dict[str, tuple] = {}
        for sid, node_id in sorted(plan.items()):
            if not node_id:
                continue  # planned local: a plain file
            path = base + self.ctx.to_ext(sid)
            if node_id in net_targets:
                addr, rdir = net_targets[node_id]
                net_plan[path] = (addr, "/".join((rdir, os.path.basename(path))))
                continue
            if os.path.lexists(path):
                continue
            target = os.path.join(targets[node_id], os.path.basename(path))
            try:
                os.symlink(target, path)
            except OSError as e:
                log.warning("remote shard link %s -> %s failed: %s (local file instead)",
                            path, target, e)
        if net_plan:
            self._net_shards[self._gen] = net_plan

    # one blob write per extent chunk: bounds the peer's landing and keeps
    # a slow peer from stalling a flush forever
    _NET_PUSH_CHUNK = 4 << 20

    def _push_net_shards(self) -> None:
        """Push every net-planned shard's newly durable extent
        [watermark, size) over the blob-write opcode (fsync before the
        ACK): once this returns, the pushed bytes are durable on the
        peer. Best-effort: a failed push keeps the watermark, so the next
        flush retries from the same offset; the local shard file stays
        authoritative either way."""
        with self._lock:
            work = [
                (path, addr, rpath)
                for plan in self._net_shards.values()
                for path, (addr, rpath) in sorted(plan.items())
            ]
        if not work:
            return
        jwt = _net_jwt()
        client = _net_client()
        for path, addr, rpath in work:
            try:
                size = os.path.getsize(path)
            except OSError:
                continue
            off = self._net_pushed.get(path, 0)
            if off >= size:
                continue
            try:
                with open(path, "rb") as f:
                    while off < size:
                        f.seek(off)
                        data = f.read(min(size - off, self._NET_PUSH_CHUNK))
                        if not data:
                            break
                        client.write_blob(addr, rpath, off, data, fsync=True, jwt=jwt)
                        off += len(data)
            except (NetPlaneUnavailable, NetPlaneError, OSError) as e:
                log.warning("net shard push %s -> %s stalled at %d: %s", path, rpath, off, e)
            self._net_pushed[path] = off

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
        # remote durability trails local: net-planned shards push their
        # newly flushed extents before this flush returns
        self._push_net_shards()
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
        net_plan = self._net_shards.pop(gen, None) or {}
        for path in net_plan:
            self._net_pushed.pop(path, None)
        targets = set(net_plan.values())
        # a restarted partition has no in-memory plan for older gens:
        # derive every possible remote blob path from the net: roots, so
        # pruning never leaks peer bytes
        for _name, root in sorted(self.remote_roots.items()):
            if not root.startswith("net:"):
                continue
            try:
                addr, sub = _parse_net_root(root)
            except ValueError:
                continue
            rdir = self._remote_dir(sub)
            for i in range(self.ctx.total):
                targets.add((addr, rdir + "/" + os.path.basename(base + self.ctx.to_ext(i))))
        if targets:
            jwt = _net_jwt()
            client = _net_client()
            for addr, rpath in sorted(targets):
                try:
                    client.unlink_blob(addr, rpath, jwt=jwt)
                except (NetPlaneUnavailable, NetPlaneError, OSError):
                    pass  # orphaned remote blob: collected with the root
        for i in range(self.ctx.total):
            path = base + self.ctx.to_ext(i)
            try:
                # a remotely placed shard: drop the target bytes too, or
                # pruning would orphan them on the remote root
                if os.path.islink(path):
                    _unlink_quiet(os.readlink(path))
            except OSError:
                pass
            _unlink_quiet(path)
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
        # the final tail extents (bytes the closing flush landed locally)
        self._push_net_shards()

    def delete(self) -> None:
        self.close()
        # remotely placed shards die with their gens; rmtree alone would
        # only remove the symlinks
        for g in self._gens():
            self._remove_gen(g)
        shutil.rmtree(self.dir, ignore_errors=True)


def _unlink_quiet(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        pass


class ParityFlusher(threading.Thread):
    """One broker-wide daemon bounding every partition's parity lag:
    wakes at half the lag deadline, flushes partitions over their
    bytes/age policy, rotates full generations, prunes generations
    below the broker's durability floor."""

    def __init__(self, broker, interval: float | None = None):
        super().__init__(daemon=True, name="mq-parity-flusher")
        self.broker = broker
        self.interval = (
            interval
            if interval is not None
            else max(max_lag_s_default() / 2.0, 0.01)
        )
        self._stop = threading.Event()

    def stop(self) -> None:
        self._stop.set()

    def run(self) -> None:
        while not self._stop.wait(self._next_interval()):
            try:
                self.broker.parity_sweep()
            except Exception as e:  # noqa: BLE001 — never kill the broker
                log.warning("parity sweep failed: %r", e)

    def _next_interval(self) -> float:
        """Graceful-shed hook: under sustained device oversubscription
        (residency shed level > 0) the flusher stretches its cadence —
        stream-parity flush is background device work and must throttle
        before any foreground admission is shed. Bounded stretch: the
        lag deadline still holds eventually, it just stops compounding
        an overload."""
        try:
            from ..ec.device_queue import shed_level

            lvl = shed_level()
        except Exception:  # the shed signal must never stall flushing
            lvl = 0
        return self.interval * (1 + lvl) if lvl > 0 else self.interval
