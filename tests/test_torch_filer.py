"""PyTorch port: the filer's core (seaweedfs_tpu_torch/filer: entries,
chunks, manifests, the three stores, POSIX locks, the meta log, `Filer`),
held against the JAX package on the CPU. Every comparison is exact:

- `Entry` protobuf bytes from both packages' constructors and codecs, and
  `normalize_path` / `split_path` on odd paths;
- a seeded sequence of store operations (inserts, deletes, folder
  deletes, listings with `start_from` / `limit` / `prefix`, finds, KV with
  `kv_put_if_absent`) through each of the three stores of each package:
  every answer equal between the packages and among the three stores;
- an `SSTableStore` directory byte-identical, file for file, between the
  packages under one pinned clock: open, after WAL-only writes, after
  flushes and a compaction, after a torn WAL tail and its replay, after
  close; and each package opens the other's directory;
- `visible_intervals`, `read_chunk_views` and `total_size` equal over
  hypothesis-generated overlapping chunk lists; a 1001-chunk list
  manifestized to the same layout, resolved and GC-expanded to the same
  chunks;
- `PosixLockManager` answers equal over a seeded sequence with lease
  expiry on a stepped monotonic clock;
- `MetaLog` files, `read_since`, rotation, retention and
  `dropped_before_ts` equal over seeded events;
- `Filer` on twin clusters (a JAX master and volume server under the JAX
  `Filer`, a port master and volume server under the port's): contents
  sha256-equal, entries and the events they cause equal once chunk fids,
  hard-link ids and timestamps are masked (a fid is compared through the
  bytes it reads), inlining at 512 bytes, hard links across rename and
  delete, TTL expiry, directory rename, recursive delete with the chunk GC
  (the needles answer 404 after `flush_gc`), manifests, and
  `apply_remote_event`'s last-writer-wins; the meta log's records equal
  less `tsNs`.

A remote-mount entry's read-through is held against the JAX package in
tests/test_torch_remote.py. The port's one divergence: a recursive delete
beside a write committed by another connection completes, where the JAX
delete under a SQL store's open cursor fails ("database is locked").
"""

import dataclasses
import hashlib
import threading
import time
import types

import numpy as np
import pytest
from conftest import wait_for
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from test_torch_volume_server import _ports

import seaweedfs_tpu.filer.abstract_sql_store as j_sql
import seaweedfs_tpu.filer.chunks as j_chunks
import seaweedfs_tpu.filer.entry as j_entry
import seaweedfs_tpu.filer.filer as j_filer
import seaweedfs_tpu.filer.filer_store as j_store
import seaweedfs_tpu.filer.locks as j_locks
import seaweedfs_tpu.filer.manifest as j_manifest
import seaweedfs_tpu.filer.meta_log as j_meta_log
import seaweedfs_tpu.filer.notification as j_notification
import seaweedfs_tpu.filer.sstable_store as j_sst
from seaweedfs_tpu.server.master import MasterServer as JaxMasterServer
from seaweedfs_tpu.server.volume_server import VolumeServer as JaxVolumeServer
import seaweedfs_tpu_torch.filer.abstract_sql_store as p_sql
import seaweedfs_tpu_torch.filer.chunks as p_chunks
import seaweedfs_tpu_torch.filer.entry as p_entry
import seaweedfs_tpu_torch.filer.filer as p_filer
import seaweedfs_tpu_torch.filer.filer_store as p_store
import seaweedfs_tpu_torch.filer.locks as p_locks
import seaweedfs_tpu_torch.filer.manifest as p_manifest
import seaweedfs_tpu_torch.filer.meta_log as p_meta_log
import seaweedfs_tpu_torch.filer.notification as p_notification
import seaweedfs_tpu_torch.filer.sstable_store as p_sst
from seaweedfs_tpu_torch.pb import filer_pb2 as fpb
from seaweedfs_tpu_torch.server.master import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer

PKGS = {
    "jax": types.SimpleNamespace(
        entry=j_entry, chunks=j_chunks, manifest=j_manifest, store=j_store, sql=j_sql,
        sst=j_sst, locks=j_locks, meta_log=j_meta_log, notification=j_notification,
        filer=j_filer, master=JaxMasterServer, volume=JaxVolumeServer),
    "port": types.SimpleNamespace(
        entry=p_entry, chunks=p_chunks, manifest=p_manifest, store=p_store, sql=p_sql,
        sst=p_sst, locks=p_locks, meta_log=p_meta_log, notification=p_notification,
        filer=p_filer, master=MasterServer, volume=VolumeServer),
}


def test_the_packages_share_one_filer_proto():
    import seaweedfs_tpu.pb.filer_pb2 as j_fpb

    assert j_fpb.Entry is fpb.Entry
    assert j_fpb.DESCRIPTOR.serialized_pb == fpb.DESCRIPTOR.serialized_pb


class PinnedClock:
    """time.time / time.time_ns as a counter from one start, for the
    test's own thread only (any other thread keeps the real clock):
    `new_entry` stamps mtime and crtime, so byte-identity across the
    packages needs both clocks pinned the same way."""

    START_NS = 1_700_000_000_000_000_000

    def __init__(self):
        self._real_ns = time.time_ns
        self._thread = threading.get_ident()
        self.reset()

    def reset(self):
        self.ns = self.START_NS

    def time_ns(self):
        if threading.get_ident() != self._thread:
            return self._real_ns()
        self.ns += 1_000
        return self.ns

    def time(self):
        return self.time_ns() / 1e9


@pytest.fixture
def clock(monkeypatch):
    c = PinnedClock()
    monkeypatch.setattr(time, "time", c.time)
    monkeypatch.setattr(time, "time_ns", c.time_ns)
    return c


def files_of(d) -> dict:
    return {p.relative_to(d).as_posix(): p.read_bytes() for p in sorted(d.rglob("*")) if p.is_file()}


# ------------------------------------------------------------------ entries


def seeded_entries(pkg, seed: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(12):
        is_dir = bool(i % 5 == 0)
        path = f"/d{int(rng.integers(0, 3))}/sub/n{i}{'/' if i % 4 == 1 else ''}"
        e = pkg.entry.new_entry(path, is_directory=is_dir, mode=int(rng.integers(0, 0o777)),
                                mime="text/plain" if i % 3 else "")
        if not is_dir:
            if i % 2:
                e.content = rng.bytes(int(rng.integers(1, 600)))
            for k in range(int(rng.integers(0, 4))):
                e.chunks.append(fpb.FileChunk(
                    fid=f"{k + 1},{int(rng.integers(1, 1 << 30)):x}", offset=k * 1000,
                    size=int(rng.integers(1, 1000)), modified_ts_ns=int(rng.integers(1, 1 << 60)),
                    etag=rng.bytes(4).hex(), is_chunk_manifest=bool(k == 2)))
            e.attr.file_size = int(rng.integers(0, 1 << 40))
            e.attr.ttl_sec = int(rng.integers(0, 3))
        for k in range(int(rng.integers(0, 3))):
            e.extended[f"x-{k}"] = rng.bytes(5)
        if i % 4 == 3:
            e.hard_link_id = rng.bytes(16)
            e.hard_link_counter = int(rng.integers(1, 9))
        out.append(e)
    return out


def canonical(raw: bytes) -> bytes:
    """An entry's bytes with its maps' keys in a fixed order: upb writes a
    map in its hash table's order, whose seed changes per process, so a
    two-key `extended` map may come back swapped from either package."""
    return fpb.Entry.FromString(raw).SerializeToString(deterministic=True)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_entry_codec_matches_jax(clock, seed):
    got = {}
    for name, pkg in PKGS.items():
        clock.reset()
        got[name] = seeded_entries(pkg, seed)
    for je, pe in zip(got["jax"], got["port"]):
        raw = je.to_bytes()
        want = canonical(raw)
        assert fpb.Entry.FromString(pe.to_bytes()) == fpb.Entry.FromString(raw)
        assert canonical(pe.to_bytes()) == want
        assert (pe.full_path, pe.file_size, pe.mode()) == (je.full_path, je.file_size, je.mode())
        # each package decodes the other's bytes to the same entry
        back = p_entry.Entry.from_bytes(je.directory, raw)
        assert canonical(back.to_bytes()) == want and back.full_path == je.full_path
        assert canonical(j_entry.Entry.from_bytes(pe.directory, pe.to_bytes()).to_bytes()) == want


def test_path_helpers_match_jax():
    for p in ("", "/", "a", "//a//b/", "/a/b/", "a/b//c", "/x", "///", "/é/日本/"):
        assert p_entry.normalize_path(p) == j_entry.normalize_path(p), p
        if p.strip("/"):
            assert p_entry.split_path(p) == j_entry.split_path(p), p
    assert p_entry.split_path("/") == j_entry.split_path("/") == ("/", "")


# ------------------------------------------------------------------- stores

STORES = {
    "memory": lambda pkg, d: pkg.store.MemoryStore(),
    "sqlite": lambda pkg, d: pkg.store.SqliteStore(str(d / "filer.db")),
    "sstable": lambda pkg, d: pkg.sst.SSTableStore(str(d / "sst"), memtable_limit=4096,
                                                   compact_at=3),
}
DIRS = ("/", "/a", "/a/b", "/a/bc", "/a/b/c", "/z")
NAMES = ("x", "y", "x1", "x10", "x2", "ab", "abc", "b", "é", "日本", "x~")
KEYS = tuple(f"k{i}".encode() for i in range(8)) + (b"hl:\x00\xff", b"")


def store_ops(seed: int, n: int = 400) -> list:
    rng = np.random.default_rng(seed)

    def pick(seq):
        return seq[int(rng.integers(len(seq)))]

    ops = []
    for _ in range(n):
        r = int(rng.integers(0, 100))
        if r < 40:
            ops.append(("insert", pick(DIRS), pick(NAMES), int(rng.integers(0, 5000)),
                        bool(rng.integers(0, 4) == 0)))
        elif r < 50:
            ops.append(("delete", pick(DIRS), pick(NAMES)))
        elif r < 52:
            ops.append(("delete_folder_children", pick(DIRS)))
        elif r < 66:
            ops.append(("list", pick(DIRS), pick(("",) + NAMES), pick((1, 2, 3, 5, 1024)),
                        pick(("", "", "x", "a", "日", "zz"))))
        elif r < 72:
            ops.append(("find", pick(DIRS), pick(NAMES)))
        elif r < 82:
            ops.append(("kv_put", pick(KEYS), rng.bytes(int(rng.integers(1, 40)))))
        elif r < 86:
            ops.append(("kv_delete", pick(KEYS)))
        elif r < 93:
            ops.append(("kv_put_if_absent", pick(KEYS), rng.bytes(int(rng.integers(1, 40)))))
        else:
            ops.append(("kv_get", pick(KEYS)))
    return ops


def run_store_ops(pkg, store, ops) -> list:
    out = []
    for op in ops:
        kind = op[0]
        if kind == "insert":
            _, d, name, size, is_dir = op
            e = pkg.entry.Entry(directory=d, name=name, is_directory=is_dir)
            e.attr.file_size = size
            e.attr.mtime = size
            e.content = bytes([size % 251]) * (size % 97)
            store.insert(e)
        elif kind == "delete":
            store.delete(op[1], op[2])
        elif kind == "delete_folder_children":
            store.delete_folder_children(op[1])
        elif kind == "list":
            _, d, start, limit, prefix = op
            out.append([(e.directory, e.name, e.to_bytes())
                        for e in store.list(d, start_from=start, limit=limit, prefix=prefix)])
        elif kind == "find":
            try:
                out.append(store.find(op[1], op[2]).to_bytes())
            except pkg.store.NotFound:
                out.append(None)
        elif kind == "kv_put":
            store.kv_put(op[1], op[2])
        elif kind == "kv_delete":
            store.kv_delete(op[1])
        elif kind == "kv_put_if_absent":
            out.append(store.kv_put_if_absent(op[1], op[2]))
        else:
            out.append(store.kv_get(op[1]))
    # the end state: every directory's whole listing and every key
    out.append({d: [e.name for e in store.list(d, limit=10_000)] for d in DIRS})
    out.append({k: store.kv_get(k) for k in KEYS})
    return out


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("kind", list(STORES))
def test_store_ops_match_jax(tmp_path, kind, seed):
    ops = store_ops(seed)
    got = {}
    for name, pkg in PKGS.items():
        d = tmp_path / name
        d.mkdir()
        store = STORES[kind](pkg, d)
        got[name] = run_store_ops(pkg, store, ops)
        store.close()
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("seed", [5, 6])
def test_the_three_stores_answer_alike(tmp_path, seed):
    ops = store_ops(seed)
    got = {}
    for kind in STORES:
        d = tmp_path / kind
        d.mkdir()
        store = STORES[kind](PKGS["port"], d)
        got[kind] = run_store_ops(PKGS["port"], store, ops)
        store.close()
    assert got["sqlite"] == got["memory"]
    assert got["sstable"] == got["memory"]


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
@pytest.mark.parametrize("kind", ["sqlite", "sstable"])
def test_a_store_written_by_one_package_opens_in_the_other(tmp_path, kind, writer, reader):
    ops = store_ops(7, 200)
    store = STORES[kind](PKGS[writer], tmp_path)
    run_store_ops(PKGS[writer], store, ops)
    want = {d: [e.to_bytes() for e in store.list(d, limit=10_000)] for d in DIRS}
    kv = {k: store.kv_get(k) for k in KEYS}
    store.close()
    other = STORES[kind](PKGS[reader], tmp_path)
    assert {d: [e.to_bytes() for e in other.list(d, limit=10_000)] for d in DIRS} == want
    assert {k: other.kv_get(k) for k in KEYS} == kv
    other.close()


def sstable_case(pkg, d, ops) -> list:
    """Snapshots of an SSTableStore directory through its life: WAL-only,
    flushed and compacted, a torn WAL tail replayed, closed."""
    snaps = []

    def fill(store, part):
        for op in part:
            if op[0] == "insert":
                _, dd, name, size, is_dir = op
                e = pkg.entry.new_entry(f"{dd.rstrip('/')}/{name}", is_directory=is_dir)
                e.content = bytes([size % 251]) * (size % 300)
                store.insert(e)
            elif op[0] == "delete":
                store.delete(op[1], op[2])
            elif op[0] == "delete_folder_children":
                store.delete_folder_children(op[1])
            elif op[0] == "kv_put":
                store.kv_put(op[1], op[2])
            elif op[0] == "kv_delete":
                store.kv_delete(op[1])
            elif op[0] == "kv_put_if_absent":
                store.kv_put_if_absent(op[1], op[2])

    store = pkg.sst.SSTableStore(str(d), memtable_limit=1 << 20)
    fill(store, ops[:30])
    snaps.append(files_of(d))  # the WAL alone
    store.memtable_limit = 2048
    store.compact_at = 2
    fill(store, ops[30:250])
    snaps.append(files_of(d))  # flushed segments and at least one compaction
    store.flush()
    snaps.append(files_of(d))
    fill(store, ops[250:300])
    # a crash: the WAL's last record torn, the handles dropped unflushed
    store._wal.write(b"\x40\x00\x00\x00\x12\x34\x56\x78partial")
    store._wal.flush()
    store._wal.close()
    for seg in store._segments:
        seg.close()
    snaps.append(files_of(d))
    store = pkg.sst.SSTableStore(str(d), memtable_limit=2048, compact_at=2)
    snaps.append(files_of(d))  # the torn tail truncated by the replay
    fill(store, ops[300:])
    snaps.append([(e.directory, e.name, e.to_bytes()) for dd in DIRS for e in store.list(dd, limit=10_000)])
    store.close()
    snaps.append(files_of(d))
    return snaps


@pytest.mark.parametrize("seed", [8, 9])
def test_sstable_directory_is_byte_identical(tmp_path, clock, seed):
    ops = store_ops(seed)
    got = {}
    for name, pkg in PKGS.items():
        clock.reset()
        d = tmp_path / name
        got[name] = sstable_case(pkg, d, ops)
    assert len(got["jax"]) == len(got["port"])
    for i, (js, ps) in enumerate(zip(got["jax"], got["port"])):
        assert ps == js, f"snapshot {i}"
    names = [set(s) for s in got["port"] if isinstance(s, dict)]
    assert any(any(n.startswith("seg-") for n in s) for s in names)
    assert got["port"][3]["wal.log"] != got["port"][4]["wal.log"]  # the torn tail went
    # each package opens the other's final directory
    for reader, writer in (("port", "jax"), ("jax", "port")):
        store = PKGS[reader].sst.SSTableStore(str(tmp_path / writer))
        assert [(e.directory, e.name, e.to_bytes()) for dd in DIRS
                for e in store.list(dd, limit=10_000)] == got[writer][5]
        store.close()


# ------------------------------------------------------------ chunks, manifests

chunk_specs = st.lists(st.tuples(st.integers(0, 300), st.integers(0, 120), st.integers(0, 12)),
                       max_size=14)


def as_chunks(spec) -> list:
    return [fpb.FileChunk(fid=f"{i + 1},{i:x}", offset=o, size=s, modified_ts_ns=ts)
            for i, (o, s, ts) in enumerate(spec)]


@settings(max_examples=300, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(chunk_specs, st.integers(0, 450), st.integers(0, 450))
def test_chunk_views_match_jax(spec, offset, size):
    chunks = as_chunks(spec)
    want = [(s, e, c.SerializeToString()) for s, e, c in j_chunks.visible_intervals(chunks)]
    assert [(s, e, c.SerializeToString()) for s, e, c in p_chunks.visible_intervals(chunks)] == want
    assert [dataclasses.astuple(v) for v in p_chunks.read_chunk_views(chunks, offset, size)] == \
        [dataclasses.astuple(v) for v in j_chunks.read_chunk_views(chunks, offset, size)]
    assert p_chunks.total_size(chunks) == j_chunks.total_size(chunks)


def manifest_case(pkg, chunks) -> dict:
    blobs: dict = {}

    def upload(blob: bytes) -> str:
        fid = f"9,{len(blobs):x}"
        blobs[fid] = blob
        return fid

    made = pkg.manifest.maybe_manifestize(upload, list(chunks))
    # a spliced entry: its manifests pass through, its plain chunks batch
    spliced = pkg.manifest.maybe_manifestize(upload, made + list(chunks[:1001]), 1000)
    return {
        "made": [c.SerializeToString() for c in made],
        "spliced": [c.SerializeToString() for c in spliced],
        "blobs": blobs,
        "resolved": [c.SerializeToString() for c in
                     pkg.manifest.resolve_manifests(blobs.__getitem__, spliced)],
        "gc": [c.SerializeToString() for c in pkg.manifest.gc_expand(blobs.__getitem__, spliced)],
        "gc_unreadable": [c.fid for c in pkg.manifest.gc_expand({}.__getitem__, made)],
        "small": pkg.manifest.maybe_manifestize(upload, list(chunks[:1000])) == list(chunks[:1000]),
    }


def test_manifests_match_jax(clock):
    rng = np.random.default_rng(10)
    sizes = rng.integers(1, 5000, 2500)
    offs = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    chunks = [fpb.FileChunk(fid=f"{i % 7 + 1},{i:x}", offset=int(o), size=int(s),
                            modified_ts_ns=int(i)) for i, (o, s) in enumerate(zip(offs, sizes))]
    got = {}
    for name, pkg in PKGS.items():
        clock.reset()
        got[name] = manifest_case(pkg, chunks)
    assert got["port"] == got["jax"]
    made = [fpb.FileChunk.FromString(b) for b in got["port"]["made"]]
    assert [c.is_chunk_manifest for c in made] == [True, True, True]
    resolved = [fpb.FileChunk.FromString(b) for b in got["port"]["resolved"]]
    assert sorted(c.SerializeToString() for c in resolved) == sorted(
        c.SerializeToString() for c in chunks + chunks[:1001])


# -------------------------------------------------------------------- locks


class SteppedClock:
    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t


def lock_ops(seed: int, n: int = 300) -> list:
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n):
        r = int(rng.integers(0, 100))
        path = f"/f{int(rng.integers(0, 3))}"
        owner = f"o{int(rng.integers(0, 4))}"
        start = int(rng.integers(0, 100))
        end = int(rng.choice([0, start + int(rng.integers(0, 50)), max(start - 5, 0)]))
        if r < 35:
            ops.append(("lock", path, owner, start, end, bool(rng.integers(0, 2)),
                        float(rng.choice([0.0, 1.0, 5.0]))))
        elif r < 50:
            ops.append(("unlock", path, owner, start, end))
        elif r < 60:
            ops.append(("renew", path, owner, float(rng.choice([0.0, 2.0]))))
        elif r < 80:
            ops.append(("test", path, start, end, bool(rng.integers(0, 2)), owner))
        elif r < 90:
            ops.append(("holders", path))
        else:
            ops.append(("advance", float(rng.choice([0.5, 2.0, 31.0]))))
    return ops


@pytest.mark.parametrize("seed", [11, 12])
def test_posix_locks_match_jax(monkeypatch, seed):
    ops = lock_ops(seed)
    got = {}
    for name, pkg in PKGS.items():
        clk = SteppedClock()
        monkeypatch.setattr(pkg.locks, "time", clk)
        lm = pkg.locks.PosixLockManager(default_lease=30.0)
        out = []
        for op in ops:
            if op[0] == "lock":
                out.append(lm.lock(op[1], op[2], op[3], op[4], exclusive=op[5], lease=op[6]))
            elif op[0] == "unlock":
                out.append(lm.unlock(*op[1:]))
            elif op[0] == "renew":
                out.append(lm.renew(op[1], op[2], lease=op[3]))
            elif op[0] == "test":
                out.append(lm.test(op[1], op[2], op[3], exclusive=op[4], owner=op[5]))
            elif op[0] == "holders":
                out.append([dataclasses.astuple(r) for r in lm.holders(op[1])])
            else:
                clk.t += op[1]
        got[name] = out
    assert got["port"] == got["jax"]
    assert any(r == (True, "") for r in got["port"]) and any(
        isinstance(r, tuple) and r[0] is False and r[1] for r in got["port"])


def test_posix_lock_semantics_and_lease_expiry(monkeypatch):
    clk = SteppedClock()
    monkeypatch.setattr(p_locks, "time", clk)
    lm = p_locks.PosixLockManager(default_lease=10.0)
    assert lm.lock("/f", "a", 0, 100) == (True, "")
    assert lm.lock("/f", "b", 50, 60) == (False, "a")
    assert lm.lock("/f", "b", 100, 200) == (True, "")  # end is exclusive
    assert lm.lock("/f", "a", 0, 0, exclusive=False) == (False, "b")  # to EOF meets b
    assert lm.test("/f", 10, 20, owner="a") == "" and lm.test("/f", 10, 20, owner="c") == "a"
    assert lm.lock("/f", "c", 5, 3) == (False, "")  # end <= start
    clk.t += 9.0
    assert lm.renew("/f", "a") == 1
    clk.t += 2.0  # b's lease is gone, a's renewed
    assert [r.owner for r in lm.holders("/f")] == ["a"]
    assert lm.lock("/f", "c", 150, 160) == (True, "")
    assert lm.unlock("/f", "a") == 1 and lm.unlock("/f", "a") == 0
    assert lm.lock("/f", "d", 0, 100, exclusive=False) == (True, "")
    assert lm.lock("/f", "e", 0, 100, exclusive=False) == (True, "")
    assert lm.lock("/f", "f", 50, 51) == (False, "d")


# ----------------------------------------------------------------- meta log


def seeded_events(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    evs = []
    ts = 1_700_000_000_000_000_000
    for i in range(n):
        ts += int(rng.integers(1, 1000))
        ev = fpb.FullEventNotification(directory=f"/d{int(rng.integers(0, 4))}", ts_ns=ts)
        r = int(rng.integers(0, 3))
        if r != 1:
            ev.event.new_entry.name = f"n{i}"
            ev.event.new_entry.content = rng.bytes(int(rng.integers(0, 60)))
            for k in range(int(rng.integers(0, 3))):
                ev.event.new_entry.chunks.add(fid=f"1,{k}", offset=k * 10, size=10)
        if r != 0:
            ev.event.old_entry.name = f"o{i}"
            ev.event.old_entry.is_directory = bool(i % 2)
        ev.event.delete_chunks = bool(r == 1)
        ev.event.is_from_other_cluster = bool(i % 5 == 0)
        evs.append(ev)
    return evs


def test_meta_log_matches_jax(tmp_path, monkeypatch):
    evs = seeded_events(13, 240)
    got = {}
    for name, pkg in PKGS.items():
        monkeypatch.setattr(pkg.meta_log, "SEGMENT_BYTES", 6000)
        monkeypatch.setattr(pkg.meta_log, "KEEP_SEGMENTS", 3)
        d = tmp_path / name
        ml = pkg.meta_log.MetaLog(str(d))
        out = {"empty": (ml.last_ts_ns, ml.oldest_retained_ts(), ml.read_since(0))}
        for ev in evs[:200]:
            ml(ev)
        # a record older than the watermark never rolls it back
        old = fpb.FullEventNotification(directory="/old", ts_ns=evs[0].ts_ns - 1)
        ml(old)
        for ev in evs[200:]:
            ml(ev)
        marks = [0, 1, evs[50].ts_ns, evs[150].ts_ns, evs[-2].ts_ns, evs[-1].ts_ns]
        out["since"] = [ml.read_since(m) for m in marks] + [ml.read_since(0, limit=7)]
        out["state"] = (ml.last_ts_ns, ml.dropped_before_ts, ml.oldest_retained_ts(),
                        ml.wait_for_events(evs[-1].ts_ns, 0.01),
                        ml.wait_for_events(evs[-2].ts_ns, 0.01))
        ml.close()
        out["files"] = files_of(d)
        again = pkg.meta_log.MetaLog(str(d))
        out["reopened"] = (again.last_ts_ns, again.dropped_before_ts, again.read_since(marks[3]))
        again.close()
        out["codec"] = [pkg.notification.event_to_json(ev) for ev in evs[:20]]
        out["decoded"] = [pkg.notification.json_to_event(r).SerializeToString()
                          for r in out["codec"]] + [pkg.notification.json_to_event({}),
                                                    pkg.notification.json_to_event({"pb": "!!"})]
        got[name] = out
    assert got["port"] == got["jax"]
    sealed = [n for n in got["port"]["files"] if n.startswith("meta-")]
    assert len(sealed) == 3 and got["port"]["state"][1] > 0  # rotated past retention
    assert got["port"]["state"][3] is False and got["port"]["state"][4] is True


# -------------------------------------------------------------------- Filer


@pytest.fixture(scope="module")
def twins(tmp_path_factory):
    """{pkg: master address}: a master and one volume server of each
    package, the port's on the CPU."""
    root = tmp_path_factory.mktemp("filer-twins")
    out, servers = {}, []
    for name, pkg in PKGS.items():
        mport = _ports()
        ms = pkg.master(ip="127.0.0.1", port=mport, vacuum_interval=3600)
        ms.start()
        vs = pkg.volume([str(root / name)], master=f"127.0.0.1:{mport}", ip="127.0.0.1",
                        port=_ports(), ec_backend="cpu")
        vs.start()
        servers += [vs, ms]
        wait_for(lambda: ms.topo.nodes, timeout=30, msg=f"the {name} volume server registered")
        out[name] = f"127.0.0.1:{mport}"
    yield out
    for s in servers:
        s.stop()


def norm_entry(p) -> bytes:
    """An Entry proto with what differs between two clusters and two runs
    masked: chunk fids, hard-link ids, timestamps."""
    q = fpb.Entry()
    q.CopyFrom(p)
    q.attributes.mtime = 0
    q.attributes.crtime = 0
    if "sw-mts" in q.extended:
        q.extended["sw-mts"] = b"ts"
    for c in q.chunks:
        c.fid = ""
        c.modified_ts_ns = 0
    if q.hard_link_id:
        q.hard_link_id = b"hl"
    return q.SerializeToString(deterministic=True)


def norm_event(ev) -> tuple:
    return (ev.directory, norm_entry(ev.event.old_entry), norm_entry(ev.event.new_entry),
            ev.event.delete_chunks, ev.event.is_from_other_cluster)


def norm_record(rec: dict) -> tuple:
    ev = p_notification.json_to_event(rec)
    rest = {k: v for k, v in rec.items() if k not in ("tsNs", "pb")}
    return tuple(sorted((k, repr(v)) for k, v in rest.items())) + norm_event(ev)


def sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def gone(f, fids) -> bool:
    """Every fid's needle answers 404: the volume server's GET fails."""
    for fid in fids:
        try:
            f.ops.read(fid, fast=False)
            return False
        except LookupError:
            continue
    return True


def walk(f, d="/") -> list:
    out = []
    for e in f.store.list(d, limit=100_000):
        out.append((e.full_path, norm_entry(e.to_proto())))
        if e.is_directory:
            out += walk(f, e.full_path)
    return out


def sc_write_read(pkg, f, out):
    rng = np.random.default_rng(20)
    sizes = [0, 1, 100, 511, 512, 513, 4095, 16384, 16385, 50_000, 3 * 16384 + 7]
    bodies = {f"/w/s{n}.bin": rng.bytes(n) for n in sizes}
    for path, body in bodies.items():
        e = f.write_file(path, body, mime="application/x-test")
        out.append(("written", path, norm_entry(e.to_proto()), bool(e.content), len(e.chunks)))
        for c in e.chunks:
            got = f.ops.read(c.fid)
            out.append(("chunk", c.offset, c.size, sha(got), c.etag == hashlib.md5(got).hexdigest()))
    for path, body in bodies.items():
        out.append(("read", path, sha(f.read_file(path)) == sha(body)))
        n = len(body)
        for off, size in ((0, 10), (n // 3, n // 2 + 1), (max(n - 5, 0), 20), (n + 3, 5)):
            out.append(("range", path, off, size, f.read_file(path, off, size) == body[off:off + size]))
    out.append(("list", [e.name for e in f.list_entries("/w", limit=3)],
                [e.name for e in f.list_entries("/w", start_from="s16384.bin", limit=4)],
                [e.name for e in f.list_entries("/w", prefix="s5")]))
    # grow past the inline limit, then shrink back: the old chunks GC'd
    e = f.write_file("/w/grow", b"tiny")
    e2 = f.write_file("/w/grow", rng.bytes(20_000))
    old = [c.fid for c in e2.chunks]
    f.write_file("/w/grow", b"small again")
    f.flush_gc()
    wait_for(lambda: gone(f, old), timeout=20, msg="the overwritten chunks deleted")
    out.append(("grow", bool(e.content), len(e2.chunks), f.read_file("/w/grow")))
    # inline=False chunks even a tiny body
    e = f.write_file("/w/forced", b"abc", inline=False)
    out.append(("forced", len(e.chunks), f.read_file("/w/forced")))
    # the root, a directory, and a type conflict
    out.append(("root", f.find_entry("/").is_directory, f.find_entry("/w").is_directory))
    with pytest.raises(pkg.filer.FilerError) as ei:
        f.create_entry(pkg.entry.new_entry("/w", is_directory=False))
    out.append(("conflict", str(ei.value)))
    with pytest.raises(pkg.filer.FilerError) as ei:
        f.write_file("/w/s1.bin/under", b"x")
    out.append(("not a dir", str(ei.value)))
    with pytest.raises(pkg.filer.FilerError) as ei:
        f.read_file("/w")
    out.append(("read dir", str(ei.value)))
    # metadata read-modify-write, and fs.configure path rules
    m = f.mutate_entry("/w/s100.bin", lambda en: en.extended.__setitem__("tag", b"v"))
    out.append(("mutated", norm_entry(m.to_proto())))
    f.store.kv_put(b"fs.configure", b'{"locations": [{"location_prefix": "/w/rule", '
                   b'"collection": "", "ttl_sec": 7}]}')
    e = f.write_file("/w/rule/x", b"ruled")
    out.append(("rule", f.path_conf("/w/rule/x"), e.attr.ttl_sec, f.path_conf("/elsewhere")))


def sc_hardlinks(pkg, f, out):
    rng = np.random.default_rng(21)
    a = rng.bytes(40_000)
    f.write_file("/h/a", a)
    dst = f.hard_link("/h/a", "/h/b")
    out.append(("linked", norm_entry(dst.to_proto()), dst.hard_link_counter,
                f.store.kv_get(b"hl:" + dst.hard_link_id)))
    b = rng.bytes(30_000)
    first = f.find_entry("/h/a")
    f.write_file("/h/b", b)  # through one name: the other sees it
    out.append(("sibling", f.read_file("/h/a") == b, f.read_file("/h/b") == b))
    f.flush_gc()
    wait_for(lambda: gone(f, [c.fid for c in first.chunks]), timeout=20,
             msg="the superseded shared chunks deleted")
    f.rename("/h/a", "/h/c")
    out.append(("renamed", f.exists("/h/a"), f.read_file("/h/c") == b,
                norm_entry(f.find_entry("/h/c").to_proto())))
    cur = [c.fid for c in f.find_entry("/h/c").chunks]
    f.delete_entry("/h/b")
    f.flush_gc()
    time.sleep(0.3)
    out.append(("one name left", f.read_file("/h/c") == b, gone(f, cur),
                f.store.kv_get(b"hl:" + dst.hard_link_id)))
    f.delete_entry("/h/c")
    f.flush_gc()
    wait_for(lambda: gone(f, cur), timeout=20, msg="the last name's chunks deleted")
    out.append(("last name gone", f.store.kv_get(b"hl:" + dst.hard_link_id),
                f.store.kv_get(b"hlmeta:" + dst.hard_link_id)))
    f.write_file("/h/d", b"small")
    f.hard_link("/h/d", "/h/e")
    for src, dst_path in (("/h", "/h2"), ("/h/d", "/h/e"), ("/h/nope", "/h/f")):
        try:
            f.hard_link(src, dst_path)
            out.append(("hard_link", src, "ok"))
        except (pkg.filer.FilerError, pkg.store.NotFound) as e:
            out.append(("hard_link", src, type(e).__name__, str(e)))


class ShiftedTime:
    """The `time` module with time() moved forward by `offset` seconds:
    a Filer's expiry check reads it, so a TTL elapses without a sleep."""

    def __init__(self):
        self.offset = 0.0

    def __getattr__(self, name):
        return getattr(time, name)

    def time(self):
        return time.time() + self.offset


def sc_ttl(pkg, f, out):
    clock = ShiftedTime()
    pkg.filer.time = clock
    try:
        f.write_file("/t/inline", b"short lived", ttl_sec=60)
        e = f.write_file("/t/chunked", bytes(5000), ttl_sec=60)
        f.write_file("/t/keep", b"stays")
        out.append(("before", [x.name for x in f.list_entries("/t")]))
        clock.offset = 61.0
        out.append(("after", [x.name for x in f.list_entries("/t")], f.exists("/t/inline"),
                    f.exists("/t/chunked")))
        f.flush_gc()
        wait_for(lambda: gone(f, [c.fid for c in e.chunks]), timeout=20,
                 msg="the expired entry's chunks deleted")
    finally:
        pkg.filer.time = time


def sc_rename_dir(pkg, f, out):
    rng = np.random.default_rng(22)
    bodies = {p: rng.bytes(int(n)) for p, n in (("/d1/x", 300), ("/d1/sub/y", 20_000),
                                              ("/d1/sub/deeper/z", 9000), ("/other", 12_000))}
    for p, body in bodies.items():
        f.write_file(p, body)
    f.rename("/d1", "/d2")
    out.append(("tree", walk(f)))
    for p, body in bodies.items():
        q = p.replace("/d1", "/d2", 1)
        out.append(("moved", q, f.read_file(q) == body, f.exists(p) if p != q else None))
    for old, new in (("/d2", "/d2"), ("/d2", "/other"), ("/nope", "/x")):
        try:
            f.rename(old, new)
            out.append(("rename", old, new, "ok"))
        except (pkg.filer.FilerError, pkg.store.NotFound) as e:
            out.append(("rename", old, new, type(e).__name__, str(e)))
    # a file renamed over a file: the destination's chunks GC'd
    dest = [c.fid for c in f.find_entry("/other").chunks]
    f.rename("/d2/sub/y", "/other")
    f.flush_gc()
    wait_for(lambda: gone(f, dest), timeout=20, msg="the overwritten destination's chunks deleted")
    out.append(("over a file", f.read_file("/other") == bodies["/d1/sub/y"], walk(f)))


def sc_recursive_delete(pkg, f, out):
    rng = np.random.default_rng(23)
    fids = {}
    for i in range(6):
        path = f"/r/{'a/' * (i % 3)}f{i}"
        fids[path] = [c.fid for c in f.write_file(path, rng.bytes(8000 + 3000 * i)).chunks]
    f.write_file("/r/inline", b"in the entry")
    with pytest.raises(pkg.filer.FilerError) as ei:
        f.delete_entry("/r")
    out.append(("not empty", str(ei.value)))
    orphan = fids.pop("/r/a/a/f2")
    f.delete_entry("/r/a/a/f2", gc_chunks=False)  # its chunks kept
    f.delete_entry("/r", recursive=True)
    out.append(("after", walk(f, "/"), f.exists("/r")))
    f.flush_gc()
    wait_for(lambda: gone(f, [x for v in fids.values() for x in v]), timeout=30,
             msg="every chunk of the deleted tree deleted")
    out.append(("kept", [len(f.ops.read(x)) for x in orphan]))
    f.delete_entry("/never/there")  # a missing path is a no-op


def sc_manifest(pkg, f, out):
    # 1001 chunk protos: create_entry manifestizes them into two blobs it
    # uploads, and resolve_chunks reads the blobs back
    chunks = [fpb.FileChunk(fid=f"7,{i:x}", offset=i * 100, size=100, modified_ts_ns=i + 1)
              for i in range(1001)]
    e = pkg.entry.new_entry("/m/huge")
    e.chunks = list(chunks)
    f.create_entry(e)
    stored = f.find_entry("/m/huge")
    out.append(("layout", [(c.offset, c.size, c.is_chunk_manifest) for c in stored.chunks]))
    out.append(("resolved", [c.SerializeToString() for c in f.resolve_chunks(stored)]
                == [c.SerializeToString() for c in chunks]))
    f.delete_entry("/m/huge", gc_chunks=False)
    # a real file past a lowered threshold: manifests read back and GC'd
    f.manifest_threshold = 4
    f.chunk_size = 1024
    body = np.random.default_rng(24).bytes(9 * 1024 + 5)
    e = f.write_file("/m/real", body)
    out.append(("real", [(c.offset, c.size, c.is_chunk_manifest) for c in e.chunks],
                f.read_file("/m/real") == body, f.read_file("/m/real", 1000, 3000) == body[1000:4000]))
    every = [c.fid for c in pkg.manifest.gc_expand(f.ops.read, e.chunks)]
    out.append(("gc_expand", len(every)))
    f.delete_entry("/m/real")
    f.flush_gc()
    wait_for(lambda: gone(f, every), timeout=30, msg="the manifests and their chunks deleted")


def sc_remote_events(pkg, f, out):
    def ev(d, ts, new=None, old=None):
        x = fpb.FullEventNotification(directory=d, ts_ns=ts)
        if new is not None:
            x.event.new_entry.CopyFrom(new)
        if old is not None:
            x.event.old_entry.CopyFrom(old)
        return x

    def entry(name, content=b"", is_dir=False, mts=None, hl=b""):
        p = fpb.Entry(name=name, content=content, is_directory=is_dir, hard_link_id=hl)
        p.attributes.mtime = 1_700_000_000
        if mts is not None:
            p.extended["sw-mts"] = str(mts).encode()
        return p

    base = time.time_ns() + 10**12  # after every local stamp of this scenario
    steps = [
        ev("/p/q", base + 100, new=entry("f", b"v1", mts=base + 100)),
        ev("/p/q", base + 50, new=entry("f", b"older", mts=base + 50)),  # LWW: dropped
        ev("/p/q", base + 100, new=entry("f", b"same ts", mts=base + 100)),  # equal: dropped
        ev("/p/q", base + 200, new=entry("f", b"v2", mts=base + 200)),
        ev("/p/q", base + 150, old=entry("f")),  # an older delete: dropped
        ev("/p/q", base + 300, new=entry("f", is_dir=True, mts=base + 300)),  # type conflict
        ev("/p", base + 400, old=entry("q", is_dir=True)),  # a non-empty dir: kept
        ev("/p/q", base + 500, old=entry("f")),
        ev("/p", base + 600, old=entry("q", is_dir=True)),
        ev("/p", base + 700),  # neither entry
        ev("/p/hl", base + 800, new=entry("g", b"linked", mts=base + 800, hl=b"L" * 16)),
        ev("/p/gone", base + 900, old=entry("never")),
    ]
    for x in steps:
        out.append(("apply", f.apply_remote_event(x), walk(f, "/p")))
    out.append(("hlmeta", f.store.kv_get(b"hlmeta:" + b"L" * 16) is not None,
                f.read_file("/p/hl/g")))
    # a local write after a remote one: the newer local stamp wins
    f.write_file("/p/hl/g", b"local")
    out.append(("local", f.read_file("/p/hl/g"),
                f.apply_remote_event(ev("/p/hl", base + 850, new=entry("g", b"stale", mts=base + 850)))))


SCENARIOS = {
    "write_read": sc_write_read, "hardlinks": sc_hardlinks, "ttl": sc_ttl,
    "rename_dir": sc_rename_dir, "recursive_delete": sc_recursive_delete,
    "manifest": sc_manifest, "remote_events": sc_remote_events,
}
FILER_STORES = {
    "memory": lambda pkg, d: pkg.store.MemoryStore(),
    "sqlite": lambda pkg, d: pkg.store.SqliteStore(str(d / "filer.db")),
    "sstable": lambda pkg, d: pkg.sst.SSTableStore(str(d / "sst")),
}
SCENARIO_STORE = {"write_read": "sqlite", "hardlinks": "sstable", "rename_dir": "sstable",
                  "recursive_delete": "sqlite"}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_filer_matches_jax(twins, tmp_path, scenario):
    got = {}
    for name, pkg in PKGS.items():
        d = tmp_path / name
        d.mkdir()
        store = FILER_STORES[SCENARIO_STORE.get(scenario, "memory")](pkg, d)
        f = pkg.filer.Filer(store, master=twins[name], chunk_size=16 * 1024)
        events = []
        f.subscribe(events.append)
        ml = pkg.meta_log.MetaLog(str(d / "meta"))
        f.subscribe(ml)
        out = []
        try:
            SCENARIOS[scenario](pkg, f, out)
            out.append(("namespace", walk(f)))
        finally:
            f.close()
        ts = [e.ts_ns for e in events]
        assert ts == sorted(set(ts)) or scenario == "remote_events"  # strictly increasing
        out.append(("events", [norm_event(e) for e in events]))
        out.append(("meta log", [norm_record(r) for r in ml.read_since(0, limit=100_000)]))
        ml.close()
        got[name] = out
    assert len(got["port"]) == len(got["jax"])
    for i, (p, j) in enumerate(zip(got["port"], got["jax"])):
        assert p == j, f"step {i}: {p[0]}"


def test_inline_limit_and_defaults_match_jax():
    assert p_filer.INLINE_LIMIT == j_filer.INLINE_LIMIT == 512
    assert p_filer.DEFAULT_CHUNK_SIZE == j_filer.DEFAULT_CHUNK_SIZE == 4 << 20
    assert p_manifest.MANIFEST_BATCH == j_manifest.MANIFEST_BATCH == 1000


@pytest.mark.parametrize("store_kind", ["sqlite", "memory"])
def test_recursive_delete_beside_a_concurrent_writer(tmp_path, store_kind):
    """A write committed by another connection while a recursive delete
    runs (a replication sink writing into the same filer does this): the
    JAX delete, under the SQL store's open cursor, fails with "database
    is locked" on the next child; the port reads the listing whole first
    and deletes every child. Without the writer both delete alike."""
    got = {}
    for name, pkg in PKGS.items():
        if store_kind == "sqlite":
            store = pkg.store.SqliteStore(str(tmp_path / f"{name}.db"))
        else:
            store = pkg.store.MemoryStore()
        f = pkg.filer.Filer(store, master="127.0.0.1:1")
        for i in range(6):
            f.write_file(f"/x/g/s{i}.txt", b"inlined %d" % i)
        f.write_file("/x/keep.txt", b"kept")
        commits = []

        def writer(_commits=commits, _store=store):
            _store.kv_put(b"k%d" % len(_commits), b"another connection")
            _commits.append(1)

        def on_event(*a, **kw):
            t = threading.Thread(target=writer)  # its own connection
            t.start()
            t.join(timeout=30)

        f.subscribe(on_event)
        try:
            f.delete_entry("/x/g", recursive=True)
            outcome = "deleted"
        except Exception as e:  # noqa: BLE001 — the JAX store's error, compared
            outcome = f"{type(e).__name__}: {e}"
        got[name] = (outcome, [e.name for e in f.list_entries("/x")], len(commits) > 0)
        f.close()
    assert got["port"] == ("deleted", ["keep.txt"], True)
    if store_kind == "sqlite":
        assert got["jax"][0] == "OperationalError: database is locked"
    else:
        assert got["jax"] == got["port"]
