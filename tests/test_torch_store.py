"""PyTorch port: the storage engine under the `Store` (storage/ttl.py,
needle_map.py, backend.py, volume.py, store.py) and `ScrubDaemon`, held
against the JAX package on the CPU.

- Every case of the JAX package's tests/test_storage.py,
  test_needle_map_sqlite.py and test_ttl.py (its master-assignment case
  becomes a `Store` TTL-bucket case: the master comes with the volume
  server), run through both packages under one fixed clock: the same
  `.dat`/`.idx` bytes, the same reads, the same raises.
- test_group_commit.py: the batched fsyncs, a failed window failing
  every writer, window 0's fsync per needle, and the volume write crash
  matrix (a child interpreter killed at each `volume.write.*` point in
  both fsync modes, replayed by the other package too). The net-plane needle
  write comes with the volume server; its blob twin (`ec.net.write.*`
  around a blob write) is in here.
- The store and volume cases of test_tiering.py, with the JAX package's
  S3 gateway as the cold tier (test infrastructure: only the port's
  `Volume` and `Store` are under test).
- Volumes (memory and sqlite maps) written by either package opened,
  read and vacuumed by the other.
- `ScrubDaemon` over `Store(..., ec_backend="cpu")`: the cases of
  tests/test_ec_chaos.py (leaf repair in place, a quarantined shard
  remembered after a failed rebuild) and a breaker per volume, each run
  by both packages on copies of one volume and one rot: the same
  reports, shard bytes, quarantines, breaker states and legitimate
  shards.
- The `Store`'s own surface: allocate, write, read, delete, the
  plain-to-EC read fallback, partial shard unmounts, status and close.
"""

import dataclasses
import os
import re
import shutil
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest
import requests
from conftest import allocate_port

import seaweedfs_tpu.storage.needle as j_needle
import seaweedfs_tpu.storage.needle_map as j_map
import seaweedfs_tpu.storage.store as j_store
import seaweedfs_tpu.storage.super_block as j_sb
import seaweedfs_tpu.storage.ttl as j_ttl
import seaweedfs_tpu.storage.types as j_types
import seaweedfs_tpu.storage.volume as j_volume
from seaweedfs_tpu import faults as j_faults
import seaweedfs_tpu.ec as j_ec
import seaweedfs_tpu.ec.scrub as j_scrub
import seaweedfs_tpu.utils.retry as j_retry
import seaweedfs_tpu_torch.storage.needle as p_needle
import seaweedfs_tpu_torch.storage.needle_map as p_map
import seaweedfs_tpu_torch.storage.store as p_store
import seaweedfs_tpu_torch.storage.super_block as p_sb
import seaweedfs_tpu_torch.storage.ttl as p_ttl
import seaweedfs_tpu_torch.storage.types as p_types
import seaweedfs_tpu_torch.storage.volume as p_volume
from seaweedfs_tpu_torch import faults as p_faults
from seaweedfs_tpu_torch.ec import CpuBackend, ECContext, ScrubDaemon, ec_encode_volume
from seaweedfs_tpu_torch.ec.context import QUARANTINE_SUFFIX
from seaweedfs_tpu_torch.ec import net_plane
from seaweedfs_tpu_torch.storage import backend as p_backend
import seaweedfs_tpu_torch.utils.retry as p_retry


def _ns(needle, nmap, sb, types_, volume, ttl, store, faults):
    return types.SimpleNamespace(
        Needle=needle.Needle, VERSION2=needle.VERSION2, VERSION3=needle.VERSION3,
        CrcError=needle.CrcError, MemDb=nmap.MemDb, MemoryNeedleMap=nmap.MemoryNeedleMap,
        SqliteNeedleMap=nmap.SqliteNeedleMap, SortedFileNeedleMap=nmap.SortedFileNeedleMap,
        walk_index_file=nmap.walk_index_file, ReplicaPlacement=sb.ReplicaPlacement,
        SuperBlock=sb.SuperBlock, NeedleValue=types_.NeedleValue, Volume=volume.Volume,
        CookieMismatch=volume.CookieMismatch, NotFoundError=volume.NotFoundError,
        ReadOnlyError=volume.ReadOnlyError, VolumeError=volume.VolumeError, TTL=ttl.TTL,
        Store=store.Store, faults=faults, volume_mod=volume,
    )


PKGS = {
    "jax": _ns(j_needle, j_map, j_sb, j_types, j_volume, j_ttl, j_store, j_faults),
    "port": _ns(p_needle, p_map, p_sb, p_types, p_volume, p_ttl, p_store, p_faults),
}
CTX = ECContext(10, 4)


class FixedClock:
    """time.time / time.time_ns as a counter from one start: `Needle`
    stamps `appendAtNs` and TTL reads the wall clock, so byte-identity
    across the packages needs both clocks pinned the same way. Only the
    test's own thread reads the counter; any other thread of the process
    (a server of a module fixture) keeps the real clock."""

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
    c = FixedClock()
    monkeypatch.setattr(time, "time", c.time)
    monkeypatch.setattr(time, "time_ns", c.time_ns)
    return c


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("SEAWEED_VOLUME_GROUP_COMMIT_MS", raising=False)
    monkeypatch.delenv("SEAWEED_VOLUME_FSYNC", raising=False)
    p_faults.clear()
    yield
    p_faults.clear()


def _files(d) -> dict[str, bytes]:
    """Every file under `d` but sqlite's (its WAL carries random salts)."""
    out = {}
    for dirpath, _dirs, names in os.walk(d):
        for n in sorted(names):
            if ".ldb" in n:
                continue
            p = os.path.join(dirpath, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, d)] = f.read()
    return out


_RUN_DIR = [""]  # the running case's directory, named "<dir>" in messages


def _raises(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the raise is the observation
        msg = str(e)
        return type(e).__name__, msg.replace(_RUN_DIR[0], "<dir>") if _RUN_DIR[0] else msg
    return None


def _data(seed: int, n: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


# -------------------------------------------------- test_storage.py cases


def c_roundtrip_minimal(S, d, mp):
    n = S.Needle(cookie=0xDEADBEEF, needle_id=0x1234, data=b"hello world")
    out = []
    for v in (S.VERSION2, S.VERSION3):
        raw = n.to_bytes(v)
        assert len(raw) % 8 == 0
        m = S.Needle.from_bytes(raw, v)
        assert (m.cookie, m.needle_id, m.data) == (n.cookie, n.needle_id, b"hello world")
        out.append(raw)
    return out


def c_roundtrip_all_fields(S, d, mp):
    n = S.Needle(cookie=7, needle_id=42, data=b"x" * 1000)
    n.set_name(b"file.txt")
    n.set_mime(b"text/plain")
    n.set_last_modified(1700000000)
    n.set_ttl(b"\x05m")
    n.set_pairs(b'{"k":"v"}')
    raw = n.to_bytes(S.VERSION3)
    m = S.Needle.from_bytes(raw, S.VERSION3)
    assert (m.name, m.mime, m.last_modified, m.ttl, m.pairs) == (
        b"file.txt", b"text/plain", 1700000000, b"\x05m", b'{"k":"v"}')
    assert m.append_at_ns == n.append_at_ns and m.disk_size(S.VERSION3) == len(raw)
    return raw


def c_crc_detects_corruption(S, d, mp):
    raw = bytearray(S.Needle(cookie=1, needle_id=2, data=b"payload-bytes").to_bytes(S.VERSION3))
    raw[20] ^= 0xFF
    got = _raises(lambda: S.Needle.from_bytes(bytes(raw), S.VERSION3))
    assert got[0] == "CrcError"
    return got


def c_empty_needle_is_tombstone_shaped(S, d, mp):
    raw = S.Needle(cookie=0, needle_id=9).to_bytes(S.VERSION3)
    _, nid, size = S.Needle.parse_header(raw)
    assert nid == 9 and size == 0
    return raw


def c_padding(S, d, mp):
    sizes = [len(S.Needle(cookie=1, needle_id=1, data=b"a" * ln).to_bytes(S.VERSION3))
             for ln in range(40)]
    assert all(s % 8 == 0 for s in sizes)
    return sizes


def c_superblock_roundtrip(S, d, mp):
    sb = S.SuperBlock(version=3, replica_placement=S.ReplicaPlacement.parse("210"), ttl=b"\x03h",
                      compaction_revision=7)
    raw = sb.to_bytes()
    sb2 = S.SuperBlock.from_bytes(raw)
    assert len(raw) == 8 and (sb2.version, str(sb2.replica_placement), sb2.ttl,
                              sb2.compaction_revision) == (3, "210", b"\x03h", 7)
    return raw


def c_replica_placement_copy_count(S, d, mp):
    counts = [S.ReplicaPlacement.parse(s).copy_count for s in ("000", "001", "210")]
    assert counts == [1, 2, 4]
    return counts, _raises(lambda: S.ReplicaPlacement.parse("21"))


def c_memory_map_replay(S, d, mp):
    idx = str(d / "1.idx")
    m = S.MemoryNeedleMap(idx)
    m.put(10, 1, 100)
    m.put(20, 2, 200)
    m.delete(10)
    m.close()
    m2 = S.MemoryNeedleMap(idx)
    assert m2.get(10) is None and m2.get(20).size == 200 and m2.deleted_counter == 1
    m2.close()


def c_walk_index_file(S, d, mp):
    idx = str(d / "2.idx")
    m = S.MemoryNeedleMap(idx)
    for i in range(5):
        m.put(i, i, i * 10)
    m.close()
    assert [e.needle_id for e in S.walk_index_file(idx)] == list(range(5))
    return [(e.needle_id, e.offset) for e in S.walk_index_file(idx, start=32)]


def c_memdb_sorted_file(S, d, mp):
    idx = str(d / "x.idx")
    m = S.MemoryNeedleMap(idx)
    for nid in (5, 1, 9, 3):
        m.put(nid, nid, nid * 2)
    m.close()
    db = S.MemDb()
    db.load_idx(idx)
    path = str(d / "x.ecx")
    db.write_sorted_file(path)
    sf = S.SortedFileNeedleMap(path)
    assert len(sf) == 4 and [e.needle_id for e in sf.ascending_visit()] == [1, 3, 5, 9]
    assert sf.get(9).size == 18 and sf.get(2) is None
    sf.close()


def c_sorted_file_partial_record_fatal(S, d, mp):
    path = str(d / "bad.ecx")
    with open(path, "wb") as f:
        f.write(b"\x00" * 20)
    got = _raises(lambda: S.SortedFileNeedleMap(path))
    assert got[0] == "ValueError"
    return got


def c_write_read_delete(S, d, mp):
    v = S.Volume(str(d), 1)
    v.write_needle(S.Needle(cookie=0xABCD, needle_id=100, data=b"blob-data"))
    assert v.read_needle(100).data == b"blob-data"
    mismatch = _raises(lambda: v.read_needle(100, cookie=0x9999))
    assert mismatch[0] == "CookieMismatch"
    assert v.read_needle(100, cookie=0xABCD).data == b"blob-data"
    freed = v.delete_needle(100)
    assert freed > 0
    gone = _raises(lambda: v.read_needle(100))
    assert gone[0] == "NotFoundError"
    v.close()
    return mismatch, freed, gone


def c_reload_replays_index(S, d, mp):
    v = S.Volume(str(d), 2)
    for i in range(20):
        v.write_needle(S.Needle(cookie=i, needle_id=i, data=bytes([i]) * 50))
    v.delete_needle(7)
    v.close()
    v2 = S.Volume(str(d), 2, create=False)
    assert v2.read_needle(5).data == bytes([5]) * 50
    gone = _raises(lambda: v2.read_needle(7))
    assert gone[0] == "NotFoundError" and v2.stat().deleted_count == 1
    st = dataclasses.astuple(v2.stat())
    v2.close()
    return st, gone


def c_overwrite_appends(S, d, mp):
    v = S.Volume(str(d), 3)
    v.write_needle(S.Needle(cookie=1, needle_id=1, data=b"v1"))
    first = v.size
    v.write_needle(S.Needle(cookie=1, needle_id=1, data=b"v2-new"))
    assert v.size > first and v.read_needle(1).data == b"v2-new"
    v.close()
    return first


def c_readonly(S, d, mp):
    v = S.Volume(str(d), 4)
    v.write_needle(S.Needle(cookie=1, needle_id=1, data=b"a"))
    v.set_read_only()
    got = [_raises(lambda: v.write_needle(S.Needle(cookie=1, needle_id=2, data=b"b"))),
           _raises(lambda: v.delete_needle(1))]
    assert [g[0] for g in got] == ["ReadOnlyError"] * 2
    assert v.read_needle(1).data == b"a"
    v.close()
    return got


def c_vacuum_reclaims_and_preserves(S, d, mp):
    v = S.Volume(str(d), 5)
    keep = {}
    for i in range(50):
        data = _data(i, 100 + i)
        v.write_needle(S.Needle(cookie=i, needle_id=i, data=data))
        keep[i] = data
    for i in range(0, 50, 2):
        v.delete_needle(i)
        del keep[i]
    rev = v.super_block.compaction_revision
    reclaimed = v.vacuum()
    assert reclaimed > 0 and v.super_block.compaction_revision == rev + 1
    for i, data in keep.items():
        assert v.read_needle(i).data == data
    assert all(_raises(lambda i=i: v.read_needle(i))[0] == "NotFoundError" for i in range(0, 50, 2))
    assert v.garbage_ratio() == 0.0
    v.close()
    v2 = S.Volume(str(d), 5, create=False)
    for i, data in keep.items():
        assert v2.read_needle(i).data == data
    v2.close()
    return reclaimed


def c_garbage_ratio(S, d, mp):
    v = S.Volume(str(d), 6)
    v.write_needle(S.Needle(cookie=1, needle_id=1, data=b"z" * 1000))
    assert v.garbage_ratio() == 0.0
    v.delete_needle(1)
    ratio = v.garbage_ratio()
    assert ratio > 0.0
    v.close()
    return ratio


def _half_deleted(S, d, vid):
    v = S.Volume(str(d), vid)
    keep = {}
    for i in range(20):
        data = _data(100 + i, 64 + i)
        v.write_needle(S.Needle(cookie=i, needle_id=i, data=data))
        keep[i] = data
    for i in range(0, 20, 2):
        v.delete_needle(i)
        del keep[i]
    return v, keep


def c_volume_serves_after_failed_commit(S, d, mp):
    v, keep = _half_deleted(S, d, 7)
    real = os.replace

    def boom(src, dst):
        if dst.endswith(".dat"):
            raise OSError("simulated rename failure")
        return real(src, dst)

    mp.setattr(os, "replace", boom)
    got = _raises(v.vacuum)
    mp.setattr(os, "replace", real)
    assert got[0] == "OSError"
    for i, data in keep.items():
        assert v.read_needle(i).data == data
    v.write_needle(S.Needle(cookie=99, needle_id=99, data=b"after-fail"))
    assert v.read_needle(99).data == b"after-fail"
    assert not os.path.exists(v.dat_path[:-4] + ".cpd") and not os.path.exists(v.idx_path[:-4] + ".cpx")
    rev = v.super_block.compaction_revision
    assert v.vacuum() > 0 and v.super_block.compaction_revision == rev + 1
    for i, data in keep.items():
        assert v.read_needle(i).data == data
    v.close()
    return got


def c_rolls_forward_when_idx_swap_fails(S, d, mp):
    v, keep = _half_deleted(S, d, 8)
    real = os.replace
    armed = [True]

    def boom(src, dst):
        if dst.endswith(".idx") and armed[0]:
            armed[0] = False
            raise OSError("simulated idx rename failure")
        return real(src, dst)

    mp.setattr(os, "replace", boom)
    reclaimed = v.vacuum()
    mp.setattr(os, "replace", real)
    assert reclaimed > 0
    for i, data in keep.items():
        assert v.read_needle(i).data == data
    assert v.garbage_ratio() == 0.0 and not os.path.exists(v.dat_path[:-4] + ".cpm")
    v.close()
    v2 = S.Volume(str(d), 8, create=False)
    for i, data in keep.items():
        assert v2.read_needle(i).data == data
    v2.close()
    return reclaimed


def c_crash_between_swaps_heals_on_open(S, d, mp):
    v, keep = _half_deleted(S, d, 9)
    v.close()
    base = v.dat_path[:-4]
    scratch = d / "scratch"
    scratch.mkdir()
    for ext in (".dat", ".idx"):
        shutil.copy(base + ext, scratch / ("9" + ext))
    sv = S.Volume(str(scratch), 9, create=False)
    assert sv.vacuum() > 0
    sv.close()
    shutil.copy(scratch / "9.dat", base + ".cpd")
    shutil.copy(scratch / "9.idx", base + ".cpx")
    open(base + ".cpm", "wb").close()
    v2 = S.Volume(str(d), 9, create=False)
    assert not any(os.path.exists(base + p) for p in (".cpm", ".cpd", ".cpx"))
    assert v2.garbage_ratio() == 0.0
    for i, data in keep.items():
        assert v2.read_needle(i).data == data
    v2.close()


def c_stale_temps_without_marker_are_aborted(S, d, mp):
    v = S.Volume(str(d), 10)
    v.write_needle(S.Needle(cookie=1, needle_id=1, data=b"keep me"))
    v.close()
    base = v.dat_path[:-4]
    for ext in (".cpd", ".cpx"):
        with open(base + ext, "wb") as f:
            f.write(b"partial garbage")
    v2 = S.Volume(str(d), 10, create=False)
    assert not os.path.exists(base + ".cpd") and not os.path.exists(base + ".cpx")
    assert v2.read_needle(1).data == b"keep me"
    v2.close()


def c_unfinishable_commit_poisons_volume(S, d, mp):
    v, keep = _half_deleted(S, d, 11)
    real = os.replace

    def boom(src, dst):
        if dst.endswith(".idx"):
            raise OSError("persistent idx rename failure")
        return real(src, dst)

    mp.setattr(os, "replace", boom)
    first = _raises(v.vacuum)
    mp.setattr(os, "replace", real)
    assert first[0] == "OSError" and v.broken and v.read_only
    refused = [_raises(lambda: v.read_needle(1)),
               _raises(lambda: v.write_needle(S.Needle(cookie=5, needle_id=55, data=b"no"))),
               _raises(v.vacuum)]
    assert [r[0] for r in refused] == ["VolumeError"] * 3
    base = v.dat_path[:-4]
    assert os.path.exists(base + ".cpm") and os.path.exists(base + ".cpx")
    v2 = S.Volume(str(d), 11, create=False)
    assert not os.path.exists(base + ".cpm") and v2.garbage_ratio() == 0.0
    for i, data in keep.items():
        assert v2.read_needle(i).data == data
    v2.close()
    return first, refused


STORAGE_CASES = {f.__name__[2:]: f for f in (
    c_roundtrip_minimal, c_roundtrip_all_fields, c_crc_detects_corruption,
    c_empty_needle_is_tombstone_shaped, c_padding, c_superblock_roundtrip,
    c_replica_placement_copy_count, c_memory_map_replay, c_walk_index_file,
    c_memdb_sorted_file, c_sorted_file_partial_record_fatal, c_write_read_delete,
    c_reload_replays_index, c_overwrite_appends, c_readonly, c_vacuum_reclaims_and_preserves,
    c_garbage_ratio, c_volume_serves_after_failed_commit, c_rolls_forward_when_idx_swap_fails,
    c_crash_between_swaps_heals_on_open, c_stale_temps_without_marker_are_aborted,
    c_unfinishable_commit_poisons_volume,
)}


def _both(tmp_path, clock, monkeypatch, case):
    out = {}
    for name in ("jax", "port"):
        d = tmp_path / name
        d.mkdir()
        clock.reset()
        _RUN_DIR[0] = str(d)
        try:
            got = case(PKGS[name], d, monkeypatch)
        finally:
            _RUN_DIR[0] = ""
        out[name] = (got, _files(d))
    return out


@pytest.mark.parametrize("case", list(STORAGE_CASES))
def test_storage_case_matches_jax(tmp_path, clock, monkeypatch, case):
    """Each case of the JAX package's test_storage.py, its own checks
    made in both packages: the same results and raises, and the same
    bytes on disk under the same clock."""
    out = _both(tmp_path, clock, monkeypatch, STORAGE_CASES[case])
    assert out["port"] == out["jax"]


# ------------------------------------------ test_needle_map_sqlite.py cases


def s_sqlite_map_basic(S, d, mp):
    idx = str(d / "1.idx")
    m = S.SqliteNeedleMap(idx)
    for i in range(1, 101):
        m.put(i, offset=i * 8, size=100 + i)
    assert m.get(50) == S.NeedleValue(50, 400, 150) and m.get(999) is None
    assert m.delete(50) == 150 and m.get(50) is None
    assert m.deleted_counter == 1 and m.deleted_bytes == 150 and len(m) == 99
    ids = [nv.needle_id for nv in m.ascending_visit()]
    assert ids == sorted(ids) and 50 not in ids
    m.close()
    assert len(list(S.walk_index_file(idx))) == 101
    return ids


def s_sqlite_map_reopen_is_o_delta(S, d, mp):
    idx = str(d / "2.idx")
    m = S.SqliteNeedleMap(idx)
    for i in range(1, 1001):
        m.put(i, offset=i * 8, size=10)
    m.flush()
    watermark = os.path.getsize(idx)
    m.close()
    with open(idx, "ab") as f:
        for i in range(2001, 2006):
            f.write(S.NeedleValue(i, i * 8, 20).to_bytes())
    m2 = S.SqliteNeedleMap(idx)
    assert m2._meta("watermark") >= watermark
    assert m2.get(500) == S.NeedleValue(500, 4000, 10)
    assert m2.get(2003) == S.NeedleValue(2003, 2003 * 8, 20) and len(m2) == 1005
    m2.close()


def s_sqlite_map_generation_change_rebuilds(S, d, mp):
    idx = str(d / "3.idx")
    m = S.SqliteNeedleMap(idx, generation=1)
    m.put(1, 8, 10)
    m.flush()
    m.close()
    with open(idx, "wb") as f:
        f.write(S.NeedleValue(7, 16, 30).to_bytes())
    m2 = S.SqliteNeedleMap(idx, generation=2)
    assert m2.get(1) is None and m2.get(7) == S.NeedleValue(7, 16, 30)
    m2.close()


def s_volume_with_sqlite_map(S, d, mp):
    v = S.Volume(str(d), 11, needle_map_kind="sqlite")
    payloads = {}
    for i in range(1, 51):
        data = bytes((i * 3 + j) % 256 for j in range(500))
        v.write_needle(S.Needle(cookie=i, needle_id=i, data=data))
        payloads[i] = data
    v.delete_needle(10)
    v.close()
    v2 = S.Volume(str(d), 11, create=False, needle_map_kind="sqlite")
    assert v2.read_needle(30).data == payloads[30] and not v2.has_needle(10)
    reclaimed = v2.vacuum()
    assert reclaimed > 0 and v2.read_needle(30).data == payloads[30] and not v2.has_needle(10)
    v2.close()
    v3 = S.Volume(str(d), 11, create=False, needle_map_kind="sqlite")
    assert v3.read_needle(49).data == payloads[49]
    v3.close()
    return reclaimed


def s_vacuum_still_readonly_volume_restored(S, d, mp):
    v = S.Volume(str(d), 23)
    v.write_needle(S.Needle(cookie=1, needle_id=1, data=b"x"))
    v.delete_needle(1)
    v.set_read_only(True)
    v.vacuum()
    assert v.read_only
    v.close()


def s_sorted_file_lookup_scalar_fast_path(S, d, mp):
    idx = str(d / "s.idx")
    m = S.MemoryNeedleMap(idx)
    n = 20_000
    for i in range(1, n + 1):
        m.put(i * 7, i, 1024)
    m.close()
    db = S.MemDb()
    db.load_idx(idx)
    path = str(d / "s.sorted")
    db.write_sorted_file(path)
    sf = S.SortedFileNeedleMap(path)
    try:
        picks = np.random.default_rng(3).integers(1, n, 2000)
        for i in picks[:100]:
            assert sf.get(int(i) * 7).offset == int(i)
        assert sf.get(3) is None
        t0 = time.perf_counter()
        for i in picks:
            sf.get(int(i) * 7)
        per = (time.perf_counter() - t0) / len(picks)
        assert per < 100e-6, f"sorted lookup {per * 1e6:.1f} us: slow path?"
    finally:
        sf.close()


SQLITE_CASES = {f.__name__[2:]: f for f in (
    s_sqlite_map_basic, s_sqlite_map_reopen_is_o_delta, s_sqlite_map_generation_change_rebuilds,
    s_volume_with_sqlite_map, s_vacuum_still_readonly_volume_restored,
    s_sorted_file_lookup_scalar_fast_path,
)}


@pytest.mark.parametrize("case", list(SQLITE_CASES))
def test_needle_map_sqlite_case_matches_jax(tmp_path, clock, monkeypatch, case):
    """The JAX package's test_needle_map_sqlite.py cases without a
    concurrent writer, in both packages: the same results and bytes."""
    if case == "sorted_file_lookup_scalar_fast_path":
        monkeypatch.undo()  # a real clock: the case times lookups
        clock = FixedClock()
    out = _both(tmp_path, clock, monkeypatch, SQLITE_CASES[case])
    assert out["port"] == out["jax"]


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_vacuum_accepts_writes_during_compaction(tmp_path, pkg):
    """A live vacuum takes writes while it copies; every one survives the
    commit and a reopen (the JAX case, run in each package: the writer
    races the copy, so the bytes are not compared)."""
    S = PKGS[pkg]
    v = S.Volume(str(tmp_path), 21)
    blob = b"z" * 2048
    for i in range(1, 3001):
        v.write_needle(S.Needle(cookie=1, needle_id=i, data=blob))
    for i in range(1, 1500):
        v.delete_needle(i)
    written: list[int] = []
    stop = threading.Event()

    def writer():
        nid = 100_000
        while not stop.is_set():
            nid += 1
            try:
                v.write_needle(S.Needle(cookie=2, needle_id=nid, data=b"live-%d" % nid))
                written.append(nid)
            except Exception:  # noqa: BLE001 - the brief freeze window
                time.sleep(0.001)

    t = threading.Thread(target=writer)
    t.start()
    time.sleep(0.01)
    reclaimed = v.vacuum()
    stop.set()
    t.join()
    assert reclaimed > 0 and written, "no write landed during the vacuum"
    for nid in written:
        assert v.read_needle(nid).data == b"live-%d" % nid
    assert v.read_needle(2000).data == blob and not v.has_needle(100)
    v.close()
    v2 = S.Volume(str(tmp_path), 21, create=False)
    for nid in written[-5:]:
        assert v2.read_needle(nid).data == b"live-%d" % nid
    assert not v2.has_needle(100)
    v2.close()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_vacuum_catchup_applies_mid_vacuum_deletes(tmp_path, pkg):
    S = PKGS[pkg]
    v = S.Volume(str(tmp_path), 22)
    for i in range(1, 2001):
        v.write_needle(S.Needle(cookie=1, needle_id=i, data=b"d" * 1024))
    v.delete_needle(1)
    deleted: list[int] = []
    stop = threading.Event()

    def deleter():
        nid = 1000
        while not stop.is_set() and nid < 1050:
            try:
                v.delete_needle(nid)
                deleted.append(nid)
                nid += 1
            except Exception:  # noqa: BLE001
                time.sleep(0.001)

    t = threading.Thread(target=deleter)
    t.start()
    v.vacuum()
    stop.set()
    t.join()
    for nid in deleted:
        assert not v.has_needle(nid), f"needle {nid} resurrected by the vacuum"
    assert v.read_needle(500).data == b"d" * 1024
    v.close()


# --------------------------------------------------------- test_ttl.py cases


def t_ttl_parse_and_encode(S, d, mp):
    assert S.TTL.parse("") == S.TTL() and not S.TTL.parse("0")
    out = []
    for s, secs in [("5m", 300), ("2h", 7200), ("1d", 86400), ("1w", 7 * 86400), ("3M", 0),
                    ("2y", 0)]:
        t = S.TTL.parse(s)
        assert str(t) == s and S.TTL.from_bytes(t.to_bytes()) == t
        assert secs == 0 or t.seconds == secs
        out.append((t.to_bytes(), t.seconds))
    assert S.TTL.parse("90").seconds == 90 * 60
    out += [_raises(lambda: S.TTL.parse("5x")), _raises(lambda: S.TTL.parse("300m")),
            _raises(lambda: S.TTL.from_bytes(b"\x01"))]
    assert [o[0] for o in out[-3:]] == ["ValueError"] * 3
    return out


def t_ttl_volume_read_expiry(S, d, mp):
    v = S.Volume(str(d), 2, ttl="1m")
    assert v.ttl.seconds == 60
    v.write_needle(S.Needle(cookie=1, needle_id=1, data=b"short lived"))
    assert v.read_needle(1).data == b"short lived"
    old = S.Needle(cookie=2, needle_id=2, data=b"stale")
    old.set_last_modified(int(time.time()) - 120)
    v.write_needle(old)
    got = _raises(lambda: v.read_needle(2))
    assert got[0] == "NotFoundError" and "expired" in got[1]
    v.close()
    v2 = S.Volume(str(d), 2, create=False)
    assert str(v2.ttl) == "1m"
    v2.close()
    return got


def t_ttl_volume_reap(S, d, mp):
    st = S.Store([str(d)], ec_backend="cpu")
    v = st.allocate_volume(4, ttl="1m")
    v.write_needle(S.Needle(cookie=1, needle_id=1, data=b"x"))
    v.flush()
    assert st.reap_expired_volumes() == []
    v._last_write_ts = time.time() - 3600
    assert st.reap_expired_volumes() == [4]
    assert st.find_volume(4) is None and not os.path.exists(str(d / "4.dat"))
    st.close()


def t_ttl_bucketed_volumes_in_a_store(S, d, mp):
    """The master's TTL buckets stand on the store keeping each volume's
    TTL: volumes allocated with different TTLs keep them across a
    reopen, in the superblock and in status()."""
    st = S.Store([str(d)], ec_backend="cpu")
    for vid, ttl in ((1, ""), (2, "1h"), (3, "3d")):
        st.allocate_volume(vid, ttl=ttl).write_needle(S.Needle(cookie=vid, needle_id=vid, data=b"x"))
    st.close()
    st2 = S.Store([str(d)], ec_backend="cpu")
    got = [(v["id"], v["ttl"]) for v in st2.status()["volumes"]]
    assert got == [(1, ""), (2, "1h"), (3, "3d")]
    assert str(st2.find_volume(2).ttl) == "1h"
    st2.close()
    return got


TTL_CASES = {f.__name__[2:]: f for f in (
    t_ttl_parse_and_encode, t_ttl_volume_read_expiry, t_ttl_volume_reap,
    t_ttl_bucketed_volumes_in_a_store,
)}


@pytest.mark.parametrize("case", list(TTL_CASES))
def test_ttl_case_matches_jax(tmp_path, clock, monkeypatch, case):
    out = _both(tmp_path, clock, monkeypatch, TTL_CASES[case])
    assert out["port"] == out["jax"]


# ------------------------------------------------ test_group_commit.py cases

DATA1 = b"first-acked-" * 200
DATA2 = b"second-dies-" * 200


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_group_commit_batches_fsyncs(tmp_path, monkeypatch, pkg):
    S = PKGS[pkg]
    monkeypatch.setenv("SEAWEED_VOLUME_GROUP_COMMIT_MS", "30")
    v = S.Volume(str(tmp_path), 1, create=True)
    real_fsync = os.fsync
    count = [0]

    def counting_fsync(fd):
        count[0] += 1
        real_fsync(fd)

    monkeypatch.setattr(os, "fsync", counting_fsync)
    errs = []

    def write(i):
        try:
            v.write_needle(S.Needle(cookie=0x10 + i, needle_id=100 + i, data=DATA1), fsync=True)
        except BaseException as e:  # noqa: BLE001 - surfaced below
            errs.append(e)

    threads = [threading.Thread(target=write, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not errs and count[0] < 32, (errs, count)
    for i in range(16):
        assert v.read_needle(100 + i).data == DATA1
    monkeypatch.setenv("SEAWEED_VOLUME_GROUP_COMMIT_MS", "0")
    before = count[0]
    v.write_needle(S.Needle(cookie=1, needle_id=999, data=DATA1), fsync=True)
    assert v._committer is None and count[0] >= before + 1
    v.close()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_group_commit_fsync_error_fails_whole_window(tmp_path, monkeypatch, pkg):
    S = PKGS[pkg]
    monkeypatch.setenv("SEAWEED_VOLUME_GROUP_COMMIT_MS", "20")
    v = S.Volume(str(tmp_path), 1, create=True)
    real = S.Volume._fsync_all
    monkeypatch.setattr(S.Volume, "_fsync_all",
                        lambda self: (_ for _ in ()).throw(OSError("disk gone")))
    errs = []

    def write(i):
        try:
            v.write_needle(S.Needle(cookie=i, needle_id=200 + i, data=DATA1), fsync=True)
        except OSError as e:
            errs.append(str(e))

    threads = [threading.Thread(target=write, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert len(errs) == 3 and all("group commit fsync failed" in e for e in errs)
    monkeypatch.setattr(S.Volume, "_fsync_all", real)
    v.write_needle(S.Needle(cookie=9, needle_id=300, data=DATA1), fsync=True)
    assert v.read_needle(300).data == DATA1
    v.close()


def test_window_zero_is_fsync_per_needle(tmp_path, clock, monkeypatch):
    """Window 0: each durable write fsyncs the .dat and the .idx inline,
    no committer thread, the same number of fsyncs and the same bytes in
    both packages."""
    real_fsync = os.fsync
    counts = {}
    for name in ("jax", "port"):
        S = PKGS[name]
        count = [0]
        monkeypatch.setattr(os, "fsync", lambda fd, c=count: (c.__setitem__(0, c[0] + 1),
                                                             real_fsync(fd))[1])
        d = tmp_path / name
        d.mkdir()
        clock.reset()
        v = S.Volume(str(d), 1, create=True)
        v.write_needle(S.Needle(cookie=1, needle_id=1, data=DATA1), fsync=True)
        assert v._committer is None and count[0] >= 2
        v.close()
        counts[name] = (count[0], _files(d))
    assert counts["port"] == counts["jax"]


# a port volume acks one durable write, then dies at the armed point in
# the second (a fresh interpreter: no fork of this threaded process)
VOLUME_CRASH_CHILD = r"""
import os, sys
from seaweedfs_tpu_torch import faults
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.volume import Volume

d, point, window_ms = sys.argv[1], sys.argv[2], sys.argv[3]
os.environ["SEAWEED_VOLUME_GROUP_COMMIT_MS"] = window_ms
data1, data2 = b"first-acked-" * 200, b"second-dies-" * 200
v = Volume(d, 1, create=True)
v.write_needle(Needle(cookie=0x11, needle_id=1, data=data1), fsync=True)
print("acked 1", flush=True)
faults.inject(point, faults.hard_exit(137))
v.write_needle(Needle(cookie=0x22, needle_id=2, data=data2), fsync=True)
print("acked 2", flush=True)
"""


def _run_child(script: str, *args: str, timeout: float = 60) -> subprocess.CompletedProcess:
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return subprocess.run([sys.executable, "-c", script, *args], cwd=repo,
                          env=dict(os.environ, PYTHONPATH=repo), capture_output=True, text=True,
                          timeout=timeout)


@pytest.mark.parametrize("window_ms", [0, 15])
@pytest.mark.parametrize("point", ["volume.write.before_fsync", "volume.write.after_fsync",
                                   "volume.write.before_ack"])
def test_volume_write_crash_acked_is_durable(tmp_path, point, window_ms):
    """A port volume killed at each write-path point, per fsync mode: the
    acked needle replays intact in both packages; a kill after the
    durability step still finds the second needle; before it, the second
    is whole or absent, and both packages replay the same."""
    proc = _run_child(VOLUME_CRASH_CHILD, str(tmp_path), point, str(window_ms))
    assert proc.returncode == 137, proc.stdout + proc.stderr
    assert proc.stdout.splitlines() == ["acked 1"]
    seen = {}
    for name in ("port", "jax"):
        S = PKGS[name]
        v = S.Volume(str(tmp_path), 1, create=False)
        try:
            assert v.read_needle(1).data == DATA1, "acked write lost"
            second = _raises(lambda: v.read_needle(2))
            if point != "volume.write.before_fsync":
                assert second is None and v.read_needle(2).data == DATA2
            else:
                assert second is None or second[0] == "NotFoundError"
            seen[name] = second
        finally:
            v.close()
    assert seen["port"] == seen["jax"]


# a blob write to a port server killed at each of its write-path points
BLOB_CRASH_CHILD = r"""
import os, sys, time
from seaweedfs_tpu_torch import faults
from seaweedfs_tpu_torch.ec import net_plane

root, point = sys.argv[1], sys.argv[2]

def resolve_blob(path, op, md):
    return os.open(os.path.join(root, path), os.O_CREAT | os.O_RDWR, 0o644)

def refuse(vid, sid, gen):
    raise net_plane.NetPlaneError("no shards here")

srv = net_plane.ShardNetPlane("127.0.0.1", 0, refuse, resolve_blob=resolve_blob)
srv.start()
faults.inject(point, faults.hard_exit(137), when=faults.nth_call(2))
print(srv.port, flush=True)
time.sleep(60)
os._exit(1)
"""


@pytest.mark.parametrize("point", ["ec.net.write.before_pwrite", "ec.net.write.after_pwrite"])
def test_blob_write_crash_acked_is_durable(tmp_path, point):
    """The write plane's own crash points, which keep it serving while
    armed: the first blob write is ACKed and on disk; the second, killed
    at the point, is never ACKed, and its bytes are on disk only past
    the pwrite."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen([sys.executable, "-c", BLOB_CRASH_CHILD, str(tmp_path), point],
                            cwd=repo, env=dict(os.environ, PYTHONPATH=repo),
                            stdout=subprocess.PIPE, text=True)
    try:
        port = int(proc.stdout.readline())
        client = net_plane.NetPlaneClient(timeout=10.0)
        try:
            addr = ("127.0.0.1", port)
            assert client.write_blob(addr, "a", 0, DATA1) == len(DATA1)
            with pytest.raises(net_plane.NetPlaneError):
                client.write_blob(addr, "b", 0, DATA2)
        finally:
            client.close()
        assert proc.wait(timeout=60) == 137
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert (tmp_path / "a").read_bytes() == DATA1
    landed = (tmp_path / "b").read_bytes() if (tmp_path / "b").exists() else b""
    assert landed == (DATA2 if point == "ec.net.write.after_pwrite" else b"")


# ------------------------------------------------------ test_tiering.py cases


@pytest.fixture(scope="module")
def cold_tier(tmp_path_factory):
    """The JAX package's master, volume server, filer and S3 gateway: the
    cold-tier endpoint the port's volumes upload to."""
    from seaweedfs_tpu.filer import Filer, MemoryStore
    from seaweedfs_tpu.s3 import S3Server
    from seaweedfs_tpu.server.master import MasterServer
    from seaweedfs_tpu.server.volume_server import VolumeServer

    tmp = tmp_path_factory.mktemp("coldvol")
    mport = allocate_port()
    master = MasterServer(ip="localhost", port=mport)
    master.start()
    vs = VolumeServer(directories=[str(tmp / "v")], master=f"localhost:{mport}", ip="localhost",
                      port=allocate_port(), ec_backend="cpu")
    vs.start()
    while not master.topo.nodes:
        time.sleep(0.05)
    filer = Filer(MemoryStore(), master=f"localhost:{mport}", chunk_size=256 * 1024)
    s3 = S3Server(filer, ip="localhost", port=allocate_port(), lifecycle_interval=0)
    s3.start()
    url = f"http://localhost:{s3.port}"
    requests.put(f"{url}/cold")
    yield url
    s3.stop()
    filer.close()
    vs.stop()
    master.stop()


def _fill(S, d, vid, n):
    v = S.Volume(str(d), vid)
    payloads = {}
    for i in range(1, n + 1):
        data = bytes((i * 7 + j) % 256 for j in range(1000 + i * 37))
        v.write_needle(S.Needle(cookie=0x1111 + i, needle_id=i, data=data))
        payloads[i] = data
    return v, payloads


def test_tier_upload_read_download(cold_tier, tmp_path):
    S = PKGS["port"]
    v, payloads = _fill(S, tmp_path, 7, 40)
    dest = f"{cold_tier}/cold/port-vol7.dat"
    assert _raises(lambda: v.tier_upload(dest))[0] == "VolumeError"
    v.set_read_only(True)
    with open(v.dat_path, "rb") as f:
        dat = f.read()
    moved = v.tier_upload(dest)
    assert moved == len(dat) and v.is_tiered
    assert not os.path.exists(v.dat_path) and os.path.exists(v.idx_path)
    assert requests.get(dest).content == dat  # the cold object is the .dat
    for i, data in payloads.items():
        assert v.read_needle(i).data == data
    assert _raises(lambda: v.write_needle(S.Needle(cookie=1, needle_id=999, data=b"x")))[0] \
        == "ReadOnlyError"
    assert _raises(lambda: v.set_read_only(False))[0] == "VolumeError"
    assert _raises(v.vacuum)[0] == "VolumeError"
    assert v.tier_download(delete_remote=True) == moved and not v.is_tiered
    assert open(v.dat_path, "rb").read() == dat
    assert requests.get(dest).status_code == 404
    for i, data in payloads.items():
        assert v.read_needle(i).data == data
    v.set_read_only(False)
    v.write_needle(S.Needle(cookie=2, needle_id=500, data=b"post-download"))
    assert v.read_needle(500).data == b"post-download"
    v.close()


@pytest.mark.parametrize("tierer,reader", [("port", "port"), ("jax", "port"), ("port", "jax")])
def test_tiered_volume_survives_reopen(cold_tier, tmp_path, tierer, reader):
    """A .vif with tier info and no .dat mounts in remote mode, in either
    package whichever tiered it."""
    v, payloads = _fill(PKGS[tierer], tmp_path, 8, 10)
    v.set_read_only(True)
    v.tier_upload(f"{cold_tier}/cold/{tierer}-{reader}-vol8.dat")
    v.close()
    v2 = PKGS[reader].Volume(str(tmp_path), 8, create=False)
    assert v2.is_tiered and v2.read_only
    for i, data in payloads.items():
        assert v2.read_needle(i).data == data
    v2.close()


def test_store_mounts_tiered_volume(cold_tier, tmp_path):
    v, payloads = _fill(PKGS["port"], tmp_path, 9, 5)
    v.set_read_only(True)
    v.tier_upload(f"{cold_tier}/cold/port-vol9.dat")
    v.close()
    loc = p_store.DiskLocation(directory=str(tmp_path))
    loc.load_existing()
    assert loc.volumes[9].is_tiered and loc.volumes[9].read_needle(3).data == payloads[3]
    for vol in loc.volumes.values():
        vol.close()


def test_remote_file_ranges_and_errors(cold_tier):
    """The HTTP client swap: the ranged GET of a part, a range past the
    end refused as a short read, a HEAD for the size, a missing object
    refused with its status, a truncated upload source refused before
    the whole body is sent, as the JAX client refuses it."""
    import io

    url = f"{cold_tier}/cold/port-ranges.bin"
    body = _data(5, 3 * 1024 * 1024 + 17)
    p_backend.put_object(url, io.BytesIO(body), len(body))
    rf = p_backend.open_backend_file(url)
    assert isinstance(rf, p_backend.S3RemoteFile)
    assert rf.read_at(1000, 5000) == body[1000:6000] and rf.read_at(0, 0) == b""
    assert rf.size() == len(body)
    with pytest.raises(p_backend.BackendError, match="short read"):
        rf.read_at(len(body) - 10, 100)
    with pytest.raises(p_backend.BackendError, match="HTTP 404"):
        p_backend.S3RemoteFile(url + ".missing").read_at(0, 10)
    from seaweedfs_tpu.storage import backend as j_backend

    for mod in (p_backend, j_backend):
        with pytest.raises(mod.BackendError, match="truncated"):
            mod.put_object(url + ".torn", io.BytesIO(body[:100]), len(body))


def test_sized_reader_bounds_match_jax():
    import io

    from seaweedfs_tpu.storage import backend as j_backend

    assert p_backend._CHUNK == j_backend._CHUNK
    body = _data(7, 3 * p_backend._CHUNK // 2)
    pieces = {}
    for name, mod in (("port", p_backend), ("jax", j_backend)):
        r = mod._SizedReader(io.BytesIO(body), len(body))
        got = []
        while piece := r.read(-1):
            got.append(len(piece))
        assert r.read() == b""
        pieces[name] = got
    assert pieces["port"] == pieces["jax"] and len(pieces["port"]) >= 2
    r = p_backend._SizedReader(io.BytesIO(b"only-ten-b"), 1000)
    assert r.read(10) == b"only-ten-b"
    with pytest.raises(p_backend.BackendError, match="truncated: 990 of 1000"):
        r.read(10)


# --------------------------------------------------- volumes across packages


@pytest.mark.parametrize("kind", ["memory", "sqlite"])
@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_volume_opens_reads_and_vacuums_in_the_other_package(tmp_path, clock, writer, reader,
                                                             kind):
    """Written by one package (a delete, an overwrite, a TTL-free
    needle with a name), reopened by the other: the same reads and
    stat; its vacuum gives the bytes the writer's own vacuum gives."""
    outs = {}
    for who in (writer, reader):
        d = tmp_path / f"by-{who}"
        d.mkdir()
        clock.reset()
        W = PKGS[writer]
        v = W.Volume(str(d), 3, replica_placement="010", needle_map_kind=kind)
        for i in range(1, 31):
            n = W.Needle(cookie=i, needle_id=i, data=_data(i, 200 + 13 * i))
            if i % 5 == 0:
                n.set_name(b"n%d" % i)
            v.write_needle(n)
        v.write_needle(W.Needle(cookie=4, needle_id=4, data=b"overwritten"))
        v.delete_needle(9)
        v.close()
        R = PKGS[who]
        v2 = R.Volume(str(d), 3, create=False, needle_map_kind=kind)
        reads = {i: (v2.read_needle(i).data, v2.read_needle(i).name) for i in range(1, 31) if i != 9}
        st = v2.stat()
        assert _raises(lambda: v2.read_needle(9))[0] == "NotFoundError"
        reclaimed = v2.vacuum()
        v2.close()
        outs[who] = (reads, st.file_count, st.deleted_count, st.deleted_bytes, st.replica_placement,
                     reclaimed, _files(d))
    assert outs[reader] == outs[writer]


# ------------------------------------------------------------ ScrubDaemon


def _make_volume(d, needles, seed):
    rng = np.random.default_rng(seed)
    v = p_volume.Volume(str(d), 1)
    payloads = {}
    for i in range(1, needles + 1):
        data = rng.integers(0, 256, int(rng.integers(1, 40_000)), dtype=np.uint8).tobytes()
        v.write_needle(p_needle.Needle(cookie=0x1000 + i, needle_id=i, data=data))
        payloads[i] = data
    v.close()
    return p_volume.Volume.base_file_name(str(d), "", 1), payloads


def _flip(path, offset):
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 1]))


SCRUB = {
    "jax": types.SimpleNamespace(Store=j_store.Store, ScrubDaemon=j_scrub.ScrubDaemon,
                                 CpuBackend=j_ec.CpuBackend, CircuitBreaker=j_retry.CircuitBreaker,
                                 faults=j_faults),
    "port": types.SimpleNamespace(Store=p_store.Store, ScrubDaemon=ScrubDaemon,
                                  CpuBackend=CpuBackend, CircuitBreaker=p_retry.CircuitBreaker,
                                  faults=p_faults),
}


def _report(r, d) -> dict:
    """A ScrubReport as a dict, with the package's directory named "<d>"
    and a refusal's retry wall ("after 3 attempts in 0.73s") as "<t>"."""
    out = dataclasses.asdict(r)
    out["healthy"] = r.healthy
    out["refused"] = re.sub(r" in [0-9.]+s:", " in <t>s:", out["refused"])
    return eval(repr(out).replace(str(d), "<d>"))  # noqa: S307 - our own repr


def _shards(d) -> dict[str, bytes]:
    """Every shard, `.bad` quarantine and `.ecx`/`.ecj` under `d`."""
    return {n: b for n, b in _files(d).items()
            if n.rsplit(".", 1)[-1].startswith(("ec", "bad"))}


def _scrub_both(tmp_path, src, scenario):
    """`scenario(E, d)` over a copy of `src` per package; the two
    observation dicts must be equal. Returns the JAX one."""
    outs = {}
    for pkg, E in SCRUB.items():
        d = tmp_path / pkg
        shutil.copytree(src, d)
        outs[pkg] = scenario(E, d)
    assert outs["port"] == outs["jax"]
    return outs["jax"]


def test_scrub_daemon_heals_store_volume(tmp_path):
    """The JAX case through both packages: rot in one leaf of shard 5 is
    patched in place (no quarantine, no rebuild, no unmount), the shard
    is its encoded bytes again, every needle reads bit-exact on the live
    EcVolume, and a second pass is clean; reports, shard bytes and
    legitimate_shards equal to the JAX package's."""
    src = tmp_path / "src"
    src.mkdir()
    base, payloads = _make_volume(src, 10, 4)
    ec_encode_volume(base, CTX, backend=CpuBackend(CTX))
    original = open(base + CTX.to_ext(5), "rb").read()
    _flip(base + CTX.to_ext(5), 777)

    def scenario(E, d):
        store = E.Store([str(d)], ec_backend="cpu")
        try:
            ev = store.find_ec_volume(1)
            daemon = E.ScrubDaemon(store, interval=3600.0, repair=True, backend=E.CpuBackend(CTX))
            r1 = _report(daemon.scrub_once()[1], d)
            reads = {i: store.read_needle(1, i).data == want for i, want in payloads.items()}
            obs = dict(r1=r1, shard_ids=sorted(ev.shard_ids), legit=ev.legitimate_shards(),
                       shards=_shards(d), reads=reads)
            obs["r2"] = _report(daemon.scrub_once()[1], d)
            obs["breaker"] = daemon.breakers[1].state
            return obs
        finally:
            store.close()

    j = _scrub_both(tmp_path, src, scenario)
    assert 5 in j["r1"]["leaf_repaired"] and not j["r1"]["rebuilt"] and not j["r1"]["quarantined"]
    assert j["shards"]["1" + CTX.to_ext(5)] == original
    assert not any(n.endswith(QUARANTINE_SUFFIX) for n in j["shards"])
    assert j["legit"] == list(range(CTX.total)) and all(j["reads"].values())
    assert j["r2"]["healthy"] and j["breaker"] == "closed"


def test_scrub_daemon_remembers_quarantined_shard_after_failed_rebuild(tmp_path):
    """Shard 6 cut short is quarantined and unmounted while vol 1's
    breaker is open; the next pass, breaker healed, still counts it
    (legitimate_shards keeps a .bad) and rebuilds and remounts it. Both
    packages: the same reports, quarantines, breaker states and bytes."""
    src = tmp_path / "src"
    src.mkdir()
    base, payloads = _make_volume(src, 8, 20)
    ec_encode_volume(base, CTX, backend=CpuBackend(CTX))
    original = open(base + CTX.to_ext(6), "rb").read()
    path6 = base + CTX.to_ext(6)
    os.truncate(path6, os.path.getsize(path6) - 100)

    def scenario(E, d):
        store = E.Store([str(d)], ec_backend="cpu")
        try:
            ev = store.find_ec_volume(1)
            daemon = E.ScrubDaemon(store, interval=3600.0, repair=True, backend=E.CpuBackend(CTX))
            b = daemon.breaker_for(1)
            for _ in range(b.failure_threshold):
                b.record_failure()
            obs = dict(r1=_report(daemon.scrub_once()[1], d), breaker1=b.state,
                       ids1=sorted(ev.shard_ids), legit1=ev.legitimate_shards(),
                       quarantined1=ev.quarantined_shards(), shards1=_shards(d))
            b.record_success()
            obs.update(r2=_report(daemon.scrub_once()[1], d), breaker2=b.state,
                       ids2=sorted(ev.shard_ids), legit2=ev.legitimate_shards(),
                       quarantined2=ev.quarantined_shards(), shards2=_shards(d),
                       reads={i: ev.read_needle(i).data == want for i, want in payloads.items()})
            return obs
        finally:
            store.close()

    j = _scrub_both(tmp_path, src, scenario)
    assert j["r1"]["quarantined"] and not j["r1"]["rebuilt"] and "skipped" in j["r1"]["refused"]
    assert 6 not in j["ids1"] and 6 in j["legit1"] and j["quarantined1"] == [6]
    assert j["breaker1"] == "open"
    assert j["r2"]["missing_shards"] == [6] and j["r2"]["rebuilt"] == [6]
    assert 6 in j["ids2"] and j["shards2"]["1" + CTX.to_ext(6)] == original
    assert all(j["reads"].values())


def test_scrub_daemon_breaker_per_volume_and_loop(tmp_path):
    """Two EC volumes. Vol 1 holds 11 shards and one of them rots to a
    short file: quarantined, its rebuild fails (an I/O error armed at
    `ec.rebuild.before_fsync`), and only vol 1's breaker (threshold 1)
    opens, so the next pass skips it.
    Vol 2's leaf rot is repaired in the same pass. The background loop
    runs passes on kick() and stops. Both packages: the same reports,
    breaker states, quarantines and shard bytes."""
    src = tmp_path / "src"
    a, b = src / "a", src / "b"
    for d in (a, b):
        d.mkdir(parents=True)
    base_a, _ = _make_volume(a, 6, 1)
    ec_encode_volume(base_a, CTX, backend=CpuBackend(CTX))
    for i in range(CTX.parity_shards - 1):
        os.unlink(base_a + CTX.to_ext(i))
    path_a = base_a + CTX.to_ext(7)
    os.truncate(path_a, os.path.getsize(path_a) - 100)
    base_b, payloads = _make_volume(b, 6, 2)
    ec_encode_volume(base_b, CTX, backend=CpuBackend(CTX))
    for ext in [".ecx", ".ecj", ".vif", ".ecsum", ".dat", ".idx"] + [
            CTX.to_ext(i) for i in range(CTX.total)]:
        if os.path.exists(base_b + ext):
            os.rename(base_b + ext, str(b / "2") + ext)
    _flip(str(b / "2") + CTX.to_ext(2), 4096 + 5)

    def scenario(E, d):
        store = E.Store([str(d / "a"), str(d / "b")], ec_backend="cpu")
        try:
            obs = dict(vids=store.ec_volume_ids())
            daemon = E.ScrubDaemon(
                store, interval=3600.0, repair=True, backend=E.CpuBackend(CTX),
                breaker=E.CircuitBreaker(failure_threshold=1, reset_timeout=9999.0))
            fault = E.faults.inject("ec.rebuild.before_fsync", E.faults.io_error())
            try:
                reports = daemon.scrub_once()
            finally:
                fault.remove()
            obs.update(pass1={v: _report(r, d) for v, r in reports.items()},
                       breakers1={v: br.state for v, br in daemon.breakers.items()},
                       legit1={v: store.find_ec_volume(v).legitimate_shards() for v in (1, 2)})
            reports = daemon.scrub_once()
            obs.update(pass2={v: _report(r, d) for v, r in reports.items()},
                       breakers2={v: br.state for v, br in daemon.breakers.items()},
                       shards=_shards(d))
            daemon.start()
            daemon.kick()
            deadline = time.time() + 10
            while daemon.passes < 2 and time.time() < deadline:
                time.sleep(0.02)
            daemon.stop()
            obs["loop"] = daemon.passes >= 2 and not daemon._thread.is_alive()
            obs["reads"] = {i: store.read_needle(2, i).data == want for i, want in payloads.items()}
            return obs
        finally:
            store.close()

    j = _scrub_both(tmp_path, src, scenario)
    assert j["vids"] == [1, 2]
    assert j["pass1"][1]["quarantined"] and j["pass1"][1]["refused"].startswith("rebuild failed")
    assert list(j["pass1"][2]["leaf_repaired"]) == [2] and not j["pass1"][2]["refused"]
    assert j["breakers1"] == {1: "open", 2: "closed"}
    assert j["pass2"][1]["refused"].startswith("rebuild skipped") and j["pass2"][2]["healthy"]
    assert 7 in j["legit1"][1]
    assert j["loop"] and all(j["reads"].values())


# ---------------------------------------------------------- the Store itself


def test_store_write_read_delete_and_ec_fallback(tmp_path, clock):
    """allocate, write, read, delete through the Store; sealed and encoded,
    the plain volume unmounted and the EC one mounted, reads fall back to
    it: every live needle bit-exact, also with shard 3 unmounted
    (reconstructed), a deleted one NotFound, and status() as the JAX
    store gives it over the same files."""
    store = p_store.Store([str(tmp_path)], ec_backend="cpu")
    v = store.allocate_volume(1)
    assert _raises(lambda: store.allocate_volume(1))[0] == "VolumeError"
    payloads = {}
    for i in range(1, 41):
        payloads[i] = _data(i, 3000 + 97 * i)
        assert store.write_needle(1, p_needle.Needle(cookie=i, needle_id=i, data=payloads[i])) > 0
    for i in (3, 17):
        assert store.delete_needle(1, i) > 0
        del payloads[i]
    assert _raises(lambda: store.read_needle(2, 1))[0] == "NotFoundError"
    v.set_read_only(True)
    base = v.dat_path[:-4]
    ec_encode_volume(base, CTX, backend=CpuBackend(CTX))
    store.unmount_volume(1)
    assert store.volume_ids() == [] and store.mount_ec_volume(1) is store.find_ec_volume(1)
    store.unmount_ec_shards(1, [3])
    assert store.find_ec_volume(1).shard_ids == [i for i in range(CTX.total) if i != 3]
    for i, want in payloads.items():
        assert store.read_needle(1, i, cookie=i).data == want
    assert _raises(lambda: store.read_needle(1, 3))[0] == "EcNotFoundError"
    assert [e["shards"] for e in store.status()["ec_volumes"]] == [
        [i for i in range(CTX.total) if i != 3]]
    store.close()
    statuses = []
    for mod in (p_store, j_store):  # a restart: both mount the .dat and the EC volume
        st = mod.Store([str(tmp_path)], ec_backend="cpu")
        try:
            statuses.append(st.status())
        finally:
            st.close()
    assert statuses[0] == statuses[1] and statuses[0]["volumes"][0]["deleted_count"] == 2


def test_store_mounts_unmounts_and_rejects_unknown_backends(tmp_path):
    with pytest.raises(p_store.ECError, match="unknown EC backend"):
        p_store.Store([str(tmp_path)], ec_backend="tpu")
    store = p_store.Store([f"{tmp_path / 'a'}", f"{tmp_path / 'b'}:ssd"], ec_backend="cpu")
    try:
        assert [loc.disk_type for loc in store.locations] == ["hdd", "ssd"]
        v = store.allocate_volume(5, disk_type="ssd", replica_placement="001")
        assert v.directory == str(tmp_path / "b")
        v.write_needle(p_needle.Needle(cookie=1, needle_id=1, data=b"kept"))
        store.unmount_volume(5)
        assert store.find_volume(5) is None and os.path.exists(str(tmp_path / "b" / "5.dat"))
        assert store.mount_volume(5).read_needle(1).data == b"kept"
        assert store.status()["volumes"][0]["replica_placement"] == "001"
        assert _raises(lambda: store.allocate_volume(6, disk_type="nvme"))[0] == "VolumeError"
        store.delete_volume(5)
        assert not os.path.exists(str(tmp_path / "b" / "5.dat"))
        assert _raises(lambda: store.delete_volume(5))[0] == "NotFoundError"
        assert _raises(lambda: store.mount_ec_volume(7))[0] == "NotFoundError"
    finally:
        store.close()


@pytest.mark.parametrize("fsync_env", ["0", "1"])
def test_store_durable_writes_default_and_group_commit(tmp_path, monkeypatch, fsync_env):
    monkeypatch.setenv("SEAWEED_VOLUME_FSYNC", fsync_env)
    assert p_store.durable_writes_default() == j_store.durable_writes_default() == (fsync_env == "1")
    monkeypatch.setenv("SEAWEED_VOLUME_GROUP_COMMIT_MS", "5")
    store = p_store.Store([str(tmp_path)], ec_backend="cpu")
    try:
        store.allocate_volume(1)
        threads = [threading.Thread(target=store.write_needle,
                                    args=(1, p_needle.Needle(cookie=i, needle_id=i, data=DATA1)))
                   for i in range(1, 9)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert (store.find_volume(1)._committer is not None) == (fsync_env == "1")
    finally:
        store.close()
    # close() stopped every committer thread
    assert not [t for t in threading.enumerate() if t.name.startswith("group-commit-")]


def test_store_shares_one_interval_cache_and_scope(tmp_path):
    from seaweedfs_tpu_torch.ec.device_queue import QueueScope, default_scope

    plain = p_store.Store([str(tmp_path / "a")], ec_backend="cpu")
    tuned = p_store.Store([str(tmp_path / "b")], ec_backend="cpu", ec_queue_window=2,
                          ec_interval_cache_bytes=0)
    try:
        assert plain.ec_scheduler is default_scope() and plain.ec_interval_cache.capacity == 64 << 20
        assert isinstance(tuned.ec_scheduler, QueueScope) and tuned.ec_scheduler is not default_scope()
        assert tuned.ec_interval_cache is None
    finally:
        plain.close()
        tuned.close()


def test_cuda_store_without_a_card_raises_at_its_ec_volume(tmp_path, monkeypatch):
    """The default backend is the card: a Store over an EC volume, with no
    card, raises where the volume's backend is built, never falls back."""
    import torch

    base, _ = _make_volume(tmp_path, 3, 9)
    ec_encode_volume(base, CTX, backend=CpuBackend(CTX))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert p_store.Store.__init__.__defaults__[3] == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p_store.Store([str(tmp_path)])


def test_repair_patch_split_accounts_every_fsync(tmp_path, monkeypatch):
    """A ScrubDaemon leaf repair with each fsync made to take 20 ms: the
    stages dict's "repair_patch.fsync" holds at least the fsyncs the
    journal protocol makes (journal, its directory, shard, the retired
    journal's directory; the sidecar already holds the repaired leaf's
    CRC, so it is not published again) and, with
    "repair_patch.work", adds up to "repair_patch"; `fsync_seconds` nests."""
    from seaweedfs_tpu_torch.ec import repair_journal
    from seaweedfs_tpu_torch.utils import fs

    base, _ = _make_volume(tmp_path, 6, 31)
    ec_encode_volume(base, CTX, backend=CpuBackend(CTX))
    _flip(base + CTX.to_ext(1), 70_000)
    real = os.fsync
    calls = [0]

    def slow(fd):
        calls[0] += 1
        time.sleep(0.02)
        real(fd)

    stages: dict = {}
    apply = repair_journal.apply_leaf_repair

    def recorded(*a, **kw):
        return apply(*a, **{**kw, "stages": stages})

    monkeypatch.setattr(os, "fsync", slow)
    monkeypatch.setattr("seaweedfs_tpu_torch.ec.scrub.apply_leaf_repair", recorded)
    store = p_store.Store([str(tmp_path)], ec_backend="cpu")
    try:
        r = ScrubDaemon(store, repair=True, backend=CpuBackend(CTX)).scrub_once()[1]
    finally:
        store.close()
    assert list(r.leaf_repaired) == [1]
    assert stages["repair_patch.fsync"] >= 4 * 0.02
    assert stages["repair_patch.fsync"] + stages["repair_patch.work"] == pytest.approx(
        stages["repair_patch"], abs=1e-3)
    with fs.fsync_seconds() as outer:
        with fs.fsync_seconds() as inner:
            fs.fsync_dir(str(tmp_path / "x"))
        assert outer[0] == inner[0] >= 0.02
