"""PyTorch port: the EC read path (needle reads, degraded reads with
on-the-fly reconstruction, the interval cache) and `ec.decode`, held
against the JAX package on the CPU.

The volume is written with real needles by the JAX package's storage
engine and EC-encoded at the default layout (the layout EcVolume and the
decoder read; a volume under 10 GiB is all 1 MiB small-block rows),
under both sidecar versions: v1 (16 MiB block CRCs) and v2 (64 KiB leaf
CRCs). The port's `EcVolume` on the CPU, under both kernel impls
("cuda" and "cuda_planes", `TorchBackend(device="cpu")`, which run their
plain versions for CPU tensors) and on the native `CpuBackend` (the name
"cpu"), must return the same needle bytes and raise the same errors as
the JAX `EcVolume(..., backend_name="cpu")`; the port's
`ec_decode_volume` must write the same .dat and .idx as the JAX one on
the Pallas plane-stack kernel in interpret mode. Tolerance 0.
"""

import json
import os
import shutil
import threading
import time
from dataclasses import replace

import numpy as np
import pytest
import torch

import seaweedfs_tpu.ec.ec_volume as jax_ecv
from seaweedfs_tpu.ec import CpuBackend, JaxBackend
from seaweedfs_tpu.ec import ECContext as JaxECContext
from seaweedfs_tpu.ec import EcVolume as JaxEcVolume
from seaweedfs_tpu.ec import ec_encode_volume as jax_ec_encode_volume
from seaweedfs_tpu.ec.decoder import ec_decode_volume as jax_ec_decode_volume
from seaweedfs_tpu.storage.needle import Needle as JaxNeedle
from seaweedfs_tpu.storage.volume import Volume
import seaweedfs_tpu_torch.ec.ec_volume as port_ecv
from seaweedfs_tpu_torch.ec import (
    BitrotProtection,
    ECContext,
    ECError,
    EcVolume,
    TorchBackend,
    VolumeInfo,
    ec_decode_volume,
    ec_encode_volume,
)
from seaweedfs_tpu_torch.ec.decoder import find_dat_file_size
from seaweedfs_tpu_torch.ec.locate import locate_data
from seaweedfs_tpu_torch.storage.needle import CrcError, Needle
from seaweedfs_tpu_torch.storage.needle_map import SortedFileNeedleMap
from seaweedfs_tpu_torch.storage.types import (
    TOMBSTONE_FILE_SIZE,
    actual_offset,
    to_stored_offset,
)

# One intra-op thread: the products here are small, and the suite runs
# in several worker processes at once, where torch's default of one
# thread per core would oversubscribe the CPU for every other test.
torch.set_num_threads(1)

CTX = ECContext(10, 4)
JCTX = JaxECContext(10, 4)
IMPLS = ["cuda", "cuda_planes"]
LEAVES = [0, 65536]  # v1 and v2 sidecars


@pytest.fixture(scope="module")
def sealed(tmp_path_factory):
    """A sealed volume of 120 real needles (about 3.6 MB: data on shards
    0 to 3 of one 10 x 1 MiB row) and its payloads; needles 5 and 17 are
    deleted before sealing."""
    d = tmp_path_factory.mktemp("sealed")
    rng = np.random.default_rng(0)
    v = Volume(str(d), 1)
    payloads = {}
    for i in range(1, 121):
        data = rng.integers(0, 256, int(rng.integers(1, 60_000)), dtype=np.uint8).tobytes()
        v.write_needle(JaxNeedle(cookie=0x1000 + i, needle_id=i, data=data))
        payloads[i] = data
    for i in (5, 17):
        v.delete_needle(i)
        del payloads[i]
    v.close()
    return os.path.join(str(d), "1"), payloads


@pytest.fixture(scope="module")
def encoded(sealed, tmp_path_factory):
    """leaf_size -> directory holding the port-encoded volume."""
    base, _ = sealed
    out = {}
    for leaf in LEAVES:
        d = tmp_path_factory.mktemp(f"enc{leaf}")
        for ext in (".dat", ".idx"):
            shutil.copy(base + ext, os.path.join(str(d), "1" + ext))
        ec_encode_volume(
            os.path.join(str(d), "1"), CTX, backend=TorchBackend(CTX, device="cpu"),
            leaf_size=leaf,
        )
        out[leaf] = str(d)
    return out


def _copy(src_dir: str, dst_dir) -> str:
    dst_dir = str(dst_dir)
    os.makedirs(dst_dir, exist_ok=True)
    for name in os.listdir(src_dir):
        shutil.copy(os.path.join(src_dir, name), os.path.join(dst_dir, name))
    return os.path.join(dst_dir, "1")


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _flip(path: str, at: int, mask: int = 0x40) -> None:
    with open(path, "r+b") as f:
        f.seek(at)
        b = f.read(1)
        f.seek(at)
        f.write(bytes([b[0] ^ mask]))


def _volumes(d: str, impl: str, **kw):
    port = EcVolume(d, 1, backend=TorchBackend(CTX, device="cpu", impl=impl), **kw)
    jax = JaxEcVolume(d, 1, backend_name="cpu", **kw)
    return port, jax


def _outcome(ev, nid, cookie):
    try:
        n = ev.read_needle(nid, cookie=cookie)
    except Exception as e:  # noqa: BLE001 - the outcome under test
        return type(e).__name__
    return (n.cookie, n.needle_id, n.data, n.flags, n.checksum, n.append_at_ns)


def _shard_of(ev, nid):
    """Shard ids that hold the needle's record."""
    nv = ev.find_needle(nid)
    off = actual_offset(nv.offset)
    size = port_ecv.record_actual_size(nv.size, ev.version)
    return {
        iv.to_shard_and_offset(10)[0]
        for iv in locate_data(off, size, ev._locate_shard_size, 10)
    }


# ------------------------------------------------------------------ reads


SCENARIOS = {"healthy": [], "one_lost": [0], "two_lost": [1, 3]}


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("leaf", LEAVES)
@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_reads_match_jax(encoded, sealed, scenario, leaf, impl):
    _, payloads = sealed
    port, jax = _volumes(encoded[leaf], impl)
    # both volumes restore their counters from the same .heat sidecar
    port_read0, port_rec0, jax_read0 = port.bytes_read, port.bytes_reconstructed, jax.bytes_read
    assert (port_read0, port_rec0) == (jax_read0, jax.bytes_reconstructed)
    try:
        for ev in (port, jax):
            ev.unmount_shards(SCENARIOS[scenario])
        for nid in range(1, 122):  # 5 and 17 were deleted, 121 never existed
            got = _outcome(port, nid, 0x1000 + nid)
            assert got == _outcome(jax, nid, 0x1000 + nid), nid
            if nid in payloads:
                assert got[2] == payloads[nid]
            else:
                assert got == "EcNotFoundError"
        if SCENARIOS[scenario]:
            assert port.bytes_reconstructed > port_rec0
            assert port.stage_seconds["reconstruct"] > 0
            assert port.stage_seconds["sibling_read"] > 0
            assert port.stage_seconds["crc_verify"] > 0
        else:
            assert port.bytes_reconstructed == port_rec0
        assert port.bytes_read - port_read0 == jax.bytes_read - jax_read0
    finally:
        port.close()
        jax.close()


@pytest.mark.parametrize("impl", IMPLS)
def test_fewer_than_k_shards_raises_like_jax(encoded, impl):
    port, jax = _volumes(encoded[65536], impl)
    try:
        for ev in (port, jax):
            ev.unmount_shards([0, 1, 2, 3, 4])
        lost = [nid for nid in (1, 2, 3, 4) if _shard_of(port, nid) & {0, 1, 2, 3, 4}]
        assert lost
        for nid in lost:
            assert _outcome(port, nid, None) == _outcome(jax, nid, None) == "ECError"
        with pytest.raises(ECError, match="need 10"):
            port.read_needle(lost[0])
    finally:
        port.close()
        jax.close()


@pytest.mark.parametrize("impl", IMPLS)
def test_cookie_mismatch_and_deleted_needle(encoded, tmp_path, impl):
    d = os.path.dirname(_copy(encoded[65536], tmp_path))
    port, jax = _volumes(d, impl)
    try:
        for ev in (port, jax):
            ev.unmount_shards([0])
        for nid in (1, 8):
            assert _outcome(port, nid, 0xBAD) == _outcome(jax, nid, 0xBAD) == "EcCookieMismatch"
        assert port.delete_needle(8) == jax.delete_needle(8) > 0
        assert port.delete_needle(8) == jax.delete_needle(8) == 0
        assert not port.has_needle(8) and not jax.has_needle(8)
        assert _outcome(port, 8, None) == _outcome(jax, 8, None) == "EcNotFoundError"
    finally:
        port.close()
        jax.close()
    # the .ecj tombstone survives a remount
    port = EcVolume(d, 1, backend="cpu")
    assert not port.has_needle(8) and port.has_needle(9)
    port.close()


@pytest.mark.parametrize("impl", IMPLS)
def test_rotten_sibling_is_excluded(encoded, sealed, tmp_path, impl):
    _, payloads = sealed
    d = os.path.dirname(_copy(encoded[65536], tmp_path))
    base = os.path.join(d, "1")
    port, jax = _volumes(d, impl)
    try:
        for ev in (port, jax):
            ev.unmount_shards([0])
        nid = next(n for n in payloads if _shard_of(port, n) == {0})
        nv = port.find_needle(nid)
        # rot shard 1 (a source of every shard-0 reconstruction) inside
        # the same leaf range
        _flip(base + ".ec01", actual_offset(nv.offset) + 100)
        got = _outcome(port, nid, 0x1000 + nid)
        assert got == _outcome(jax, nid, 0x1000 + nid)
        assert got[2] == payloads[nid]
    finally:
        port.close()
        jax.close()


@pytest.mark.parametrize("impl", IMPLS)
def test_crc_error_heals_through_verified_reconstruction(encoded, sealed, tmp_path, impl):
    _, payloads = sealed
    d = os.path.dirname(_copy(encoded[65536], tmp_path))
    base = os.path.join(d, "1")
    port, jax = _volumes(d, impl)
    try:
        nid = next(n for n in payloads if _shard_of(port, n) == {2})
        nv = port.find_needle(nid)
        # row 0 of the small blocks: shard 2 holds .dat [2 MiB, 3 MiB)
        _flip(base + ".ec02", actual_offset(nv.offset) - 2 * (1 << 20) + 40)
        raw = port._read_extent(
            actual_offset(nv.offset), port_ecv.record_actual_size(nv.size, 3)
        )
        with pytest.raises(CrcError):
            Needle.from_bytes(raw)
        got = _outcome(port, nid, 0x1000 + nid)
        assert got == _outcome(jax, nid, 0x1000 + nid)
        assert got[2] == payloads[nid]
        assert port.bytes_reconstructed > 0
    finally:
        port.close()
        jax.close()


@pytest.mark.parametrize("impl", IMPLS)
def test_rotten_reconstruction_is_refused(encoded, sealed, tmp_path, impl):
    """A sidecar whose leaf CRC for the lost shard is wrong: the verified
    reconstruction must be refused, never served."""
    _, payloads = sealed
    d = os.path.dirname(_copy(encoded[65536], tmp_path))
    base = os.path.join(d, "1")
    prot = BitrotProtection.load(base + ".ecsum")
    leaves = [list(r) for r in prot.shard_leaf_crcs]
    leaves[0] = [c ^ 1 for c in leaves[0]]
    replace(prot, shard_leaf_crcs=leaves).save(base + ".ecsum")
    port, jax = _volumes(d, impl)
    try:
        for ev in (port, jax):
            ev.unmount_shards([0])
        nid = next(n for n in payloads if _shard_of(port, n) == {0})
        assert _outcome(port, nid, None) == _outcome(jax, nid, None) == "ECError"
        with pytest.raises(ECError, match="refusing to serve"):
            port.read_needle(nid)
        assert port.interval_cache.size_bytes == 0
    finally:
        port.close()
        jax.close()


@pytest.mark.parametrize("impl", IMPLS)
def test_staged_degraded_reads_match_jax(encoded, sealed, monkeypatch, impl):
    """Shrinking the staged-batch threshold sends every reconstruction
    (64 KiB leaf extents) through run_staged_apply."""
    _, payloads = sealed
    monkeypatch.setattr(port_ecv, "STAGED_RECOVERY_BATCH", 2048)
    monkeypatch.setattr(jax_ecv, "STAGED_RECOVERY_BATCH", 2048)
    port, jax = _volumes(encoded[65536], impl, interval_cache_bytes=0)
    calls = []
    real = port.backend.apply_staged
    port.backend.apply_staged = lambda c, s: calls.append(1) or real(c, s)
    try:
        for ev in (port, jax):
            ev.unmount_shards([0])
        for nid in payloads:
            got = _outcome(port, nid, 0x1000 + nid)
            assert got == _outcome(jax, nid, 0x1000 + nid)
            assert got[2] == payloads[nid]
        assert len(calls) > 10
    finally:
        del port.backend.apply_staged
        port.close()
        jax.close()


def test_remote_reader_serves_shards_held_elsewhere(encoded, sealed, tmp_path):
    """Five data shards unmounted locally (fewer than k left): the
    remote_reader hook serves direct reads and reconstruction sources,
    with the generation fence passed through."""
    _, payloads = sealed
    d = os.path.dirname(_copy(encoded[65536], tmp_path))
    base = os.path.join(d, "1")
    served = []

    def remote(sid, off, size, gen):
        served.append((sid, gen))
        if sid == 0:
            return None  # this peer lost shard 0 too: reconstruct it
        with open(base + f".ec{sid:02d}", "rb") as f:
            f.seek(off)
            return f.read(size)

    ev = EcVolume(
        d, 1, backend=TorchBackend(CTX, device="cpu", impl="cuda_planes"), remote_reader=remote
    )
    try:
        ev.unmount_shards([0, 1, 2, 3, 4])
        for nid, data in payloads.items():
            assert ev.read_needle(nid, cookie=0x1000 + nid).data == data
        assert {sid for sid, _ in served} >= {0, 1, 2, 3}
        assert {gen for _, gen in served} == {ev.encode_ts_ns} and ev.encode_ts_ns > 0
        assert ev.bytes_reconstructed > 0
    finally:
        ev.close()


def test_quarantined_shards_and_collection_names(encoded, tmp_path):
    d = str(tmp_path)
    for name in os.listdir(encoded[65536]):
        shutil.copy(os.path.join(encoded[65536], name), os.path.join(d, "pics_" + name))
    os.rename(os.path.join(d, "pics_1.ec06"), os.path.join(d, "pics_1.ec06.bad"))
    ev = EcVolume(d, 1, collection="pics", backend="cpu")
    try:
        assert ev.base == os.path.join(d, "pics_1")
        assert ev.shard_ids == [i for i in range(14) if i != 6]
        assert ev.quarantined_shards() == [6]
        assert ev.read_needle(1, cookie=0x1001).needle_id == 1
    finally:
        ev.close()


# ----------------------------------------------------------- interval cache


def test_interval_cache_hit_on_repeat_reads(encoded, sealed):
    _, payloads = sealed
    ev = EcVolume(encoded[65536], 1, backend=TorchBackend(CTX, device="cpu", impl="cuda_planes"))
    try:
        ev.unmount_shards([0])
        for nid, data in payloads.items():
            assert ev.read_needle(nid, cookie=0x1000 + nid).data == data
        first_pass, loads, h0 = ev.bytes_read, ev.interval_cache.loads, ev.interval_cache.hits
        rec = ev.bytes_reconstructed
        for nid, data in payloads.items():
            assert ev.read_needle(nid, cookie=0x1000 + nid).data == data
        assert ev.interval_cache.hits > h0
        assert ev.interval_cache.loads == loads
        assert ev.bytes_reconstructed == rec
        # repeats re-read only the live shards' intervals
        assert ev.bytes_read - first_pass < first_pass / 4
    finally:
        ev.close()


def test_interval_cache_invalidated_on_unmount_reopen_delete(encoded, sealed, tmp_path):
    _, payloads = sealed
    d = os.path.dirname(_copy(encoded[65536], tmp_path))
    ev = EcVolume(d, 1, backend="cpu")
    try:
        ev.unmount_shards([0])
        nid = next(n for n in payloads if _shard_of(ev, n) == {0})
        ev.read_needle(nid)
        assert ev.interval_cache.size_bytes > 0
        ev.delete_needle(max(payloads))  # delete drops this volume's extents
        assert ev.interval_cache.size_bytes == 0
        ev.read_needle(nid)
        assert ev.interval_cache.size_bytes > 0
        assert ev.reopen_shards([0]) == list(range(14))  # remount drops
        assert ev.interval_cache.size_bytes == 0
        b0 = ev.bytes_read
        assert ev.read_needle(nid).data == payloads[nid]  # served directly now
        assert ev.interval_cache.size_bytes == 0 and ev.bytes_read > b0
        ev.unmount_shards([0])
        ev.read_needle(nid)
        assert ev.interval_cache.size_bytes > 0
        ev.unmount_shards([0])  # unmount drops too
        assert ev.interval_cache.size_bytes == 0
        assert ev.refresh_shards() == list(range(14))
    finally:
        ev.close()


def test_interval_cache_disabled(encoded, sealed):
    _, payloads = sealed
    ev = EcVolume(encoded[65536], 1, backend="cpu", interval_cache_bytes=0)
    try:
        assert ev.interval_cache is None
        ev.unmount_shards([0])
        nid = next(n for n in payloads if _shard_of(ev, n) == {0})
        for _ in range(2):
            assert ev.read_needle(nid).data == payloads[nid]
        assert ev.bytes_reconstructed > 0
    finally:
        ev.close()


def test_invalidate_shard_ranges_drops_only_overlapping_extents(encoded, sealed):
    _, payloads = sealed
    ev = EcVolume(encoded[65536], 1, backend="cpu")
    try:
        ev.unmount_shards([0])
        on0 = [n for n in payloads if 0 in _shard_of(ev, n)]
        for nid in on0:
            ev.read_needle(nid)
        before = ev.interval_cache.stats()["entries"]
        assert before >= 2
        overlapping = [
            nid for nid in on0 if actual_offset(ev.find_needle(nid).offset) < 65536
        ]
        assert overlapping
        ev.invalidate_shard_ranges(0, [(0, 1)])  # the first leaf of shard 0
        after = ev.interval_cache.stats()["entries"]
        assert 0 < after < before
        loads = ev.interval_cache.loads
        for nid in on0[-3:]:  # extents past the first leaf stay cached
            ev.read_needle(nid)
        assert ev.interval_cache.loads == loads
    finally:
        ev.close()


@pytest.mark.parametrize("impl", IMPLS)
def test_concurrent_degraded_readers_collapse_to_one_reconstruct(encoded, sealed, impl):
    _, payloads = sealed
    ev = EcVolume(encoded[65536], 1, backend=TorchBackend(CTX, device="cpu", impl=impl))
    calls = []
    real = ev.backend.reconstruct

    def slow(shards, want=None):
        calls.append(want)
        time.sleep(0.2)  # hold the flight open while the others arrive
        return real(shards, want=want)

    ev.backend.reconstruct = slow
    try:
        ev.unmount_shards([0])
        nid = next(n for n in payloads if _shard_of(ev, n) == {0})
        barrier = threading.Barrier(12)
        results = [None] * 12

        def reader(t):
            barrier.wait()
            results[t] = ev.read_needle(nid, cookie=0x1000 + nid).data

        threads = [threading.Thread(target=reader, args=(t,)) for t in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert calls == [[0]]
        assert all(r == payloads[nid] for r in results)
        assert ev.interval_cache.singleflight_waits == 11
    finally:
        ev.close()


# ------------------------------------------------------------------ decode


def _jax_pallas_aligned():
    return JaxBackend(JCTX, impl="pallas_aligned", interpret=True, n_devices=1)


def _decode_both(src_dir, tmp_path, prepare=None):
    """Copies of one encoded volume; `prepare(base)` runs on each; then
    the port's and the JAX package's decode. Returns the two bases and
    both results (a value or the exception's type name)."""
    bases = []
    for who in ("port", "jax"):
        base = _copy(src_dir, tmp_path / who)
        os.unlink(base + ".dat")
        os.unlink(base + ".idx")
        if prepare is not None:
            prepare(base)
        bases.append(base)
    results = []
    for base, fn in (
        (bases[0], lambda b: ec_decode_volume(b, CTX, backend=TorchBackend(CTX, device="cpu", impl="cuda_planes"))),
        (bases[1], lambda b: jax_ec_decode_volume(b, JCTX, backend=_jax_pallas_aligned())),
    ):
        try:
            results.append(fn(base))
        except Exception as e:  # noqa: BLE001 - the outcome under test
            results.append(type(e).__name__)
    return bases, results


def _delete(base, ids):
    with open(base + ".ecj", "ab") as f:
        for nid in ids:
            f.write(int(nid).to_bytes(8, "big"))


DECODE_CASES = {
    "nothing_missing": None,
    "missing_data_shard": lambda b: os.unlink(b + ".ec02"),
    "rotten_data_shard": lambda b: _flip(b + ".ec01", 777),
    "ecj_tombstones": lambda b: _delete(b, [3, 9, 120]),
}


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_decode_matches_jax(encoded, sealed, tmp_path, case):
    base0, _ = sealed
    src = encoded[65536]
    originals = {i: _read(os.path.join(src, f"1.ec{i:02d}")) for i in range(14)}
    (port, jax), results = _decode_both(src, tmp_path, DECODE_CASES[case])
    assert results == [True, True]
    assert _read(port + ".dat") == _read(jax + ".dat")
    assert _read(port + ".idx") == _read(jax + ".idx")
    size = find_dat_file_size(port, 3)
    assert _read(port + ".dat") == _read(base0 + ".dat")[:size]
    for i in range(10):  # healed data shards, bit-exact
        assert _read(port + f".ec{i:02d}") == originals[i]
    assert not os.path.exists(port + ".ecj")
    if case == "ecj_tombstones":
        idx = _read(port + ".idx")
        sizes = {
            int.from_bytes(idx[o : o + 8], "big"): int.from_bytes(idx[o + 12 : o + 16], "big", signed=True)
            for o in range(0, len(idx), 16)
        }
        assert all(sizes[n] == TOMBSTONE_FILE_SIZE for n in (3, 9, 120))


def test_decode_fewer_than_k_fails_closed_like_jax(encoded, tmp_path):
    def lose5(base):
        for i in range(5):
            os.unlink(base + f".ec{i:02d}")

    (port, jax), results = _decode_both(encoded[65536], tmp_path, lose5)
    assert results == ["ECError", "ECError"]
    assert not os.path.exists(port + ".dat") and not os.path.exists(jax + ".dat")


def test_decode_fully_deleted_volume_returns_false(encoded, sealed, tmp_path):
    _, payloads = sealed
    (port, jax), results = _decode_both(
        encoded[65536], tmp_path, lambda b: _delete(b, payloads)
    )
    assert results == [False, False]
    assert _read(port + ".ecx") == _read(jax + ".ecx")


# -------------------------------------------------------- across packages


def test_port_reads_and_decodes_a_jax_encoded_volume(sealed, tmp_path):
    base0, payloads = sealed
    base = os.path.join(str(tmp_path), "1")
    for ext in (".dat", ".idx"):
        shutil.copy(base0 + ext, base + ext)
    jax_ec_encode_volume(base, JCTX, backend=CpuBackend(JCTX))
    ev = EcVolume(str(tmp_path), 1, backend=TorchBackend(CTX, device="cpu", impl="cuda_planes"))
    try:
        ev.unmount_shards([0, 7])
        for nid, data in payloads.items():
            assert ev.read_needle(nid, cookie=0x1000 + nid).data == data
    finally:
        ev.close()
    os.unlink(base + ".ec07")
    original = _read(base + ".dat")
    os.unlink(base + ".dat")
    assert ec_decode_volume(base, backend=TorchBackend(CTX, device="cpu", impl="cuda_planes"))
    assert original.startswith(_read(base + ".dat"))


def test_jax_reads_and_decodes_a_port_encoded_volume(encoded, sealed, tmp_path):
    base0, payloads = sealed
    base = _copy(encoded[65536], tmp_path)
    jev = JaxEcVolume(str(tmp_path), 1, backend_name="cpu")
    try:
        jev.unmount_shards([3])
        for nid, data in payloads.items():
            assert jev.read_needle(nid, cookie=0x1000 + nid).data == data
    finally:
        jev.close()
    os.unlink(base + ".dat")
    assert jax_ec_decode_volume(base, JCTX, backend=CpuBackend(JCTX))
    assert _read(base0 + ".dat").startswith(_read(base + ".dat"))


# -------------------------------------------------------- storage modules


def test_needle_bytes_match_the_jax_package():
    rng = np.random.default_rng(4)
    for version in (2, 3):
        for size in (0, 1, 7, 1000):
            data = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
            ours = Needle(cookie=7, needle_id=99, data=data, append_at_ns=123)
            theirs = JaxNeedle(cookie=7, needle_id=99, data=data, append_at_ns=123)
            if size == 7:
                for n in (ours, theirs):
                    n.set_name(b"a.txt")
                    n.set_mime(b"text/plain")
                    n.set_last_modified(1_700_000_000)
            raw = ours.to_bytes(version)
            assert raw == theirs.to_bytes(version)
            assert ours.disk_size(version) == len(raw)
            back = Needle.from_bytes(raw, version)
            assert (back.data, back.name, back.cookie) == (data, ours.name, 7)
    bad = bytearray(Needle(cookie=1, needle_id=2, data=b"xyz").to_bytes())
    bad[21] ^= 1
    with pytest.raises(CrcError):
        Needle.from_bytes(bytes(bad))
    from seaweedfs_tpu.storage.super_block import SuperBlock as JaxSuperBlock
    from seaweedfs_tpu_torch.storage.super_block import SuperBlock

    raw = JaxSuperBlock(version=2, compaction_revision=7).to_bytes()
    sb = SuperBlock.from_bytes(raw)
    assert (sb.version, sb.compaction_revision) == (2, 7)
    assert sb.to_bytes() == raw and SuperBlock().to_bytes() == JaxSuperBlock().to_bytes()
    with pytest.raises(ValueError):
        SuperBlock.from_bytes(b"\x09" + bytes(7))
    assert to_stored_offset(4096) == 512
    with pytest.raises(ValueError):
        to_stored_offset(4097)


def test_sorted_file_needle_map(encoded, sealed):
    _, payloads = sealed
    m = SortedFileNeedleMap(os.path.join(encoded[0], "1.ecx"))
    try:
        assert len(m) == len(payloads)
        assert [nv.needle_id for nv in m.ascending_visit()] == sorted(payloads)
        assert m.get(5) is None and m.get(1 << 40) is None
        assert m.get(9).needle_id == 9
    finally:
        m.close()


# ------------------------------------------------------- the .heat sidecar


def _mount(side: str, d: str):
    if side == "port":
        return EcVolume(d, 1, backend=TorchBackend(CTX, device="cpu"))
    return JaxEcVolume(d, 1, backend_name="cpu")


def _generation(base: str) -> int:
    return VolumeInfo.load(base + ".vif").encode_ts_ns


def _degraded_reads(ev, payloads) -> None:
    ev.unmount_shards([1])
    for nid in (1, 2, 3, 40, 41, 90):
        assert ev.read_needle(nid, cookie=0x1000 + nid).data == payloads[nid]


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_heat_written_by_one_package_read_by_the_other(encoded, sealed, tmp_path, writer, reader):
    _, payloads = sealed
    base = _copy(encoded[65536], tmp_path)
    ev = _mount(writer, str(tmp_path))
    _degraded_reads(ev, payloads)
    counters = (ev.bytes_read, ev.bytes_reconstructed)
    ev.close()
    assert counters[0] > 0 and counters[1] > 0
    heat = json.loads(_read(base + ".heat"))
    assert (heat["read_bytes"], heat["reconstructed_bytes"]) == counters
    assert heat["gen"] == _generation(base) > 0
    other = _mount(reader, str(tmp_path))
    try:
        assert (other.bytes_read, other.bytes_reconstructed) == counters
    finally:
        other.close()


def test_heat_files_equal_after_the_same_reads(encoded, sealed, tmp_path):
    """The same reads on two copies of one volume, one per package: the
    counters agree, and so do the .heat files, byte for byte."""
    _, payloads = sealed
    files = {}
    for side in ("port", "jax"):
        base = _copy(encoded[65536], tmp_path / side)
        ev = _mount(side, str(tmp_path / side))
        _degraded_reads(ev, payloads)
        ev.close()
        files[side] = _read(base + ".heat")
    assert files["port"] == files["jax"]


@pytest.mark.parametrize("side", ["port", "jax"])
def test_heat_fenced_by_generation(encoded, sealed, tmp_path, side):
    """Counters of a volume re-encoded under the same id are dropped."""
    base, payloads = sealed
    vbase = _copy(encoded[65536], tmp_path)
    ev = _mount("port", str(tmp_path))
    _degraded_reads(ev, payloads)
    ev.close()
    assert json.loads(_read(vbase + ".heat"))["read_bytes"] > 0
    ec_encode_volume(vbase, CTX, backend=TorchBackend(CTX, device="cpu"))  # a new generation
    ev = _mount(side, str(tmp_path))
    try:
        assert (ev.bytes_read, ev.bytes_reconstructed) == (0, 0)
    finally:
        ev.close()


@pytest.mark.parametrize("junk", [b"", b"{not json", b"[1,", b'{"gen": "x", "read_bytes": "y"}'])
@pytest.mark.parametrize("side", ["port", "jax"])
def test_corrupt_heat_starts_cold(encoded, tmp_path, side, junk):
    base = _copy(encoded[65536], tmp_path)
    with open(base + ".heat", "wb") as f:
        f.write(junk)
    ev = _mount(side, str(tmp_path))
    try:
        assert (ev.bytes_read, ev.bytes_reconstructed) == (0, 0)
    finally:
        ev.close()
    assert json.loads(_read(base + ".heat"))["read_bytes"] == 0  # close rewrote it
