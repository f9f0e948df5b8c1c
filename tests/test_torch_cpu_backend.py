"""PyTorch port: the native CPU backend (`CpuBackend`, the GF(2^8) apply
of csrc/seaweed_native.cpp) held against the JAX package's `CpuBackend`,
its native library and the numpy oracle, on the CPU. Tolerance 0.

- the library's apply: `rs_apply` against JAX `rs_apply` and the oracle
  over m, k and widths on and off every vector edge, with zero and one
  coefficients, misaligned and strided data, and each multiply body
  (scalar, SSSE3, AVX2) through the test-only entry where the CPU has
  it; `rs_apply_mt` on the worker pool against `rs_apply` across its
  64 KiB threshold for 1-9 threads; `gf_mul` over the whole table;
  `has_avx2` against /proc/cpuinfo; a first use raced from 8 threads in
  a fresh interpreter;
- the backend's surface against JAX `CpuBackend` at 10+4 and 4+2, and
  `get_backend("cpu")`;
- encode, rebuild, decode, a degraded read, a leaf repair and a short
  stream through the port's `CpuBackend`, file for file against the JAX
  package on its own `CpuBackend`;
- a failed build or load raises, and nothing computes the bytes with the
  numpy tables instead.
"""

import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

from seaweedfs_tpu.ec import CpuBackend as JaxCpuBackend
from seaweedfs_tpu.ec import ECContext as JaxECContext
from seaweedfs_tpu.ec import EcStreamEncoder as JaxStreamEncoder
from seaweedfs_tpu.ec import EcVolume as JaxEcVolume
from seaweedfs_tpu.ec import ec_encode_volume as jax_ec_encode_volume
from seaweedfs_tpu.ec import rebuild_ec_files as jax_rebuild_ec_files
from seaweedfs_tpu.ec.decoder import ec_decode_volume as jax_ec_decode_volume
from seaweedfs_tpu.ec.scrub import scrub_ec_volume as jax_scrub
from seaweedfs_tpu.storage.needle import Needle
from seaweedfs_tpu.storage.volume import Volume
from seaweedfs_tpu.utils import native as jax_native
from seaweedfs_tpu_torch import faults as port_faults
from seaweedfs_tpu_torch.ec import (
    BitrotProtection,
    CpuBackend,
    ECContext,
    ECError,
    EcStreamEncoder,
    EcVolume,
    TorchBackend,
    ec_decode_volume,
    ec_encode_volume,
    get_backend,
    rebuild_ec_files,
    scrub_ec_volume,
)
from seaweedfs_tpu_torch.mq import stream_parity as port_sp
from seaweedfs_tpu_torch.ops import _build, gf256
from seaweedfs_tpu_torch.ops import rs_kernels
from seaweedfs_tpu_torch.utils import native

REPO = pathlib.Path(__file__).resolve().parent.parent
KIB, MIB = 1 << 10, 1 << 20
WIDTHS = (1, 15, 16, 17, 31, 32, 33, 64 * KIB - 1, 64 * KIB, MIB - 3, MIB)
GEOMETRIES = {"10+4": (10, 4), "4+2": (4, 2)}


@pytest.fixture(autouse=True)
def _clear_port_registry():
    port_faults.clear()
    yield
    port_faults.clear()


def _coeffs(rng, m: int, k: int) -> np.ndarray:
    """Random coefficients with zeros and ones placed where the apply
    takes its skip and its plain-XOR branches: one 0 and one 1 in the
    first row, and from m = 3 on a row of zeros and a row of ones."""
    c = rng.integers(2, 256, (m, k), dtype=np.uint8)
    c[0, 0] = 0
    c[0, -1] = 1
    if m >= 3:
        c[1, :] = 0
        c[2, :] = 1
    return c


# ------------------------------------------------------- the library's apply


@pytest.mark.parametrize("n", WIDTHS)
@pytest.mark.parametrize("k", [1, 4, 10])
@pytest.mark.parametrize("m", [1, 2, 4, 7])
def test_rs_apply_matches_jax_and_oracle(m, k, n):
    rng = np.random.default_rng(1000 * m + 10 * k + n % 997)
    coeffs = _coeffs(rng, m, k)
    data = rng.integers(0, 256, (k, n), dtype=np.uint8)
    want = gf256.matrix_apply(coeffs, data)
    got = native.rs_apply(coeffs, data)
    assert got.shape == (m, n) and got.dtype == np.uint8
    assert np.array_equal(got, want)
    assert np.array_equal(jax_native.rs_apply(coeffs, data), want)
    # data 1 byte past an aligned start (a contiguous view of a larger buffer)
    raw = np.empty(k * n + 64, dtype=np.uint8)
    at = (-raw.ctypes.data) % 32 + 1
    off = raw[at : at + k * n].reshape(k, n)
    off[...] = data
    assert off.ctypes.data % 32 == 1
    assert np.array_equal(native.rs_apply(coeffs, off), want)
    # each multiply body where the CPU has it
    ran = []
    for body in native.BODIES:
        out = native.rs_apply_body(body, coeffs, off)
        if out is not None:
            ran.append(body)
            assert np.array_equal(out, want), body
    assert "scalar" in ran
    if native.has_avx2():
        assert ran == list(native.BODIES)


def test_rs_apply_makes_strided_operands_contiguous():
    """A strided view goes through the binding as its contiguous copy:
    the library reads row j at data + j*n and would otherwise see other
    bytes, with no error."""
    rng = np.random.default_rng(3)
    coeffs = _coeffs(rng, 4, 10)
    wide = rng.integers(0, 256, (10, 2 * 4099), dtype=np.uint8)
    data = wide[:, ::2]
    assert not data.flags.c_contiguous
    want = gf256.matrix_apply(coeffs, np.ascontiguousarray(data))
    assert np.array_equal(native.rs_apply(coeffs, data), want)
    assert np.array_equal(native.rs_apply_mt(coeffs, data, 3), want)
    tall = rng.integers(0, 256, (20, 4099), dtype=np.uint8)[::2]  # row stride 2n
    assert np.array_equal(native.rs_apply(coeffs, tall), gf256.matrix_apply(coeffs, tall))
    assert np.array_equal(
        native.rs_apply(np.asfortranarray(coeffs), tall), gf256.matrix_apply(coeffs, tall)
    )
    with pytest.raises(ValueError, match="coeffs expect 10 rows"):
        native.rs_apply(coeffs, tall[:9])


@pytest.mark.parametrize("threads", range(1, 10))
def test_rs_apply_mt_matches_rs_apply(threads):
    rng = np.random.default_rng(threads)
    for m, k in ((4, 10), (2, 10), (1, 4), (3, 1)):
        coeffs = _coeffs(rng, m, k)
        for n in (64 * KIB - 5, 64 * KIB + 3, 64 * KIB + 67, 3 * 64 * KIB + 7, MIB - 3, MIB + 5):
            data = rng.integers(0, 256, (k, n), dtype=np.uint8)
            want = native.rs_apply(coeffs, data)
            assert np.array_equal(native.rs_apply_mt(coeffs, data, threads), want), (m, k, n)
            assert np.array_equal(jax_native.rs_apply_mt(coeffs, data, threads), want)
    data = rng.integers(0, 256, (10, MIB + 5), dtype=np.uint8)
    coeffs = _coeffs(rng, 4, 10)
    assert np.array_equal(native.rs_apply_mt(coeffs, data), native.rs_apply(coeffs, data))


def test_gf_mul_full_table_and_avx2_flag():
    table = np.array(
        [[native.gf_mul(a, b) for b in range(256)] for a in range(256)], dtype=np.uint8
    )
    assert np.array_equal(table, gf256._mul_table())
    for a, b in ((0, 7), (1, 200), (2, 128), (255, 255), (0x53, 0xCA)):
        assert native.gf_mul(a, b) == jax_native.gf_mul(a, b) == gf256.gal_mul(a, b)
    flags = set()
    with open("/proc/cpuinfo") as f:
        for line in f:
            if line.startswith("flags"):
                flags.update(line.split(":", 1)[1].split())
    assert native.has_avx2() == ("avx2" in flags) == jax_native.has_avx2()
    assert native.pool_threads() >= 1


_RACE = r"""
import sys, threading
import numpy as np
from seaweedfs_tpu_torch.ops import gf256
from seaweedfs_tpu_torch.utils import native

rng = np.random.default_rng(11)
cases = []
for t in range(8):
    k, m = (10, 4) if t % 2 else (4, 2)
    coeffs = rng.integers(0, 256, (m, k), dtype=np.uint8)
    data = rng.integers(0, 256, (k, (1 << 20) + 13 * t), dtype=np.uint8)
    cases.append((coeffs, data, gf256.matrix_apply(coeffs, data)))
assert "seaweed_native" not in native._build._loaded  # first use is below
barrier = threading.Barrier(8)
bad = []

def run(t):
    coeffs, data, want = cases[t]
    barrier.wait()
    got = native.rs_apply_mt(coeffs, data, 1 + t) if t % 3 else native.rs_apply(coeffs, data)
    if not np.array_equal(got, want) or native.gf_mul(3, 7) != gf256.gal_mul(3, 7):
        bad.append(t)

threads = [threading.Thread(target=run, args=(t,)) for t in range(8)]
for th in threads:
    th.start()
for th in threads:
    th.join()
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "seaweedfs_tpu"))
print("BAD", bad, "LEAKED", leaked)
sys.exit(1 if bad or leaked else 0)
"""


def test_first_use_raced_from_eight_threads():
    """Eight threads reach the library's first apply at once in a fresh
    interpreter (table set-up, pool start, load): all results exact."""
    native.has_avx2()  # the library built on disk; the child only loads it
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", _RACE], cwd=str(REPO), env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "BAD [] LEAKED []" in proc.stdout


# ---------------------------------------------------------- the backend


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_encode_and_apply_match_jax_cpu_backend(geometry):
    k, m = GEOMETRIES[geometry]
    port, ref = CpuBackend(ECContext(k, m)), JaxCpuBackend(JaxECContext(k, m))
    assert np.array_equal(port.matrix, ref.matrix)
    rng = np.random.default_rng(k)
    for n in (1, 4099, MIB + 5):  # the last takes the pooled apply
        data = rng.integers(0, 256, (k, n), dtype=np.uint8)
        assert np.array_equal(port.encode(data), ref.encode(data))
        coeffs = _coeffs(rng, 3, k)
        assert np.array_equal(port.apply(coeffs, data), ref.apply(coeffs, data))


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_reconstruct_and_verify_match_jax_cpu_backend(geometry):
    k, m = GEOMETRIES[geometry]
    port, ref = CpuBackend(ECContext(k, m)), JaxCpuBackend(JaxECContext(k, m))
    data = np.random.default_rng(m).integers(0, 256, (k, 7777), dtype=np.uint8)
    full = np.concatenate([data, port.encode(data)])
    assert port.verify(full) and ref.verify(full)
    lost = (0, k) if m >= 2 else (0,)
    present = {i: full[i] for i in range(k + m) if i not in lost}
    got, want = port.reconstruct(present), ref.reconstruct(present)
    assert sorted(got) == sorted(want) == list(lost)
    for i in lost:
        assert np.array_equal(got[i], want[i]) and np.array_equal(got[i], full[i])
    one = port.reconstruct(present, want=[lost[-1]])
    assert list(one) == [lost[-1]] and np.array_equal(one[lost[-1]], full[lost[-1]])
    assert port.reconstruct(full_dict := {i: full[i] for i in range(k + m)}) == {}
    assert ref.reconstruct(full_dict) == {}
    bad = full.copy()
    bad[k, 5] ^= 1
    assert not port.verify(bad) and not ref.verify(bad)
    with pytest.raises(ECError, match=f"need {k} shards"):
        port.reconstruct({i: full[i] for i in range(k - 1)})


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_staged_hooks_and_stage_accounting(geometry):
    k, m = GEOMETRIES[geometry]
    port, ref = CpuBackend(ECContext(k, m)), JaxCpuBackend(JaxECContext(k, m))
    rng = np.random.default_rng(40 + k)
    data = rng.integers(0, 256, (k, 5000), dtype=np.uint8)
    coeffs = _coeffs(rng, 2, k)
    assert port.to_device(data) is data
    parity = port.to_host(port.encode_staged(port.to_device(data)))
    assert parity.dtype == np.uint8 and np.array_equal(parity, ref.encode(data))
    staged = port.apply_staged(coeffs, port.to_device(data))
    assert np.array_equal(port.to_host(staged), ref.apply(coeffs, data))
    # the kernel stage is the wall time of the applies; pin, h2d and d2h stay 0
    st = port.stage_seconds
    assert st["kernel"] > 0 and st["pin"] == st["h2d"] == st["d2h"] == 0 and port.pin_skips == 0
    port.add_stage("write", 0.25)
    port.add_stage("disk_read", 0.5)
    assert port.stage_seconds["write"] == 0.25 and port.stage_seconds["disk_read"] == 0.5
    port.reset_stages()
    assert set(port.stage_seconds) == set(TorchBackend(ECContext(k, m), device="cpu").stage_seconds)
    assert not any(port.stage_seconds.values())


def test_get_backend_cpu_is_the_native_backend(tmp_path, monkeypatch):
    be = get_backend("cpu", 10, 4)
    assert isinstance(be, CpuBackend) and be is get_backend("cpu", 10, 4)
    assert be.avx2 == native.has_avx2() and not hasattr(be, "device")
    for impl in ("cuda_planes", "pallas"):
        with pytest.raises(ECError, match="no kernel impl"):
            get_backend("cpu", 10, 4, impl=impl)
    for name in ("tpu", "CPU", "gpu"):
        with pytest.raises(ECError, match="unknown EC backend"):
            get_backend(name, 10, 4)
    # the names that reach it: EcVolume's backend and the stream knob
    monkeypatch.setenv("SEAWEED_EC_STREAM_BACKEND", "cpu")
    monkeypatch.delenv("SEAWEED_EC_STREAM_REMOTE_ROOTS", raising=False)
    pp = port_sp.PartitionParity(str(tmp_path), "ns", "t", 0, ctx=ECContext(4, 2))
    assert pp.backend is None
    pp.append_record(0, 1, b"k", b"v" * 100)
    assert pp.backend is get_backend("cpu", 4, 2)
    pp.close()


# ---------------------------------------------- the volume paths, file by file


@pytest.fixture(scope="module")
def volume(tmp_path_factory):
    """One sealed volume of real needles (.dat + .idx, about 1.2 MB), so
    at the default layout every shard is one 1 MiB small-block row: the
    encode batch is 1 MiB wide and takes the pooled apply."""
    d = tmp_path_factory.mktemp("vol")
    rng = np.random.default_rng(8)
    v = Volume(str(d), 1)
    payloads = {}
    for i in range(1, 41):
        payloads[i] = rng.integers(0, 256, int(rng.integers(1, 60_000)), dtype=np.uint8).tobytes()
        v.write_needle(Needle(cookie=0x1000 + i, needle_id=i, data=payloads[i]))
    for i in (5, 17):
        v.delete_needle(i)
        del payloads[i]
    v.close()
    return Volume.base_file_name(str(d), "", 1), payloads


@pytest.fixture(scope="module")
def encoded(volume, tmp_path_factory):
    """The volume encoded by each package on its own CpuBackend:
    {"port": base, "jax": base}."""
    src, _ = volume
    out = {}
    for pkg in ("port", "jax"):
        base = os.path.join(str(tmp_path_factory.mktemp(pkg)), "1")
        for ext in (".dat", ".idx"):
            shutil.copy(src + ext, base + ext)
        if pkg == "port":
            ec_encode_volume(base, ECContext(10, 4), backend=CpuBackend(ECContext(10, 4)))
        else:
            jax_ec_encode_volume(base, JaxECContext(10, 4), backend=JaxCpuBackend(JaxECContext(10, 4)))
        out[pkg] = base
    return out


def _lists(path):
    p = BitrotProtection.load(path)
    return p.shard_sizes, p.shard_crcs, p.leaf_size, p.shard_leaf_crcs


def _copy(base, dst) -> str:
    shutil.copytree(os.path.dirname(base), str(dst))
    return os.path.join(str(dst), os.path.basename(base))


def test_encode_matches_jax_cpu_backend(encoded):
    port, jax = encoded["port"], encoded["jax"]
    for i in range(14):
        ext = f".ec{i:02d}"
        assert pathlib.Path(port + ext).read_bytes() == pathlib.Path(jax + ext).read_bytes(), ext
    assert pathlib.Path(port + ".ecx").read_bytes() == pathlib.Path(jax + ".ecx").read_bytes()
    assert _lists(port + ".ecsum") == _lists(jax + ".ecsum")
    assert os.path.getsize(port + ".ec00") == MIB


def test_rebuild_matches_jax_cpu_backend(encoded, tmp_path):
    originals = {i: pathlib.Path(encoded["port"] + f".ec{i:02d}").read_bytes() for i in (2, 12)}
    launches = dict(rs_kernels.LAUNCHES)
    for pkg in ("port", "jax"):
        base = _copy(encoded[pkg], tmp_path / pkg)
        for i in originals:
            os.unlink(base + f".ec{i:02d}")
        if pkg == "port":
            got = rebuild_ec_files(base, backend=CpuBackend(ECContext(10, 4)))
        else:
            got = jax_rebuild_ec_files(base, backend=JaxCpuBackend(JaxECContext(10, 4)))
        assert sorted(got) == [2, 12]
        for i, blob in originals.items():
            assert pathlib.Path(base + f".ec{i:02d}").read_bytes() == blob, (pkg, i)
    assert rs_kernels.LAUNCHES == launches  # no kernel, nor its plain version


def test_decode_matches_jax_cpu_backend(encoded, volume, tmp_path):
    src, _ = volume
    out = {}
    for pkg in ("port", "jax"):
        base = _copy(encoded[pkg], tmp_path / pkg)
        for ext in (".dat", ".idx", ".ec03"):
            os.unlink(base + ext)
        if pkg == "port":
            assert ec_decode_volume(base, backend=CpuBackend(ECContext(10, 4)))
        else:
            assert jax_ec_decode_volume(base, backend=JaxCpuBackend(JaxECContext(10, 4)))
        out[pkg] = {ext: pathlib.Path(base + ext).read_bytes() for ext in (".dat", ".idx", ".ec03")}
    assert out["port"] == out["jax"]
    assert out["port"][".ec03"] == pathlib.Path(encoded["port"] + ".ec03").read_bytes()
    assert pathlib.Path(src + ".dat").read_bytes().startswith(out["port"][".dat"])


def test_degraded_reads_match_jax_cpu_backend(encoded, volume):
    _, payloads = volume
    d = os.path.dirname(encoded["port"])
    port, jax = EcVolume(d, 1, backend="cpu"), JaxEcVolume(d, 1, backend_name="cpu")
    try:
        assert isinstance(port.backend, CpuBackend)
        port.unmount_shards([0, 9])
        jax.unmount_shards([0, 9])
        for nid, data in payloads.items():
            got = port.read_needle(nid, cookie=0x1000 + nid)
            assert got.data == data == jax.read_needle(nid, cookie=0x1000 + nid).data
        assert port.bytes_reconstructed == jax.bytes_reconstructed > 0
        assert port.backend.stage_seconds["kernel"] > 0
    finally:
        port.close()
        jax.close()


def test_leaf_repair_matches_jax_cpu_backend(encoded, tmp_path):
    """Two rotten leaves of data shard 4 (a v2 sidecar of 64 KiB leaves)
    repaired in place by each package's scrub on its CpuBackend."""
    prot = BitrotProtection.load(encoded["port"] + ".ecsum")
    leaves = [2, 9]
    out = {}
    for pkg in ("port", "jax"):
        base = _copy(encoded["port"], tmp_path / pkg)
        with open(base + ".ec04", "r+b") as f:
            for leaf in leaves:
                f.seek(leaf * prot.leaf_size + 333)
                b = f.read(1)
                f.seek(leaf * prot.leaf_size + 333)
                f.write(bytes([b[0] ^ 0x11]))
        if pkg == "port":
            r = scrub_ec_volume(base, backend=CpuBackend(ECContext(10, 4)), repair=True)
        else:
            r = jax_scrub(base, backend=JaxCpuBackend(JaxECContext(10, 4)), repair=True)
        assert r.leaf_repaired == {4: leaves} and not r.quarantined and not r.rebuilt
        out[pkg] = (pathlib.Path(base + ".ec04").read_bytes(), _lists(base + ".ecsum"))
    assert out["port"] == out["jax"]
    assert out["port"][0] == pathlib.Path(encoded["port"] + ".ec04").read_bytes()


def test_short_stream_matches_jax_cpu_backend(tmp_path):
    """The same appends and flushes through both packages' stream
    encoders on their CpuBackends: shards, sidecar lists and (with one
    uuid) the stripe-cursor journal, flush by flush."""
    k, m, block, small = 4, 2, 8192, 1024
    payload = np.random.default_rng(17).integers(0, 256, 3 * block * k + 5 * small + 9, dtype=np.uint8)
    encs = {
        "port": EcStreamEncoder(str(tmp_path / "port"), ECContext(k, m), backend=CpuBackend(ECContext(k, m)),
                                block_size=block, small_block_size=small, meta=3),
        "jax": JaxStreamEncoder(str(tmp_path / "jax"), JaxECContext(k, m),
                                backend=JaxCpuBackend(JaxECContext(k, m)),
                                block_size=block, small_block_size=small, meta=3),
    }
    for enc in encs.values():
        enc.uuid = b"S" * 16
    assert encs["port"].chip_label == encs["jax"].chip_label == ""
    pos, step = 0, 0
    while pos < len(payload):
        n = 1 + (step * 7919) % 9000
        piece = payload[pos : pos + n].tobytes()
        for enc in encs.values():
            enc.append(piece)
        if step % 3 == 2:
            for enc in encs.values():
                enc.flush()
            assert (tmp_path / "port.stream").read_bytes() == (tmp_path / "jax.stream").read_bytes()
        pos, step = pos + n, step + 1
    prots = {pkg: enc.close() for pkg, enc in encs.items()}
    for i in range(k + m):
        ext = f".ec{i:02d}"
        assert (tmp_path / ("port" + ext)).read_bytes() == (tmp_path / ("jax" + ext)).read_bytes()
    assert (prots["port"].shard_crcs, prots["port"].shard_leaf_crcs) == (
        prots["jax"].shard_crcs, prots["jax"].shard_leaf_crcs,
    )


# --------------------------------------------------- a failed build or load


@pytest.mark.parametrize("fault", ["build", "load"])
def test_failed_build_or_load_raises_and_never_uses_the_numpy_tables(tmp_path, monkeypatch, fault):
    def forbidden(*args, **kwargs):
        raise AssertionError("the numpy tables computed the bytes")

    monkeypatch.setattr(gf256, "matrix_apply", forbidden)
    ctx = ECContext(4, 2)
    built = CpuBackend(ctx)  # on the real library, before it goes away
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    build.mkdir()
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", build)
    monkeypatch.setattr(_build, "_loaded", {})
    src = csrc / "seaweed_native.cpp"
    if fault == "build":
        src.write_text("#error this source does not compile\n")
        expect = RuntimeError
    else:
        src.write_text((_build.PKG_DIR / "csrc" / "seaweed_native.cpp").read_text())
        _build._command("seaweed_native")[1].write_bytes(b"not a shared library")
        expect = OSError
    with pytest.raises(expect):
        CpuBackend(ctx)
    with pytest.raises(expect):
        get_backend("cpu", 5, 3)  # a geometry no other test caches
    data = np.zeros((4, 100), dtype=np.uint8)
    with pytest.raises(expect):
        built.encode(data)
    with pytest.raises(expect):
        built.reconstruct({i: data[0] for i in range(1, 5)}, want=[0])
