"""PyTorch port: encode and rebuild of a volume, held against the JAX
package on the CPU, and the guards that keep the port apart from JAX.

The volume is written with real needles through the JAX package's
storage engine (this test file is the only place where both packages
meet). Encode compares the port's `write_ec_files` with the JAX
package's Pallas path in interpret mode: shard bytes, .ecx bytes and the
.ecsum block and leaf CRCs must be identical (tolerance 0); the sidecar
uuid and generation may differ. Rebuild runs across the packages in both
directions.
"""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from seaweedfs_tpu.ec import CpuBackend, JaxBackend
from seaweedfs_tpu.ec import ECContext as JaxECContext
from seaweedfs_tpu.ec import ec_encode_volume as jax_ec_encode_volume
from seaweedfs_tpu.ec import rebuild_ec_files as jax_rebuild_ec_files
from seaweedfs_tpu.ec import write_ec_files as jax_write_ec_files
from seaweedfs_tpu.ec.bitrot import BitrotProtection as JaxBitrotProtection
from seaweedfs_tpu.ec.encoder import write_sorted_file_from_idx as jax_sort_idx
from seaweedfs_tpu.ec.volume_info import VolumeInfo as JaxVolumeInfo
from seaweedfs_tpu.storage.needle import Needle
from seaweedfs_tpu.storage.volume import Volume
from seaweedfs_tpu.utils.crc import crc32c as jax_crc32c
from seaweedfs_tpu_torch.ec import CpuBackend as PortCpuBackend
from seaweedfs_tpu_torch.ec import (
    BitrotProtection,
    ECContext,
    ECError,
    TorchBackend,
    VolumeInfo,
    ec_encode_volume,
    get_backend,
    rebuild_ec_files,
    write_ec_files,
    write_sorted_file_from_idx,
)
from seaweedfs_tpu_torch.utils.crc import crc32c, crc32c_combine

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "seaweedfs_tpu_torch"
CTX = ECContext(10, 4)
JCTX = JaxECContext(10, 4)
SIZES = dict(large_block_size=65536, small_block_size=4096)


@pytest.fixture(scope="module")
def volume(tmp_path_factory):
    """One sealed volume (.dat + .idx) of real needles, about 1.1 MB:
    two large rows of 10 x 64 KiB, then 4 KiB small rows."""
    d = tmp_path_factory.mktemp("vol")
    rng = np.random.default_rng(0)
    v = Volume(str(d), 1)
    for i in range(1, 41):
        size = int(rng.integers(1, 60_000))
        data = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        v.write_needle(Needle(cookie=0x1000 + i, needle_id=i, data=data))
    for i in (5, 17):
        v.delete_needle(i)
    v.close()
    return Volume.base_file_name(str(d), "", 1)


def _copy_volume(src_base: str, dst_dir) -> str:
    dst = os.path.join(str(dst_dir), "1")
    for ext in (".dat", ".idx"):
        shutil.copy(src_base + ext, dst + ext)
    return dst


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _shards(base: str, total: int = 14) -> list[bytes]:
    return [_read(base + f".ec{i:02d}") for i in range(total)]


# ------------------------------------------------------------- (c) encode


def test_encode_matches_jax_pallas_interpret(volume, tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jbase = _copy_volume(volume, tmp_path / "jax")
    pbase = _copy_volume(volume, tmp_path / "port")

    jprot = jax_write_ec_files(
        jbase, JCTX,
        backend=JaxBackend(JCTX, impl="pallas", interpret=True, n_devices=1),
        **SIZES,
    )
    backend = TorchBackend(CTX, device="cpu")
    pprot = write_ec_files(pbase, CTX, backend=backend, **SIZES)

    assert _shards(pbase) == _shards(jbase)
    assert pprot.shard_sizes == jprot.shard_sizes
    assert pprot.shard_crcs == jprot.shard_crcs
    assert pprot.leaf_size == jprot.leaf_size > 0
    assert pprot.shard_leaf_crcs == jprot.shard_leaf_crcs
    assert pprot.block_size == jprot.block_size

    jax_sort_idx(jbase)
    write_sorted_file_from_idx(pbase)
    assert _read(pbase + ".ecx") == _read(jbase + ".ecx")

    # every stage of the run was recorded
    s = backend.stage_seconds
    assert s["disk_read"] > 0 and s["kernel"] > 0 and s["write"] > 0


@pytest.mark.parametrize("leaf_size", [0, 4096])
def test_encode_sidecar_variants_match_cpu_backend(volume, tmp_path, leaf_size):
    """v1 (no leaves) and v2 sidecars, a batch split inside the rows."""
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jbase = _copy_volume(volume, tmp_path / "jax")
    pbase = _copy_volume(volume, tmp_path / "port")
    jprot = jax_write_ec_files(
        jbase, JCTX, backend=CpuBackend(JCTX), batch_size=10_000,
        leaf_size=leaf_size, **SIZES,
    )
    pprot = write_ec_files(
        pbase, CTX, backend=TorchBackend(CTX, device="cpu"), batch_size=10_000,
        leaf_size=leaf_size, **SIZES,
    )
    assert _shards(pbase) == _shards(jbase)
    assert pprot.to_bytes()[:6] == jprot.to_bytes()[:6]  # magic + version
    assert pprot.shard_crcs == jprot.shard_crcs
    assert pprot.shard_leaf_crcs == jprot.shard_leaf_crcs


def test_full_volume_encode_files_are_readable_by_jax_package(volume, tmp_path):
    base = _copy_volume(volume, tmp_path)
    vi = ec_encode_volume(base, CTX, backend=TorchBackend(CTX, device="cpu"))
    jvi = JaxVolumeInfo.load(base + ".vif")
    assert (jvi.ec_ctx.data_shards, jvi.ec_ctx.parity_shards) == (10, 4)
    assert jvi.dat_file_size == vi.dat_file_size == os.path.getsize(base + ".dat")
    jprot = JaxBitrotProtection.load(base + ".ecsum")
    prot = BitrotProtection.load(base + ".ecsum")
    assert prot.generation == jprot.generation == vi.encode_ts_ns
    for i in range(14):
        assert jprot.verify_shard_file(base + f".ec{i:02d}", i) == []
        assert prot.verify_shard_file(base + f".ec{i:02d}", i) == []
    assert VolumeInfo.load(base + ".vif").ec_ctx == CTX


# ------------------------------------------------------------ (d) rebuild


def _drop(base: str, ids) -> dict[int, bytes]:
    kept = {}
    for i in ids:
        kept[i] = _read(base + f".ec{i:02d}")
        os.unlink(base + f".ec{i:02d}")
    return kept


def test_port_rebuilds_jax_encoded_volume(volume, tmp_path):
    base = _copy_volume(volume, tmp_path)
    jax_ec_encode_volume(base, JCTX, backend=CpuBackend(JCTX))
    originals = _drop(base, (3, 11))
    got = rebuild_ec_files(base, backend=TorchBackend(CTX, device="cpu"))
    assert got == [3, 11]
    for i, raw in originals.items():
        assert _read(base + f".ec{i:02d}") == raw
    assert not any(p.endswith(".rebuilding") for p in os.listdir(tmp_path))


def test_jax_pallas_rebuilds_port_encoded_volume(volume, tmp_path):
    base = _copy_volume(volume, tmp_path)
    prot = write_ec_files(base, CTX, backend=TorchBackend(CTX, device="cpu"), **SIZES)
    prot.save(base + ".ecsum")
    VolumeInfo(ec_ctx=CTX, dat_file_size=os.path.getsize(base + ".dat")).save(
        base + ".vif"
    )
    originals = _drop(base, (0, 12))
    got = jax_rebuild_ec_files(
        base, backend=JaxBackend(JCTX, impl="pallas", interpret=True, n_devices=1)
    )
    assert got == [0, 12]
    for i, raw in originals.items():
        assert _read(base + f".ec{i:02d}") == raw


def test_rebuild_excludes_corrupt_present_shard(volume, tmp_path):
    base = _copy_volume(volume, tmp_path)
    ec_encode_volume(base, CTX, backend=TorchBackend(CTX, device="cpu"))
    originals = {i: _read(base + f".ec{i:02d}") for i in range(14)}
    os.unlink(base + ".ec02")
    with open(base + ".ec04", "r+b") as f:  # a source shard rots
        f.seek(12345)
        b = f.read(1)
        f.seek(12345)
        f.write(bytes([b[0] ^ 0x01]))
    got = rebuild_ec_files(base, backend=TorchBackend(CTX, device="cpu"))
    assert got == [2, 4]
    assert _shards(base) == [originals[i] for i in range(14)]


def test_rebuild_fails_closed(volume, tmp_path):
    base = _copy_volume(volume, tmp_path)
    ec_encode_volume(base, CTX, backend=TorchBackend(CTX, device="cpu"))
    be = TorchBackend(CTX, device="cpu")
    raw = bytearray(_read(base + ".ecsum"))
    raw[-1] ^= 0xFF
    with open(base + ".ecsum", "wb") as f:
        f.write(bytes(raw))
    os.unlink(base + ".ec01")
    with pytest.raises(ECError):
        rebuild_ec_files(base, backend=be)
    for i in range(2, 7):
        os.unlink(base + f".ec{i:02d}")
    with pytest.raises(ECError):
        rebuild_ec_files(base, backend=be, unsafe_ignore_sidecar=True)


def test_rebuild_only_shards_and_noop(volume, tmp_path):
    base = _copy_volume(volume, tmp_path)
    ec_encode_volume(base, CTX, backend=TorchBackend(CTX, device="cpu"))
    be = TorchBackend(CTX, device="cpu")
    assert rebuild_ec_files(base, backend=be) == []
    originals = _drop(base, (1, 9))
    assert rebuild_ec_files(base, backend=be, only_shards=[9]) == [9]
    assert not os.path.exists(base + ".ec01")
    assert _read(base + ".ec09") == originals[9]


def test_backend_surface_matches_cpu_backend():
    rng = np.random.default_rng(21)
    data = rng.integers(0, 256, (10, 777), dtype=np.uint8)
    port, ref = TorchBackend(CTX, device="cpu"), CpuBackend(JCTX)
    parity = port.encode(data)
    assert np.array_equal(parity, ref.encode(data))
    full = np.concatenate([data, parity])
    assert port.verify(full)
    present = {i: full[i] for i in range(14) if i not in (4, 13)}
    got = port.reconstruct(present, want=[4])
    assert list(got) == [4] and np.array_equal(got[4], full[4])
    coeffs = rng.integers(0, 256, (3, 10), dtype=np.uint8)
    assert np.array_equal(port.apply(coeffs, data), ref.apply(coeffs, data))
    staged = port.apply_staged(coeffs, port.to_device(data))
    assert np.array_equal(port.to_host(staged), ref.apply(coeffs, data))


@pytest.mark.parametrize("impl", ["cuda", "cuda_planes"])
def test_backend_impls_match_cpu_backend(impl):
    rng = np.random.default_rng(22)
    data = rng.integers(0, 256, (10, 999), dtype=np.uint8)
    port, ref = TorchBackend(CTX, device="cpu", impl=impl), CpuBackend(JCTX)
    assert port.impl == impl
    parity = port.encode(data)
    assert np.array_equal(parity, ref.encode(data))
    full = np.concatenate([data, parity])
    present = {i: full[i] for i in range(14) if i not in (0, 5, 12)}
    got = port.reconstruct(present)
    assert sorted(got) == [0, 5, 12]
    for i in got:
        assert np.array_equal(got[i], full[i])
    assert isinstance(get_backend("cpu", 10, 4), PortCpuBackend)
    assert get_backend("cpu", 10, 4) is get_backend("cpu", 10, 4)
    with pytest.raises(ECError, match="no kernel impl"):
        get_backend("cpu", 10, 4, impl="cuda_planes")  # any but the default
    with pytest.raises(ECError):
        TorchBackend(CTX, device="cpu", impl="pallas")


# -------------------------------------------------------- CRC32C and build


def test_encode_pipeline_error_propagates(volume, tmp_path):
    """A failing device stage raises out of write_ec_files; the pipeline
    threads are joined, never left running."""

    class Boom(TorchBackend):
        def encode_staged(self, staged):
            raise RuntimeError("device lost")

    base = _copy_volume(volume, tmp_path)
    with pytest.raises(RuntimeError, match="device lost"):
        write_ec_files(base, CTX, backend=Boom(CTX, device="cpu"), **SIZES)


@pytest.mark.parametrize("leaf_size,block_size", [(4096, 16384), (1000, 3000)])
def test_fold_leaf_crcs_matches_rolled_blocks_and_jax(leaf_size, block_size):
    from seaweedfs_tpu.ec.bitrot import fold_leaf_crcs as jax_fold
    from seaweedfs_tpu_torch.ec.bitrot import ShardChecksumBuilder, fold_leaf_crcs

    data = np.random.default_rng(leaf_size).integers(0, 256, 50_001, dtype=np.uint8)
    b = ShardChecksumBuilder(block_size, leaf_size)
    b.write(data[:7777])
    b.write(data[7777:])
    blocks, leaves = b.finish(), b.finish_leaves()
    assert fold_leaf_crcs(leaves, len(data), leaf_size, block_size) == blocks
    assert jax_fold(leaves, len(data), leaf_size, block_size) == blocks


def test_crc32c_matches_jax_package():
    assert crc32c(b"123456789") == 0xE3069283
    rng = np.random.default_rng(9)
    for n in (0, 1, 7, 8, 1000, 65536 + 3):
        buf = rng.integers(0, 256, n, dtype=np.uint8)
        assert crc32c(buf) == jax_crc32c(buf.tobytes())
        assert crc32c(memoryview(buf.tobytes()), 0x1234) == jax_crc32c(buf.tobytes(), 0x1234)
    a, b = b"hello ", b"world"
    assert crc32c_combine(crc32c(a), crc32c(b), len(b)) == crc32c(a + b)


# ------------------------------------------------------------- (e) guards


def _python_files():
    built = PORT / "build"  # build outputs, not sources
    return sorted(
        p for p in PORT.rglob("*.py") if built not in p.parents
    ) + [REPO / "chip_smoke.py", REPO / "chip_kernels.py", REPO / "chip_host_io.py",
         REPO / "chip_sched_ab.py", REPO / "chip_loopback.py"]


@pytest.mark.parametrize(
    "path", _python_files(), ids=lambda p: str(p.relative_to(REPO))
)
def test_port_imports_no_jax_and_nothing_of_the_jax_package(path):
    # the card's host has no `requests`: every HTTP call goes over urllib
    # or http.client
    banned = {"jax", "jaxlib", "seaweedfs_tpu", "requests"}
    if path == PORT / "server" / "volume_server.py":
        # the data plane: gRPC and protobuf stay in server/volume_grpc.py,
        # client/ and pb/
        banned |= {"grpc", "google"}
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in banned, (path, name)
    text = path.read_text()
    assert "libseaweed" not in text and "native/" not in text


@pytest.mark.parametrize("name", ["chip_smoke.py", "chip_kernels.py", "chip_host_io.py",
                                  "chip_sched_ab.py", "chip_loopback.py"])
def test_chip_scripts_define_each_top_level_name_once(name):
    """A second top-level `def` or assignment of a name silently replaces
    the first for every phase that calls it; only the card runs most
    phases, so the clash shows there alone."""
    tree = ast.parse((REPO / name).read_text())
    seen = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names = [node.name]
        elif isinstance(node, ast.Assign):
            names = [t.id for t in node.targets if isinstance(t, ast.Name)]
        else:
            continue
        for n in names:
            assert n not in seen, f"{name}: {n} defined at lines {seen[n]} and {node.lineno}"
            seen[n] = node.lineno


def test_import_guard_scans_every_package_of_the_port():
    scanned = {p.relative_to(PORT).parts[0] for p in _python_files() if PORT in p.parents}
    assert {"client", "ec", "faults", "filer", "iam", "mq", "ops", "pb", "remote", "replication",
            "s3", "server", "shell", "storage", "tools", "utils", "worker"} <= scanned
    assert PORT / "server" / "volume_server.py" in _python_files()
    assert PORT / "server" / "volume_grpc.py" in _python_files()
    for mod in ("server/master.py", "server/topology.py", "server/raft.py", "server/cluster_lock.py",
                "utils/telemetry.py", "utils/sequence.py", "shell/commands.py", "shell/__main__.py",
                "client/operations.py", "utils/urls.py", "ec/rebalance.py", "ec/placement.py",
                "worker/__init__.py", "worker/__main__.py", "worker/worker.py",
                "worker/control.py", "pb/worker_pb2.py", "utils/tls.py", "utils/pprof.py",
                "utils/fastread.py", "utils/images.py", "utils/scaffold.py",
                "utils/telemetry_server.py", "tools/__init__.py", "tools/__main__.py",
                "pb/filer_pb2.py", "filer/__init__.py", "filer/entry.py", "filer/chunks.py",
                "filer/manifest.py", "filer/filer_store.py", "filer/abstract_sql_store.py",
                "filer/sstable_store.py", "filer/locks.py", "filer/notification.py",
                "filer/meta_log.py", "filer/filer.py", "filer/grpc_service.py",
                "filer/meta_aggregator.py", "filer/tus.py", "filer/lock_ring.py",
                "server/filer_server.py", "server/multipart.py", "client/filer_client.py",
                "mq/stream_parity.py", "pb/mq_pb2.py", *S3_MODULES, *REMOTE_MODULES,
                *MQ_MODULES):
        assert PORT / mod in _python_files(), mod


# S3's gateway, its libraries and the IAM they check requests against
S3_MODULES = ("iam/__init__.py", "iam/policy.py", "iam/sts.py", "iam/oidc.py", "iam/ldap.py",
              "s3/__init__.py", "s3/auth.py", "s3/chunked.py", "s3/post_policy.py",
              "s3/config.py", "s3/versioning.py", "s3/sse.py", "s3/server.py", "s3/lifecycle.py",
              "s3/tables.py", "s3/iamapi.py")
# remote storage and replication, the replication daemon's entry point among them
REMOTE_MODULES = ("remote/__init__.py", "remote/s3_client.py", "remote/providers.py",
                  "remote/mount.py", "replication/__init__.py", "replication/sync.py",
                  "replication/backup.py", "replication/s3_sink.py", "replication/__main__.py")

# the MQ broker's modules but the durable-parity stream (which imports the
# EC backend, and so torch): its group commit and the Kafka gateway and
# client among them
MQ_MODULES = ("mq/__init__.py", "mq/log_buffer.py", "mq/logstore.py", "mq/balancer.py",
              "mq/broker.py", "mq/client.py", "mq/agent.py", "mq/group_commit.py",
              "mq/kafka/__init__.py", "mq/kafka/protocol.py", "mq/kafka/records.py",
              "mq/kafka/codecs.py", "mq/kafka/groups.py", "mq/kafka/frame_pool.py",
              "mq/kafka/fetch_spool.py", "mq/kafka/gateway.py", "mq/kafka/client.py")

# an HS256 bearer for issuer https://g signed with "k", and an LDAP bind
# through the stand-in server, in the guards' child interpreters
_PROVIDERS = r"""
import base64, hashlib, hmac, json, time
from seaweedfs_tpu_torch.iam.ldap import LdapProvider, MiniLdapServer
from seaweedfs_tpu_torch.iam.oidc import OidcProvider
b64 = lambda b: base64.urlsafe_b64encode(b).rstrip(b"=").decode()
signing = b64(b'{"alg": "HS256"}') + "." + b64(json.dumps(
    {"iss": "https://g", "exp": time.time() + 60, "sub": "g", "roles": "r"}).encode())
tok = signing + "." + b64(hmac.new(b"k", signing.encode(), hashlib.sha256).digest())
oidc = OidcProvider("https://g", hs256_secret="k", roles={"r": {"actions": ["Read"]}})
assert oidc.identity_for(oidc.verify(tok)).actions == ("Read",)
ldap_srv = MiniLdapServer({"uid=g,dc=x": "pw"})
assert LdapProvider(f"127.0.0.1:{ldap_srv.port}", "uid={username},dc=x").authenticate(
    "g", "pw") == "uid=g,dc=x"
ldap_srv.close()
"""

_FILER_ALONE = r"""
import hashlib, importlib, os, sys, tempfile
port, s3port, master, PROVIDERS = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
for name in sys.argv[5:]:
    importlib.import_module(name)
from seaweedfs_tpu_torch.client.operations import Operations
from seaweedfs_tpu_torch.filer import Filer, MemoryStore
from seaweedfs_tpu_torch.s3 import auth, config, sse, versioning
from seaweedfs_tpu_torch.server.__main__ import build

# the launcher's filer mode, a filer in process and the S3 libraries over it
d = tempfile.mkdtemp()
servers = build(["filer", "-master", "127.0.0.1:1", "-ip", "127.0.0.1", "-port", str(port),
                 "-dir", d, "-store", "memory"], config_dirs=())
f = Filer(MemoryStore(), master="127.0.0.1:1")
f.store.kv_put(config.S3_IDENTITY_KV, b'{"identities": [{"accessKey": "A", "secretKey": "S"}]}')
ids = config.FilerIdentityStore(f, ttl=0)
h = auth.sign_v4("GET", "/b/k", access_key="A", secret_key="S", payload_hash="UNSIGNED-PAYLOAD")
assert auth.verify_v4(ids, "GET", "/b/k", "", h, "UNSIGNED-PAYLOAD").access_key == "A"
ring = sse.load_or_create_keyring(f.store.kv_get, f.store.kv_put, f.store.kv_put_if_absent)
ct, ext, _ = sse.encrypt_for_put(b"body" * 100, None, "AES256", ring)
f.write_file("/buckets/b/k", ct, extended={**ext, versioning.VID_KEY: versioning.new_version_id().encode()})
versioning.archive_current(f, "/buckets", "b", "k")
(e,) = versioning.iter_versions(f, "/buckets", "b", "k")
key = sse.decrypt_key_for_entry(e, None, ring)
assert sse.read_decrypted(lambda o, n: f.read_entry(e, o, n), e, key, 3, 50) == (b"body" * 100)[3:53]
Operations("127.0.0.1:1").close()
# the launched filer's routes: a multipart POST and a raw PUT (both through
# the upload parse), GET, a rename by mv.from, a listing and DELETE
import http.client, json
def call(method, path, body=None, headers=None):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    c.request(method, path, body=body, headers=headers or {})
    r = c.getresponse()
    out = r.status, r.read()
    c.close()
    return out
form = (b'--bnd\r\nContent-Disposition: form-data; name="file"; filename="a.txt"\r\n'
        b'Content-Type: text/plain\r\n\r\nsmall body\r\n--bnd--\r\n')
assert call("POST", "/d/a.txt", form, {"Content-Type": "multipart/form-data; boundary=bnd"})[0] == 201
assert call("PUT", "/d/b.bin", b"raw body")[0] == 201
assert call("GET", "/d/a.txt") == (200, b"small body")
assert call("POST", "/d/c.bin?mv.from=/d/b.bin", b"")[0] == 200
assert [x["FullPath"] for x in json.loads(call("GET", "/d/")[1])["Entries"]] == ["/d/a.txt", "/d/c.bin"]
# the replication daemon by its entry point: a backup of /d into a local
# directory, stopped by SIGTERM once its copy is made
import signal, threading, time
from seaweedfs_tpu_torch.replication.__main__ import main as replication_main
dest = os.path.join(d, "backup")
def _terminate():
    deadline = time.time() + 60
    while not os.path.exists(os.path.join(dest, "c.bin")) and time.time() < deadline:
        time.sleep(0.05)
    os.kill(os.getpid(), signal.SIGTERM)
threading.Thread(target=_terminate, daemon=True).start()
assert replication_main(["-from", f"127.0.0.1:{port}", "-to", dest, "-path", "/d",
                         "-state", os.path.join(d, "bk.state")]) == 0
assert open(os.path.join(dest, "a.txt"), "rb").read() == b"small body"
assert open(os.path.join(dest, "c.bin"), "rb").read() == b"raw body"
assert call("DELETE", "/d?recursive=true")[0] == 204
# the MQ broker with no durable-parity topic, its segments in a filer
# launched on the parent's cluster; its status plane; the client, the
# agent, the shell's mq.* and a filer launched with -notify.mq
import socket, urllib.request
import grpc
import seaweedfs_tpu_torch.mq
from seaweedfs_tpu_torch.mq import MqBrokerServer, MqClient
from seaweedfs_tpu_torch.mq.agent import MqAgentServer
from seaweedfs_tpu_torch.pb import mq_pb2, rpc
from seaweedfs_tpu_torch.shell.commands import ShellEnv, run_command
def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
bport = free_port()
bservers = build(["filer", "-master", master, "-ip", "127.0.0.1", "-port", str(bport),
                  "-dir", os.path.join(d, "b"), "-store", "memory"], config_dirs=())
bk = MqBrokerServer(ip="127.0.0.1", grpc_port=free_port(), filer=f"127.0.0.1:{bport}",
                    segment_records=4, status_port=0, kafka_port=0)
bk.start()
# its Kafka gateway, produced to and fetched from by the port's client
from seaweedfs_tpu_torch.mq.kafka.client import KafkaClient
from seaweedfs_tpu_torch.mq.kafka.records import Record
kc = KafkaClient("127.0.0.1", bk.kafka.port)
assert kc.create_topic("kguard", partitions=1) == 0
assert kc.produce("kguard", 0, [Record(key=b"k%d" % i, value=b"kv") for i in range(6)],
                  compression=1) == 0
got = []
while len(got) < 6:  # a sealed segment of 4 records comes back as one batch
    got += kc.fetch("kguard", 0, len(got))[1]
assert [r.key for r in got] == [b"k%d" % i for i in range(6)]
kc.close()
baddr = f"127.0.0.1:{bk.grpc_port}"
mc = MqClient(baddr)
mc.configure_topic("guard", partitions=1)
for i in range(6):
    mc.publish("guard", b"v%d" % i, partition=0)
assert [r.message.value for r in mc.subscribe("guard", 0, start_offset=0)] == [b"v%d" % i for i in range(6)]
with urllib.request.urlopen(f"http://127.0.0.1:{bk.status_port}/status", timeout=10) as r:
    st = json.loads(r.read())
    assert st["load_score"] == 0.0 and st["kafka_pool"]["kind"] == "pooled"
ag = MqAgentServer(baddr, ip="127.0.0.1")
ag.start()
ach = grpc.insecure_channel(f"127.0.0.1:{ag.port}")
astub = rpc.Stub(ach, rpc.MQ_AGENT_SERVICE)
sid = astub.StartPublishSession(mq_pb2.AgentStartPublishRequest(name="guard"), timeout=30).session_id
acks = list(astub.PublishRecord(iter([mq_pb2.AgentPublishRequest(session_id=sid, value=b"a")]),
                                timeout=30))
assert [a.offset for a in acks] == [6]
ach.close()
senv = ShellEnv(master, f"127.0.0.1:{bport}")
assert run_command(senv, f"mq.topic.describe -topic guard -broker {baddr}") == (
    "partition 0: offsets [0, 7) (7 records)")
assert run_command(senv, f"mq.topic.compact -topic guard -broker {baddr}").startswith("archived ")
senv.close()
nport = free_port()
nservers = build(["filer", "-master", "127.0.0.1:1", "-ip", "127.0.0.1", "-port", str(nport),
                  "-dir", os.path.join(d, "n"), "-store", "memory", "-notify.mq", baddr],
                 config_dirs=())
c = http.client.HTTPConnection("127.0.0.1", nport, timeout=30)
c.request("PUT", "/n/e.txt", body=b"event")
assert c.getresponse().status == 201
c.close()
deadline = time.time() + 30
while not sum(p.next_offset for p in mc.partition_info("filer-events")):
    assert time.time() < deadline, "no filer event reached the broker"
    time.sleep(0.05)
for srv in nservers:
    srv.stop()
mc.close()
ag.stop()
bk.stop()
for srv in bservers:
    srv.stop()
for srv in servers:
    srv.stop()
# the S3 gateway over a filer whose cluster runs in the parent process: a
# signed bucket, a chunked PUT and a GET, and the lifecycle scanner
from seaweedfs_tpu_torch.s3 import Identity, IdentityStore, S3Server
gf = Filer(MemoryStore(), master=master, chunk_size=4096)
ids = IdentityStore()
ids.add(Identity("admin", "AKG", "guard/secret"))
s3 = S3Server(gf, ip="127.0.0.1", port=s3port, identities=ids, lifecycle_interval=0)
s3.start()
def s3_call(method, path, body=b"", query=""):
    h = auth.sign_v4(method, path, query, access_key="AKG", secret_key="guard/secret",
                     headers={"host": f"127.0.0.1:{s3.port}"},
                     payload_hash=hashlib.sha256(body).hexdigest())
    c = http.client.HTTPConnection("127.0.0.1", s3.port, timeout=30)
    c.request(method, path + (f"?{query}" if query else ""), body=body, headers=h)
    r = c.getresponse()
    out = r.status, r.read()
    c.close()
    return out
obj = os.urandom(10_000)
assert s3_call("PUT", "/guard")[0] == 200
assert s3_call("PUT", "/guard/lc/obj.bin", obj)[0] == 200
assert len(gf.find_entry("/buckets/guard/lc/obj.bin").chunks) == 3
assert s3_call("GET", "/guard/lc/obj.bin") == (200, obj)
rules = b"<LifecycleConfiguration><Rule><Prefix>lc/</Prefix><Status>Enabled</Status><Expiration><Date>2020-01-01</Date></Expiration></Rule></LifecycleConfiguration>"
assert s3_call("PUT", "/guard", rules, "lifecycle")[0] == 200
assert s3.lifecycle.run_once(bucket="guard")["expired"] == 1
assert s3_call("GET", "/guard/lc/obj.bin")[0] == 404
# S3 Tables and the IAM API through the signed gateway
def s3_post(body, headers):
    h = auth.sign_v4("POST", "/", "", access_key="AKG", secret_key="guard/secret",
                     headers={"host": f"127.0.0.1:{s3.port}", **headers},
                     payload_hash=hashlib.sha256(body).hexdigest())
    c = http.client.HTTPConnection("127.0.0.1", s3.port, timeout=30)
    c.request("POST", "/", body=body, headers=h)
    r = c.getresponse()
    out = r.status, r.read()
    c.close()
    return out
assert s3_post(b'{"name": "guardtb"}', {"X-Amz-Target": "S3Tables.CreateTableBucket"})[0] == 200
assert gf.find_entry("/buckets/guardtb").is_directory
assert s3_post(b"Action=CreateUser&UserName=g",
               {"Content-Type": "application/x-www-form-urlencoded"})[0] == 200
# a remote mount of the bucket, read through the gateway
from seaweedfs_tpu_torch.remote import mount as rm
assert s3_call("PUT", "/guard/r/x.bin", obj)[0] == 200
rf = Filer(MemoryStore(), master=master)
rm.configure(rf, "g", {"endpoint": f"http://127.0.0.1:{s3.port}", "access_key": "AKG",
                       "secret_key": "guard/secret"})
assert rm.mount(rf, "/m", "g", "guard", prefix="r/") == 1
assert rf.read_file("/m/x.bin") == obj and rf.read_file("/m/x.bin", 10, 20) == obj[10:30]
rf.close()
s3.stop()
gf.close()
exec(PROVIDERS)
print("LOADED", sorted({m.split(".")[0] for m in sys.modules}
                      & {"torch", "jax", "jaxlib", "seaweedfs_tpu", "requests"}))
"""


def test_the_filer_its_server_and_s3_libraries_import_no_torch(tmp_path):
    """The filer, its server (by the launcher's `filer` mode, its writes,
    reads, renames and deletes included, and with `-notify.mq`), the MQ
    package root, a filer-backed broker with no durable-parity topic, its
    status plane and its Kafka gateway (produced to and fetched from by
    the port's Kafka client), the MQ client and agent and the shell's
    `mq.*`, the
    client's Operations, every
    S3 / IAM module and the S3 gateway serving a PUT and a GET over a
    filer whose cluster (a port master and volume server) runs in this
    process, remote storage (a mount read through that gateway) and
    replication (its daemon's entry point backing the launched filer up
    until SIGTERM) load neither torch, nor the JAX package, nor
    `requests`: a gateway, a filer or a replication child starts and
    serves without the torch import."""
    from test_torch_volume_server import _ports
    from conftest import wait_for
    from seaweedfs_tpu_torch.server.master import MasterServer
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer

    mods = ["seaweedfs_tpu_torch.filer.filer", "seaweedfs_tpu_torch.server.filer_server",
            "seaweedfs_tpu_torch.server.multipart", "seaweedfs_tpu_torch.client.operations"] + [
        "seaweedfs_tpu_torch." + m[:-3].replace("/", ".").replace(".__init__", "")
        for m in S3_MODULES + REMOTE_MODULES + MQ_MODULES]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    mport = _ports()
    ms = MasterServer(ip="127.0.0.1", port=mport, vacuum_interval=3600)
    ms.start()
    vs = VolumeServer([str(tmp_path / "v")], master=f"127.0.0.1:{mport}", ip="127.0.0.1",
                      port=_ports(), ec_backend="cpu")
    vs.start()
    try:
        wait_for(lambda: ms.topo.nodes, timeout=30, msg="the volume server registered")
        proc = subprocess.run([sys.executable, "-c", _FILER_ALONE, str(_ports()), str(_ports()),
                               f"127.0.0.1:{mport}", _PROVIDERS, *mods], cwd=str(REPO), env=env,
                              capture_output=True, text=True, timeout=120)
    finally:
        vs.stop()
        ms.stop()
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout, proc.stdout


def test_the_ec_package_loads_its_modules_on_first_use():
    """`seaweedfs_tpu_torch.ec` exports every name it did, each loaded from
    its module on first use."""
    import seaweedfs_tpu_torch.ec as ec
    from seaweedfs_tpu_torch.ec import backend, device_queue

    assert ec.TorchBackend is backend.TorchBackend and ec.get_backend is backend.get_backend
    assert ec.configure_device_queue is device_queue.configure
    assert ec.native_io is sys.modules["seaweedfs_tpu_torch.ec.native_io"]
    for name in ec.__all__:
        assert getattr(ec, name) is not None, name
    with pytest.raises(AttributeError):
        ec.no_such_name


_SUBPROCESS_ENCODE = r"""
import os, shutil, sys, tempfile, time
PROVIDERS = sys.argv[1]
import numpy as np
import seaweedfs_tpu_torch
import seaweedfs_tpu_torch.remote.mount, seaweedfs_tpu_torch.remote.providers
import seaweedfs_tpu_torch.replication.__main__, seaweedfs_tpu_torch.replication.backup
import seaweedfs_tpu_torch.replication.s3_sink
from seaweedfs_tpu_torch.ec import (
    CpuBackend, ECContext, EcVolume, TorchBackend, ec_decode_volume, ec_encode_volume,
)
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.super_block import SuperBlock
from seaweedfs_tpu_torch.storage.types import NeedleValue, to_stored_offset

d = tempfile.mkdtemp()
base = os.path.join(d, "7")
rng = np.random.default_rng(3)
ctx = ECContext(10, 4)
bodies = {}
with open(base + ".dat", "wb") as dat, open(base + ".idx", "wb") as idx:
    dat.write(SuperBlock().to_bytes())
    for nid in range(1, 40):
        bodies[nid] = rng.integers(0, 256, 50_000, dtype=np.uint8).tobytes()
        n = Needle(cookie=nid, needle_id=nid, data=bodies[nid])
        off = dat.tell()
        dat.write(n.to_bytes())
        idx.write(NeedleValue(nid, to_stored_offset(off), len(n._body())).to_bytes())
ec_encode_volume(base, ctx, backend=TorchBackend(ctx, device="cpu"))
plain = {i: open(base + ctx.to_ext(i), "rb").read() for i in range(14)}
cpu = CpuBackend(ctx)  # builds the host library's GF(2^8) apply
ec_encode_volume(base, ctx, backend=cpu)
assert cpu.stage_seconds["kernel"] > 0
assert all(open(base + ctx.to_ext(i), "rb").read() == plain[i] for i in range(14))
for backend in (TorchBackend(ctx, device="cpu", impl="cuda_planes"), "cpu"):
    ev = EcVolume(d, 7, backend=backend)
    ev.unmount_shards([0])
    for nid in bodies:
        assert ev.read_needle(nid, cookie=nid).data == bodies[nid]
    assert ev.bytes_reconstructed > 0
    ev.close()
original = open(base + ".dat", "rb").read()
os.unlink(base + ".dat")
os.unlink(base + ".ec00")
assert ec_decode_volume(base, backend=TorchBackend(ctx, device="cpu", impl="cuda_planes"))
assert open(base + ".dat", "rb").read() == original
from seaweedfs_tpu_torch.mq.stream_parity import PartitionParity
pp = PartitionParity(d, "ns", "t", 0, backend=TorchBackend(ECContext(4, 2), device="cpu"),
                     block_size=8192, small_block_size=1024)
for off in range(20):
    pp.append_record(off, off, b"k", bytes(900))
pp.flush()
pp.close()
assert len(PartitionParity(d, "ns", "t", 0, backend=pp.backend).recover()) == 20
# the scheduler, placement, the fallback and the probe
from seaweedfs_tpu_torch.ec import FallbackBackend, QueueScope, get_backend, rebuild_ec_files
from seaweedfs_tpu_torch.ec import backend as port_backend, chip_pool, device_queue
from seaweedfs_tpu_torch.utils import devices, metrics
assert isinstance(get_backend("auto", 10, 4), CpuBackend) and port_backend.AUTO_CPU["no_card"] == 1
assert devices.probe_accelerators() == 0
shard5 = open(base + ".ec05", "rb").read()
os.unlink(base + ".ec05")
fb = FallbackBackend(TorchBackend(ctx, device="cpu"), CpuBackend(ctx))
scope = QueueScope(window=2)
assert rebuild_ec_files(base, ctx, backend=fb, scheduler=scope) == [5]
assert open(base + ".ec05", "rb").read() == shard5 and fb.fallback_batches == 0
assert scope.stats_snapshot()[0]["classes"]["recovery"]["admitted"] >= 1
assert chip_pool.pool_for(fb) is None and "residency" in metrics.gateway_summary()
assert device_queue.residency_snapshot()["budget"] == device_queue.DEFAULT_RESIDENCY_BUDGET
# peer-fetch rebuild over the shard net plane
from seaweedfs_tpu_torch.ec import net_plane, rebuild_from_peers
peer = os.path.join(d, "peer")
os.makedirs(peer)
for i in range(14):
    shutil.copy(base + ctx.to_ext(i), os.path.join(peer, "7" + ctx.to_ext(i)))
for i in range(4, 14):
    os.unlink(base + ctx.to_ext(i))
fds = {}

def resolve(vid, sid, gen):
    if sid not in fds:
        fds[sid] = os.open(os.path.join(peer, "7" + ctx.to_ext(sid)), os.O_RDONLY)
    return fds[sid], os.fstat(fds[sid]).st_size

plane = net_plane.ShardNetPlane("127.0.0.1", 0, resolve)
plane.start()
client = net_plane.NetPlaneClient(timeout=5.0)
addr = ("127.0.0.1", plane.port)
rep = rebuild_from_peers(
    base, {i: ["p"] for i in range(4, 14)},
    lambda p, sid, off, size: client.read_bytes(addr, 7, sid, 0, off, size),
    targets=[4], backend=TorchBackend(ctx, device="cpu"),
    fetch_into=net_plane.make_fetch_into(client, 7, 0, addr_of=lambda p: addr),
)
assert rep.rebuilt == [4] and set(rep.fetched_plane.values()) == {"native"}
assert open(base + ".ec04", "rb").read() == open(os.path.join(peer, "7.ec04"), "rb").read()
client.close()
plane.stop()
# the Store: write, encode, degraded read
from seaweedfs_tpu_torch.storage.store import Store
sdir = os.path.join(d, "store")
store = Store([sdir], ec_backend="cpu")
vol = store.allocate_volume(9)
for nid, body in bodies.items():
    store.write_needle(9, Needle(cookie=nid, needle_id=nid, data=body))
vol.set_read_only(True)
ec_encode_volume(vol.dat_path[:-4], ctx, backend=TorchBackend(ctx, device="cpu"))
store.unmount_volume(9)
store.mount_ec_volume(9)
store.unmount_ec_shards(9, [0, 1])
for nid, body in bodies.items():
    assert store.read_needle(9, nid, cookie=nid).data == body
assert store.find_ec_volume(9).bytes_reconstructed > 0
store.close()
# a partition with a mounted and a net-plane remote root
blobs = os.path.join(d, "blobs")

def resolve_blob(path, op, md):
    full = os.path.join(blobs, path)
    if op == "unlink":
        if os.path.exists(full):
            os.unlink(full)
        return None
    os.makedirs(os.path.dirname(full), exist_ok=True)
    return os.open(full, os.O_CREAT | os.O_RDWR, 0o644)

bplane = net_plane.ShardNetPlane("127.0.0.1", 0, resolve, resolve_blob=resolve_blob)
bplane.start()
gport = bplane.port - net_plane.NET_PLANE_PORT_OFFSET
os.environ["SEAWEED_EC_STREAM_REMOTE_ROOTS"] = (
    f"far={os.path.join(d, 'far')},peer=net:127.0.0.1:{gport}")
rp = PartitionParity(d, "ns", "remote", 0, backend=TorchBackend(ECContext(4, 2), device="cpu"),
                     block_size=8192, small_block_size=1024)
for off in range(30):
    rp.append_record(off, off, b"k", bytes(900))
rp.flush()
rp.close()
assert any(os.path.islink(os.path.join(rp.dir, n)) for n in os.listdir(rp.dir))
assert os.listdir(os.path.join(blobs, "ns", "remote", "0000"))
assert len(PartitionParity(d, "ns", "remote", 0, backend=rp.backend).recover()) == 30
PartitionParity(d, "ns", "remote", 0, backend=rp.backend).delete()
assert not os.listdir(os.path.join(blobs, "ns", "remote", "0000"))
del os.environ["SEAWEED_EC_STREAM_REMOTE_ROOTS"]
bplane.stop()
# a port server's gRPC EC RPCs, with no master reachable
import grpc
from seaweedfs_tpu_torch.ec.net_plane import free_grpc_port
from seaweedfs_tpu_torch.pb import cluster_pb2 as pb, rpc
from seaweedfs_tpu_torch.server.volume_server import VolumeServer

dead = free_grpc_port()
vs = VolumeServer([os.path.join(d, "vs")], master=f"127.0.0.1:{dead}", ip="127.0.0.1",
                  port=free_grpc_port(), grpc_port=free_grpc_port(), ec_backend="cpu")
vs.start()
vol = vs.store.allocate_volume(13)
for nid, body in bodies.items():
    vs.store.write_needle(13, Needle(cookie=nid, needle_id=nid, data=body))
with grpc.insecure_channel(f"127.0.0.1:{vs.grpc_port}") as ch:
    st = rpc.volume_stub(ch)
    gen = st.VolumeEcShardsGenerate(pb.EcShardsGenerateRequest(volume_id=13), timeout=60).generation
    st.VolumeEcShardsMount(pb.EcShardsMountRequest(volume_id=13), timeout=30)
    got = b"".join(c.data for c in st.VolumeEcShardRead(pb.EcShardReadRequest(
        volume_id=13, shard_id=12, offset=0, size=70_000, generation=gen), timeout=30))
assert got == open(os.path.join(d, "vs", "13.ec12"), "rb").read()[:70_000] and len(got) == 70_000
vs.stop()
# servers built by the launcher: VolumeCopy from one into the other, then
# VacuumVolume of the copy
from seaweedfs_tpu_torch.server.__main__ import build

def launched(name):
    return build(["volume", "-dir", os.path.join(d, name), "-master", f"127.0.0.1:{dead}",
                  "-ip", "127.0.0.1", "-port", str(free_grpc_port()), "-ec.backend", "cpu"],
                 config_dirs=())[0]

src, dst = launched("la"), launched("lb")
src.store.allocate_volume(21)
for nid, body in bodies.items():
    src.store.write_needle(21, Needle(cookie=nid, needle_id=nid, data=body))
src.store.delete_needle(21, min(bodies))
with grpc.insecure_channel(f"127.0.0.1:{dst.grpc_port}") as ch:
    st = rpc.volume_stub(ch)
    assert not st.VolumeCopy(pb.EcShardsCopyRequest(
        volume_id=21, source_url=f"127.0.0.1:{src.grpc_port}"), timeout=60).error
    assert st.VacuumVolume(pb.VacuumRequest(volume_id=21), timeout=60).reclaimed_bytes > 50_000
nid = max(bodies)
assert dst.store.read_needle(21, nid, nid).data == bodies[nid]
src.stop()
dst.stop()
# a port master with one port server: Assign, POST, lookup
import http.client, json
from seaweedfs_tpu_torch.server.master import MasterServer

mport = free_grpc_port()
ms = MasterServer(ip="127.0.0.1", port=mport, vacuum_interval=3600)
ms.start()
vs = VolumeServer([os.path.join(d, "mv")], master=f"127.0.0.1:{mport}", ip="127.0.0.1",
                  port=free_grpc_port(), grpc_port=free_grpc_port(), ec_backend="cpu")
vs.start()

def http_req(port, method, path, body=None):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    c.request(method, path, body=body)
    r = c.getresponse()
    out = r.status, r.read()
    c.close()
    return out

deadline = time.time() + 60
while not ms.topo.nodes and time.time() < deadline:
    time.sleep(0.05)
code, body = http_req(mport, "GET", "/dir/assign")
a = json.loads(body)
assert code == 200, a
assert http_req(vs.port, "POST", "/" + a["fid"], b"assigned" * 99)[0] == 201
code, body = http_req(mport, "GET", "/dir/lookup?volumeId=" + a["fid"].split(",")[0])
assert code == 200 and json.loads(body)["locations"][0]["url"] == a["url"] == f"127.0.0.1:{vs.port}"
assert http_req(vs.port, "GET", "/" + a["fid"]) == (200, b"assigned" * 99)
# the port shell at the port master: ec.encode of the assigned volume, then
# volume.list once the heartbeat lists its shards
from seaweedfs_tpu_torch.shell.commands import ShellEnv, run_command

env = ShellEnv(f"127.0.0.1:{mport}")
vid = int(a["fid"].split(",")[0])
out = run_command(env, f"ec.encode -volumeId {vid} -backend cpu")
assert out.startswith(f"ec.encode volume {vid}: generation ") and out.endswith(a["url"]), out
want = f"  ec {vid} col=- shards={list(range(14))} 10+4 gen="
deadline = time.time() + 30
while want not in run_command(env, "volume.list") and time.time() < deadline:
    time.sleep(0.05)
listing = run_command(env, "volume.list")
assert want in listing and f"volume {vid} " not in listing, listing
# a port worker registered at the port master: the fleet scrub of the EC
# volume, submitted through the shell, runs ScrubEcVolume at the server
import threading
from seaweedfs_tpu_torch.worker.worker import Worker

w = Worker(master=f"127.0.0.1:{mport}", backend="cpu", worker_id="w-guard")
threading.Thread(target=w.run, daemon=True).start()
deadline = time.time() + 30
while "w-guard" not in run_command(env, "worker.list") and time.time() < deadline:
    time.sleep(0.05)
assert run_command(env, f"task.submit -kind ec_scrub -volumeId {vid}").endswith(" submitted")
deadline = time.time() + 30
while " done worker=w-guard" not in run_command(env, "task.list") and time.time() < deadline:
    time.sleep(0.05)
assert run_command(env, "task.list").endswith(f"ec_scrub vol={vid} done worker=w-guard")
report = ms.worker_control.scrub_summary()
assert report["volumes"] == 1 and report["corrupt_shards"] == 0, report
w.stop()
env.close()
assert http_req(vs.port, "GET", "/" + a["fid"]) == (200, b"assigned" * 99)
# one file written and read back through the port's Filer, chunked
from seaweedfs_tpu_torch.filer import Filer, SSTableStore

filer = Filer(SSTableStore(os.path.join(d, "filer")), master=f"127.0.0.1:{mport}",
              chunk_size=4096)
body = rng.integers(0, 256, 10_000, dtype=np.uint8).tobytes()
assert len(filer.write_file("/guard/f.bin", body).chunks) == 3
assert filer.read_file("/guard/f.bin") == body
filer.close()
# two port FilerServers in one lock ring: a PUT and a GET over HTTP, a
# lease through the ring, the shell's fs.ls and cluster.lock.ring
from seaweedfs_tpu_torch.filer import MemoryStore
from seaweedfs_tpu_torch.filer.lock_ring import DlmClient
from seaweedfs_tpu_torch.server.filer_server import FilerServer

gports = [free_grpc_port(), free_grpc_port()]
ring = [f"127.0.0.1:{g}" for g in gports]
fss = []
for g in gports:
    fs = FilerServer(Filer(MemoryStore(), master=f"127.0.0.1:{mport}"), ip="127.0.0.1",
                     port=free_grpc_port(), grpc_port=g, peers=[a for a in ring if not a.endswith(f":{g}")])
    fs.start()
    fss.append(fs)
assert http_req(fss[0].port, "PUT", "/guard/ring.bin", body)[0] == 201
assert http_req(fss[0].port, "GET", "/guard/ring.bin") == (200, body)
dlm = DlmClient(ring)
lease = dlm.lock("guard", "guard-owner", ttl=30.0)
assert lease.ok and dlm.status()[0][:2] == ("guard", "guard-owner")
renv = ShellEnv(f"127.0.0.1:{mport}", f"127.0.0.1:{fss[0].port}")
assert run_command(renv, "fs.ls /guard").endswith("/guard/ring.bin")
assert run_command(renv, f"cluster.lock.ring -filers {','.join(ring)}").startswith("guard ")
assert dlm.unlock("guard", lease.token).ok
dlm.close()
renv.close()
# the S3 gateway over the ring's first filer, open mode: a bucket, a
# chunked PUT and a GET, and its lifecycle scanner over the bucket
from seaweedfs_tpu_torch.s3 import S3Server

s3 = S3Server(fss[0].filer, ip="127.0.0.1", port=free_grpc_port(), lifecycle_interval=0)
s3.start()
assert http_req(s3.port, "PUT", "/guard")[0] == 200
assert http_req(s3.port, "PUT", "/guard/obj.bin", body)[0] == 200
assert http_req(s3.port, "GET", "/guard/obj.bin") == (200, body)
assert s3.lifecycle.run_once(bucket="guard") == {"expired": 0, "noncurrent_expired": 0,
                                                 "aborted_uploads": 0}
# the Iceberg catalog and the IAM API in open mode, an OIDC bearer and an LDAP bind
assert http_req(s3.port, "POST", "/iceberg/v1/namespaces", b'{"namespace": ["g"]}')[0] == 200
assert http_req(s3.port, "POST", "/iceberg/v1/namespaces/g/tables", b'{"name": "t"}')[0] == 200
code, body = http_req(s3.port, "GET", "/iceberg/v1/namespaces/g/tables/t")
assert code == 200 and json.loads(body)["metadata"]["location"] == "s3://default/g/t"
assert http_req(s3.port, "POST", "/", b"Action=CreateUser&UserName=g")[0] == 200
exec(PROVIDERS)
s3.stop()
for fs in fss:
    fs.stop()
vs.stop()
ms.stop()
# a port master and volume server over https, then ?locate and the
# fastread sidecar (its library built from csrc/)
from seaweedfs_tpu_torch.client.operations import Operations
from seaweedfs_tpu_torch.utils import urls
from seaweedfs_tpu_torch.utils.fastread import read_fid_fast
from seaweedfs_tpu_torch.utils.tls import generate_self_signed

certs = generate_self_signed(os.path.join(d, "tls"))
urls.enable_https(certs.ca_file)
tport = free_grpc_port()
tms = MasterServer(ip="127.0.0.1", port=tport, vacuum_interval=3600, tls=certs)
tms.start()
tvs = VolumeServer([os.path.join(d, "tv")], master=f"127.0.0.1:{tport}", ip="127.0.0.1",
                   port=free_grpc_port(), grpc_port=free_grpc_port(), ec_backend="cpu", tls=certs)
tvs.start()
deadline = time.time() + 60
while not tms.topo.nodes and time.time() < deadline:
    time.sleep(0.05)
ops = Operations(f"127.0.0.1:{tport}")
fid = ops.upload(b"over https" * 99)
assert ops.read(fid, fast=False) == b"over https" * 99
with urls.urlopen(f"https://127.0.0.1:{tvs.port}/{fid}?locate=true", timeout=10) as r:
    loc = json.loads(r.read())
assert loc["socket"] and read_fid_fast(loc) == b"over https" * 99
ops.close()
tvs.stop()
tms.stop()
urls.disable_https()
# a memory-only MQ broker with a durable-parity topic on the native CPU
# backend, closed and replayed from its parity directory
os.environ["SEAWEED_EC_STREAM_BACKEND"] = "cpu"
from seaweedfs_tpu_torch.mq import MqBroker
import seaweedfs_tpu_torch.mq.agent, seaweedfs_tpu_torch.mq.logstore
br = MqBroker(parity_dir=os.path.join(d, "mqp"))
br.configure_topic("default", "dp", 2)
for i in range(50):
    br.topic("default", "dp").logs[i % 2].append(i, b"k%d" % i, b"v" * 700)
br.close()
br = MqBroker(parity_dir=os.path.join(d, "mqp"))
assert [len(br.topic("default", "dp").logs[p].read_from(0)) for p in (0, 1)] == [25, 25]
br.close()
# a broker's Kafka gateway with group commit, a durable-parity topic
# produced to and fetched back through the port's client
os.environ["SEAWEED_MQ_GROUP_COMMIT_MS"] = "5"
from seaweedfs_tpu_torch.mq import MqBrokerServer
from seaweedfs_tpu_torch.mq.kafka.client import KafkaClient, assign_range, parse_assignment
from seaweedfs_tpu_torch.mq.kafka.records import Record
kb = MqBrokerServer(ip="127.0.0.1", grpc_port=free_grpc_port(), kafka_port=0,
                    parity_dir=os.path.join(d, "kp"))
kb.start()
kc = KafkaClient("127.0.0.1", kb.kafka.port)
assert kc.create_topic("kdp", partitions=1) == 0
for codec in range(5):
    kc.produce("kdp", 0, [Record(key=b"k", value=b"v%d" % codec)], compression=codec)
assert [r.value for r in kc.fetch("kdp", 0, 0)[1]] == [b"v%d" % c for c in range(5)]
assert parse_assignment(assign_range([("m", b"")], {"kdp": 1})[0][1]) == {"kdp": [0]}
assert kb.broker.group_committer().windows_committed >= 1
kc.close()
kb.stop()
shutil.rmtree(d)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "seaweedfs_tpu", "requests"))
print("LEAKED", bad)
sys.exit(1 if bad else 0)
"""


def test_port_import_and_encode_leave_jax_out_of_sys_modules():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _SUBPROCESS_ENCODE, _PROVIDERS],
        cwd=str(REPO), env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LEAKED []" in proc.stdout


_PARITY_BROKER = r"""
import os, sys, tempfile
os.environ["SEAWEED_EC_STREAM_BACKEND"] = "cpu"
from seaweedfs_tpu_torch.mq import MqBroker
d = tempfile.mkdtemp()
br = MqBroker(parity_dir=d)
br.configure_topic("default", "plain", 1, durable_parity=False)
br.topic("default", "plain").logs[0].append(1, b"k", b"v")
before = "torch" in sys.modules
br.configure_topic("default", "dp", 1)
br.topic("default", "dp").logs[0].append(1, b"k", b"v")
br.close()
print("TORCH", before, "torch" in sys.modules)
"""


def test_a_broker_loads_torch_where_a_durable_parity_topic_attaches():
    """A broker takes a topic without parity with torch out of
    `sys.modules`; the first durable-parity topic attaches its stream,
    which loads the EC backend and torch."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _PARITY_BROKER], cwd=str(REPO), env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "TORCH False True" in proc.stdout, proc.stdout


def test_default_backend_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchBackend(CTX)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_backend("cuda", 7, 3)  # a geometry no other test caches
    # "auto" is reached only by name, and without a card it is the
    # native CPU backend, counted (tests/test_torch_fallback.py)
    from seaweedfs_tpu_torch.ec import backend as port_backend

    before = port_backend.AUTO_CPU["no_card"]
    assert isinstance(get_backend("auto", 6, 3), PortCpuBackend)
    assert port_backend.AUTO_CPU["no_card"] == before + 1
    # the native CPU backend needs no card, and only its name reaches it
    be = get_backend("cpu", 7, 3)
    assert isinstance(be, PortCpuBackend) and not hasattr(be, "device")
    data = np.random.default_rng(5).integers(0, 256, (7, 333), dtype=np.uint8)
    assert np.array_equal(be.encode(data), CpuBackend(JaxECContext(7, 3)).encode(data))
    with pytest.raises(ECError):
        TorchBackend(CTX, device="meta")


def test_the_two_packages_schedulers_share_no_state():
    """Both packages' schedulers in one process: pools, ledgers, the
    default scope, the fallback registry and the metric families are
    each package's own, and driving one moves nothing of the other."""
    from seaweedfs_tpu.ec import backend as jax_backend
    from seaweedfs_tpu.ec import chip_pool as jax_pool
    from seaweedfs_tpu.ec import device_queue as jax_dq
    from seaweedfs_tpu.utils import metrics as jax_metrics
    from seaweedfs_tpu_torch.ec import backend, chip_pool, device_queue
    from seaweedfs_tpu_torch.utils import metrics

    assert device_queue.default_scope() is not jax_dq.default_scope()
    assert device_queue.default_residency() is not jax_dq.default_residency()
    assert chip_pool._pools is not jax_pool._pools and chip_pool._ledgers is not jax_pool._ledgers
    assert backend._FALLBACKS is not jax_backend._FALLBACKS
    assert metrics.REGISTRY is not jax_metrics.REGISTRY
    assert device_queue._queue_admitted is not jax_dq._queue_admitted
    assert not isinstance(device_queue.default_scope(), jax_dq.QueueScope)
    jax_before = {s["chip"] for s in jax_dq.default_scope().stats_snapshot()}
    jax_res = set(jax_dq.residency_snapshot().get("chips", {}))
    be = PortCpuBackend(CTX)
    q = device_queue.for_backend(be)
    t = q._admit("foreground", 123)
    assert any(s["chip"] == q.label for s in device_queue.stats_snapshot())
    # (a JAX queue may drop out of its weak registry meanwhile; none is added)
    assert {s["chip"] for s in jax_dq.default_scope().stats_snapshot()} <= jax_before
    assert q.label not in jax_before and q.label not in jax_res
    assert set(jax_dq.residency_snapshot().get("chips", {})) <= jax_res
    q._release(t)
    # a scope of one package refuses to serve the other's backend as a chip
    # of its own pool: neither package builds a pool from the other's backend
    assert chip_pool.pool_for(CpuBackend(JCTX)) is None
    assert jax_pool.pool_for(be) is None
    # the gateway summary reads each package's own ledger
    assert metrics.gateway_summary()["residency"] == device_queue.residency_snapshot()
