"""PyTorch port: remote storage (seaweedfs_tpu_torch/remote: the SigV4
`RemoteS3Client`, the provider registry, lazy remote mounts), the filer's
read-through and `/~remote/<op>`, the shell's `remote.*`, the worker's
`iceberg` task and `utils/retry.Backoff`, held against the JAX package
on the CPU.

Twin stacks (`Stack`): per package, a cluster with an S3 gateway over its
own filer (the "cloud", tests/torch_s3_twins.py `Side`) and a second,
local filer on the same cluster, served over HTTP with a meta log, with a
shell at it. Each scenario of the JAX tests/test_remote.py runs on both
stacks, its answers compared with the gateway's port masked (tolerance
0):

- SigV4 interop both ways: the port client against the JAX gateway, the
  JAX client against the port gateway, and the port against itself,
  each equal to the JAX client against the JAX gateway; listings paged
  past one ListObjectsV2 answer of 1,000 keys;
- mount, read-through and cache (the gateway stopped: cached bytes still
  read, uncached ones fail; restarted: uncache, unmount);
- the HTTP plane (every op, 400 / 404 / 409 / 502) and the shell's
  `remote.*` output, string for string; meta.sync counts; mount.buckets;
- the KV records and the `sw-remote` JSON byte-equal, both local filers
  mounting the one gateway; the provider registry's errors;
- `Backoff`'s schedule; the worker's `iceberg` task against a port
  gateway; the port client's kept connections.
"""

import functools
import hashlib
import http.client
import itertools
import json
import random
import re
import types

import numpy as np
import pytest
from torch_s3_twins import KEYS, PKGS, Side
from test_torch_volume_server import _ports

import seaweedfs_tpu.remote.mount as j_mount
import seaweedfs_tpu.remote.providers as j_providers
import seaweedfs_tpu.remote.s3_client as j_s3c
import seaweedfs_tpu.shell.commands as j_shell
import seaweedfs_tpu.utils.retry as j_retry
import seaweedfs_tpu.worker.worker as j_worker
from seaweedfs_tpu.filer.filer_store import NotFound as JaxNotFound
from seaweedfs_tpu.filer.meta_log import MetaLog as JaxMetaLog
from seaweedfs_tpu.server.filer_server import FilerServer as JaxFilerServer
import seaweedfs_tpu_torch.remote as p_remote
import seaweedfs_tpu_torch.remote.mount as p_mount
import seaweedfs_tpu_torch.remote.providers as p_providers
import seaweedfs_tpu_torch.remote.s3_client as p_s3c
import seaweedfs_tpu_torch.shell.commands as p_shell
import seaweedfs_tpu_torch.utils.retry as p_retry
import seaweedfs_tpu_torch.worker.worker as p_worker
from seaweedfs_tpu_torch.filer.filer_store import NotFound as PortNotFound
from seaweedfs_tpu_torch.filer.meta_log import MetaLog as PortMetaLog
from seaweedfs_tpu_torch.server.filer_server import FilerServer as PortFilerServer
from seaweedfs_tpu_torch.utils import urls as p_urls

REMOTE = {
    "jax": types.SimpleNamespace(
        mount=j_mount, providers=j_providers, s3c=j_s3c, shell=j_shell, worker=j_worker,
        filer_server=JaxFilerServer, meta_log=JaxMetaLog, not_found=JaxNotFound),
    "port": types.SimpleNamespace(
        mount=p_mount, providers=p_providers, s3c=p_s3c, shell=p_shell, worker=p_worker,
        filer_server=PortFilerServer, meta_log=PortMetaLog, not_found=PortNotFound),
}
AK, SK = KEYS["admin"]
CHUNK = 64 * 1024
SCHEMA = {"type": "struct", "schema-id": 0, "fields": [
    {"id": 1, "name": "id", "required": True, "type": "long"},
    {"id": 2, "name": "v", "required": False, "type": "string"}]}


def sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def seeded(seed: int, n: int) -> bytes:
    return np.random.default_rng(seed).bytes(n)


class Stack:
    """One package's twin: `side` (a cluster and its S3 gateway over the
    cloud filer), a local filer on the same cluster served at `fport`
    with a meta log, and a shell `env` at both."""

    def __init__(self, name: str, root, mp):
        self.name, self.r = name, REMOTE[name]
        # room for a volume per bucket: each bucket is a collection
        mp.setattr(PKGS[name], "volume", functools.partial(PKGS[name].volume,
                                                           max_volume_count=100))
        self.side = Side(name, root, mp)
        pkg = self.side.pkg
        self.filer = pkg.filer(pkg.memory(), master=f"127.0.0.1:{self.side.mport}",
                               chunk_size=CHUNK)
        self.fport = _ports()
        self.fsrv = self.r.filer_server(self.filer, ip="127.0.0.1", port=self.fport,
                                        meta_log=self.r.meta_log(str(root / "meta")))
        self.fsrv.start()
        self.env = self.r.shell.ShellEnv(master=f"127.0.0.1:{self.side.mport}",
                                         filer=f"127.0.0.1:{self.fport}")

    @property
    def endpoint(self) -> str:
        return f"http://127.0.0.1:{self.side.port}"

    def client(self, endpoint: str | None = None, secret: str = SK):
        return self.r.s3c.RemoteS3Client(endpoint or self.endpoint, AK, secret)

    def post(self, op: str, body) -> tuple:
        """POST /~remote/<op> at the local filer server: (status, JSON)."""
        raw = body if isinstance(body, bytes) else json.dumps(body).encode()
        c = http.client.HTTPConnection("127.0.0.1", self.fport, timeout=60)
        try:
            c.request("POST", f"/~remote/{op}", body=raw)
            r = c.getresponse()
            return r.status, json.loads(r.read())
        finally:
            c.close()

    def get(self, path: str, headers: dict | None = None) -> tuple:
        c = http.client.HTTPConnection("127.0.0.1", self.fport, timeout=60)
        try:
            c.request("GET", path, headers=headers or {})
            r = c.getresponse()
            return r.status, r.read()
        finally:
            c.close()

    def configure(self, name: str, endpoint: str | None = None) -> None:
        self.r.mount.configure(self.filer, name, {"endpoint": endpoint or self.endpoint,
                                                  "access_key": AK, "secret_key": SK})

    def restart_gateway(self) -> None:
        """The gateway stopped and started again over the same filer, on
        a new port."""
        pkg, old = self.side.pkg, self.side.s3
        self.side.port = _ports()
        self.side.s3 = pkg.server.S3Server(
            self.side.filer, ip="127.0.0.1", port=self.side.port, identities=old.identities,
            lifecycle_interval=0, http_workers=4)
        self.side.s3.start()

    def stop(self):
        self.env.close()
        self.fsrv.stop()
        self.filer.close()
        self.side.stop()


@pytest.fixture(scope="module")
def stacks(tmp_path_factory):
    root = tmp_path_factory.mktemp("remote")
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        for name in PKGS:
            (root / name).mkdir()
            out[name] = Stack(name, root / name, mp)
        yield out
    finally:
        for s in out.values():
            s.stop()
        mp.undo()


def masked(stack: Stack, obj):
    """`obj` as JSON text with the stack's gateway and filer ports masked."""
    text = json.dumps(obj, sort_keys=True, default=repr)
    return re.sub(rf"\b({stack.side.port}|{stack.fport})\b", "<port>", text)


# ------------------------------------------------------------ the client


def client_ops(client, errors, bucket: str) -> list:
    """The JAX test_s3_client_sigv4_round_trip's operations, and a key
    that needs quoting: what each answered."""
    out = []

    def step(fn):
        try:
            out.append(fn())
        except errors as e:
            out.append(("raised", type(e).__name__,
                        str(e).split(":")[0].replace(bucket, "<bucket>")))

    body = seeded(1, 70_000)
    step(lambda: client.ensure_bucket(bucket))
    step(lambda: client.ensure_bucket(bucket))
    step(lambda: client.put_object(bucket, "a/b/hello.txt", b"hello remote"))
    step(lambda: client.put_object(bucket, "a/big.bin", body))
    step(lambda: client.put_object(bucket, "sp ace/ü+x=y.txt", b"quoted key"))
    step(lambda: client.get_object(bucket, "a/b/hello.txt"))
    step(lambda: client.get_object(bucket, "a/b/hello.txt", 6, 6))
    step(lambda: sha(client.get_object(bucket, "a/big.bin", 1000)))
    step(lambda: sha(client.get_object(bucket, "a/big.bin", 0, 65_537)))
    step(lambda: client.get_object(bucket, "sp ace/ü+x=y.txt"))
    step(lambda: [(o.key, o.size, o.etag) for o in client.list_objects(bucket, prefix="a/")])
    step(lambda: [o.key for o in client.list_objects(bucket)])
    step(lambda: [o.key for o in client.list_objects(bucket, prefix="sp ace/")])
    step(lambda: vars(client.head_object(bucket, "a/b/hello.txt")))
    step(lambda: client.head_object(bucket, "missing"))
    step(lambda: client.get_object(bucket, "missing"))
    step(lambda: bucket in client.list_buckets())
    step(lambda: client.delete_object(bucket, "a/b/hello.txt"))
    step(lambda: client.delete_object(bucket, "a/b/hello.txt"))
    step(lambda: client.list_objects(bucket, prefix="a/b/"))
    return out


@pytest.mark.parametrize("client_pkg,gateway_pkg", [("port", "jax"), ("jax", "port"),
                                                    ("port", "port")],
                         ids=["port-client-jax-gateway", "jax-client-port-gateway",
                              "port-client-port-gateway"])
def test_s3_client_sigv4_interop(stacks, client_pkg, gateway_pkg):
    bucket = f"sig-{client_pkg}-{gateway_pkg}"
    want = client_ops(stacks["jax"].client(), (j_s3c.RemoteStorageError,), bucket + "-ref")
    gw = stacks[gateway_pkg]
    client = REMOTE[client_pkg].s3c.RemoteS3Client(gw.endpoint, AK, SK)
    got = client_ops(client, (REMOTE[client_pkg].s3c.RemoteStorageError,), bucket)
    assert got == want
    assert got[5] == b"hello remote" and got[6] == b"remote" and got[9] == b"quoted key"
    # a wrong secret is refused by the gateway, the same way to both clients
    bad = REMOTE[client_pkg].s3c.RemoteS3Client(gw.endpoint, AK, "wrong")
    with pytest.raises(REMOTE[client_pkg].s3c.RemoteStorageError, match="HTTP 403") as e:
        bad.put_object(bucket, "x", b"y")
    assert type(e.value) is REMOTE[client_pkg].s3c.RemoteStorageError  # 4xx: not retried


def test_list_objects_pages_past_one_listing(stacks):
    """1,050 keys: ListObjectsV2 answers 1,000 and a continuation token;
    both clients follow it on both gateways, to the same listing."""
    keys = sorted(f"p/{i:05d}/k{i % 7}" for i in range(1050))
    for s in stacks.values():
        s.client().ensure_bucket("paged")
        for i, k in enumerate(keys):
            s.side.filer.write_file(f"/buckets/paged/{k}", seeded(i, 40 + i % 90))
    got = {}
    for client_pkg, gateway_pkg in itertools.product(REMOTE, REMOTE):
        c = REMOTE[client_pkg].s3c.RemoteS3Client(stacks[gateway_pkg].endpoint, AK, SK)
        got[client_pkg, gateway_pkg] = [(o.key, o.size, o.etag)
                                        for o in c.list_objects("paged", prefix="p/")]
    assert [k for k, *_ in got["port", "port"]] == keys
    assert len({json.dumps(v) for v in got.values()}) == 1


def test_the_port_client_keeps_its_connections(stacks, monkeypatch):
    """A client shared by a server's threads: requests in turn reuse one
    kept connection; a connection the gateway closed while idle is
    dialled again at once, without a retry's back-off."""
    dials = []
    plain = p_urls.connection

    def counting(url, timeout):
        dials.append(url)
        return plain(url, timeout)

    monkeypatch.setattr(p_urls, "connection", counting)
    s = stacks["port"]
    c = s.client()
    c.ensure_bucket("kept")
    for i in range(20):
        c.put_object("kept", f"k{i}", seeded(i, 1000))
        assert c.get_object("kept", f"k{i}", 10, 20) == seeded(i, 1000)[10:30]
    assert c.head_object("kept", "k3").size == 1000  # the HEAD's empty body read
    assert c.get_object("kept", "k4") == seeded(4, 1000)
    assert len(dials) == 1
    # the gateway closes its idle connections when it stops
    s.restart_gateway()
    c.endpoint = s.endpoint
    assert c.get_object("kept", "k5") == seeded(5, 1000)
    assert len(dials) == 2
    c.close()


# ---------------------------------------------------- mounts, read-through


def sc_mount_read_through_cache(s: Stack) -> list:
    """The JAX test_remote_mount_read_through_cache, its answers."""
    r, f = s.r, s.filer
    client = s.client()
    out = []
    client.ensure_bucket("datasets")
    blob = bytes(range(256)) * 640  # 160 KiB: three chunks once cached
    client.put_object("datasets", "v1/model.bin", blob)
    client.put_object("datasets", "v1/labels.txt", b"cat\ndog\n")
    client.put_object("datasets", "v1/sub/deep.txt", b"deep")
    client.put_object("datasets", "v2/other.txt", b"not mounted")
    s.configure("cloud")
    out.append(r.mount.mount(f, "/mnt/data", "cloud", "datasets", prefix="v1"))
    with pytest.raises(Exception) as e:
        r.mount.mount(f, "/mnt/data", "cloud", "datasets", prefix="v1")
    out.append(str(e.value))
    e = f.find_entry("/mnt/data/model.bin")
    out.append((e.file_size, len(e.chunks), bytes(e.content), e.extended["sw-remote"]))
    out.append(sha(f.read_entry(e)))
    out.append(f.read_entry(e, offset=256, size=16))
    out.append(f.read_entry(e, offset=len(blob) - 5, size=-1))
    out.append(f.read_file("/mnt/data/sub/deep.txt"))
    cached = r.mount.cache(f, "/mnt/data/model.bin")
    out.append((len(cached.chunks), cached.file_size, cached.extended["sw-remote"]))
    out.append(len(r.mount.cache(f, "/mnt/data/model.bin").chunks))  # already cached
    with pytest.raises(Exception) as e:
        r.mount.cache(f, "/mnt/data")
    out.append(str(e.value))
    # the cloud goes dark: the cached bytes still read, the rest fails
    s.side.s3.stop()
    try:
        out.append(sha(f.read_file("/mnt/data/model.bin")))
        with pytest.raises(r.s3c.RemoteStorageError):
            f.read_file("/mnt/data/labels.txt")
    finally:
        s.restart_gateway()
        s.configure("cloud")
    out.append(f.read_file("/mnt/data/labels.txt"))
    before = len(r.mount.uncache(f, "/mnt/data/model.bin").chunks)
    e = f.find_entry("/mnt/data/model.bin")
    out.append((before, len(e.chunks), bytes(e.content), e.file_size))
    out.append(sha(f.read_entry(e)))
    r.mount.unmount(f, "/mnt/data")
    with pytest.raises(r.not_found):
        f.find_entry("/mnt/data/model.bin")
    with pytest.raises(Exception) as e:
        r.mount.unmount(f, "/mnt/data")
    out.append(str(e.value))
    out.append(s.client().head_object("datasets", "v1/model.bin").size)
    out.append(r.mount.list_mounts(f))
    return out


def test_mount_read_through_and_cache(stacks):
    got = {name: masked(s, sc_mount_read_through_cache(s)) for name, s in stacks.items()}
    assert got["port"] == got["jax"]


def test_remote_mount_reads_through_a_chunked_cloud_object(stacks):
    """A cloud object the gateway stored in several chunks, read through
    the mount whole and at ranges across its chunk edges."""
    for s in stacks.values():
        body = seeded(7, 5 * CHUNK + 123)
        s.client().ensure_bucket("chunky")
        s.client().put_object("chunky", "obj", body)
        assert len(s.side.filer.find_entry("/buckets/chunky/obj").chunks) == 6
        s.configure("chunky")
        assert s.r.mount.mount(s.filer, "/chunky", "chunky", "chunky") == 1
        e = s.filer.find_entry("/chunky/obj")
        for off, n in ((0, -1), (CHUNK - 3, 7), (2 * CHUNK, 3 * CHUNK + 1), (5 * CHUNK, 500)):
            want = body[off:] if n < 0 else body[off:off + n]
            assert s.filer.read_entry(e, off, n) == want
        s.r.mount.unmount(s.filer, "/chunky")


# ------------------------------------------------------- the HTTP plane


def sc_http_plane(s: Stack) -> list:
    client = s.client()
    client.ensure_bucket("shellbucket")
    client.put_object("shellbucket", "f.txt", b"from the cloud")
    client.put_object("shellbucket", "d/g.bin", seeded(3, 100_000))
    out = []
    conf = {"name": "c2", "endpoint": s.endpoint, "access_key": AK, "secret_key": SK}
    out.append(s.post("configure", conf))
    out.append(s.post("mount", {"dir": "/cloud2", "remote": "c2", "bucket": "shellbucket"}))
    out.append(s.post("mount", {"dir": "/cloud2", "remote": "c2", "bucket": "shellbucket"}))
    out.append(s.get("/cloud2/f.txt"))
    out.append(s.get("/cloud2/f.txt", {"Range": "bytes=5-7"}))
    status, body = s.get("/cloud2/d/g.bin")
    out.append((status, sha(body)))
    status, body = s.get("/cloud2/d/g.bin", {"Range": "bytes=65530-65545"})
    out.append((status, body))
    status, body = s.get("/cloud2/?limit=10")
    out.append((status, [(e["FullPath"], e["FileSize"], e["IsDirectory"])
                         for e in json.loads(body)["Entries"]]))
    out.append(s.post("cache", {"path": "/cloud2/f.txt"}))
    out.append(s.post("cache", {"path": "/cloud2/d/g.bin"}))
    out.append(s.post("cache", {"path": "/cloud2/nope"}))
    status, body = s.get("/cloud2/d/g.bin")
    out.append((status, sha(body)))
    out.append(s.post("uncache", {"path": "/cloud2/d/g.bin"}))
    out.append(s.post("uncache", {"path": "/"}))
    out.append(s.post("meta.sync", {"dir": "/cloud2"}))
    out.append(s.post("meta.sync", {"dir": "/nowhere"}))
    out.append(s.post("unmount", {"dir": "/cloud2"}))
    out.append(s.post("unmount", {"dir": "/cloud2"}))
    out.append(s.get("/cloud2/f.txt")[0])
    out.append(s.post("bogus", {"dir": "/x"}))
    out.append(s.post("mount", b"{not json"))
    out.append(s.post("mount", {}))
    out.append(s.post("mount", {"dir": "/n", "remote": "nope", "bucket": "b"}))
    out.append(s.post("configure", {"endpoint": "x"}))
    # a remote that does not answer: 502
    dead = f"http://127.0.0.1:{_ports()}"
    out.append(s.post("configure", {**conf, "name": "dead", "endpoint": dead})[0])
    status, doc = s.post("mount", {"dir": "/dead", "remote": "dead", "bucket": "b"})
    out.append((status, sorted(doc)))
    return out


def test_remote_http_plane(stacks):
    got = {name: masked(s, sc_http_plane(s)) for name, s in stacks.items()}
    assert got["port"] == got["jax"]
    doc = json.loads(got["port"])
    assert doc[1] == [200, {"mounted": 2}] and doc[-1] == [502, ["error"]]


def sc_shell(s: Stack) -> list:
    client = s.client()
    for b, key in (("mb-one", "a.txt"), ("mb-two", "b/c.txt"), ("zz-skip", "c.txt")):
        client.ensure_bucket(b)
        client.put_object(b, key, b"data-" + b.encode())
    run = s.r.shell.run_command
    env = s.env
    lines = [
        f"remote.configure -name c3 -endpoint {s.endpoint} -accessKey {AK} -secretKey {SK}",
        "remote.mount -dir /sh -remote c3 -bucket mb-two",
        "remote.mount -dir /sh -remote c3 -bucket mb-two",
        "remote.mount -dir /sh2 -remote c3 -bucket mb-one -prefix a",
        "remote.cache -path /sh/b/c.txt",
        "remote.cache -path /sh/nope",
        "remote.uncache -path /sh/b/c.txt",
        "remote.meta.sync -dir /sh",
        "remote.meta.sync -dir /none",
        "remote.mount.buckets -dir /all -remote c3 -prefix mb-",
        "remote.mount.buckets -dir /all -remote c3 -prefix mb-",
        "remote.mount.buckets -dir /all -remote nope",
        "remote.unmount -dir /sh",
        "remote.unmount -dir /sh",
        "remote.unmount -dir /sh2",
        "fs.ls /all",
    ]
    out = [(line.split(" -endpoint")[0], run(env, line)) for line in lines]
    out.append(s.get("/all/mb-one/a.txt"))
    out.append(sorted(n for n, (_, h) in s.r.shell.COMMANDS.items() if n.startswith("remote.")))
    return out


def test_remote_shell_commands(stacks):
    """The shell's remote.* output, string for string."""
    got = {name: masked(s, sc_shell(s)) for name, s in stacks.items()}
    assert got["port"] == got["jax"]
    doc = json.loads(got["port"])
    assert doc[0][1] == "configured=True" and doc[1][1] == "mounted=1"
    assert doc[9][1] == "mounted={'mb-one': 1, 'mb-two': 1}, buckets=2"
    assert len(doc[-1]) == 7 and not set(doc[-1]) & set(p_shell.DEFERRED)
    assert len(p_shell.DEFERRED) == 9


def test_remote_configure_secret_that_starts_with_a_dash():
    """Both shells' parsers take `-secretKey -abc` for an option and exit;
    `-secretKey=-abc` carries it."""
    for r in REMOTE.values():
        env = types.SimpleNamespace(filer_addr="127.0.0.1:1")
        with pytest.raises(SystemExit):
            r.shell.run_command(env, "remote.configure -name n -endpoint e -secretKey -abc")
    sent = {}
    for name, r in REMOTE.items():
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(r.shell, "_remote_post", lambda env, op, body, _n=name: sent.setdefault(
                _n, (op, body)) and "ok")
            r.shell.run_command(None, "remote.configure -name n -endpoint e -secretKey=-abc")
    assert sent["port"] == sent["jax"] and sent["port"][1]["secret_key"] == "-abc"


def sc_meta_sync(s: Stack) -> list:
    """The JAX test_remote_meta_sync through the HTTP op, and a cached
    file whose cloud object changed (its stale chunks dropped)."""
    client = s.client()
    client.ensure_bucket("syncb")
    client.put_object("syncb", "keep.txt", b"v1")
    client.put_object("syncb", "gone.txt", b"bye")
    client.put_object("syncb", "cached.bin", seeded(4, 90_000))
    client.put_object("syncb", "dir/same.txt", b"same")
    s.post("configure", {"name": "c4", "endpoint": s.endpoint, "access_key": AK,
                         "secret_key": SK})
    out = [s.post("mount", {"dir": "/sync3", "remote": "c4", "bucket": "syncb"})]
    out.append(s.post("cache", {"path": "/sync3/cached.bin"}))
    client.put_object("syncb", "keep.txt", b"v2-new-content")
    client.put_object("syncb", "cached.bin", seeded(5, 20_000))
    client.put_object("syncb", "new.txt", b"fresh")
    client.put_object("syncb", "dir/new2.txt", b"fresh2")
    client.delete_object("syncb", "gone.txt")
    out.append(s.post("meta.sync", {"dir": "/sync3"}))
    out.append(s.post("meta.sync", {"dir": "/sync3"}))
    out.append(s.filer.find_entry("/sync3/new.txt").attr.file_size)
    out.append(s.filer.find_entry("/sync3/keep.txt").attr.file_size)
    e = s.filer.find_entry("/sync3/cached.bin")
    out.append((len(e.chunks), e.file_size))
    with pytest.raises(s.r.not_found):
        s.filer.find_entry("/sync3/gone.txt")
    out.append(s.get("/sync3/keep.txt"))
    status, body = s.get("/sync3/cached.bin")
    out.append((status, body == seeded(5, 20_000)))
    out.append(s.get("/sync3/dir/new2.txt"))
    out.append(s.post("unmount", {"dir": "/sync3"}))
    return out


def test_remote_meta_sync(stacks):
    got = {name: masked(s, sc_meta_sync(s)) for name, s in stacks.items()}
    assert got["port"] == got["jax"]
    doc = json.loads(got["port"])
    assert doc[2] == [200, {"added": 2, "updated": 2, "removed": 1}]
    assert doc[3] == [200, {"added": 0, "updated": 0, "removed": 0}]


def test_kv_records_and_the_sw_remote_json_are_byte_equal(stacks):
    """Both packages' local filers mount the one JAX gateway: the
    `remote.conf:<name>` and `remote.mounts` KV values and each entry's
    `sw-remote` attribute are the same bytes."""
    jax = stacks["jax"]
    client = jax.client()
    client.ensure_bucket("kvb")
    for i in range(5):
        client.put_object("kvb", f"pre/x{i}/o{i}.bin", seeded(i, 100 + 37 * i))
    got = {}
    for name, s in stacks.items():
        r = s.r
        r.mount.configure(s.filer, "kvr", {"endpoint": jax.endpoint, "access_key": AK,
                                            "secret_key": SK, "region": "eu-west-1"})
        r.mount.mount(s.filer, "/kv", "kvr", "kvb", prefix="pre/")
        attrs = {}
        stack = ["/kv"]
        while stack:
            for e in s.filer.list_entries(stack.pop(), limit=1000):
                if e.is_directory:
                    stack.append(e.full_path)
                else:
                    attrs[e.full_path] = bytes(e.extended["sw-remote"])
        got[name] = (s.filer.store.kv_get(b"remote.conf:kvr"),
                     s.filer.store.kv_get(b"remote.mounts"), attrs)
        r.mount.unmount(s.filer, "/kv")
    assert got["port"] == got["jax"] and len(got["port"][2]) == 5


# ----------------------------------------------------- providers, Backoff


def test_provider_registry():
    """The JAX test_remote_provider_registry on both packages: the same
    clients, the same errors with the same messages."""
    got = {}
    for name, r in REMOTE.items():
        out = []
        c = r.providers.make_remote_client("s3", endpoint="http://localhost:1",
                                           access_key="a", secret_key="b")
        out.append((type(c) is r.s3c.RemoteS3Client, c.endpoint, c.region))
        g = r.providers.make_remote_client("gcs-s3", access_key="a", secret_key="b",
                                           region="auto")
        out.append((type(g) is r.s3c.RemoteS3Client, g.endpoint, g.region))
        for kind in ("gcs", "azure", "dropbox"):
            with pytest.raises((RuntimeError, NotImplementedError, ValueError)) as e:
                r.providers.make_remote_client(kind)
            out.append((type(e.value).__name__, str(e.value)))

        class Fake:
            def __init__(self, **kw):
                self.kw = kw

        r.providers.register("fake-twin", Fake)
        f = r.providers.make_remote_client("fake-twin", endpoint="x", access_key="k",
                                           secret_key="s", extra=1)
        out.append(sorted(f.kw.items()))
        got[name] = out
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("seed", [0, 29])
def test_backoff_matches_the_jax_schedule(seed):
    for policy in (p_retry.RetryPolicy(max_attempts=7, base_delay=0.5, max_delay=30.0),
                   p_retry.RetryPolicy(max_attempts=3, base_delay=0.2, jitter=0.0)):
        jpol = j_retry.RetryPolicy(**{f: getattr(policy, f) for f in (
            "max_attempts", "base_delay", "max_delay", "multiplier", "jitter")})
        mine = p_retry.Backoff(policy, rng=random.Random(seed))
        theirs = j_retry.Backoff(jpol, rng=random.Random(seed))
        seq = []
        for i in range(12):
            if i == 9:
                mine.reset()
                theirs.reset()
            seq.append((mine.next_delay(), theirs.next_delay(), mine.failures,
                        theirs.failures))
        assert all(a == b and fa == fb for a, b, fa, fb in seq)
        assert max(f for _, _, f, _ in seq) == policy.max_attempts


def test_remote_s3_client_surface_matches():
    """Names, the retry policy and the error taxonomy."""
    for cls in ("RemoteS3Client", "RemoteObject", "RemoteStorageError",
                "TransientRemoteError", "DEFAULT_S3_RETRY_POLICY"):
        assert hasattr(p_s3c, cls)
    assert issubclass(p_s3c.TransientRemoteError, p_s3c.RemoteStorageError)
    pp, jp = p_s3c.DEFAULT_S3_RETRY_POLICY, j_s3c.DEFAULT_S3_RETRY_POLICY
    assert (pp.max_attempts, pp.base_delay, pp.max_delay) == (jp.max_attempts, jp.base_delay,
                                                              jp.max_delay)
    assert p_s3c.TransientRemoteError in pp.retry_on and OSError in pp.retry_on
    assert p_remote.RemoteS3Client is p_s3c.RemoteS3Client
    c = p_s3c.RemoteS3Client(f"http://127.0.0.1:{_ports()}", "a", "b")
    with pytest.raises(p_s3c.RemoteStorageError, match="failed after 3 attempts"):
        c.list_buckets()


# ---------------------------------------------------------- the worker


def test_iceberg_task_against_a_port_gateway(stacks):
    """Each package's worker runs its `iceberg` task against the port's
    gateway, on a table of three snapshots: the same POST, the same
    snapshots expired (only the current one kept)."""
    s = stacks["port"]
    got = {}
    for name, r in REMOTE.items():
        ns = f"ice{name}"
        base = "/iceberg/v1"

        def call(method, path, doc):
            status, _, raw = s.side.raw(method, path, "", json.dumps(doc).encode(),
                                        {"Content-Type": "application/json"})
            assert status == 200, raw
            return json.loads(raw)

        call("POST", f"{base}/namespaces", {"namespace": [ns]})
        call("POST", f"{base}/namespaces/{ns}/tables", {"name": "t", "schema": SCHEMA})
        for sid in (1, 2, 3):
            call("POST", f"{base}/namespaces/{ns}/tables/t", {"updates": [
                {"action": "add-snapshot", "snapshot": {
                    "snapshot-id": sid, "sequence-number": sid, "timestamp-ms": sid * 1000,
                    "manifest-list": f"s3://x/{sid}", "summary": {"operation": "append"}}},
                {"action": "set-snapshot-ref", "ref-name": "main", "snapshot-id": sid,
                 "type": "branch"}]})
        w = r.worker.Worker.__new__(r.worker.Worker)
        assign = types.SimpleNamespace(params={
            "s3": f"127.0.0.1:{s.side.port}", "older_than_days": "0", "access_key": AK,
            "secret_key": SK})
        w._task_iceberg(assign)
        status, _, raw = s.side.raw("GET", f"{base}/namespaces/{ns}/tables/t")
        meta = json.loads(raw)["metadata"]
        got[name] = ([x["snapshot-id"] for x in meta["snapshots"]],
                     meta["current-snapshot-id"])
        bad = types.SimpleNamespace(params={"s3": f"127.0.0.1:{s.side.port}",
                                            "access_key": AK, "secret_key": "wrong"})
        with pytest.raises(r.s3c.RemoteStorageError, match="HTTP 403"):
            w._task_iceberg(bad)
        with pytest.raises(RuntimeError, match="needs an s3"):
            w._task_iceberg(types.SimpleNamespace(params={}))
    assert got["port"] == got["jax"] == ([3], 3)


def test_the_port_worker_takes_iceberg():
    """`-capabilities iceberg` is taken, as by the JAX worker: the same
    capabilities by default and the same descriptors."""
    w = p_worker.Worker(master="127.0.0.1:1", capabilities=("iceberg", "vacuum"))
    assert w.capabilities == ("iceberg", "vacuum")
    jw = j_worker.Worker(master="127.0.0.1:1")
    pw = p_worker.Worker(master="127.0.0.1:1")
    assert pw.capabilities == jw.capabilities and "iceberg" in pw.capabilities
    assert [d.SerializeToString() for d in pw.descriptors] == [
        d.SerializeToString() for d in jw.descriptors]
