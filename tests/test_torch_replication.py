"""PyTorch port: replication (seaweedfs_tpu_torch/replication: `FilerSync`,
`FilerBackup`, `S3Sink` and the `python -m seaweedfs_tpu_torch.replication`
daemon), held against the JAX package on the CPU.

Twin stacks (tests/test_torch_remote.py `Stack`: per package a cluster, an
S3 gateway and a filer served with a meta log) and, per package, a second
filer on the same cluster, the sync's target. Each scenario runs on both
packages with the same seeded bytes; what the sinks hold after it, the
counters, the state files and what each call answered must be equal
(tolerance 0):

- the JAX test_filer_sync_full_and_tail (full copy, creates, overwrites,
  deletes, a directory, an idempotent tail), and the meta log's gap
  (`droppedBeforeTsNs` past the watermark) answered by a full resync;
- the JAX test_filer_backup_to_local_dir (full copy, tail, rename by
  `os.replace`, deletes, scope, a restart that resumes from its state);
- the JAX test_s3_sink_mirrors_filer_subtree;
- `__main__`'s parsing of every `-to` shape and of `replication.toml`;
- a renamed file at a filer and an S3 sink (its old path removed by the
  rename's own delete event), and a fault of the reference, ported as it
  is and shown in both: a backup's full copy reads one page (1,024
  entries) of a directory;
- the port's daemon by name on each sink, stopped by SIGTERM: exit code
  0, its state at the last event; `stop()` ends the tail's long-poll at
  once.
"""

import hashlib
import http.client
import json
import os
import signal
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

import numpy as np
import pytest
from conftest import wait_for
from test_torch_remote import AK, CHUNK, REMOTE, SK, Stack
from test_torch_volume_server import _ports
from torch_s3_twins import PKGS

import seaweedfs_tpu.filer.meta_log as j_meta_log
import seaweedfs_tpu.replication.__main__ as j_main
import seaweedfs_tpu.replication.backup as j_backup
import seaweedfs_tpu.replication.s3_sink as j_s3_sink
import seaweedfs_tpu.replication.sync as j_sync
import seaweedfs_tpu_torch.filer.meta_log as p_meta_log
import seaweedfs_tpu_torch.replication.__main__ as p_main
import seaweedfs_tpu_torch.replication.backup as p_backup
import seaweedfs_tpu_torch.replication.s3_sink as p_s3_sink
import seaweedfs_tpu_torch.replication.sync as p_sync

REPO = str(Path(__file__).resolve().parent.parent)
REPL = {
    "jax": types.SimpleNamespace(sync=j_sync, backup=j_backup, s3_sink=j_s3_sink, main=j_main,
                                 meta_log=j_meta_log),
    "port": types.SimpleNamespace(sync=p_sync, backup=p_backup, s3_sink=p_s3_sink, main=p_main,
                                  meta_log=p_meta_log),
}


def sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def seeded(seed: int, n: int) -> bytes:
    return np.random.default_rng(seed).bytes(n)


class Filers:
    """One package's pair: the source (its stack's filer server) and a
    target filer on the same cluster, served with a meta log."""

    def __init__(self, stack: Stack, root):
        self.stack, self.name = stack, stack.name
        self.repl = REPL[stack.name]
        pkg = stack.side.pkg
        self.tfiler = pkg.filer(pkg.memory(), master=f"127.0.0.1:{stack.side.mport}",
                                chunk_size=CHUNK)
        self.tport = _ports()
        self.tsrv = stack.r.filer_server(self.tfiler, ip="127.0.0.1", port=self.tport,
                                         meta_log=stack.r.meta_log(str(root / "tmeta")))
        self.tsrv.start()

    @property
    def source(self) -> str:
        return f"127.0.0.1:{self.stack.fport}"

    @property
    def target(self) -> str:
        return f"127.0.0.1:{self.tport}"

    def stop(self):
        self.tsrv.stop()
        self.tfiler.close()


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    root = tmp_path_factory.mktemp("replication")
    mp = pytest.MonkeyPatch()
    stacks, out = {}, {}
    try:
        for name in PKGS:
            (root / name).mkdir()
            stacks[name] = Stack(name, root / name, mp)
            out[name] = Filers(stacks[name], root / name)
        yield out
    finally:
        for f in out.values():
            f.stop()
        for s in stacks.values():
            s.stop()
        mp.undo()


def call(port: int, method: str, path: str, body: bytes | None = None, headers=None):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        c.request(method, path, body=body, headers=headers or {})
        r = c.getresponse()
        return r.status, r.read()
    finally:
        c.close()


def tree(filer, root: str) -> list:
    """Every entry under `root`: path, kind, size, the sha256 of its bytes."""
    out, stack = [], [root]
    while stack:
        for e in filer.list_entries(stack.pop(), limit=100_000):
            if e.is_directory:
                stack.append(e.full_path)
                out.append((e.full_path, "d"))
            else:
                out.append((e.full_path, e.file_size, sha(filer.read_entry(e))))
    return sorted(out)


def local_tree(d: str) -> list:
    out = []
    for dirpath, dirs, files in os.walk(d):
        rel = os.path.relpath(dirpath, d)
        out += [(os.path.normpath(os.path.join(rel, x)), "d") for x in dirs]
        for x in files:
            with open(os.path.join(dirpath, x), "rb") as f:
                out.append((os.path.normpath(os.path.join(rel, x)), sha(f.read())))
    return sorted(out)


def tail_until(job, cond, timeout: float = 20.0) -> None:
    deadline = time.time() + timeout
    while not cond():
        assert time.time() < deadline, "the tail never applied the events"
        job.tail_once(wait_seconds=0.5)


# -------------------------------------------------------------- FilerSync


def sc_sync(f: Filers) -> list:
    """The JAX test_filer_sync_full_and_tail, with a directory, a large
    chunked file and a recursive delete."""
    src, dst = f.stack.fport, f.tport
    out = []
    call(src, "POST", "/docs/one.txt", b"first")
    call(src, "POST", "/docs/sub/two.txt", b"second")
    call(src, "POST", "/docs/big.bin", seeded(1, 3 * CHUNK + 77))
    call(src, "POST", "/topics/skip.txt", b"excluded")
    sync = f.repl.sync.FilerSync(f.source, f.target)
    sync.watermark = time.time_ns() - 1
    out.append(sync.full_sync())
    out.append(tree(f.tfiler, "/"))
    call(src, "POST", "/docs/three.txt", b"third")
    call(src, "POST", "/docs/one.txt", b"first-v2")
    call(src, "DELETE", "/docs/sub/two.txt")
    call(src, "POST", "/docs/newdir/?mkdir=true")
    call(src, "POST", "/docs/deep/x/y.bin", seeded(2, 5000))
    tail_until(sync, lambda: call(dst, "GET", "/docs/deep/x/y.bin")[0] == 200
               and call(dst, "GET", "/docs/one.txt")[1] == b"first-v2"
               and call(dst, "GET", "/docs/sub/two.txt")[0] == 404)
    call(src, "DELETE", "/docs/deep?recursive=true")
    tail_until(sync, lambda: call(dst, "GET", "/docs/deep/x/y.bin")[0] == 404)
    out.append(tree(f.tfiler, "/docs"))
    out.append(sync.tail_once(wait_seconds=0.2))
    out.append((sync.synced_files, sync.deleted_files))
    return out


def test_filer_sync_full_and_tail(pairs):
    got = {name: sc_sync(f) for name, f in pairs.items()}
    assert got["port"] == got["jax"]
    assert got["port"][0] == 3 and got["port"][-2] == 0


def test_filer_sync_resyncs_across_a_meta_log_gap(pairs, tmp_path, monkeypatch, capsys):
    """Events before the watermark rotated out of the source's log
    (`droppedBeforeTsNs` past it): the tail answers 0 and runs a full
    resync, which brings the target up to the source."""
    got = {}
    for name, f in pairs.items():
        stack = f.stack
        monkeypatch.setattr(f.repl.meta_log, "SEGMENT_BYTES", 3000)
        monkeypatch.setattr(f.repl.meta_log, "KEEP_SEGMENTS", 2)
        pkg = stack.side.pkg
        sfiler = pkg.filer(pkg.memory(), master=f"127.0.0.1:{stack.side.mport}")
        sport = _ports()
        ssrv = stack.r.filer_server(sfiler, ip="127.0.0.1", port=sport,
                                    meta_log=stack.r.meta_log(str(tmp_path / f"{name}-gap")))
        ssrv.start()
        try:
            out = []
            call(sport, "POST", "/gap/first.txt", b"before the gap")
            sync = f.repl.sync.FilerSync(f"127.0.0.1:{sport}", f.target, "/gap",
                                         str(tmp_path / f"{name}.state"))
            sync.watermark = 1
            for i in range(60):
                call(sport, "POST", f"/gap/f{i:02d}.txt", seeded(i, 100 + i))
            status, body = call(sport, "GET", "/~meta/tail?sinceNs=0")
            out.append(json.loads(body)["droppedBeforeTsNs"] > 1)
            capsys.readouterr()
            out.append(sync.tail_once(wait_seconds=0))
            out.append(capsys.readouterr().out.split(" (watermark")[0])
            out.append(tree(f.tfiler, "/gap"))
            with open(tmp_path / f"{name}.state") as fh:
                state = json.load(fh)
            out.append((sorted(state), state["sinceNs"] == sync.watermark > 1))
            got[name] = out
        finally:
            ssrv.stop()
            sfiler.close()
    assert got["port"] == got["jax"]
    assert got["port"][0] is True and got["port"][1] == 0 and len(got["port"][3]) == 61


def test_a_renamed_file_leaves_its_old_path_at_no_sink(pairs):
    """FilerSync and S3Sink copy a renamed file's new path and leave the
    old one to the event that removes it: the filer's rename logs a
    delete of the old path and a create of the new one, so neither sink
    keeps the old path, in either package."""
    got = {}
    for name, f in pairs.items():
        src, dst = f.stack.fport, f.tport
        call(src, "POST", "/mv/a.txt", b"moved bytes")
        sync = f.repl.sync.FilerSync(f.source, f.target, "/mv")
        client = f.stack.client()
        sink = f.repl.s3_sink.S3Sink(f.source, client, "mvsink", path_prefix="/mv")
        sync.watermark = sync._source_now_ns() - 1
        sink.watermark = sync.watermark
        out = [sync.full_sync(), sink.full_sync()]
        call(src, "POST", "/mv/b.txt?mv.from=/mv/a.txt")
        tail_until(sync, lambda: call(dst, "GET", "/mv/b.txt")[0] == 200
                   and call(dst, "GET", "/mv/a.txt")[0] == 404)
        tail_until(sink, lambda: [o.key for o in client.list_objects("mvsink")] == ["b.txt"])
        out.append((call(dst, "GET", "/mv/a.txt"), call(dst, "GET", "/mv/b.txt")))
        out.append(sorted(o.key for o in client.list_objects("mvsink")))
        got[name] = out
    assert got["port"] == got["jax"]
    assert got["port"][2][0][0] == 404 and got["port"][2][1] == (200, b"moved bytes")
    assert got["port"][3] == ["b.txt"]


# ------------------------------------------------------------ FilerBackup


def sc_backup(f: Filers, root: Path) -> list:
    """The JAX test_filer_backup_to_local_dir."""
    src = f.stack.fport
    dest, state = str(root / f"{f.name}-backup"), str(root / f"{f.name}-bk.state")
    out = []
    call(src, "POST", "/bk/a.txt", b"alpha")
    call(src, "POST", "/bk/sub/b.txt", b"beta")
    call(src, "POST", "/bk/big.bin", seeded(3, 2 * CHUNK + 5))
    bk = f.repl.backup.FilerBackup(f.source, dest, path="/bk", state_path=state)
    t = threading.Thread(target=bk.run, daemon=True)
    t.start()

    def wait_file(rel, content, timeout=20):
        p = os.path.join(dest, rel)

        def there():
            if not os.path.exists(p):
                return False
            with open(p, "rb") as fh:
                return fh.read() == content

        wait_for(there, timeout=timeout, msg=f"{rel} never reached {content[:20]!r}")

    wait_file("a.txt", b"alpha")
    wait_file("sub/b.txt", b"beta")
    wait_file("big.bin", seeded(3, 2 * CHUNK + 5))
    out.append(local_tree(dest))
    call(src, "POST", "/bk/c.txt", b"gamma")
    wait_file("c.txt", b"gamma")
    call(src, "POST", "/bk/a.txt", b"alpha-2")
    wait_file("a.txt", b"alpha-2")
    call(src, "POST", "/bk/renamed.txt?mv.from=/bk/c.txt")
    wait_file("renamed.txt", b"gamma")
    wait_for(lambda: not os.path.exists(os.path.join(dest, "c.txt")), timeout=20,
             msg="the rename never moved the file")
    call(src, "DELETE", "/bk/sub/b.txt")
    wait_for(lambda: not os.path.exists(os.path.join(dest, "sub/b.txt")), timeout=20,
             msg="the delete never propagated")
    call(src, "POST", "/other/x.txt", b"no")
    call(src, "POST", "/bk/marker.txt", b"m")
    wait_file("marker.txt", b"m")
    out.append(local_tree(dest))
    bk.stop()
    t.join(timeout=15)
    out.append(t.is_alive())
    with open(state) as fh:
        out.append(sorted(json.load(fh)))
    # a restart resumes from the watermark: no full recopy
    call(src, "POST", "/bk/d.txt", b"delta")
    os.unlink(os.path.join(dest, "a.txt"))
    bk2 = f.repl.backup.FilerBackup(f.source, dest, path="/bk", state_path=state)
    out.append(bk2.watermark == bk.watermark > 0)
    tail_until(bk2, lambda: os.path.exists(os.path.join(dest, "d.txt")))
    out.append(local_tree(dest))
    out.append((bk.copied_files, bk.deleted_files, bk2.copied_files))
    return out


def test_filer_backup_to_a_local_directory(pairs, tmp_path):
    got = {name: sc_backup(f, tmp_path) for name, f in pairs.items()}
    assert got["port"] == got["jax"]
    assert got["port"][3] == ["watermark"] and got["port"][2] is False
    assert "a.txt" not in {p for p, _ in got["port"][-2]}  # not recopied on restart


def test_backup_full_copy_reads_one_page_of_a_directory(pairs, tmp_path):
    """A fault of the reference, ported as it is: `full_sync` reads one
    listing page (the filer's 1,024 entries) of each directory."""
    got = {}
    for name, f in pairs.items():
        for i in range(1030):
            f.stack.filer.write_file(f"/page/f{i:04d}", b"x%d" % i)
        bk = f.repl.backup.FilerBackup(f.source, str(tmp_path / name), path="/page",
                                       state_path=str(tmp_path / f"{name}.state"))
        # the listing is at fault, not the copy: each file's copy is noted
        # and not fetched
        copied = []
        bk._copy_file = lambda path, _c=copied: _c.append(path) or True
        got[name] = (bk.full_sync(), copied[-1])
    assert got["port"] == got["jax"] == (1024, "/page/f1023")


# --------------------------------------------------------------- S3Sink


def sc_s3_sink(f: Filers) -> list:
    """The JAX test_s3_sink_mirrors_filer_subtree."""
    filer = f.stack.filer
    client = f.stack.client()
    filer.write_file("/backup/a.txt", b"alpha" * 500)
    filer.write_file("/backup/sub/b.txt", b"beta")
    filer.write_file("/backup/big.bin", seeded(4, 3 * CHUNK))
    filer.write_file("/other/c.txt", b"out of scope")
    sink = f.repl.s3_sink.S3Sink(f.source, client, "mirror", key_prefix="pfx/",
                                 path_prefix="/backup")
    out = [sink.full_sync()]
    out.append(sorted((o.key, o.size) for o in client.list_objects("mirror")))
    out.append(client.get_object("mirror", "pfx/a.txt") == b"alpha" * 500)
    sink.watermark = sink._source_now_ns()
    filer.write_file("/backup/new.txt", b"fresh")
    filer.delete_entry("/backup/a.txt")
    filer.write_file("/backup/sub/b.txt", b"beta-2")

    def done():
        keys = {o.key for o in client.list_objects("mirror")}
        return ("pfx/new.txt" in keys and "pfx/a.txt" not in keys
                and client.get_object("mirror", "pfx/sub/b.txt") == b"beta-2")

    tail_until(sink, done)
    out.append(sorted((o.key, o.size) for o in client.list_objects("mirror")))
    out.append((sink.synced_files, sink.deleted_files))
    return out


def test_s3_sink_mirrors_a_filer_subtree(pairs):
    got = {name: sc_s3_sink(f) for name, f in pairs.items()}
    assert got["port"] == got["jax"]
    assert got["port"][0] == 3


# ------------------------------------------------------- the entry point


TO_SHAPES = {
    "filer": ["-to", "127.0.0.1:2"],
    "s3": ["-to", "s3://127.0.0.1:3/bucket/key/prefix", "-s3.accessKey", "k",
           "-s3.secretKey", "s"],
    "s3-bucket-only": ["-to", "s3://127.0.0.1:3/bucket"],
    "local": ["-to", "/tmp/backup-dir", "-path", "/docs"],
    "file-url": ["-to", "file:///tmp/backup-dir", "-state", "mine.state"],
    "filer-with-state": ["-to", "127.0.0.1:2", "-path", "/a/b/", "-state", "s.state"],
}


def parsed(name: str, argv, monkeypatch) -> list:
    """What `main(argv)` of package `name` builds (each job's arguments,
    the S3 client's), that it runs it, and what it returns."""
    r, seen = REPL[name], []

    class Client:
        def __init__(self, **kw):
            seen.append(("client", sorted(kw.items())))

    def fake(kind):
        class Job:
            def __init__(self, *a, **kw):
                a = tuple("<client>" if isinstance(x, Client) else x for x in a)
                seen.append((kind, a, sorted(kw.items())))

            def run(self):
                seen.append(("run", kind))

            def stop(self):
                pass

        return Job

    monkeypatch.setattr(r.main, "FilerSync", fake("sync"))
    monkeypatch.setattr(r.backup, "FilerBackup", fake("backup"))
    monkeypatch.setattr(r.s3_sink, "S3Sink", fake("s3"))
    monkeypatch.setattr(REMOTE[name].s3c, "RemoteS3Client", Client)
    monkeypatch.setattr(signal, "signal", lambda *a: None)
    seen.append(r.main.main(argv))
    return seen


@pytest.mark.parametrize("shape", sorted(TO_SHAPES))
def test_main_parses_every_sink_shape(shape, monkeypatch, capsys):
    argv = ["-from", "127.0.0.1:1", *TO_SHAPES[shape]]
    got = {name: parsed(name, argv, monkeypatch) for name in REPL}
    assert got["port"] == got["jax"] and got["port"][-1] == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2 and out[0] == out[1]


@pytest.mark.parametrize("argv", [[], ["-to", "s3://127.0.0.1:3"], ["-to", "s3://h:1/"]],
                         ids=["no-target", "s3-no-bucket", "s3-empty-bucket"])
def test_main_refuses_what_it_cannot_run(argv, capsys):
    errs = {}
    for name, r in REPL.items():
        with pytest.raises(SystemExit) as e:
            r.main.main(["-from", "127.0.0.1:1", *argv] if argv else [])
        errs[name] = (e.value.code, capsys.readouterr().err.splitlines()[-1].split(": ", 1)[1])
    assert errs["port"] == errs["jax"] and errs["port"][0] == 2


def test_main_reads_replication_toml(tmp_path, monkeypatch, capsys):
    """`replication.toml` in the working directory gives -from, -to and
    -path their defaults."""
    (tmp_path / "replication.toml").write_text(
        '[source.filer]\naddress = "127.0.0.1:7"\n'
        '[sink.filer]\naddress = "127.0.0.1:8"\ndirectory = "/from/toml"\n')
    monkeypatch.chdir(tmp_path)
    got = {name: parsed(name, [], monkeypatch) for name in REPL}
    assert got["port"] == got["jax"]
    assert got["port"][0] == ("sync", ("127.0.0.1:7", "127.0.0.1:8", "/from/toml",
                                       "filer.sync.state"), [])
    assert capsys.readouterr().out.splitlines()[0] == "syncing 127.0.0.1:7/from/toml -> 127.0.0.1:8"


# ----------------------------------------------------- the port's daemon


def spawn(argv, cwd) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.Popen([sys.executable, "-m", "seaweedfs_tpu_torch.replication", *argv],
                            cwd=cwd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


@pytest.mark.parametrize("sink", ["filer", "s3", "local"])
def test_the_daemon_stops_on_sigterm_with_its_state_saved(pairs, tmp_path, sink):
    """`python -m seaweedfs_tpu_torch.replication` by name: its initial
    copy, an event tailed to the sink, then SIGTERM while it waits in
    its long-poll: exit code 0 within seconds, its state at or past the
    event."""
    f = pairs["port"]
    src = f.stack.fport
    root = f"/daemon-{sink}"
    call(src, "POST", f"{root}/one.bin", seeded(6, 70_000))
    state = str(tmp_path / "state")
    client = f.stack.client()
    if sink == "filer":
        to, get = f.target, lambda p: call(f.tport, "GET", f"{root}/{p}")
    elif sink == "s3":
        to = f"s3://127.0.0.1:{f.stack.side.port}/daemonsink/pfx"

        def get(p):
            obj = client.head_object("daemonsink", f"pfx/{p}")
            return (200, client.get_object("daemonsink", f"pfx/{p}")) if obj else (404, b"")
    else:
        to = str(tmp_path / "local")

        def get(p):
            path = os.path.join(to, p)
            if not os.path.exists(path):
                return 404, b""
            with open(path, "rb") as fh:
                return 200, fh.read()

    proc = spawn(["-from", f.source, "-to", to, "-path", root, "-state", state,
                  "-s3.accessKey", AK, "-s3.secretKey", SK], str(tmp_path))
    try:
        wait_for(lambda: get("one.bin") == (200, seeded(6, 70_000)), timeout=60,
                 msg="the initial copy never arrived")
        call(src, "POST", f"{root}/two.txt", b"tailed")
        wait_for(lambda: get("two.txt") == (200, b"tailed"), timeout=30,
                 msg="the tailed write never arrived")
        _, body = call(src, "GET", "/~meta/tail?sinceNs=0")
        last = max(e["tsNs"] for e in json.loads(body)["events"])
        time.sleep(0.5)  # into the next long-poll
        t0 = time.monotonic()
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=10)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out
    assert time.monotonic() - t0 < 5, "the daemon waited out its long-poll"
    with open(state) as fh:
        doc = json.load(fh)
    assert (doc.get("sinceNs") or doc.get("watermark")) >= last, (doc, last)
    assert {"filer": "initial sync: 1 files copied", "s3": "initial copy: 1 files",
            "local": "initial backup: 1 files copied"}[sink] in out


def test_stop_ends_the_long_poll_at_once(pairs):
    f = pairs["port"]
    sync = p_sync.FilerSync(f.source, f.target, "/nothing-here")
    t = threading.Thread(target=sync.run, daemon=True)
    t.start()
    time.sleep(1.0)  # the initial copy done, the tail waiting
    t0 = time.monotonic()
    sync.stop()
    t.join(timeout=5)
    assert not t.is_alive() and time.monotonic() - t0 < 2
