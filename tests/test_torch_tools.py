"""PyTorch port: the offline tools (`python -m seaweedfs_tpu_torch.tools
fix|export|compact|scan|backup`, tools/__main__.py) and the scaffold
templates (utils/scaffold.py, the launcher's `scaffold` mode), held
against the JAX package on the CPU:

- the seven cases of tests/test_tools.py against the port: scan, fix,
  export, compact, the incremental backup, the remote tail backup from a
  live port server, and the scrub RPCs through the port shell;
- every subcommand over copies of the same volume files in both
  packages: the same `.idx`, the same tar bytes, the same compacted
  `.dat` and `.idx`, the same scan lines, the same backup files;
- `tools` started by name in a child interpreter;
- every scaffold template's text equals the JAX one, and the launcher's
  `scaffold -output D` writes a TOML the port's config loader reads.
"""

import os
import shutil
import subprocess
import sys
import tarfile
import time

import numpy as np
import pytest
from conftest import allocate_port as free_port

from seaweedfs_tpu.tools.__main__ import main as jax_tools_main
from seaweedfs_tpu.utils import scaffold as jax_scaffold
from seaweedfs_tpu_torch.server import __main__ as launcher
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.volume import Volume
from seaweedfs_tpu_torch.storage.volume_scan import scan_volume_file
from seaweedfs_tpu_torch.tools.__main__ import main as tools_main
from seaweedfs_tpu_torch.utils import config, scaffold

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_volume(tmp_path, vid=9):
    v = Volume(str(tmp_path), vid)
    for i in range(1, 21):
        n = Needle(cookie=i, needle_id=i, data=bytes([i]) * (i * 100))
        n.set_name(f"file{i}.bin".encode())
        v.write_needle(n)
    v.delete_needle(3)
    v.write_needle(Needle(cookie=7, needle_id=7, data=b"rewritten"))
    v.close()
    return v


def test_scan_sees_all_records(tmp_path):
    make_volume(tmp_path)
    sb, items = scan_volume_file(str(tmp_path / "9.dat"))
    items = list(items)
    assert len(items) == 22  # 20 puts + 1 delete marker + 1 overwrite
    assert sum(1 for i in items if i.needle.is_tombstone) == 1
    assert all(i.crc_ok for i in items)


def test_fix_rebuilds_idx(tmp_path):
    make_volume(tmp_path)
    os.unlink(tmp_path / "9.idx")
    assert tools_main(["fix", "-dir", str(tmp_path), "-volumeId", "9"]) == 0
    v = Volume(str(tmp_path), 9, create=False)
    assert not v.has_needle(3)
    assert v.read_needle(7).data == b"rewritten"
    for i in (1, 10, 20):
        assert v.read_needle(i).data == bytes([i]) * (i * 100)
    v.close()


def test_export_tar(tmp_path):
    make_volume(tmp_path)
    out = str(tmp_path / "dump.tar")
    assert tools_main(["export", "-dir", str(tmp_path), "-volumeId", "9", "-o", out]) == 0
    with tarfile.open(out) as tar:
        names = tar.getnames()
        assert "file3.bin" not in names and len(names) == 19
        assert tar.extractfile("file10.bin").read() == bytes([10]) * 1000


def test_compact_tool(tmp_path):
    make_volume(tmp_path)
    size_before = os.path.getsize(tmp_path / "9.dat")
    assert tools_main(["compact", "-dir", str(tmp_path), "-volumeId", "9"]) == 0
    assert os.path.getsize(tmp_path / "9.dat") < size_before
    v = Volume(str(tmp_path), 9, create=False)
    assert v.read_needle(7).data == b"rewritten"
    v.close()


def test_incremental_backup(tmp_path):
    bdir = str(tmp_path / "bk")
    v = Volume(str(tmp_path), 11)
    for i in range(1, 6):
        v.write_needle(Needle(cookie=i, needle_id=i, data=bytes([i]) * 5000))
    v.flush()
    args = ["backup", "-dir", str(tmp_path), "-volumeId", "11", "-o", bdir]
    assert tools_main(args) == 0
    for i in range(6, 9):  # append more, delete one, back up again
        v.write_needle(Needle(cookie=i, needle_id=i, data=bytes([i]) * 5000))
    v.delete_needle(2)
    v.flush()
    assert tools_main(args) == 0
    v.close()
    b = Volume(bdir, 11, create=False)  # a loadable volume, the same live content
    assert not b.has_needle(2)
    for i in (1, 5, 8):
        assert b.read_needle(i).data == bytes([i]) * 5000
    b.close()
    v = Volume(str(tmp_path), 11, create=False)  # a vacuum forces a full backup
    v.vacuum()
    v.close()
    assert tools_main(args) == 0
    b = Volume(bdir, 11, create=False)
    assert b.read_needle(8).data == bytes([8]) * 5000
    b.close()


@pytest.fixture
def port_cluster(tmp_path):
    from seaweedfs_tpu_torch.client.operations import Operations
    from seaweedfs_tpu_torch.server.master import MasterServer
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer

    mport = free_port()
    master = MasterServer(ip="localhost", port=mport)
    master.start()
    vs = VolumeServer(directories=[str(tmp_path / "v")], master=f"localhost:{mport}",
                      ip="localhost", port=free_port(), ec_backend="cpu")
    vs.start()
    while not master.topo.nodes:
        time.sleep(0.05)
    ops = Operations(f"localhost:{mport}")
    yield mport, vs, ops
    ops.close()
    vs.stop()
    master.stop()


def test_remote_tail_backup(tmp_path, port_cluster):
    """Incremental backup pulled from a LIVE port volume server over gRPC
    (CopyFile)."""
    from seaweedfs_tpu_torch.storage.file_id import FileId

    _, vs, ops = port_cluster
    bdir = str(tmp_path / "remote-bk")
    fids = [ops.upload(b"live-%d" % i * 400) for i in range(5)]
    vid = FileId.parse(fids[0]).volume_id
    args = ["backup", "-dir", str(tmp_path / "ignored"), "-volumeId", str(vid), "-o", bdir,
            "-from", f"localhost:{vs.grpc_port}"]
    assert tools_main(args) == 0
    first = os.path.getsize(f"{bdir}/{vid}.dat")
    fids += [ops.upload(b"tail-%d" % i * 400) for i in range(3)]
    assert tools_main(args) == 0
    assert os.path.getsize(f"{bdir}/{vid}.dat") > first
    b = Volume(bdir, vid, create=False)
    for fid in fids:
        if FileId.parse(fid).volume_id == vid:
            assert b.read_needle(FileId.parse(fid).needle_id).data.startswith((b"live-", b"tail-"))
    b.close()
    # a volume the server does not hold: 1, and nothing written
    assert tools_main(args[:4] + ["999"] + args[5:]) == 1
    assert not os.path.exists(f"{bdir}/999.dat")


def test_scrub_rpcs(tmp_path, port_cluster):
    from seaweedfs_tpu_torch.shell.commands import ShellEnv, run_command
    from seaweedfs_tpu_torch.storage.file_id import FileId
    from seaweedfs_tpu_torch.storage.types import actual_offset

    mport, vs, ops = port_cluster
    env = ShellEnv(f"localhost:{mport}")
    try:
        fid = ops.upload(b"scrub me" * 1000)
        vid = FileId.parse(fid).volume_id
        assert "all clean" in run_command(env, f"volume.scrub -volumeId {vid}")
        v = vs.store.find_volume(vid)
        nv = v.needle_map.get(FileId.parse(fid).needle_id)
        with open(v.dat_path, "r+b") as f:  # one flipped data byte on disk
            f.seek(actual_offset(nv.offset) + 16 + 4 + 10)
            b = f.read(1)
            f.seek(-1, 1)
            f.write(bytes([b[0] ^ 0xFF]))
        assert "CORRUPT" in run_command(env, f"volume.scrub -volumeId {vid}")
        fid2 = ops.upload(b"ec scrub" * 5000)
        vid2 = FileId.parse(fid2).volume_id
        run_command(env, f"ec.encode -volumeId {vid2} -backend cpu -keepSource")
        time.sleep(0.5)
        assert "all clean" in run_command(env, f"ec.scrub -volumeId {vid2}")
        base = Volume.base_file_name(str(tmp_path / "v"), "", vid2)
        with open(base + ".ec02", "r+b") as f:
            f.seek(100)
            b = f.read(1)
            f.seek(100)
            f.write(bytes([b[0] ^ 0x01]))
        out = run_command(env, f"ec.scrub -volumeId {vid2}")
        assert "BITROT in shards [2]" in out, out
    finally:
        env.close()


# ------------------------------------------- the two packages, same files


def seeded_volume(d, vid: int = 6) -> None:
    """A volume of seeded needles with deletes, an overwrite and a
    record with a bad CRC at the end."""
    rng = np.random.default_rng(61)
    v = Volume(str(d), vid)
    for nid in range(1, 41):
        n = Needle(cookie=int(rng.integers(0, 1 << 32)), needle_id=nid,
                   data=rng.bytes(int(rng.integers(0, 30_000))))
        if nid % 3:
            n.set_name(f"n{nid}.bin".encode())
        v.write_needle(n)
    for nid in (4, 9, 33):
        v.delete_needle(nid)
    v.write_needle(Needle(cookie=1, needle_id=9, data=b"back again"))
    v.close()


def entries(v) -> list[tuple[int, int, int]]:
    return [(nv.needle_id, nv.offset, nv.size) for nv in v.needle_map.ascending_visit()]


def both(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    seeded_volume(src)
    for pkg in ("jax", "port"):
        shutil.copytree(src, tmp_path / pkg)
    return tmp_path / "jax", tmp_path / "port"


def run_both(capsys, jdir, pdir, args: list[str], out=None):
    outs = []
    for fn, d in ((jax_tools_main, jdir), (tools_main, pdir)):
        extra = ["-o", str(d / out)] if out else []
        assert fn([args[0], "-dir", str(d), "-volumeId", "6", *args[1:], *extra]) == 0
        outs.append(capsys.readouterr().out.replace(str(d), "D"))
    assert outs[0] == outs[1]
    return outs[1]


def test_fix_gives_the_jax_idx(tmp_path, capsys):
    jdir, pdir = both(tmp_path)
    for d in (jdir, pdir):
        os.unlink(d / "6.idx")
    assert run_both(capsys, jdir, pdir, ["fix"]) == (
        "rebuilt D/6.idx from 44 records (38 live entries)\n")
    assert (pdir / "6.idx").read_bytes() == (jdir / "6.idx").read_bytes()
    # the rebuilt map is the journal's: the same live entries
    v = Volume(str(pdir), 6, create=False)
    w = Volume(str(tmp_path / "src"), 6, create=False)
    assert entries(v) == entries(w)
    v.close(), w.close()


def test_fix_with_the_python_walk_gives_the_jax_idx(tmp_path, capsys, monkeypatch):
    jdir, pdir = both(tmp_path)
    for d in (jdir, pdir):
        os.unlink(d / "6.idx")
    monkeypatch.setenv("SEAWEED_EC_NATIVE", "0")
    run_both(capsys, jdir, pdir, ["fix"])
    assert (pdir / "6.idx").read_bytes() == (jdir / "6.idx").read_bytes()


def test_export_gives_the_jax_tar(tmp_path, capsys):
    jdir, pdir = both(tmp_path)
    assert run_both(capsys, jdir, pdir, ["export"], out="x.tar") == "exported 38 files -> D/x.tar\n"
    assert (pdir / "x.tar").read_bytes() == (jdir / "x.tar").read_bytes()
    v = Volume(str(pdir), 6, create=False)
    with tarfile.open(pdir / "x.tar") as tar:
        members = {m.name: tar.extractfile(m).read() for m in tar.getmembers()}
    live = {}
    for nid, _, _ in entries(v):
        n = v.read_needle(nid)
        live[n.name.decode() if n.name else f"{nid:x}"] = n.data
    v.close()
    assert members == live


def test_compact_gives_the_jax_volume(tmp_path, capsys):
    jdir, pdir = both(tmp_path)
    out = run_both(capsys, jdir, pdir, ["compact"])
    assert out.startswith("compacted volume 6: reclaimed ") and " 0 bytes" not in out
    for ext in (".dat", ".idx"):
        assert (pdir / f"6{ext}").read_bytes() == (jdir / f"6{ext}").read_bytes(), ext
    v = Volume(str(pdir), 6, create=False)
    w = Volume(str(tmp_path / "src"), 6, create=False)
    assert [e[0] for e in entries(v)] == [e[0] for e in entries(w)]
    for nid, _, _ in entries(w):
        assert v.read_needle(nid).data == w.read_needle(nid).data
    v.close(), w.close()


def test_scan_prints_the_jax_lines(tmp_path, capsys):
    jdir, pdir = both(tmp_path)
    at = (pdir / "6.dat").read_bytes().rindex(b"back again")
    for d in (pdir, jdir):  # a flipped data byte in the last record
        with open(d / "6.dat", "r+b") as f:
            f.seek(at)
            f.write(b"B")
    out = run_both(capsys, jdir, pdir, ["scan"])
    lines = out.splitlines()
    assert lines[0].startswith("superblock: version=3") and len(lines) == 45
    assert sum(ln.startswith("DEL ") for ln in lines) == 3 and lines[-1].endswith(" CRC-BAD")


def test_backup_gives_the_jax_files(tmp_path, capsys):
    jdir, pdir = both(tmp_path)
    run_both(capsys, jdir, pdir, ["backup"], out="bk")
    for ext in (".dat", ".idx", ".backup.state"):
        assert (pdir / "bk" / f"6{ext}").read_bytes() == (jdir / "bk" / f"6{ext}").read_bytes()


def test_tools_run_by_name(tmp_path):
    seeded_volume(tmp_path)
    os.unlink(tmp_path / "6.idx")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-m", "seaweedfs_tpu_torch.tools", "fix", "-dir",
                           str(tmp_path), "-volumeId", "6"], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout == f"rebuilt {tmp_path}/6.idx from 44 records (38 live entries)\n"
    proc = subprocess.run([sys.executable, "-m", "seaweedfs_tpu_torch.tools", "nope"], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2 and "invalid choice: 'nope'" in proc.stderr


# ------------------------------------------------------------ scaffold


@pytest.mark.parametrize("name", sorted(jax_scaffold.TEMPLATES))
def test_scaffold_template_is_the_jax_text(name):
    assert scaffold.scaffold(name) == jax_scaffold.scaffold(name)
    assert set(scaffold.TEMPLATES) == set(jax_scaffold.TEMPLATES)


def test_scaffold_refuses_an_unknown_config():
    for mod in (scaffold, jax_scaffold):
        with pytest.raises(KeyError, match="unknown config 'nope'"):
            mod.scaffold("nope")


def test_launcher_scaffold_writes_a_config_the_loader_reads(tmp_path, capsys):
    assert launcher.main(["scaffold", "-config", "security", "-output", str(tmp_path)]) == 0
    path = tmp_path / "security.toml"
    assert capsys.readouterr().out == f"{path}\n"
    assert path.read_text() == jax_scaffold.scaffold("security")
    cfg = config.load_config("security", [str(tmp_path)])
    assert cfg.get("jwt.signing.expires_after_seconds") == 10
    assert cfg.get_str("https.default.cert") == ""
    assert launcher.main(["scaffold", "-config", "master"]) == 0
    assert capsys.readouterr().out == jax_scaffold.scaffold("master")
