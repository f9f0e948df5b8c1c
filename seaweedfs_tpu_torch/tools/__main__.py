"""Offline volume tools (reference `weed fix` / `export` / `compact`):

  python -m seaweedfs_tpu_torch.tools fix     -dir D -volumeId N   rebuild .idx from .dat
  python -m seaweedfs_tpu_torch.tools export  -dir D -volumeId N -o out.tar
  python -m seaweedfs_tpu_torch.tools compact -dir D -volumeId N   offline vacuum
  python -m seaweedfs_tpu_torch.tools scan    -dir D -volumeId N   print needles
  python -m seaweedfs_tpu_torch.tools backup  -dir D -volumeId N -o B [-from host:grpcPort]

Port of seaweedfs_tpu/tools/__main__.py over the port's storage/, the
same output byte for byte. Where the two differ, on purpose: `fix` reads
the .dat with the host library's scanner (`utils/native.scan_dat`), and a
library that fails to build or load stops it, where the JAX tool falls
back to the Python walk on any error of the native scan; with
SEAWEED_EC_NATIVE=0 it takes the Python walk (`storage/volume_scan.py`).
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys
import tarfile

from ..storage.types import NeedleValue
from ..storage.volume import Volume
from ..storage.volume_scan import scan_volume_file


def _base(a) -> str:
    return Volume.base_file_name(a.dir, a.collection, a.volumeId)


def _is_tombstone_record(dat_fd: int, stored_off: int, body_size: int) -> bool:
    """Delete marker test: empty body (legacy tombstones / reference
    fix.go:86 semantics) OR an empty-data body whose flags byte carries
    FLAG_IS_TOMBSTONE (0x40, this framework's explicit marker). The
    flags byte sits at header(16) + data_size(4) + data(len) when the
    body exists."""
    if body_size == 0:
        return True
    if body_size > 64:  # real payloads: skip the pread
        return False
    import struct as _struct

    from ..storage.needle import FLAG_IS_TOMBSTONE

    off = stored_off * 8 + 16
    head = os.pread(dat_fd, min(body_size, 64), off)
    if len(head) < 5:
        return False
    (data_len,) = _struct.unpack_from(">I", head, 0)
    if data_len != 0 or len(head) < 5 + data_len:
        return False
    return bool(head[4] & FLAG_IS_TOMBSTONE)


def cmd_fix(a) -> int:
    """Rebuild .idx by replaying the .dat (reference fix.go:86: size>0
    puts, tombstone appends are delete markers)."""
    base = _base(a)
    live: dict[int, NeedleValue] = {}
    records = 0
    if os.environ.get("SEAWEED_EC_NATIVE", "1") != "0":  # the host library's scanner
        from ..utils import native

        ids, offs, sizes, ok = native.scan_dat(base + ".dat")
        scan = (
            (int(a), int(b), int(c), bool(d))
            for a, b, c, d in zip(ids, offs, sizes, ok)
        )
    else:
        _, items = scan_volume_file(base + ".dat")
        scan = (
            (i.needle.needle_id, i.offset // 8, i.body_size, i.crc_ok)
            for i in items
        )
    dat_fd = os.open(base + ".dat", os.O_RDONLY)
    try:
        for nid, stored_off, body_size, crc_ok in scan:
            if not crc_ok:
                print(f"skip needle {nid:x} at {stored_off * 8}: bad crc")
                continue
            records += 1
            if _is_tombstone_record(dat_fd, stored_off, body_size):
                live.pop(nid, None)  # delete marker
            else:
                live[nid] = NeedleValue(nid, stored_off, body_size)
    finally:
        os.close(dat_fd)
    # .idx is a replayable journal; a minimal rebuild carries only the
    # surviving entries, ascending
    with open(base + ".idx.tmp", "wb") as f:
        for nid in sorted(live):
            f.write(live[nid].to_bytes())
        f.flush()
        os.fsync(f.fileno())
    os.replace(base + ".idx.tmp", base + ".idx")
    print(f"rebuilt {base}.idx from {records} records ({len(live)} live entries)")
    return 0


def cmd_export(a) -> int:
    base = _base(a)
    live: dict[int, tuple] = {}
    _, items = scan_volume_file(base + ".dat")
    for item in items:
        if item.crc_ok and not (
            item.body_size == 0 or item.needle.is_tombstone
        ):
            live[item.needle.needle_id] = item
        else:
            live.pop(item.needle.needle_id, None)
    with tarfile.open(a.o, "w") as tar:
        for nid, item in sorted(live.items()):
            n = item.needle
            name = n.name.decode(errors="replace") if n.name else f"{nid:x}"
            info = tarfile.TarInfo(name=name)
            info.size = len(n.data)
            info.mtime = n.last_modified
            tar.addfile(info, io.BytesIO(n.data))
    print(f"exported {len(live)} files -> {a.o}")
    return 0


def cmd_compact(a) -> int:
    v = Volume(a.dir, a.volumeId, collection=a.collection, create=False)
    reclaimed = v.vacuum()
    v.close()
    print(f"compacted volume {a.volumeId}: reclaimed {reclaimed} bytes")
    return 0


def _remote_reader(source: str, vid: int, collection: str):
    """CopyFile-backed reader against a live volume server
    ('host:grpcPort') for remote incremental backup."""
    import grpc

    from ..pb import cluster_pb2 as pb
    from ..pb import rpc

    channel = grpc.insecure_channel(source)
    stub = rpc.volume_stub(channel)

    def stream(ext: str, start: int = 0, stop: int = 0):
        for c in stub.CopyFile(
            pb.CopyFileRequest(
                volume_id=vid,
                collection=collection,
                ext=ext,
                start_offset=start,
                stop_offset=stop,
            ),
            timeout=3600,
        ):
            yield c.data

    def read(ext: str, start: int = 0, stop: int = 0) -> bytes:
        return b"".join(stream(ext, start, stop))

    return read, stream, channel


def cmd_backup(a) -> int:
    """Incremental volume backup (reference `weed backup`): .dat is
    append-only, so each run copies only the new tail plus the current
    .idx; the backup directory is itself a loadable volume directory.
    With -from host:grpcPort the source is a LIVE volume server
    (VolumeTailSender analog) instead of local files."""

    from ..storage.super_block import SUPER_BLOCK_SIZE, SuperBlock

    src_base = _base(a)
    os.makedirs(a.o, exist_ok=True)
    name = os.path.basename(src_base)
    dst_base = os.path.join(a.o, name)
    state_path = dst_base + ".backup.state"
    last = 0
    last_rev = -1
    if os.path.exists(state_path):
        try:
            st = json.load(open(state_path))
            last = st["size"]
            last_rev = st.get("revision", -1)
        except (ValueError, KeyError, OSError):
            last = 0
    remote = getattr(a, "source", "")
    channel = None
    if remote:
        import grpc as _grpc

        from ..ec.decoder import record_actual_size
        from ..storage.types import NEEDLE_MAP_ENTRY_SIZE, NeedleValue, actual_offset

        read_remote, stream_remote, channel = _remote_reader(
            remote, a.volumeId, a.collection
        )
        try:
            header = read_remote(".dat", 0, SUPER_BLOCK_SIZE)
        except _grpc.RpcError as e:
            print(f"volume {a.volumeId} not readable on {remote}: {e.code().name}")
            channel.close()
            return 1
        sb = SuperBlock.from_bytes(header)
        revision = sb.compaction_revision
        # snapshot the .idx FIRST and bound the .dat to the extent its
        # entries cover: a write racing the backup must never leave idx
        # entries pointing past the copied data
        idx = read_remote(".idx")
        src_size = SUPER_BLOCK_SIZE
        for off in range(0, len(idx) - len(idx) % NEEDLE_MAP_ENTRY_SIZE,
                         NEEDLE_MAP_ENTRY_SIZE):
            nv = NeedleValue.from_bytes(idx[off : off + NEEDLE_MAP_ENTRY_SIZE])
            if nv.is_deleted:
                continue
            src_size = max(
                src_size,
                actual_offset(nv.offset)
                + record_actual_size(nv.size, sb.version),
            )
    else:
        src_size = os.path.getsize(src_base + ".dat")
        with open(src_base + ".dat", "rb") as f:
            revision = SuperBlock.from_bytes(
                f.read(SUPER_BLOCK_SIZE)
            ).compaction_revision
    if last_rev != -1 and revision != last_rev:
        # compaction shifted every offset — size alone can't detect it
        # when post-vacuum writes regrow the file past the old size
        print(
            f"compaction revision changed ({last_rev} -> {revision}); "
            "taking a fresh full backup"
        )
        last = 0
    elif src_size < last:
        print("source shrank; taking a fresh full backup")
        last = 0
    if not os.path.exists(dst_base + ".dat"):
        last = 0  # stale state without a backup file: full copy
    if last > src_size:
        last = 0  # idx-bounded extent moved backwards: full copy
    mode = "r+b" if last > 0 else "wb"
    try:
        with open(dst_base + ".dat", mode) as dst:
            dst.seek(last)
            copied = 0
            if remote:
                # streamed: a large volume must not be held in RAM
                for chunk in stream_remote(".dat", last, src_size):
                    dst.write(chunk)
                    copied += len(chunk)
            else:
                with open(src_base + ".dat", "rb") as src:
                    src.seek(last)
                    while True:
                        chunk = src.read(1 << 20)
                        if not chunk:
                            break
                        dst.write(chunk)
                        copied += len(chunk)
            dst.truncate(src_size)
            dst.flush()
            os.fsync(dst.fileno())
        # .idx is small and replayable: copy whole (remote: the snapshot
        # taken BEFORE the dat copy, so entries never outrun the data)
        if not remote:
            with open(src_base + ".idx", "rb") as f:
                idx = f.read()
        with open(dst_base + ".idx", "wb") as f:
            f.write(idx)
            f.flush()
            os.fsync(f.fileno())
    finally:
        if channel is not None:
            channel.close()
    with open(state_path, "w") as f:
        json.dump({"size": src_size, "revision": revision}, f)
    print(f"backed up volume {a.volumeId}: +{copied} bytes (total {src_size})")
    return 0


def cmd_scan(a) -> int:
    base = _base(a)
    sb, items = scan_volume_file(base + ".dat")
    print(f"superblock: version={sb.version} rp={sb.replica_placement} rev={sb.compaction_revision}")
    for item in items:
        n = item.needle
        kind = "DEL" if (n.is_tombstone or item.body_size == 0) else "PUT"
        flag = "" if item.crc_ok else " CRC-BAD"
        print(
            f"{kind} offset={item.offset} id={n.needle_id:x} cookie={n.cookie:08x} "
            f"size={len(n.data)} name={n.name.decode(errors='replace')!r}{flag}"
        )
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="seaweedfs_tpu_torch.tools")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name, fn in (
        ("fix", cmd_fix),
        ("export", cmd_export),
        ("compact", cmd_compact),
        ("scan", cmd_scan),
        ("backup", cmd_backup),
    ):
        sp = sub.add_parser(name)
        sp.add_argument("-dir", required=True)
        sp.add_argument("-volumeId", type=int, required=True)
        sp.add_argument("-collection", default="")
        if name in ("export", "backup"):
            sp.add_argument("-o", required=True)
        if name == "backup":
            sp.add_argument(
                "-from",
                dest="source",
                default="",
                help="live volume server host:grpcPort (remote tail backup)",
            )
        sp.set_defaults(fn=fn)
    a = p.parse_args(argv)
    return a.fn(a)


if __name__ == "__main__":
    sys.exit(main())
