"""Volume tail and incremental-sync client helpers.

Port of seaweedfs_tpu/client/volume_sync.py (reference
weed/operation/tail_volume.go TailVolumeFromSource, the needle reassembly
from the VolumeTailSender chunk stream, and weed/storage/volume_backup.go
IncrementalBackup, the byte-level follow). Either package's server is a
source: both speak the same `cluster.proto`.
"""

from __future__ import annotations

from typing import Iterator

import grpc

from ..pb import cluster_pb2 as pb
from ..pb import rpc
from ..storage.needle import Needle


def tail_volume(
    addr: str,
    volume_id: int,
    since_ns: int,
    idle_timeout_s: int = 3,
    timeout: float = 3600.0,
) -> Iterator[Needle]:
    """Yield the needles (puts and tombstones: the 0x40 flag bit)
    appended to `volume_id` on `addr` (host:grpcPort) after since_ns,
    following live appends until the source is idle for
    idle_timeout_s."""
    with grpc.insecure_channel(addr) as ch:
        stub = rpc.volume_stub(ch)
        pending = bytearray()
        version = 3
        for chunk in stub.VolumeTailSender(
            pb.VolumeTailRequest(volume_id=volume_id, since_ns=since_ns,
                                 idle_timeout_seconds=idle_timeout_s),
            timeout=timeout,
        ):
            version = chunk.version or version
            if chunk.needle_header or chunk.is_last_chunk:
                # a new record (or a heartbeat) completes the pending one
                if pending:
                    yield Needle.from_bytes(bytes(pending), version)
                    pending.clear()
            if chunk.needle_header:
                pending += chunk.needle_header
            if chunk.needle_body:
                pending += chunk.needle_body
        if pending:
            yield Needle.from_bytes(bytes(pending), version)


def incremental_copy(
    addr: str,
    volume_id: int,
    since_ns: int,
    timeout: float = 3600.0,
) -> tuple[int, Iterator[bytes]]:
    """-> (start_offset, chunk iterator) of the raw .dat bytes appended
    after since_ns. start_offset lets a byte-prefix follower check that it
    appends at the right place before it consumes the stream."""
    ch = grpc.insecure_channel(addr)
    stub = rpc.volume_stub(ch)
    stream = stub.VolumeIncrementalCopy(
        pb.VolumeIncrementalCopyRequest(volume_id=volume_id, since_ns=since_ns),
        timeout=timeout,
    )
    try:
        first = next(stream)
    except StopIteration:
        ch.close()
        return 0, iter(())
    if not first.has_start:
        ch.close()
        raise RuntimeError("incremental copy stream missing start_offset")

    def chunks() -> Iterator[bytes]:
        try:
            if first.file_content:
                yield first.file_content
            for c in stream:
                if c.file_content:
                    yield c.file_content
        finally:
            ch.close()

    return first.start_offset, chunks()


def sync_replica(
    target_addr: str,
    source_addr: str,
    volume_id: int,
    since_ns: int = 0,
    idle_timeout_s: int = 3,
    timeout: float = 3600.0,
) -> int:
    """Ask the target server to pull the tail from the source (the
    volume.sync verb); returns the needles applied."""
    with grpc.insecure_channel(target_addr) as ch:
        resp = rpc.volume_stub(ch).VolumeTailReceiver(
            pb.VolumeTailReceiverRequest(volume_id=volume_id, since_ns=since_ns,
                                         idle_timeout_seconds=idle_timeout_s,
                                         source_volume_server=source_addr),
            timeout=timeout,
        )
    if resp.error:
        raise RuntimeError(resp.error)
    return resp.received
