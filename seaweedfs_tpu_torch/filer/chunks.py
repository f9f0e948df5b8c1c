"""Chunk interval resolution: which bytes of which chunk are visible.

Port of seaweedfs_tpu/filer/chunks.py, whole. Files are ordered FileChunk
lists; overlapping writes are resolved by modification time — the latest
write wins (reference weed/filer/filechunks.go ViewFromChunks /
interval_list.go).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..pb import filer_pb2 as fpb


@dataclass(frozen=True)
class ChunkView:
    fid: str
    offset_in_chunk: int  # where in the chunk this view starts
    size: int
    logical_offset: int  # where in the file this view lands


def visible_intervals(chunks: list[fpb.FileChunk]) -> list[tuple[int, int, fpb.FileChunk]]:
    """-> [(start, stop, chunk)] non-overlapping, sorted by start."""
    intervals: list[tuple[int, int, fpb.FileChunk]] = []
    for c in sorted(chunks, key=lambda c: (c.modified_ts_ns, c.offset)):
        start, stop = c.offset, c.offset + c.size
        if stop <= start:
            continue
        updated: list[tuple[int, int, fpb.FileChunk]] = []
        for s, e, old in intervals:
            if e <= start or s >= stop:  # disjoint
                updated.append((s, e, old))
                continue
            if s < start:  # left remainder survives
                updated.append((s, start, old))
            if e > stop:  # right remainder survives
                updated.append((stop, e, old))
        updated.append((start, stop, c))
        updated.sort(key=lambda t: t[0])
        intervals = updated
    return intervals


def read_chunk_views(
    chunks: list[fpb.FileChunk], offset: int, size: int
) -> list[ChunkView]:
    """Views covering file range [offset, offset+size); gaps (sparse
    regions) are simply absent — callers zero-fill."""
    stop = offset + size
    views = []
    for s, e, c in visible_intervals(chunks):
        lo = max(s, offset)
        hi = min(e, stop)
        if lo >= hi:
            continue
        views.append(
            ChunkView(
                fid=c.fid,
                offset_in_chunk=lo - c.offset,
                size=hi - lo,
                logical_offset=lo,
            )
        )
    return views


def total_size(chunks: list[fpb.FileChunk]) -> int:
    return max((c.offset + c.size for c in chunks), default=0)
