"""Manifest chunks: chunk lists beyond a threshold are batched into
blobs so huge files don't bloat every metadata read.

Port of seaweedfs_tpu/filer/manifest.py, whole (reference
weed/filer/filechunk_manifest.go): when a file exceeds ManifestBatch (1000)
chunks, groups of chunks are serialized into a FileChunkManifest blob
stored in the volume store; the entry keeps one manifest FileChunk per
batch (is_chunk_manifest=true) whose offset/size cover the batch's
logical span.
"""

from __future__ import annotations

import time

from ..pb import filer_pb2 as fpb

MANIFEST_BATCH = 1000


def has_manifests(chunks) -> bool:
    return any(c.is_chunk_manifest for c in chunks)


def maybe_manifestize(
    upload, chunks: list[fpb.FileChunk], threshold: int = MANIFEST_BATCH
) -> list[fpb.FileChunk]:
    """Batch data chunks into manifest blobs when there are more than
    `threshold`. `upload(data: bytes) -> fid`. Already-manifest chunks
    pass through untouched (no nested re-manifesting of a spliced
    entry's existing manifests)."""
    plain = [c for c in chunks if not c.is_chunk_manifest]
    out = [c for c in chunks if c.is_chunk_manifest]
    if len(plain) <= threshold:
        return chunks
    ts = time.time_ns()
    for i in range(0, len(plain), threshold):
        batch = plain[i : i + threshold]
        blob = fpb.FileChunkManifest(chunks=batch).SerializeToString()
        fid = upload(blob)
        lo = min(c.offset for c in batch)
        hi = max(c.offset + c.size for c in batch)
        out.append(
            fpb.FileChunk(
                fid=fid,
                offset=lo,
                size=hi - lo,
                modified_ts_ns=ts,
                is_chunk_manifest=True,
            )
        )
    out.sort(key=lambda c: c.offset)
    return out


def resolve_manifests(read, chunks) -> list[fpb.FileChunk]:
    """Expand manifest chunks into their underlying data chunks.
    `read(fid) -> bytes`. Recurses (a manifest may itself have been
    re-manifestized by a later splice)."""
    if not has_manifests(chunks):
        return list(chunks)
    out: list[fpb.FileChunk] = []
    for c in chunks:
        if not c.is_chunk_manifest:
            out.append(c)
            continue
        m = fpb.FileChunkManifest.FromString(read(c.fid))
        out.extend(resolve_manifests(read, list(m.chunks)))
    return out


def gc_expand(read, chunks) -> list[fpb.FileChunk]:
    """All chunks a GC must delete: data chunks, manifest-referenced
    chunks, and the manifest blobs themselves. A manifest blob that
    can't be read still yields its own fid (best effort — the data
    chunks it referenced are orphaned rather than crashing GC)."""
    out: list[fpb.FileChunk] = []
    for c in chunks:
        out.append(c)
        if c.is_chunk_manifest:
            try:
                m = fpb.FileChunkManifest.FromString(read(c.fid))
            except Exception:
                continue
            out.extend(gc_expand(read, list(m.chunks)))
    return out
