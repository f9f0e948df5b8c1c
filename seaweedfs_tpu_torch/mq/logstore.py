"""Parquet archival of sealed MQ log segments.

Port of seaweedfs_tpu/mq/logstore.py, whole; pyarrow is imported where a
segment is converted, or by `load_pyarrow` (which a filer-backed broker
calls where it is built), never when the module is. Reference: weed/mq/logstore — sealed in-memory log segments are
re-written as parquet files on the filer so long-retention topics cost
columnar-compressed storage and SQL scans read a columnar layout
instead of replaying raw record blobs. Archived segments remain fully
readable on the normal consume path: the broker's segment loader
falls back from `seg-N.log` to `seg-N.parquet` and re-materializes the
record stream bit-for-bit (offset, ts_ns, key, value).

Schema: offset int64 | ts_ns int64 | key binary | value binary, zstd
column compression, one row group per segment (segments are small).
"""

from __future__ import annotations

import io

from ..utils.glog import logger
from .log_buffer import decode_records, encode_record

log = logger("mq.logstore")


def load_pyarrow() -> bool:
    """Import pyarrow on the calling thread, where it is installed.

    In a process that holds torch, pyarrow first imported on a thread
    that later exits (a gRPC worker of `mq.topic.compact`) leaves the
    next conversion on another thread to segfault; imported on a thread
    that lives on, it does not. A broker calls this where it is built.
    False where pyarrow is missing (compaction then answers its error)."""
    try:
        import pyarrow  # noqa: F401
        import pyarrow.parquet  # noqa: F401
    except ImportError:
        return False
    return True


def segment_to_parquet(raw: bytes) -> bytes:
    """Sealed raw segment blob -> parquet bytes."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    offs, tss, keys, vals = [], [], [], []
    for off, ts_ns, key, value in decode_records(raw):
        offs.append(off)
        tss.append(ts_ns)
        keys.append(key)
        vals.append(value)
    table = pa.table(
        {
            "offset": pa.array(offs, pa.int64()),
            "ts_ns": pa.array(tss, pa.int64()),
            "key": pa.array(keys, pa.binary()),
            "value": pa.array(vals, pa.binary()),
        }
    )
    buf = io.BytesIO()
    pq.write_table(table, buf, compression="zstd")
    return buf.getvalue()


def parquet_to_segment(data: bytes) -> bytes:
    """Parquet bytes -> the original raw segment blob (re-encoded in
    offset order; the archival schema preserves every field)."""
    import pyarrow.parquet as pq

    table = pq.read_table(io.BytesIO(data))
    cols = [table.column(n).to_pylist() for n in ("offset", "ts_ns", "key", "value")]
    return b"".join(
        encode_record(o, t, k or b"", v or b"")
        for o, t, k, v in zip(*cols)
    )


def parquet_stats(data: bytes) -> dict:
    """Row count + offset/ts ranges straight from parquet metadata
    (no data decode) — used for scan pruning."""
    import pyarrow.parquet as pq

    f = pq.ParquetFile(io.BytesIO(data))
    md = f.metadata
    stats = {"rows": md.num_rows}
    try:
        rg = md.row_group(0)
        for i in range(rg.num_columns):
            col = rg.column(i)
            name = col.path_in_schema
            if name in ("offset", "ts_ns") and col.statistics is not None:
                stats[f"{name}_min"] = col.statistics.min
                stats[f"{name}_max"] = col.statistics.max
    except Exception:  # noqa: BLE001 — stats are an optimization only
        pass
    return stats


class SegmentArchiver:
    """Background conversion of sealed `.log` segments to `.parquet`.

    Idempotent and crash-safe: the parquet file is written BEFORE the
    raw segment is deleted, and the loader prefers `.log` when both
    exist. The live (unsealed) tail is never touched."""

    def __init__(self, broker, min_age_segments: int = 1):
        self.broker = broker
        # keep the newest N sealed segments raw (cheap re-reads for
        # tailing consumers); archive everything older
        self.min_age_segments = max(min_age_segments, 0)

    def run_once(self) -> int:
        archived = 0
        if not self.broker.filer:
            return 0
        for ns, name, count in self.broker.list_topics():
            for part in range(count):
                archived += self._archive_partition(ns, name, part)
        return archived

    def _archive_partition(self, ns: str, name: str, part: int) -> int:
        b = self.broker
        d = f"{b.topics_root()}/{ns}/{name}/{part:04d}"
        try:
            entries = b._list_dir(d)
        except Exception:  # noqa: BLE001 — directory may not exist yet
            return 0
        raw_segs = sorted(
            e["FullPath"]
            for e in entries
            if e["FullPath"].endswith(".log")
        )
        done = 0
        # leave the newest sealed segments raw
        for path in raw_segs[: len(raw_segs) - self.min_age_segments]:
            raw = b._get_file(path)
            if raw is None:
                continue
            try:
                parquet = segment_to_parquet(raw)
            except Exception as e:  # noqa: BLE001 — skip, keep the raw seg
                log.warning(f"archive {path}: {e!r}")
                continue
            pq_path = path[: -len(".log")] + ".parquet"
            b._put_file(pq_path, parquet)
            # stats sidecar BEFORE the raw delete: the query engine's
            # predicate pushdown prunes whole segments on it without
            # fetching the parquet bytes
            import json as _json

            try:
                b._put_file(
                    path[: -len(".log")] + ".stats.json",
                    _json.dumps(parquet_stats(parquet)).encode(),
                )
            except Exception as e:  # noqa: BLE001 — stats optional
                log.warning(f"stats for {path}: {e!r}")
            b._delete_file(path)
            done += 1
            log.v(1, f"archived {path} ({len(raw)} -> {len(parquet)} bytes)")
        return done
