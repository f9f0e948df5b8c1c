"""MQ broker: topics -> partitions -> append logs, pub/sub over gRPC.

Reference: weed/mq/broker (broker_grpc_pub.go/_sub.go) with filer-backed
segment storage (weed/mq/logstore) and consumer-group offsets
(weed/mq/offset). Partitioning: key-hash over a fixed partition count
(ring-slicing arrives with multi-broker balancing).

Port of seaweedfs_tpu/mq/broker.py: `MqBroker` (with its
`group_committer()`, mq/group_commit.py), `MqService` (every RPC) and
`MqBrokerServer` (with the Kafka gateway, mq/kafka/, on `kafka_port`).
Segments, `topic.conf`, `offsets.json` and
`schema.json` are the JAX broker's bytes in the same filer paths, and a
topic with durable parity writes the same stream generations. Where the
two differ, on purpose:

- the filer I/O goes over `http.client`, through one
  `utils/urls.KeptConnections` pool (one connection per request in
  flight, so the gRPC workers may share it), where the JAX broker keeps
  a `requests.Session`; only a 404 is absence, any other failure raises,
  as there;
- the SQL view (`pg_port`, ROADMAP item 19) is refused with a
  ValueError naming the item;
- the status plane also serves `/debug/kernels`: the launches of the
  port's two kernels in this process and its streams' parity
  dispatches, read without importing torch;
- a broker with a filer imports pyarrow where it is built
  (`logstore.load_pyarrow`), where the JAX broker imports it at the
  first conversion, on a gRPC worker: in a process that holds torch, a
  pyarrow first loaded on a thread that exits leaves the next
  conversion to segfault (ROADMAP Queue 3);
- the archive loop logs a failed cycle through the module's logger and
  goes on; the JAX loop names an undefined `log` there, and its thread
  ends at the first failure;
- `load_score` of a broker without a durable-parity stream answers 0
  before it imports `stream_parity` (which imports the EC backend, and
  so torch); the JAX one imports it first. The score is the same.

A topic with durable parity imports `stream_parity` where it attaches
its stream: a broker with none loads no torch.
"""

from __future__ import annotations

import hashlib
import http.client
import json
import os
import sys
import threading
import time
import urllib.parse
from concurrent import futures

import grpc

from ..pb import mq_pb2 as mq
from ..pb import rpc
from ..utils.glog import logger
from ..utils.urls import KeptConnections, service_url
from . import balancer as balancer_mod
from .log_buffer import PartitionLog, decode_records

mlog = logger("mq")

TOPICS_ROOT = "/topics"

# what a filer request of the broker raises where the filer is down or
# answers an error status (the JAX broker's `requests.RequestException`)
FILER_ERRORS = (OSError, http.client.HTTPException)


def refuse_later_ports(pg_port: int) -> None:
    """ValueError for a gateway the port does not serve yet: the
    PostgreSQL view (ROADMAP item 19)."""
    if pg_port >= 0:
        raise ValueError(f"pg port {pg_port}: the port has no query engine yet: it comes with "
                         "ROADMAP.md item 19")


class _TopicState:
    def __init__(self, partition_count: int, durable_parity: bool = False):
        self.partition_count = partition_count
        self.durable_parity = durable_parity
        self.logs: dict[int, PartitionLog] = {}
        # partition -> durable-parity stream (mq/stream_parity.py);
        # populated only when durable_parity is on and the broker has a
        # parity_dir
        self.parity: dict[int, "object"] = {}


class MqBroker:
    """Single-broker core; the service facade lives in MqService."""

    def __init__(
        self,
        filer: str = "",
        segment_records: int = 4096,
        parity_dir: str = "",
        durable_parity_default: bool | None = None,
    ):
        """filer: host:port of a filer for durable segments/offsets;
        empty = memory-only broker (bounded tails, no recovery — unless
        `parity_dir` gives it a durable-parity stream to replay from).

        parity_dir: local directory for streaming-EC log parity
        (ec/stream_encode.py). Topics configured with durable parity
        get per-partition EC streams whose parity trails the append
        head by a bounded lag; on restart the unsealed tail (records
        the filer segments never saw) is replayed from the stream.
        `durable_parity_default` is what `configure_topic` uses when
        the caller doesn't say (default: on iff parity_dir is set)."""
        self.filer = filer
        self.segment_records = segment_records
        self.parity_dir = parity_dir
        self.durable_parity_default = (
            bool(parity_dir)
            if durable_parity_default is None
            else durable_parity_default
        )
        self._parity_flusher = None
        self._mq_committer = None
        self._topics: dict[tuple[str, str], _TopicState] = {}
        self._offsets: dict[tuple, int] = {}  # (ns, topic, part, group)
        self._offset_meta: dict[tuple, str] = {}  # committed metadata
        self._schemas: dict[tuple[str, str], str] = {}  # (ns, topic)
        self._lock = threading.RLock()
        self._http = KeptConnections()
        if filer:
            # pyarrow (compaction, the archive loop) loads on the thread
            # that builds the broker, never on a gRPC worker that exits
            from .logstore import load_pyarrow

            load_pyarrow()
            # startup-ordering tolerance: the filer may still be coming up
            last_err = None
            for attempt in range(10):
                try:
                    self._recover()
                    break
                except FILER_ERRORS as e:
                    last_err = e
                    time.sleep(min(0.5 * (attempt + 1), 3.0))
            else:
                raise RuntimeError(
                    f"mq broker: filer {filer} unreachable during recovery: {last_err}"
                )
        elif parity_dir:
            # memory-only broker with a parity dir: the EC streams are
            # the ONLY durability — topics and their unsealed tails are
            # recovered from parity_dir alone
            self._recover_parity_only()

    # ------------------------------------------------------------ filer io

    def _url(self, path: str) -> str:
        # quoted as `requests` requotes the JAX broker's URLs
        path, q, query = path.partition("?")
        return service_url(self.filer, urllib.parse.quote(path, safe="/!$&'()*+,;=:@[]~%") + q + query)

    def _seg_path(self, ns: str, name: str, part: int, seg: int) -> str:
        return f"{TOPICS_ROOT}/{ns}/{name}/{part:04d}/seg-{seg:08d}.log"

    def topics_root(self) -> str:
        return TOPICS_ROOT

    def _delete_file(self, path: str) -> None:
        r = self._http.delete(self._url(path), timeout=60)
        if r.status_code not in (200, 204, 404):
            r.raise_for_status()

    def _put_file(self, path: str, data: bytes) -> None:
        r = self._http.post(
            self._url(path),
            data=data,
            headers={"Content-Type": "application/octet-stream"},
            timeout=60,
        )
        r.raise_for_status()

    def _get_file(self, path: str):
        """File bytes, or None ONLY for not-found; a transient filer
        error must raise — treating it as absence would recover a too-low
        next_offset and overwrite records."""
        r = self._http.get(self._url(path), timeout=60)
        if r.status_code == 404:
            return None
        r.raise_for_status()
        if r.headers.get("X-Filer-Listing") == "true":
            return None  # a directory, not a file
        return r.content

    def _list_dir(self, path: str) -> list[dict]:
        """Full listing, following pagination (the filer caps pages)."""
        from ..client.filer_client import list_dir

        return list(list_dir(self.filer, path))

    # ------------------------------------------------------------ recovery

    def _recover(self) -> None:
        for ns_e in self._list_dir(TOPICS_ROOT):
            if not ns_e["IsDirectory"]:
                continue
            ns = ns_e["FullPath"].rsplit("/", 1)[-1]
            if ns.startswith("."):
                continue
            for t_e in self._list_dir(f"{TOPICS_ROOT}/{ns}"):
                if not t_e["IsDirectory"]:
                    continue
                name = t_e["FullPath"].rsplit("/", 1)[-1]
                conf = self._get_file(f"{TOPICS_ROOT}/{ns}/{name}/topic.conf")
                if conf is None:
                    continue
                cfg = json.loads(conf)
                st = _TopicState(
                    int(cfg["partitionCount"]),
                    durable_parity=bool(cfg.get("durableParity"))
                    and bool(self.parity_dir),
                )
                self._topics[(ns, name)] = st
                for p in range(st.partition_count):
                    st.logs[p] = self._make_log(ns, name, p, recover=True)
                    if st.durable_parity:
                        self._attach_parity(ns, name, st, p, recover=True)
                off = self._get_file(f"{TOPICS_ROOT}/{ns}/{name}/offsets.json")
                if off:
                    for k, v in json.loads(off).items():
                        part_s, group = k.split("|", 1)
                        key = (ns, name, int(part_s), group)
                        if isinstance(v, list):  # [offset, metadata]
                            self._offsets[key] = v[0]
                            self._offset_meta[key] = v[1]
                        else:
                            self._offsets[key] = v

    def _make_log(self, ns: str, name: str, part: int, recover: bool = False) -> PartitionLog:
        spill = None
        load = None
        if self.filer:
            def spill(seg: int, raw: bytes, _ns=ns, _name=name, _p=part):
                path = self._seg_path(_ns, _name, _p, seg)
                self._put_file(path, raw)
                # a re-sealed partial segment supersedes any archived
                # stats sidecar: stale bounds would let pushdown prune
                # LIVE rows
                self._delete_file(path[: -len(".log")] + ".stats.json")

            def load(seg: int, _ns=ns, _name=name, _p=part):
                path = self._seg_path(_ns, _name, _p, seg)
                raw = self._get_file(path)
                if raw is not None:
                    return raw
                # sealed segment may have been ARCHIVED to parquet
                # (mq/logstore.py); re-materialize the record stream
                data = self._get_file(path[: -len(".log")] + ".parquet")
                if data is None:
                    return None
                from .logstore import parquet_to_segment

                return parquet_to_segment(data)

        next_offset = earliest = 0
        if recover and self.filer:
            # dedupe per segment NUMBER, preferring .log: a stale
            # .parquet coexisting with a fuller re-sealed .log must
            # never shadow it (lexicographic sort alone would pick
            # ".parquet" as last and recover a too-low next_offset)
            by_stem: dict[str, str] = {}
            for e in self._list_dir(f"{TOPICS_ROOT}/{ns}/{name}/{part:04d}"):
                p_full = e["FullPath"]
                for ext in (".log", ".parquet"):
                    if p_full.endswith(ext):
                        stem = p_full[: -len(ext)]
                        if ext == ".log" or stem not in by_stem:
                            by_stem[stem] = p_full
            segs = [by_stem[s] for s in sorted(by_stem)]

            def _read_seg(path: str) -> bytes | None:
                data = self._get_file(path)
                if data is None or not path.endswith(".parquet"):
                    return data
                from .logstore import parquet_to_segment

                return parquet_to_segment(data)

            if segs:
                first = _read_seg(segs[0])
                last = _read_seg(segs[-1])
                if first is not None:
                    for off, *_ in decode_records(first):
                        earliest = off
                        break
                if last is not None:
                    for off, *_ in decode_records(last):
                        next_offset = off + 1
        return PartitionLog(
            segment_records=self.segment_records,
            spill=spill,
            load=load,
            next_offset=next_offset,
            earliest_offset=earliest,
        )

    # ----------------------------------------------------- durable parity

    def _attach_parity(
        self, ns: str, name: str, st: _TopicState, p: int,
        recover: bool = False,
    ) -> None:
        """Give partition `p` its streaming-EC parity: recover+replay
        the unsealed tail first (records the durable segments never
        saw), then hook the log's append observer so every new record
        enters the live stream."""
        from .stream_parity import PartitionParity

        parity = PartitionParity(self.parity_dir, ns, name, p)
        plog = st.logs[p]
        if recover:
            replayed = 0
            for off, ts, key, value in parity.recover():
                if off < plog.next_offset:
                    continue  # already durable in a sealed segment
                if off > plog.next_offset:
                    # hole vs the durable cut. On a virgin log this is
                    # just the retention window starting past 0 (the
                    # bounded tail dropped earlier records by design):
                    # fast-forward and replay from there. Otherwise
                    # stop — dense numbering must never skip.
                    if not plog.fast_forward(off):
                        break
                plog.append_at(off, ts, key, value)
                replayed += 1
            if replayed:
                mlog.info(
                    "mq parity: replayed %d unsealed records for "
                    "%s/%s[%d]", replayed, ns, name, p,
                )
        st.parity[p] = parity
        plog.on_append = parity.append_record
        self._ensure_parity_flusher()

    def _parity_topic_conf(self, ns: str, name: str) -> str:
        return os.path.join(self.parity_dir, ns, name, "topic.json")

    def _recover_parity_only(self) -> None:
        """Memory-only broker + parity_dir: rebuild topics (and their
        recoverable tails) from the parity directory alone."""
        import glob as _glob

        for conf in sorted(
            _glob.glob(os.path.join(self.parity_dir, "*", "*", "topic.json"))
        ):
            name = os.path.basename(os.path.dirname(conf))
            ns = os.path.basename(os.path.dirname(os.path.dirname(conf)))
            try:
                with open(conf) as f:
                    cfg = json.load(f)
            except (OSError, ValueError) as e:
                # loud: an unreadable topic.json strands intact stream
                # generations — never skip one silently
                mlog.warning(
                    "mq parity: unreadable %s (%s); topic %s/%s NOT "
                    "recovered, stream generations left on disk",
                    conf, e, ns, name,
                )
                continue
            st = _TopicState(
                int(cfg.get("partitionCount", 1)), durable_parity=True
            )
            self._topics[(ns, name)] = st
            for p in range(st.partition_count):
                st.logs[p] = self._make_log(ns, name, p)
                self._attach_parity(ns, name, st, p, recover=True)

    def _ensure_parity_flusher(self) -> None:
        if self._parity_flusher is None:
            from .stream_parity import ParityFlusher

            self._parity_flusher = ParityFlusher(self)
            self._parity_flusher.start()

    def parity_sweep(self) -> None:
        """One flusher pass: bound every partition's parity lag, then
        prune stream generations below the durability floor (sealed
        into filer segments, or — memory-only — fallen out of the
        bounded tail)."""
        with self._lock:
            items = [
                (st, dict(st.parity)) for st in self._topics.values()
            ]
        for st, parts in items:
            for p, parity in parts.items():
                if parity.needs_flush():
                    parity.flush()
                plog = st.logs.get(p)
                if plog is None:
                    continue
                with plog._lock:
                    floor = (
                        plog._tail_base if self.filer
                        else plog.earliest_offset
                    )
                parity.prune(floor)

    def parity_status(self) -> dict:
        """Per-topic durable-parity roll-up (shell/status surfaces)."""
        out = {}
        with self._lock:
            items = list(self._topics.items())
        for (ns, name), st in items:
            if not st.parity:
                continue
            out[f"{ns}/{name}"] = {
                p: {
                    "pending_bytes": parity.pending_bytes(),
                    "parity_lag_ms": round(
                        parity.parity_lag_s() * 1000.0, 3
                    ),
                }
                for p, parity in sorted(st.parity.items())
            }
        return out

    def load_score(self) -> float:
        """Parity-backlog component of the gravity load signal: pending
        parity bytes across every partition, in units of the flush
        threshold (1.0 ≈ one full flush window behind)."""
        pending = 0
        with self._lock:
            items = [dict(st.parity) for st in self._topics.values()]
        if not any(items):
            return 0.0
        from .stream_parity import flush_bytes_default

        for parts in items:
            for parity in parts.values():
                try:
                    pending += parity.pending_bytes()
                except Exception:  # noqa: BLE001 — telemetry only
                    pass
        return pending / float(max(1, flush_bytes_default()))

    def group_committer(self):
        """The broker group committer covering durable-parity produce
        acks, or None when SEAWEED_MQ_GROUP_COMMIT_MS is 0. The knob is
        read live per call and the committer swapped when it changes
        (mirrors the volume's group committer)."""
        from .group_commit import MqGroupCommitter, group_commit_window_s

        w = group_commit_window_s()
        c = self._mq_committer
        if c is not None and c.window_s == w:
            return c
        with self._lock:
            c = self._mq_committer
            if w <= 0:
                if c is not None:
                    self._mq_committer = None
                    c.stop()
                return None
            if c is None or c.window_s != w:
                if c is not None:
                    c.stop()
                c = MqGroupCommitter(w)
                self._mq_committer = c
            return c

    def close(self) -> None:
        """Stop the parity flusher and close every stream (flushes
        first: a clean shutdown leaves nothing to replay)."""
        if self._mq_committer is not None:
            self._mq_committer.stop()
            self._mq_committer = None
        if self._parity_flusher is not None:
            self._parity_flusher.stop()
            self._parity_flusher = None
        self.flush()
        with self._lock:
            for st in self._topics.values():
                for parity in st.parity.values():
                    parity.close()

    # ------------------------------------------------------------- topics

    def configure_topic(
        self,
        ns: str,
        name: str,
        partitions: int,
        durable_parity: bool | None = None,
    ) -> None:
        """`durable_parity` (None = the broker default: on when it has
        a parity_dir) gives every partition a streaming-EC parity
        stream — parity trails the append head by a bounded lag instead
        of waiting for segment seal."""
        with self._lock:
            if (ns, name) in self._topics:
                return
            want_parity = bool(self.parity_dir) and (
                self.durable_parity_default
                if durable_parity is None
                else durable_parity
            )
            st = _TopicState(max(partitions, 1), durable_parity=want_parity)
            for p in range(st.partition_count):
                st.logs[p] = self._make_log(ns, name, p)
                if want_parity:
                    self._attach_parity(ns, name, st, p)
            self._topics[(ns, name)] = st
            if want_parity:
                # atomic + fsynced: on a memory-only broker this file
                # is the only way a restart learns the topic exists —
                # a torn write would orphan every intact stream gen
                from ..utils.fs import atomic_write

                conf = self._parity_topic_conf(ns, name)
                os.makedirs(os.path.dirname(conf), exist_ok=True)
                atomic_write(
                    conf,
                    json.dumps(
                        {"partitionCount": st.partition_count}
                    ).encode(),
                )
            if self.filer:
                self._put_file(
                    f"{TOPICS_ROOT}/{ns}/{name}/topic.conf",
                    json.dumps(
                        {
                            "partitionCount": st.partition_count,
                            "durableParity": want_parity,
                        }
                    ).encode(),
                )

    def delete_topic(self, ns: str, name: str) -> None:
        """Drop a topic: in-memory state AND its filer subtree
        (topic.conf, offsets.json, segments) — otherwise a restart
        resurrects the topic, and a re-created topic's offsets would
        collide with stale segments."""
        with self._lock:
            st = self._topics.pop((ns, name), None)
            if st is not None:
                for parity in st.parity.values():
                    parity.delete()
                if st.parity and self.parity_dir:
                    # the per-partition deletes leave the topic dir +
                    # topic.json; a restart must not resurrect the topic
                    import shutil as _shutil

                    _shutil.rmtree(
                        os.path.join(self.parity_dir, ns, name),
                        ignore_errors=True,
                    )
            self._offsets = {
                k: v
                for k, v in self._offsets.items()
                if (k[0], k[1]) != (ns, name)
            }
            self._offset_meta = {
                k: v
                for k, v in self._offset_meta.items()
                if (k[0], k[1]) != (ns, name)
            }
        if self.filer:
            r = self._http.delete(
                self._url(f"{TOPICS_ROOT}/{ns}/{name}?recursive=true"),
                timeout=60,
            )
            if r.status_code not in (204, 404):
                r.raise_for_status()

    def topic(self, ns: str, name: str) -> _TopicState:
        st = self._topics.get((ns, name))
        if st is None:
            raise KeyError(f"topic {ns}/{name} not configured")
        return st

    def scan_records(
        self,
        ns: str,
        name: str,
        part: int,
        off_lo: int = 0,
        ts_lo_ns: int | None = None,
        ts_hi_ns: int | None = None,
        counters: dict | None = None,
    ):
        """Yield (offset, ts_ns, key, value) for one partition with
        PREDICATE PUSHDOWN over archived segments: a `.stats.json`
        sidecar (written at parquet-archive time) whose offset/ts
        ranges exclude the query's bounds skips the segment WITHOUT
        fetching its bytes. `counters` (if given) tallies
        segments_scanned / segments_skipped / rows_scanned — the
        auditable proof pruning happened."""
        st = self.topic(ns, name)
        plog = st.logs.get(part)
        if plog is None:
            return
        if counters is None:
            counters = {}
        counters.setdefault("segments_scanned", 0)
        counters.setdefault("segments_skipped", 0)
        counters.setdefault("rows_scanned", 0)
        off = max(plog.earliest_offset, off_lo)
        with plog._lock:
            tail_base = plog._tail_base
        sr = self.segment_records
        if self.filer:
            seg = off // sr
            # segments wholly below the offset bound are pruned without
            # even a stats fetch; count them so the audit adds up
            counters["segments_skipped"] += max(
                seg - plog.earliest_offset // sr, 0
            )
            while seg * sr < tail_base:
                lo_in_seg = max(off, seg * sr)
                # stats can only prune when a ts bound is set or the
                # scan starts mid-segment; an unbounded full scan must
                # not pay a sidecar round-trip per segment
                can_prune = (
                    ts_lo_ns is not None
                    or ts_hi_ns is not None
                    or lo_in_seg > seg * sr
                )
                stats = (
                    self._seg_stats(ns, name, part, seg) if can_prune else None
                )
                if stats is not None and (
                    (
                        ts_lo_ns is not None
                        and stats.get("ts_ns_max") is not None
                        and stats["ts_ns_max"] < ts_lo_ns
                    )
                    or (
                        ts_hi_ns is not None
                        and stats.get("ts_ns_min") is not None
                        and stats["ts_ns_min"] > ts_hi_ns
                    )
                    or (
                        stats.get("offset_max") is not None
                        and stats["offset_max"] < lo_in_seg
                    )
                ):
                    counters["segments_skipped"] += 1
                    seg += 1
                    continue
                raw = None
                path = self._seg_path(ns, name, part, seg)
                raw = self._get_file(path)
                if raw is None:
                    data = self._get_file(path[: -len(".log")] + ".parquet")
                    if data is not None:
                        from .logstore import parquet_to_segment

                        raw = parquet_to_segment(data)
                if raw is not None:
                    counters["segments_scanned"] += 1
                    for rec in decode_records(raw):
                        # upper bound at the tail_base snapshot: a seal
                        # racing this scan can merge tail records into
                        # the segment, and the tail read below would
                        # yield them AGAIN
                        if lo_in_seg <= rec[0] < tail_base:
                            counters["rows_scanned"] += 1
                            yield rec
                seg += 1
            off = max(off, tail_base)
        while True:
            recs = plog.read_from(off, max_records=2048)
            if not recs:
                return
            for rec in recs:
                counters["rows_scanned"] += 1
                yield rec
            off = recs[-1][0] + 1

    def _seg_stats(self, ns: str, name: str, part: int, seg: int) -> dict | None:
        path = self._seg_path(ns, name, part, seg)[: -len(".log")] + ".stats.json"
        try:
            raw = self._get_file(path)
        except FILER_ERRORS:
            return None
        if raw is None:
            return None
        try:
            return json.loads(raw)
        except ValueError:
            return None

    def compact_topic(self, ns: str, name: str) -> int:
        """Archive this topic's sealed raw segments to parquet NOW
        (mq.topic.compact; the periodic archiver does the same on a
        timer). Returns segments archived."""
        from .logstore import SegmentArchiver

        st = self.topic(ns, name)  # KeyError surfaces to the caller
        if not self.filer:
            return 0
        for log_ in st.logs.values():
            log_.flush()  # seal the tails so they are archivable
        # min_age_segments=0: an OPERATOR-initiated compact must cover
        # every sealed segment (the background archiver's 1-segment
        # grace exists only to keep tail reads on the raw format)
        arch = SegmentArchiver(self, min_age_segments=0)
        return sum(
            arch._archive_partition(ns, name, p)
            for p in range(st.partition_count)
        )

    def truncate_topic(
        self, ns: str, name: str, partition: int = -1, before_offset: int = -1
    ) -> int:
        """Drop records below before_offset (-1 = all current records)
        for one or every partition (mq.topic.truncate). In-memory
        truncation is record-granular; durable segment files are
        deleted only when ENTIRELY below the boundary, so a restart may
        re-expose the partial segment's older records (documented
        segment-granular durability)."""
        st = self.topic(ns, name)
        parts = (
            range(st.partition_count) if partition < 0 else [partition]
        )
        done = 0
        for p in parts:
            log_ = st.logs.get(p)
            if log_ is None:
                continue
            boundary = log_.truncate_before(before_offset)
            if self.filer:
                full_below = boundary // self.segment_records
                for seg in range(full_below):
                    self._delete_file(self._seg_path(ns, name, p, seg))
                    pq = self._seg_path(ns, name, p, seg)[: -len(".log")]
                    self._delete_file(pq + ".parquet")
                    self._delete_file(pq + ".stats.json")
            done += 1
        return done

    def pick_partition(self, st: _TopicState, key: bytes, requested: int) -> int:
        if requested >= 0:
            return requested % st.partition_count
        if not key:
            return int(time.time_ns()) % st.partition_count
        return int.from_bytes(
            hashlib.md5(key).digest()[:4], "big"
        ) % st.partition_count

    # ------------------------------------------------------------- offsets

    def list_topics(self) -> list[tuple[str, str, int]]:
        with self._lock:
            return sorted(
                (ns, name, st.partition_count)
                for (ns, name), st in self._topics.items()
            )

    # ------------------------------------------------------------ schemas

    def set_schema(self, ns: str, name: str, schema_json: str) -> None:
        """Register (or with "" delete) a topic's schema: a JSON doc
        {"fields": [{"name": ..., "type": int|float|string|bool}, ...],
        "enforce": bool} (reference weed/mq/schema, simplified from
        protobuf descriptors to a JSON field list)."""
        self.topic(ns, name)  # must exist
        if schema_json:
            doc = json.loads(schema_json)
            if not isinstance(doc.get("fields"), list):
                raise ValueError("schema needs a 'fields' list")
            for f in doc["fields"]:
                if "name" not in f:
                    raise ValueError(f"schema field without name: {f}")
        with self._lock:
            if schema_json:
                self._schemas[(ns, name)] = schema_json
            else:
                self._schemas.pop((ns, name), None)
        if self.filer:
            path = f"{TOPICS_ROOT}/{ns}/{name}/schema.json"
            if schema_json:
                self._put_file(path, schema_json.encode())
            else:
                self._delete_file(path)

    def get_schema(self, ns: str, name: str) -> str:
        """'' = no schema. Negative lookups are CACHED — Publish calls
        this on the hot path, and a schema-less topic must not pay a
        filer round-trip (or fail on a filer hiccup) per message."""
        with self._lock:
            s = self._schemas.get((ns, name))
        if s is not None:
            return s
        s = ""
        if self.filer:
            try:
                raw = self._get_file(f"{TOPICS_ROOT}/{ns}/{name}/schema.json")
            except FILER_ERRORS:
                return ""  # transient filer error: fail open, don't cache
            if raw:
                s = raw.decode()
        with self._lock:
            self._schemas[(ns, name)] = s
        return s

    def validate_against_schema(self, ns: str, name: str, value: bytes) -> str:
        """'' when acceptable; an error string when the topic enforces
        a schema and the payload violates it."""
        s = self.get_schema(ns, name)
        if not s:
            return ""
        try:
            doc = json.loads(s)
        except json.JSONDecodeError:
            return ""
        if not doc.get("enforce"):
            return ""
        try:
            payload = json.loads(value)
        except (ValueError, UnicodeDecodeError):
            return "payload is not JSON but the topic enforces a schema"
        if not isinstance(payload, dict):
            return "payload must be a JSON object"
        types = {
            "int": int,
            "float": (int, float),
            "string": str,
            "bool": bool,
            "bytes": str,
        }
        for f in doc.get("fields", []):
            fname = f.get("name")
            if fname not in payload:
                if f.get("required"):
                    return f"missing required field {fname!r}"
                continue
            ftype = f.get("type", "string")
            want = types.get(ftype)
            have = payload[fname]
            # bool is a subclass of int in Python: a JSON true must not
            # satisfy an int/float field
            if ftype in ("int", "float") and isinstance(have, bool):
                return f"field {fname!r} is not a {ftype}"
            if want and not isinstance(have, want):
                return f"field {fname!r} is not a {ftype}"
        return ""

    def commit_offset(self, ns, name, part, group, offset, metadata: str = "") -> None:
        # snapshot under the lock, persist outside it: one slow filer
        # write must not stall every other MQ RPC
        with self._lock:
            self._offsets[(ns, name, part, group)] = offset
            if metadata:
                self._offset_meta[(ns, name, part, group)] = metadata
            else:
                self._offset_meta.pop((ns, name, part, group), None)
            grouped = {
                f"{p}|{g}": (
                    [o, m]
                    if (m := self._offset_meta.get((n2, t2, p, g), ""))
                    else o
                )
                for (n2, t2, p, g), o in self._offsets.items()
                if (n2, t2) == (ns, name)
            }
        if self.filer:
            self._put_file(
                f"{TOPICS_ROOT}/{ns}/{name}/offsets.json",
                json.dumps(grouped).encode(),
            )

    def fetch_offset(self, ns, name, part, group) -> int:
        with self._lock:
            return self._offsets.get((ns, name, part, group), -1)

    def fetch_offset_meta(self, ns, name, part, group) -> tuple[int, str]:
        """(offset, committed metadata) — Kafka's OffsetFetch returns
        the metadata string the committer attached."""
        with self._lock:
            return (
                self._offsets.get((ns, name, part, group), -1),
                self._offset_meta.get((ns, name, part, group), ""),
            )

    def flush(self) -> None:
        with self._lock:
            for st in self._topics.values():
                for log in st.logs.values():
                    log.flush()
                for parity in st.parity.values():
                    parity.flush()


class MqService:
    """gRPC servicer (method table in pb/rpc.py MQ_SERVICE)."""

    def __init__(self, broker: MqBroker, balancer=None, load_fn=None):
        self.broker = broker
        self.balancer = balancer
        self.load_fn = load_fn  # gravity telemetry source (server-level)

    # ------------------------------------------------------ multi-broker

    def BrokerStatus(self, request, context):
        bal = self.balancer
        fn = self.load_fn or self.broker.load_score
        try:
            load = float(fn())
        except Exception:  # noqa: BLE001 — telemetry must not fail pings
            load = 0.0
        return mq.BrokerStatusResponse(
            address=bal.self_addr if bal else "",
            peers=bal.peers if bal else [],
            uptime_seconds=int(time.time() - bal.started_at) if bal else 0,
            load_score=load,
        )

    def LookupTopicBrokers(self, request, context):
        t = request.topic
        ns = t.namespace or "default"
        try:
            st = self.broker.topic(ns, t.name)
        except KeyError as e:
            return mq.LookupTopicBrokersResponse(error=str(e))
        bal = self.balancer
        if bal is None:
            return mq.LookupTopicBrokersResponse(
                assignments=[
                    mq.BrokerPartitionAssignment(partition=p, leader="")
                    for p in range(st.partition_count)
                ]
            )
        return mq.LookupTopicBrokersResponse(
            assignments=[
                mq.BrokerPartitionAssignment(
                    partition=p, leader=leader, follower=follower
                )
                for p, leader, follower in bal.assignments(
                    ns, t.name, st.partition_count
                )
            ]
        )

    def FollowAppend(self, request, context):
        """Leader → follower synchronous replication (reference
        broker_grpc_pub_follow.go)."""
        t = request.topic
        ns = t.namespace or "default"
        try:
            st = self.broker.topic(ns, t.name)
        except KeyError:
            # follower that missed the configure broadcast lazily
            # materializes the topic at the leader's partition count
            self.broker.configure_topic(
                ns, t.name, request.partition_count or 1
            )
            st = self.broker.topic(ns, t.name)
        part = request.partition
        plog = st.logs.get(part)
        if plog is None:
            return mq.FollowAppendResponse(error=f"partition {part} absent")
        expected = plog.append_at(
            request.offset,
            request.message.ts_ns or time.time_ns(),
            request.message.key,
            request.message.value,
        )
        if expected <= request.offset:
            # gap: this replica is missing [expected, offset); tell the
            # leader so it backfills before re-sending
            return mq.FollowAppendResponse(error=f"gap:{expected}")
        return mq.FollowAppendResponse()

    def DeleteTopic(self, request, context):
        try:
            self.broker.delete_topic(request.ns or "default", request.name)
        except KeyError as e:
            return mq.DeleteTopicResponse(error=str(e))
        return mq.DeleteTopicResponse()

    def CompactTopic(self, request, context):
        try:
            n = self.broker.compact_topic(
                request.ns or "default", request.name
            )
        except KeyError as e:
            return mq.CompactTopicResponse(error=str(e))
        return mq.CompactTopicResponse(archived_segments=n)

    def TruncateTopic(self, request, context):
        try:
            n = self.broker.truncate_topic(
                request.ns or "default",
                request.name,
                partition=request.partition,
                before_offset=request.before_offset,
            )
        except KeyError as e:
            return mq.TruncateTopicResponse(error=str(e))
        return mq.TruncateTopicResponse(truncated_partitions=n)

    def ConfigureTopic(self, request, context):
        t = request.topic
        # durable_parity rides the wire as a tri-state int32 (proto3
        # scalar presence is unknowable): 0 = broker default, 1 = on,
        # 2 = off — the gRPC twin of the Python API's None/True/False.
        dp = {1: True, 2: False}.get(int(request.durable_parity))
        self.broker.configure_topic(
            t.namespace or "default", t.name, request.partition_count,
            durable_parity=dp,
        )
        # broadcast: every broker needs the topic state (any of them
        # may lead or follow any partition)
        bal = self.balancer
        if bal is not None and not balancer_mod.is_forwarded(context):
            for peer in bal.peers:
                if peer == bal.self_addr:
                    continue
                try:
                    bal.stub(peer).ConfigureTopic(
                        request,
                        metadata=balancer_mod.FWD_METADATA,
                        timeout=5,
                    )
                except grpc.RpcError:
                    pass  # down peers re-learn via FollowAppend/recovery
        return mq.ConfigureTopicResponse()

    def ListTopics(self, request, context):
        return mq.ListTopicsResponse(
            topics=[
                mq.TopicInfo(
                    topic=mq.Topic(namespace=ns, name=name),
                    partition_count=count,
                )
                for ns, name, count in self.broker.list_topics()
            ]
        )

    def Publish(self, request, context):
        t = request.topic
        ns = t.namespace or "default"
        try:
            st = self.broker.topic(ns, t.name)
        except KeyError as e:
            return mq.PublishResponse(error=str(e))
        err = self.broker.validate_against_schema(
            ns, t.name, bytes(request.message.value)
        )
        if err:
            return mq.PublishResponse(error=f"schema violation: {err}")
        part = self.broker.pick_partition(
            st, request.message.key, request.partition
        )
        bal = self.balancer
        # the Kafka gateway owns its namespace on its own broker (Kafka
        # clients see a single-broker cluster); only native topics ride
        # the balancer
        balanced = (
            bal is not None and not bal.single and ns != "kafka"
        )
        leader = follower = ""
        if balanced:
            leader, follower = bal.assignment(ns, t.name, part)
        if (
            balanced
            and leader != bal.self_addr
            and not balancer_mod.is_forwarded(context)
        ):
            # transparent forward: any broker accepts any publish
            # (reference pub_balancer routing)
            fwd = mq.PublishRequest(topic=request.topic, partition=part)
            fwd.message.CopyFrom(request.message)
            try:
                return bal.stub(leader).Publish(
                    fwd, metadata=balancer_mod.FWD_METADATA, timeout=10
                )
            except grpc.RpcError as e:
                return mq.PublishResponse(
                    error=f"forward to {leader}: {e.code()}"
                )
        ts = request.message.ts_ns or time.time_ns()
        off = st.logs[part].append(ts, request.message.key, request.message.value)
        if balanced and follower and follower != bal.self_addr:
            self._replicate(request.topic, ns, st, part, off, ts,
                            request.message, follower)
        return mq.PublishResponse(offset=off, partition=part)

    def _replicate(
        self, topic, ns: str, st, part: int, off: int, ts: int,
        message, follower: str,
    ) -> None:
        """Sync-replicate one record; on a reported gap, backfill the
        follower from this leader's log first (a rejoining follower
        must never hold silent holes — they become lost acked records
        at promotion)."""
        def send(o: int, ts_ns: int, key: bytes, value: bytes) -> str:
            fa = mq.FollowAppendRequest(
                topic=topic,
                partition=part,
                offset=o,
                partition_count=st.partition_count,
                message=mq.DataMessage(key=key, value=value, ts_ns=ts_ns),
            )
            return bal_stub.FollowAppend(fa, timeout=10).error

        bal_stub = self.balancer.stub(follower)
        try:
            err = send(off, ts, message.key, message.value)
            if err.startswith("gap:"):
                start = int(err[4:])
                for o, rts, k, v in st.logs[part].read_from(
                    start, max_records=off - start + 1
                ):
                    if o > off:
                        break
                    err = send(o, rts, k, v)
                    if err and not err.startswith("gap:"):
                        break
            if err and not err.startswith("gap:"):
                # a non-gap refusal (partition absent, ...) is a replica
                # hole no protocol will repair — it must be visible
                mlog.warning(
                    "follow append %s/%s[%d]@%d -> %s refused: %s",
                    ns, topic.name, part, off, follower, err,
                )
        except (grpc.RpcError, ValueError) as e:
            # availability over strictness: acked on the leader; the
            # gap protocol repairs the replica on the next publish
            mlog.warning(
                "follow append %s/%s[%d]@%d -> %s failed: %s",
                ns, topic.name, part, off, follower, e,
            )

    def Subscribe(self, request, context):
        t = request.topic
        ns = t.namespace or "default"
        try:
            st = self.broker.topic(ns, t.name)
        except KeyError:
            context.abort(grpc.StatusCode.NOT_FOUND, "topic not configured")
        part = request.partition % st.partition_count
        bal = self.balancer
        resumed_at = -1
        if (
            bal is not None
            and not bal.single
            and ns != "kafka"
            and not balancer_mod.is_forwarded(context)
        ):
            leader, follower = bal.assignment(ns, t.name, part)
            if leader != bal.self_addr:
                # proxy the stream from the partition's leader; on a
                # mid-stream leader death, resume PAST what was already
                # yielded (never re-deliver), and only from a broker
                # actually holding a replica
                last = -1
                try:
                    for rec in bal.stub(leader).Subscribe(
                        request, metadata=balancer_mod.FWD_METADATA
                    ):
                        if not rec.end_of_stream:
                            last = rec.offset
                        yield rec
                        if rec.end_of_stream:
                            return
                    return
                except grpc.RpcError:
                    if bal.self_addr not in (follower,):
                        context.abort(
                            grpc.StatusCode.UNAVAILABLE,
                            f"leader {leader} unreachable and this "
                            "broker holds no replica",
                        )
                    if last >= 0:
                        resumed_at = last + 1
                    # else: nothing was delivered — fall through to the
                    # normal offset resolution (start_offset/committed),
                    # never to an unconditional 0
        log = st.logs[part]
        if resumed_at >= 0:
            offset = resumed_at
        elif request.start_offset >= 0:
            offset = request.start_offset
        elif request.consumer_group and (
            committed := self.broker.fetch_offset(
                t.namespace or "default", t.name, part, request.consumer_group
            )
        ) >= 0:
            offset = committed
        else:
            offset = log.next_offset  # tail
        while context.is_active():
            batch = log.read_from(offset)
            for off, ts, key, value in batch:
                yield mq.SubscribeRecord(
                    message=mq.DataMessage(key=key, value=value, ts_ns=ts),
                    offset=off,
                    partition=part,
                )
                offset = off + 1
            if not batch:
                if not request.follow:
                    yield mq.SubscribeRecord(end_of_stream=True, partition=part)
                    return
                log.wait_for(offset, timeout=1.0)

    def _route_to_leader(self, ns: str, name: str, part: int, context):
        """The partition leader to forward an offset op to, or None to
        serve locally (single broker / kafka ns / already forwarded /
        we ARE the leader)."""
        bal = self.balancer
        if (
            bal is None
            or bal.single
            or ns == "kafka"
            or balancer_mod.is_forwarded(context)
        ):
            return None
        leader, _f = bal.assignment(ns, name, part)
        return None if leader == bal.self_addr else leader

    def CommitOffset(self, request, context):
        t = request.topic
        ns = t.namespace or "default"
        # group offsets live with the partition leader (the broker
        # Subscribe proxies to) — otherwise commits fragment per broker
        leader = self._route_to_leader(ns, t.name, request.partition, context)
        if leader is not None:
            try:
                return self.balancer.stub(leader).CommitOffset(
                    request, metadata=balancer_mod.FWD_METADATA, timeout=10
                )
            except grpc.RpcError:
                # surface the failure: a silent local commit would be
                # invisible to every future FetchOffset (which routes
                # to the leader) — let the client retry instead
                context.abort(
                    grpc.StatusCode.UNAVAILABLE,
                    f"offset leader {leader} unreachable",
                )
        self.broker.commit_offset(
            ns, t.name, request.partition, request.consumer_group,
            request.offset,
        )
        return mq.CommitOffsetResponse()

    def FetchOffset(self, request, context):
        t = request.topic
        ns = t.namespace or "default"
        leader = self._route_to_leader(ns, t.name, request.partition, context)
        if leader is not None:
            try:
                return self.balancer.stub(leader).FetchOffset(
                    request, metadata=balancer_mod.FWD_METADATA, timeout=10
                )
            except grpc.RpcError:
                pass
        return mq.FetchOffsetResponse(
            offset=self.broker.fetch_offset(
                ns, t.name, request.partition, request.consumer_group
            )
        )

    def RegisterSchema(self, request, context):
        t = request.topic
        try:
            self.broker.set_schema(
                t.namespace or "default", t.name, request.schema_json
            )
        except (KeyError, ValueError, json.JSONDecodeError) as e:
            return mq.RegisterSchemaResponse(error=str(e))
        return mq.RegisterSchemaResponse()

    def GetSchema(self, request, context):
        t = request.topic
        return mq.GetSchemaResponse(
            schema_json=self.broker.get_schema(
                t.namespace or "default", t.name
            )
        )

    def PartitionInfo(self, request, context):
        t = request.topic
        try:
            st = self.broker.topic(t.namespace or "default", t.name)
        except KeyError:
            context.abort(grpc.StatusCode.NOT_FOUND, "topic not configured")
        return mq.PartitionInfoResponse(
            partitions=[
                mq.PartitionInfo(
                    partition=p,
                    earliest_offset=log.earliest_offset,
                    next_offset=log.next_offset,
                )
                for p, log in sorted(st.logs.items())
            ]
        )


class MqBrokerServer:
    def __init__(
        self,
        ip: str = "localhost",
        grpc_port: int = 17777,
        filer: str = "",
        segment_records: int = 4096,
        kafka_port: int = -1,
        pg_port: int = -1,
        peers: list[str] | None = None,
        archive_interval: float = 300.0,
        parity_dir: str = "",
        durable_parity_default: bool | None = None,
        status_port: int = -1,
    ):
        """kafka_port >= 0 also serves the Kafka wire protocol on that
        port (0 = ephemeral; see .kafka.port). pg_port: -1, since the
        port does not serve the SQL view (ROADMAP item 19) yet; a value
        >= 0 raises ValueError naming the item.
        peers: every broker's grpc host:port for multi-broker partition
        balancing + follower replication. parity_dir: local dir for
        streaming-EC durable-parity log streams (see MqBroker).
        status_port >= 0 serves /status (JSON roll-up incl. the Kafka
        gateway pool) and /metrics (sw_mq_*) over HTTP (0 =
        ephemeral; see .status_port after start)."""
        refuse_later_ports(pg_port)
        self.ip = ip
        self.grpc_port = grpc_port
        self.broker = MqBroker(
            filer=filer, segment_records=segment_records,
            parity_dir=parity_dir,
            durable_parity_default=durable_parity_default,
        )
        self.balancer = balancer_mod.BrokerBalancer(
            f"{ip}:{grpc_port}", list(peers or [])
        )
        self.balancer.load_fn = self.load_score
        self.service = MqService(
            self.broker, balancer=self.balancer, load_fn=self.load_score
        )
        self._grpc = grpc.server(futures.ThreadPoolExecutor(max_workers=32))
        rpc.add_service(self._grpc, rpc.MQ_SERVICE, self.service)
        self._grpc.add_insecure_port(f"{ip}:{grpc_port}")
        self.kafka = None
        if kafka_port >= 0:
            from .kafka.gateway import KafkaGateway

            self.kafka = KafkaGateway(self.broker, ip=ip, port=kafka_port)
        # parquet archival of sealed segments (reference weed/mq/logstore)
        self.archiver = None
        self._archive_stop = threading.Event()
        self._archive_thread = None
        if filer and archive_interval > 0:
            from .logstore import SegmentArchiver

            self.archiver = SegmentArchiver(self.broker)
            self._archive_thread = threading.Thread(
                target=self._archive_loop,
                args=(archive_interval,),
                daemon=True,
            )
        # operator HTTP plane: /status + /metrics (mirrors the volume
        # server's listener; advisory sections never fail the endpoint)
        self._status_httpd = None
        self.status_port = status_port
        if status_port >= 0:
            self._status_httpd = self._build_status_httpd(ip, status_port)
            self.status_port = self._status_httpd.server_address[1]

    def _archive_loop(self, interval: float) -> None:
        while not self._archive_stop.wait(interval):
            try:
                self.archiver.run_once()
            except Exception as e:  # noqa: BLE001 — never kill the broker
                mlog.warning(f"segment archival cycle failed: {e!r}")

    def load_score(self) -> float:
        """Gravity telemetry shipped on BrokerStatus pings: parity
        backlog (flush-threshold units) + Kafka gateway pool pressure
        (ready backlog per worker + connection-slot occupancy). 0 when
        idle; ~1 per saturated dimension."""
        score = self.broker.load_score()
        if self.kafka is not None:
            try:
                ps = self.kafka.pool_status()
                workers = max(1, int(ps.get("workers") or 1))
                score += float(ps.get("ready_backlog", 0)) / workers
                slots = max(1, int(ps.get("max_connections") or 1))
                score += float(ps.get("open_connections", 0)) / slots
            except Exception:  # noqa: BLE001 — telemetry only
                pass
        return score

    def status(self) -> dict:
        """Operator JSON roll-up served at /status."""
        st = {
            "address": self.balancer.self_addr,
            "peers": self.balancer.peers,
            "live_brokers": self.balancer.live(),
            "broker_loads": self.balancer.loads(),
            "load_score": self.load_score(),
            "topics": [
                {"namespace": ns, "name": name, "partitions": count}
                for ns, name, count in self.broker.list_topics()
            ],
        }
        try:
            st["parity"] = self.broker.parity_status()
        except Exception:  # noqa: BLE001 — advisory
            pass
        if self.kafka is not None:
            try:
                st["kafka_pool"] = self.kafka.pool_status()
            except Exception:  # noqa: BLE001 — advisory
                pass
        return st

    def kernels(self) -> dict:
        """The launches of the port's kernels in this process (the
        volume server's `/debug/kernels` seam), the parity batches its
        streams dispatched (each one `gf2_apply` launch on the card), and
        whether torch is loaded: read from `sys.modules`, so asking loads
        nothing."""
        pkg = __name__.rsplit(".", 2)[0]
        rk = sys.modules.get(f"{pkg}.ops.rs_kernels")
        se = sys.modules.get(f"{pkg}.ec.stream_encode")
        return {
            "launches": dict(rk.LAUNCHES) if rk is not None else {},
            "masked": dict(rk.MASKED) if rk is not None else {},
            "stream_dispatches": se.dispatch_count() if se is not None else 0,
            "torch": "torch" in sys.modules,
        }

    def _build_status_httpd(self, ip: str, port: int):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet
                pass

            def _send(self, code, body, ctype):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path.split("?", 1)[0] == "/metrics":
                    from ..utils.metrics import REGISTRY

                    self._send(
                        200, REGISTRY.render(),
                        "text/plain; version=0.0.4",
                    )
                    return
                if self.path.split("?", 1)[0] == "/status":
                    body = json.dumps(server.status()).encode()
                    self._send(200, body, "application/json")
                    return
                if self.path.split("?", 1)[0] == "/debug/kernels":
                    body = json.dumps(server.kernels()).encode()
                    self._send(200, body, "application/json")
                    return
                self._send(404, b"not found", "text/plain")

        httpd = ThreadingHTTPServer((ip, port), Handler)
        httpd.daemon_threads = True
        return httpd

    def start(self) -> None:
        self._grpc.start()
        self.balancer.start()
        if self.kafka is not None:
            self.kafka.start()
        if self._archive_thread is not None:
            self._archive_thread.start()
        if self._status_httpd is not None:
            threading.Thread(
                target=self._status_httpd.serve_forever, daemon=True
            ).start()

    def stop(self) -> None:
        self._archive_stop.set()
        if self._status_httpd is not None:
            self._status_httpd.shutdown()
            self._status_httpd.server_close()
        self.balancer.stop()
        if self.kafka is not None:
            self.kafka.stop()
        self.broker.close()  # parity flusher + streams, then flush
        self._grpc.stop(grace=0.5)
