"""The Kafka wire-protocol gateway server.

Port of seaweedfs_tpu/mq/kafka/gateway.py, whole: `KafkaGateway`, with
`_API_RANGES` and `_FLEXIBLE` as they are there and the fault point
`mq.fetch.before_send`; every response is the JAX gateway's, byte for
byte.

Reference: weed/mq/kafka/gateway/server.go + protocol/ handlers — a TCP
listener speaking the Kafka binary protocol, mapping topics onto the
MqBroker's partition logs (namespace "kafka"). Kafka clients configure
it as a single-broker cluster: this gateway is every partition's leader
and every group's coordinator.

Framing: i32 length | request header (api_key i16, api_version i16,
correlation_id i32, client_id nullable-string) | body. Responses:
i32 length | correlation_id i32 | body. Only non-flexible request
versions are advertised (see _API_RANGES), so tagged fields never
appear on the wire.

Front end: connections are served by the bounded
worker-pool frame server (``frame_pool.PooledFrameServer``) instead of
one thread per connection. Saturation is answered with well-formed
per-api error/throttle responses (``_handle_reject``), pool pressure
surfaces as ``throttle_time_ms`` in every response, fetches of sealed
segments egress zero-copy via the batch spool, and durable-parity
produces ride the broker group committer.
"""

from __future__ import annotations

import socket
import struct
import threading
import time

from ...faults import registry as faults
from ...utils.glog import logger
from . import protocol as kp
from .fetch_spool import FetchSpool
from .frame_pool import Parts, build_frame_server
from .groups import GroupCoordinator
from .protocol import Reader, Writer
from .records import Record, UnsupportedCompression, decode_batches, encode_batch

log = logger("kafka")

NAMESPACE = "kafka"

# api_key -> (min_version, max_version) actually implemented
_API_RANGES: dict[int, tuple[int, int]] = {
    kp.PRODUCE: (3, 9),
    kp.FETCH: (4, 11),
    kp.LIST_OFFSETS: (0, 5),
    kp.METADATA: (0, 8),
    kp.OFFSET_COMMIT: (0, 7),
    kp.OFFSET_FETCH: (0, 5),
    kp.FIND_COORDINATOR: (0, 2),
    kp.JOIN_GROUP: (0, 5),
    kp.HEARTBEAT: (0, 3),
    kp.LEAVE_GROUP: (0, 3),
    kp.SYNC_GROUP: (0, 3),
    kp.DESCRIBE_GROUPS: (0, 4),
    kp.LIST_GROUPS: (0, 2),
    kp.API_VERSIONS: (0, 3),
    kp.CREATE_TOPICS: (0, 4),
    kp.DELETE_TOPICS: (0, 3),
}

# First FLEXIBLE (KIP-482 compact/tagged) version per api. Requests at
# or above it use request-header v2 (tagged fields after client_id) and
# response-header v1 — except ApiVersions, whose response header stays
# v0 so a downgrading client can always parse it.
_FLEXIBLE: dict[int, int] = {
    kp.PRODUCE: 9,
    kp.API_VERSIONS: 3,
}

NODE_ID = 0


class KafkaGateway:
    def __init__(
        self,
        broker,
        ip: str = "localhost",
        port: int = 9092,
        advertised_host: str | None = None,
        auto_create_partitions: int = 1,
        workers: int | None = None,
    ):
        self.broker = broker
        self.ip = ip
        self.advertised_host = advertised_host or ip
        self.auto_create_partitions = auto_create_partitions
        self.coordinator = GroupCoordinator()
        # Per-REQUEST context: every frame carries its own header, and a
        # frame is handled start-to-finish on one worker thread, so a
        # thread-local set at frame entry stays correct under the pool.
        self._tl = threading.local()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((ip, port))
        self.port = self._sock.getsockname()[1]
        self._sock.listen(64)
        self.spool = FetchSpool()
        self.server = build_frame_server(
            self._sock,
            self._handle,
            reject_handler=self._handle_reject,
            workers=workers,
            request_timeout=30.0,
            server_kind="kafka",
        )

    # ---------------------------------------------------------- lifecycle

    def start(self) -> None:
        self.server.start()

    def stop(self) -> None:
        self.coordinator.stop()
        self.server.stop()
        self.spool.close()

    def pool_status(self) -> dict:
        st = self.server.pool_status()
        st["fetch_spool"] = self.spool.status()
        return st

    # --------------------------------------------------------- connection

    def _handle(self, state: dict, frame: bytes) -> "bytes | Parts | None":
        self._tl.reject = False
        return self._handle_frame(frame)

    def _handle_reject(self, state: dict, frame: bytes) -> "bytes | Parts | None":
        """Saturation path: the frame server is over its admission
        budget, so this (first and only) frame is answered with the
        api's normal response shape carrying a retriable error and a
        non-zero throttle_time — explicit, parseable backpressure —
        and the connection is closed. Data-plane work is skipped
        (produce appends nothing, fetch reads nothing)."""
        self._tl.reject = True
        try:
            return self._handle_frame(frame)
        finally:
            self._tl.reject = False

    def _rejecting(self) -> bool:
        return bool(getattr(self._tl, "reject", False))

    def _throttle_ms(self) -> int:
        """throttle_time_ms for the current response: the reject hint
        when saturated, else the pool's live backpressure suggestion
        (0 while there is headroom — the common case, and the value
        golden tests pin)."""
        if self._rejecting():
            return 1000
        try:
            return self.server.suggested_throttle_ms()
        except Exception:
            return 0

    def _handle_frame(self, frame: bytes) -> "bytes | Parts | None":
        r = Reader(frame)
        api_key = r.i16()
        api_version = r.i16()
        correlation_id = r.i32()
        # client_id (NON-compact even in header v2); kept per-thread —
        # JoinGroup derives generated member ids from it, matching the
        # broker convention "<client.id>-<uuid>"
        self._tl.client_id = r.nullable_string() or ""
        out = Writer().i32(correlation_id)
        lo_hi = _API_RANGES.get(api_key)
        if lo_hi is None or not lo_hi[0] <= api_version <= lo_hi[1]:
            # KIP-511: answer an out-of-range ApiVersions with a v0 body
            # carrying UNSUPPORTED_VERSION + our ranges so the client
            # can downgrade; other apis get the error-only body. The
            # body (and any header tags) of an unknown future version
            # is never parsed — its layout is unknowable.
            if api_key == kp.API_VERSIONS:
                self._api_versions_body(out, 0, kp.UNSUPPORTED_VERSION)
                return out.done()
            out.i16(kp.UNSUPPORTED_VERSION)
            return out.done()
        flexible = api_version >= _FLEXIBLE.get(api_key, 1 << 30)
        if flexible:
            r.tagged_fields()  # request header v2
            if api_key != kp.API_VERSIONS:
                out.tags()  # response header v1
        handler = {
            kp.API_VERSIONS: self._h_api_versions,
            kp.METADATA: self._h_metadata,
            kp.PRODUCE: self._h_produce,
            kp.FETCH: self._h_fetch,
            kp.LIST_OFFSETS: self._h_list_offsets,
            kp.CREATE_TOPICS: self._h_create_topics,
            kp.DELETE_TOPICS: self._h_delete_topics,
            kp.FIND_COORDINATOR: self._h_find_coordinator,
            kp.OFFSET_COMMIT: self._h_offset_commit,
            kp.OFFSET_FETCH: self._h_offset_fetch,
            kp.JOIN_GROUP: self._h_join_group,
            kp.SYNC_GROUP: self._h_sync_group,
            kp.HEARTBEAT: self._h_heartbeat,
            kp.LEAVE_GROUP: self._h_leave_group,
            kp.LIST_GROUPS: self._h_list_groups,
            kp.DESCRIBE_GROUPS: self._h_describe_groups,
        }[api_key]
        body = handler(r, api_version)
        if body is None:  # acks=0 produce: no response frame at all
            return None
        if isinstance(body, Parts):  # zero-copy fetch: header + spans
            body.parts.insert(0, out.done())
            return body
        return out.raw(body).done()

    # ------------------------------------------------------- topic helpers

    def _log_for(self, topic: str, partition: int):
        try:
            st = self.broker.topic(NAMESPACE, topic)
        except KeyError:
            return None
        return st.logs.get(partition)

    def _partitions(self, topic: str) -> int:
        try:
            return self.broker.topic(NAMESPACE, topic).partition_count
        except KeyError:
            return -1

    def _parity_for(self, topic: str, part: int):
        try:
            st = self.broker.topic(NAMESPACE, topic)
        except KeyError:
            return None
        return st.parity.get(part)

    # ----------------------------------------------------------- handlers

    def _api_versions_body(self, w: Writer, version: int, error: int) -> None:
        w.i16(error)
        if version >= 3:
            # flexible body (compact array + per-entry tags)
            w.compact_array(
                sorted(_API_RANGES.items()),
                lambda ww, kv: ww.i16(kv[0])
                .i16(kv[1][0])
                .i16(kv[1][1])
                .tags(),
            )
            w.i32(self._throttle_ms())  # throttle_time_ms
            w.tags()
            return
        w.array(
            sorted(_API_RANGES.items()),
            lambda ww, kv: ww.i16(kv[0]).i16(kv[1][0]).i16(kv[1][1]),
        )
        if version >= 1:
            w.i32(self._throttle_ms())  # throttle_time_ms

    def _h_api_versions(self, r: Reader, v: int) -> bytes:
        if v >= 3:
            r.compact_string()  # client_software_name
            r.compact_string()  # client_software_version
            r.tagged_fields()
        w = Writer()
        self._api_versions_body(w, v, kp.NONE)
        return w.done()

    def _h_metadata(self, r: Reader, v: int) -> bytes:
        n = r.i32()
        wanted: list[str] | None
        if n < 0 or (n == 0 and v == 0):
            # null = all topics (v1+); v0 has no null encoding — an
            # empty array is its only way to say "all topics"
            wanted = None
        else:
            wanted = [r.string() for _ in range(n)]
        allow_auto = True
        if v >= 4:
            allow_auto = r.i8() != 0
        if v >= 8:
            r.i8()  # include_cluster_authorized_operations
            r.i8()  # include_topic_authorized_operations
        existing = {
            name
            for ns, name, _c in self.broker.list_topics()
            if ns == NAMESPACE
        }
        if wanted is None:
            topics = sorted(existing)
        else:
            topics = wanted
            if allow_auto:
                for t in wanted:
                    if t not in existing and _valid_topic(t):
                        self.broker.configure_topic(
                            NAMESPACE, t, self.auto_create_partitions
                        )
                        existing.add(t)
        w = Writer()
        if v >= 3:
            w.i32(self._throttle_ms())  # throttle
        # brokers: just us
        def broker_entry(ww: Writer, _):
            ww.i32(NODE_ID).string(self.advertised_host).i32(self.port)
            if v >= 1:
                ww.nullable_string(None)  # rack

        w.array([None], broker_entry)
        if v >= 2:
            w.nullable_string("seaweedfs-tpu-kafka")  # cluster_id
        if v >= 1:
            w.i32(NODE_ID)  # controller_id

        def topic_entry(ww: Writer, name: str):
            count = self._partitions(name)
            if count < 0:
                ww.i16(
                    kp.INVALID_TOPIC_EXCEPTION
                    if not _valid_topic(name)
                    else kp.UNKNOWN_TOPIC_OR_PARTITION
                )
                ww.string(name)
                if v >= 1:
                    ww.i8(0)  # is_internal
                ww.i32(0)  # empty partitions
                if v >= 8:
                    ww.i32(-2147483648)  # topic_authorized_operations
                return
            ww.i16(kp.NONE).string(name)
            if v >= 1:
                ww.i8(0)

            def part_entry(w3: Writer, p: int):
                w3.i16(kp.NONE).i32(p).i32(NODE_ID)
                if v >= 7:
                    w3.i32(0)  # leader_epoch
                w3.array([NODE_ID], lambda w4, nid: w4.i32(nid))  # replicas
                w3.array([NODE_ID], lambda w4, nid: w4.i32(nid))  # isr
                if v >= 5:
                    w3.array([], lambda w4, nid: w4.i32(nid))  # offline

            ww.array(list(range(count)), part_entry)
            if v >= 8:
                ww.i32(-2147483648)  # topic_authorized_operations (unset)

        w.array(topics, topic_entry)
        if v >= 8:
            w.i32(-2147483648)  # cluster_authorized_operations (unset)
        return w.done()

    def _h_produce(self, r: Reader, v: int) -> bytes | None:
        flex = v >= 9
        if flex:
            r.compact_nullable_string()  # transactional_id
        else:
            r.nullable_string()
        acks = r.i16()
        r.i32()  # timeout_ms
        from ...utils import metrics

        rejecting = self._rejecting()
        results: list[tuple[str, list[tuple[int, int, int]]]] = []
        dirty_parities: list = []
        ntopics = r.uvarint() - 1 if flex else r.i32()
        for _ in range(max(ntopics, 0)):
            topic = r.compact_string() if flex else r.string()
            parts: list[tuple[int, int, int]] = []  # (part, error, base)
            nparts = r.uvarint() - 1 if flex else r.i32()
            for _p in range(max(nparts, 0)):
                part = r.i32()
                blob = (
                    r.compact_nullable_bytes() if flex else r.nullable_bytes()
                ) or b""
                if flex:
                    r.tagged_fields()  # partition-struct tags
                if rejecting:
                    # saturation: parse (the reader must stay in sync)
                    # but append NOTHING — the retriable error + the
                    # throttle are the whole answer
                    parts.append((part, kp.REQUEST_TIMED_OUT, -1))
                    continue
                metrics.mq_produce_bytes_total.inc(
                    len(blob), plane="python"
                )
                plog = self._log_for(topic, part)
                if plog is None:
                    parts.append((part, kp.UNKNOWN_TOPIC_OR_PARTITION, -1))
                    continue
                try:
                    records = decode_batches(blob)
                except UnsupportedCompression:
                    parts.append(
                        (part, kp.UNSUPPORTED_COMPRESSION_TYPE, -1)
                    )
                    continue
                except (ValueError, EOFError, struct.error):
                    # a lying recordCount / truncated post-CRC section
                    # must fail ONE partition, not the connection
                    parts.append((part, kp.CORRUPT_MESSAGE, -1))
                    continue
                # enforced topic schemas apply to the Kafka path too —
                # otherwise any Kafka client could bypass what
                # MqService.Publish rejects (tombstones exempt: a null
                # value deletes, it doesn't carry a document)
                bad = next(
                    (
                        err
                        for rec in records
                        if rec.value is not None
                        and (
                            err := self.broker.validate_against_schema(
                                NAMESPACE, topic, rec.value
                            )
                        )
                    ),
                    "",
                )
                if bad:
                    parts.append((part, kp.INVALID_RECORD, -1))
                    continue
                base = -1
                if records:
                    # one lock hold: offsets must be contiguous so the
                    # client's baseOffset+index arithmetic holds under
                    # concurrent producers
                    base = plog.append_batch(
                        [
                            (
                                rec.timestamp_ms * 1_000_000
                                if rec.timestamp_ms
                                else time.time_ns(),
                                _pack_null(rec.key),
                                _pack_null(rec.value),
                            )
                            for rec in records
                        ]
                    )
                    parity = self._parity_for(topic, part)
                    if parity is not None:
                        dirty_parities.append(parity)
                parts.append((part, kp.NONE, base))
            if flex:
                r.tagged_fields()  # topic-struct tags
            results.append((topic, parts))
        if flex:
            r.tagged_fields()  # request tags
        if acks == 0:
            return None
        if dirty_parities:
            # durable-parity topics: the ack certifies replayability.
            # One group-commit window covers this produce's cohort; a
            # failed window fails every producer in it (none of the
            # cohort's records are certified durable).
            committer = self.broker.group_committer()
            if committer is not None:
                for parity in dirty_parities:
                    committer.mark_dirty(parity)
                try:
                    committer.wait_durable()
                except OSError:
                    results = [
                        (
                            topic,
                            [
                                (
                                    part,
                                    kp.KAFKA_STORAGE_ERROR
                                    if err == kp.NONE and base >= 0
                                    else err,
                                    -1 if err == kp.NONE and base >= 0 else base,
                                )
                                for part, err, base in parts
                            ],
                        )
                        for topic, parts in results
                    ]
        w = Writer()

        def topic_entry(ww: Writer, tp):
            name, parts = tp
            if flex:
                ww.compact_string(name)
            else:
                ww.string(name)

            def part_entry(w3: Writer, pr):
                part, err, base = pr
                w3.i32(part).i16(err).i64(base)
                if v >= 2:
                    w3.i64(-1)  # log_append_time
                if v >= 5:
                    w3.i64(0)  # log_start_offset
                if v >= 8:
                    # record_errors + error_message
                    if flex:
                        w3.compact_array([], lambda *_: None)
                        w3.compact_nullable_string(None)
                        w3.tags()
                    else:
                        w3.array([], lambda *_: None)
                        w3.nullable_string(None)

            if flex:
                ww.compact_array(parts, part_entry).tags()
            else:
                ww.array(parts, part_entry)

        if flex:
            w.compact_array(results, topic_entry)
            w.i32(self._throttle_ms())  # throttle
            w.tags()
        else:
            w.array(results, topic_entry)
            w.i32(self._throttle_ms())  # throttle (v1+)
        return w.done()

    def _h_fetch(self, r: Reader, v: int) -> bytes:
        r.i32()  # replica_id
        max_wait_ms = r.i32()
        r.i32()  # min_bytes
        r.i32()  # max_bytes (v3+)
        r.i8()  # isolation_level (v4+)
        if v >= 7:
            # incremental fetch sessions (KIP-227): not maintained —
            # responding session_id=0 tells the client "no session",
            # so it keeps sending full fetches (legal, just uncached)
            r.i32()  # session_id
            r.i32()  # session_epoch
        requests: list[tuple[str, list[tuple[int, int, int]]]] = []
        for _ in range(r.i32()):
            topic = r.string()
            parts = []
            for _p in range(r.i32()):
                part = r.i32()
                if v >= 9:
                    r.i32()  # current_leader_epoch
                fetch_offset = r.i64()
                if v >= 5:
                    r.i64()  # log_start_offset
                pmax = r.i32()
                parts.append((part, fetch_offset, pmax))
            requests.append((topic, parts))
        if v >= 7:
            for _ in range(max(r.i32(), 0)):  # forgotten_topics_data
                r.string()
                r.array(r.i32)
        if v >= 11:
            r.nullable_string()  # rack_id
        rejecting = self._rejecting()
        # long-poll: when every requested partition is empty, block on
        # the log's condition (single-partition fetch, the common
        # consumer shape) or poll coarsely. Partitions are re-resolved
        # each round: a fetch may race the topic's auto-creation, and
        # returning early would make the client spin. Under pool
        # pressure (frames queueing behind busy workers) the wait is
        # skipped entirely: parking a worker on an empty partition is
        # exactly the wrong move when workers are the scarce resource —
        # the empty response carries the throttle hint instead.
        wait_s = max(max_wait_ms, 0) / 1000.0
        if rejecting or self._throttle_ms() > 0:
            wait_s = 0.0
        deadline = time.monotonic() + wait_s
        wanted = [
            (topic, part, off)
            for topic, parts in requests
            for part, off, _m in parts
        ]
        while not rejecting:
            live = [
                (plog, off)
                for topic, part, off in wanted
                if (plog := self._log_for(topic, part)) is not None
            ]
            if any(plog.next_offset > off for plog, off in live):
                break
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            if len(live) == len(wanted) == 1:
                live[0][0].wait_for(live[0][1], timeout=remaining)
            else:
                time.sleep(min(0.05, remaining))
        # Response assembly: manual field walk (no Writer.array
        # callbacks) so a sealed-segment spool hit can CUT the byte
        # stream and splice in a FileExtent — the zero-copy span the
        # frame server ships via sn_send_file, bit-identically on the
        # Python fallback.
        resp = Parts(api="fetch")
        w = Writer()

        def cut(extent) -> None:
            nonlocal w
            resp.append(w.done())
            resp.append(extent)
            w = Writer()

        w.i32(self._throttle_ms())  # throttle
        if v >= 7:
            w.i16(kp.NONE)  # top-level error
            w.i32(0)  # session_id (0 = no fetch session)
        w.i32(len(requests))
        for name, parts in requests:
            w.string(name)
            w.i32(len(parts))
            for part, off, pmax in parts:
                if rejecting:
                    w.i32(part).i16(kp.REQUEST_TIMED_OUT)
                    w.i64(-1).i64(-1)
                    if v >= 5:
                        w.i64(-1)
                    w.i32(0)  # aborted_transactions (empty)
                    if v >= 11:
                        w.i32(-1)  # preferred_read_replica
                    w.i32(-1)  # null records
                    continue
                plog = self._log_for(name, part)
                if plog is None:
                    w.i32(part).i16(kp.UNKNOWN_TOPIC_OR_PARTITION)
                    w.i64(-1).i64(-1)
                    if v >= 5:
                        w.i64(-1)
                    w.i32(0)
                    if v >= 11:
                        w.i32(-1)
                    w.i32(-1)
                    continue
                hw = plog.next_offset
                if off > hw or (off < plog.earliest_offset):
                    w.i32(part).i16(kp.OFFSET_OUT_OF_RANGE)
                    w.i64(hw).i64(hw)
                    if v >= 5:
                        w.i64(plog.earliest_offset)
                    w.i32(0)
                    if v >= 11:
                        w.i32(-1)
                    w.i32(-1)
                    continue
                spooled = self.spool.extent_for(name, part, plog, off)
                if spooled is not None:
                    # whole sealed segment as ONE on-disk batch; it may
                    # start before `off` (protocol-legal — the client
                    # skips below its requested offset) and it ships
                    # regardless of pmax (the oversized-first-batch
                    # rule: it is the first batch)
                    extent, _base, _next_off = spooled
                    w.i32(part).i16(kp.NONE)
                    w.i64(hw).i64(hw)  # high_watermark, last_stable
                    if v >= 5:
                        w.i64(plog.earliest_offset)
                    w.i32(0)  # aborted_transactions
                    if v >= 11:
                        w.i32(-1)  # preferred_read_replica
                    w.i32(extent.length)  # records blob length
                    cut(extent)
                    continue
                recs = plog.read_from(off, max_records=1024)
                batch = b""
                if recs:
                    if pmax > 0:
                        # honor partition max_bytes, but always ship at
                        # least one record so the consumer makes
                        # progress (Kafka's oversized-first-batch rule)
                        kept, size = [], 64  # batch header overhead
                        for rec in recs:
                            size += 16 + len(rec[2]) + len(rec[3])
                            if kept and size > pmax:
                                break
                            kept.append(rec)
                        recs = kept
                    batch = encode_batch(
                        [
                            Record(
                                key=_unpack_null(k),
                                value=_unpack_null(val),
                                timestamp_ms=ts // 1_000_000,
                                offset=o,
                            )
                            for o, ts, k, val in recs
                        ],
                        base_offset=recs[0][0],
                    )
                w.i32(part).i16(kp.NONE)
                w.i64(hw).i64(hw)  # high_watermark, last_stable
                if v >= 5:
                    w.i64(plog.earliest_offset)
                w.i32(0)  # aborted_transactions
                if v >= 11:
                    w.i32(-1)  # preferred_read_replica
                if batch:
                    w.i32(len(batch)).raw(batch)
                else:
                    w.i32(-1)  # null records
        resp.append(w.done())
        faults.fire("mq.fetch.before_send", bytes=resp.total())
        return resp

    def _h_list_offsets(self, r: Reader, v: int) -> bytes:
        r.i32()  # replica_id
        if v >= 2:
            r.i8()  # isolation
        req = []
        for _ in range(r.i32()):
            topic = r.string()
            parts = []
            for _p in range(r.i32()):
                part = r.i32()
                if v >= 4:
                    r.i32()  # current_leader_epoch
                ts = r.i64()
                if v == 0:
                    r.i32()  # max_num_offsets
                parts.append((part, ts))
            req.append((topic, parts))
        w = Writer()
        if v >= 2:
            w.i32(self._throttle_ms())  # throttle

        def topic_entry(ww: Writer, tp):
            name, parts = tp
            ww.string(name)

            def part_entry(w3: Writer, pt):
                part, ts = pt
                plog = self._log_for(name, part)
                found_ts = -1  # special queries report -1 (spec: only
                #                timestamp lookups name a record's ts)
                if plog is None:
                    err, off = kp.UNKNOWN_TOPIC_OR_PARTITION, -1
                elif ts == -1:  # latest
                    err, off = kp.NONE, plog.next_offset
                elif ts == -2:  # earliest
                    err, off = kp.NONE, plog.earliest_offset
                else:
                    err = kp.NONE
                    off, found_ts = _offset_for_time(plog, ts)
                w3.i32(part).i16(err)
                if v == 0:
                    w3.array(
                        [off] if off >= 0 else [],
                        lambda w4, o: w4.i64(o),
                    )
                else:
                    w3.i64(found_ts).i64(off)
                    if v >= 4:
                        w3.i32(-1)  # leader_epoch

            ww.array(parts, part_entry)

        w.array(req, topic_entry)
        return w.done()

    def _h_create_topics(self, r: Reader, v: int) -> bytes:
        topics = []
        for _ in range(r.i32()):
            name = r.string()
            num_partitions = r.i32()
            r.i16()  # replication_factor
            for _a in range(max(r.i32(), 0)):  # manual assignments
                r.i32()
                r.array(r.i32)
            for _c in range(max(r.i32(), 0)):  # configs
                r.string()
                r.nullable_string()
            topics.append((name, num_partitions))
        r.i32()  # timeout
        validate_only = v >= 1 and r.i8() != 0
        existing = {
            name
            for ns, name, _c in self.broker.list_topics()
            if ns == NAMESPACE
        }
        w = Writer()
        if v >= 2:
            w.i32(self._throttle_ms())  # throttle

        def entry(ww: Writer, tp):
            name, count = tp
            if not _valid_topic(name):
                err = kp.INVALID_TOPIC_EXCEPTION
            elif name in existing:
                err = kp.TOPIC_ALREADY_EXISTS
            else:
                err = kp.NONE
                if not validate_only:
                    self.broker.configure_topic(
                        NAMESPACE, name, max(count, 1)
                    )
            ww.string(name).i16(err)
            if v >= 1:
                ww.nullable_string(None)  # error_message

        w.array(topics, entry)
        return w.done()

    def _h_delete_topics(self, r: Reader, v: int) -> bytes:
        names = r.array(r.string)
        r.i32()  # timeout
        existing = {
            name
            for ns, name, _c in self.broker.list_topics()
            if ns == NAMESPACE
        }
        w = Writer()
        if v >= 1:
            w.i32(self._throttle_ms())

        def entry(ww: Writer, name: str):
            if name in existing:
                self.broker.delete_topic(NAMESPACE, name)
                ww.string(name).i16(kp.NONE)
            else:
                ww.string(name).i16(kp.UNKNOWN_TOPIC_OR_PARTITION)

        w.array(names, entry)
        return w.done()

    def _h_find_coordinator(self, r: Reader, v: int) -> bytes:
        r.string()  # key (group id)
        if v >= 1:
            r.i8()  # key_type
        w = Writer()
        if v >= 1:
            w.i32(self._throttle_ms())  # throttle
        w.i16(kp.NONE)
        if v >= 1:
            w.nullable_string(None)  # error_message
        w.i32(NODE_ID).string(self.advertised_host).i32(self.port)
        return w.done()

    # ------------------------------------------------- group offset apis

    def _h_offset_commit(self, r: Reader, v: int) -> bytes:
        group = r.string()
        if v >= 1:
            r.i32()  # generation
            r.string()  # member
        if 2 <= v <= 4:
            r.i64()  # retention_time (removed in v5)
        if v >= 7:
            r.nullable_string()  # group_instance_id
        results = []
        for _ in range(r.i32()):
            topic = r.string()
            parts = []
            for _p in range(r.i32()):
                part = r.i32()
                offset = r.i64()
                if v >= 6:
                    r.i32()  # committed_leader_epoch
                if v == 1:
                    r.i64()  # commit timestamp
                metadata = r.nullable_string() or ""
                known = 0 <= part < max(self._partitions(topic), 0)
                if known:
                    self.broker.commit_offset(
                        NAMESPACE, topic, part, group, offset,
                        metadata=metadata,
                    )
                    parts.append((part, kp.NONE))
                else:
                    parts.append((part, kp.UNKNOWN_TOPIC_OR_PARTITION))
            results.append((topic, parts))
        w = Writer()
        if v >= 3:
            w.i32(self._throttle_ms())
        w.array(
            results,
            lambda ww, tp: ww.string(tp[0]).array(
                tp[1], lambda w3, pe: w3.i32(pe[0]).i16(pe[1])
            ),
        )
        return w.done()

    def _h_offset_fetch(self, r: Reader, v: int) -> bytes:
        group = r.string()
        req = []
        n = r.i32()
        if n >= 0:
            for _ in range(n):
                topic = r.string()
                parts = r.array(r.i32)
                req.append((topic, parts))
        else:  # null = all topics with commits; serve configured topics
            for ns, name, count in self.broker.list_topics():
                if ns == NAMESPACE:
                    req.append((name, list(range(count))))
        w = Writer()
        if v >= 3:
            w.i32(self._throttle_ms())

        def topic_entry(ww: Writer, tp):
            name, parts = tp
            ww.string(name)

            def part_entry(w3: Writer, part: int):
                off, meta = self.broker.fetch_offset_meta(
                    NAMESPACE, name, part, group
                )
                w3.i32(part).i64(off)
                if v >= 5:
                    w3.i32(-1)  # committed_leader_epoch
                # committed metadata round-trips (null when none)
                w3.nullable_string(meta or None).i16(kp.NONE)

            ww.array(parts, part_entry)

        w.array(req, topic_entry)
        if v >= 2:
            w.i16(kp.NONE)  # top-level error
        return w.done()

    # --------------------------------------------------- group membership

    def _h_join_group(self, r: Reader, v: int) -> bytes:
        group_id = r.string()
        session_timeout = r.i32() / 1000.0
        rebalance_timeout = session_timeout
        if v >= 1:
            rebalance_timeout = r.i32() / 1000.0
        member_id = r.string()
        if v >= 5:
            r.nullable_string()  # group_instance_id
        protocol_type = r.string()
        protocols = [
            (p_name, p_meta)
            for p_name, p_meta in (
                (r.string(), r.bytes_()) for _ in range(r.i32())
            )
        ]
        g = self.coordinator.group(group_id)
        resp = g.join(
            member_id,
            client_id=getattr(self._tl, "client_id", ""),
            protocol_type=protocol_type,
            protocols=protocols,
            session_timeout=max(session_timeout, 1.0),
            rebalance_timeout=max(rebalance_timeout, 1.0),
        )
        w = Writer()
        if v >= 2:
            w.i32(self._throttle_ms())  # throttle
        if resp["error"] != kp.NONE:
            w.i16(resp["error"]).i32(-1).string("").string("").string("")
            w.array([], lambda *_: None)
            return w.done()
        w.i16(kp.NONE).i32(resp["generation"]).string(resp["protocol"])
        w.string(resp["leader"]).string(resp["member_id"])

        def member_entry(ww: Writer, m):
            ww.string(m[0])
            if v >= 5:
                ww.nullable_string(None)  # group_instance_id
            ww.bytes_(m[1])

        w.array(resp["members"], member_entry)
        return w.done()

    def _h_sync_group(self, r: Reader, v: int) -> bytes:
        group_id = r.string()
        generation = r.i32()
        member_id = r.string()
        if v >= 3:
            r.nullable_string()  # group_instance_id
        assignments = [
            (mid, blob)
            for mid, blob in (
                (r.string(), r.bytes_()) for _ in range(r.i32())
            )
        ]
        g = self.coordinator.lookup(group_id)
        if g is None:
            err, blob = kp.UNKNOWN_MEMBER_ID, b""
        else:
            err, blob = g.sync(member_id, generation, assignments)
        w = Writer()
        if v >= 1:
            w.i32(self._throttle_ms())
        w.i16(err).bytes_(blob)
        return w.done()

    def _h_heartbeat(self, r: Reader, v: int) -> bytes:
        group_id = r.string()
        generation = r.i32()
        member_id = r.string()
        if v >= 3:
            r.nullable_string()  # group_instance_id
        g = self.coordinator.lookup(group_id)
        err = (
            kp.UNKNOWN_MEMBER_ID
            if g is None
            else g.heartbeat(member_id, generation)
        )
        w = Writer()
        if v >= 1:
            w.i32(self._throttle_ms())
        w.i16(err)
        return w.done()

    def _h_leave_group(self, r: Reader, v: int) -> bytes:
        group_id = r.string()
        if v >= 3:
            # batch leave (KIP-345): members array replaces member_id
            members = [
                (r.string(), r.nullable_string()) for _ in range(r.i32())
            ]
        else:
            members = [(r.string(), None)]
        g = self.coordinator.lookup(group_id)
        results = [
            (
                mid,
                gid,
                kp.UNKNOWN_MEMBER_ID if g is None else g.leave(mid),
            )
            for mid, gid in members
        ]
        top_err = next(
            (err for _, _, err in results if err != kp.NONE), kp.NONE
        )
        w = Writer()
        if v >= 1:
            w.i32(self._throttle_ms())
        w.i16(top_err if v < 3 else kp.NONE)
        if v >= 3:
            w.array(
                results,
                lambda ww, m: ww.string(m[0])
                .nullable_string(m[1])
                .i16(m[2]),
            )
        return w.done()

    def _h_list_groups(self, r: Reader, v: int) -> bytes:
        w = Writer()
        if v >= 1:
            w.i32(self._throttle_ms())
        w.i16(kp.NONE)
        w.array(
            self.coordinator.list_groups(),
            lambda ww, g: ww.string(g[0]).string(g[1]),
        )
        return w.done()

    def _h_describe_groups(self, r: Reader, v: int) -> bytes:
        names = r.array(r.string)
        if v >= 3:
            r.i8()  # include_authorized_operations
        w = Writer()
        if v >= 1:
            w.i32(self._throttle_ms())

        def entry(ww: Writer, name: str):
            g = self.coordinator.lookup(name)
            if g is None:
                ww.i16(kp.NONE).string(name).string("Dead")
                ww.string("").string("")
                ww.array([], lambda *_: None)
                if v >= 3:
                    ww.i32(-2147483648)  # authorized_operations (unset)
                return
            with g.lock:
                ww.i16(kp.NONE).string(name).string(g.state)
                ww.string(g.protocol_type).string(g.protocol_name)

                def member_entry(w3: Writer, m):
                    w3.string(m.member_id)
                    if v >= 4:
                        w3.nullable_string(None)  # group_instance_id
                    w3.string(m.client_id)
                    w3.string("/127.0.0.1")
                    w3.bytes_(g._metadata_for(m)).bytes_(m.assignment)

                ww.array(list(g.members.values()), member_entry)
            if v >= 3:
                ww.i32(-2147483648)

        w.array(names, entry)
        return w.done()


def _pack_null(b: bytes | None) -> bytes:
    """Kafka keys/values are nullable (a null value IS a compaction
    tombstone) but the partition log stores plain bytes — a one-byte
    flag preserves null vs empty. Only topics in the kafka namespace
    use this framing."""
    return b"\x00" if b is None else b"\x01" + b


def _unpack_null(b: bytes) -> bytes | None:
    if not b or b[0] == 0:
        return None
    return b[1:]


def _valid_topic(name: str) -> bool:
    return (
        0 < len(name) <= 249
        and name not in (".", "..")
        and all(c.isalnum() or c in "._-" for c in name)
    )


def _offset_for_time(plog, ts_ms: int, scan_limit: int = 10_000) -> tuple[int, int]:
    """(first offset whose timestamp >= ts_ms, that record's
    timestamp ms) via bounded scan; (-1, -1) when nothing qualifies —
    the pair the ListOffsets v1+ response reports."""
    ts_ns = ts_ms * 1_000_000
    off = plog.earliest_offset
    scanned = 0
    while scanned < scan_limit:
        recs = plog.read_from(off, max_records=1024)
        if not recs:
            return -1, -1
        for o, rts, _k, _v in recs:
            if rts >= ts_ns:
                return o, rts // 1_000_000
        scanned += len(recs)
        off = recs[-1][0] + 1
    return -1, -1
