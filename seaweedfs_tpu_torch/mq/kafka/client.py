"""A minimal Kafka wire-protocol client.

Port of seaweedfs_tpu/mq/kafka/client.py, whole: `KafkaClient` over one
plain socket that it holds open for every call, `assign_range` and
`parse_assignment`.

The counterpart of the gateway, usable standalone against any
single-broker Kafka endpoint: metadata/create/delete topics,
produce/fetch with record batches v2, list offsets, committed offsets,
and classic group membership (join/sync/heartbeat). The test suite
drives the gateway with it the way the reference's test/kafka drives
theirs with real client libraries.
"""

from __future__ import annotations

import socket
import struct
import threading
import time

from . import protocol as kp
from .protocol import Reader, Writer
from .records import Record, decode_batches, encode_batch


class KafkaError(Exception):
    def __init__(self, code: int, where: str = ""):
        self.code = code
        super().__init__(f"kafka error {code} {where}".strip())


class KafkaClient:
    def __init__(self, host: str, port: int, client_id: str = "sw-client"):
        self.client_id = client_id
        self._sock = socket.create_connection((host, port), timeout=30)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._corr = 0
        self._lock = threading.Lock()
        self.api_versions = self._fetch_api_versions()

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    # ------------------------------------------------------------ framing

    def _call(
        self,
        api_key: int,
        api_version: int,
        body: bytes,
        oneway: bool = False,
        flexible: bool = False,
        resp_header_tags: bool | None = None,
    ) -> Reader | None:
        """flexible: request header v2 (tagged fields after client_id).
        resp_header_tags: response header v1; defaults to `flexible`
        except for ApiVersions whose response header is always v0."""
        with self._lock:
            self._corr += 1
            corr = self._corr
            head = (
                Writer()
                .i16(api_key)
                .i16(api_version)
                .i32(corr)
                .nullable_string(self.client_id)
            )
            if flexible:
                head.tags()
            frame = head.done() + body
            self._sock.sendall(struct.pack(">i", len(frame)) + frame)
            if oneway:
                return None
            (size,) = struct.unpack(">i", self._read_exact(4))
            resp = self._read_exact(size)
        r = Reader(resp)
        got = r.i32()
        if got != corr:
            raise KafkaError(-1, f"correlation mismatch {got} != {corr}")
        if resp_header_tags is None:
            resp_header_tags = flexible and api_key != kp.API_VERSIONS
        if resp_header_tags:
            r.tagged_fields()
        return r

    def _read_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self._sock.recv(n - len(buf))
            if not chunk:
                raise EOFError("connection closed")
            buf += chunk
        return buf

    def _fetch_api_versions(self, version: int = 3) -> dict[int, tuple[int, int]]:
        if version >= 3:
            body = (
                Writer()
                .compact_string("seaweedfs-tpu")
                .compact_string("r4")
                .tags()
                .done()
            )
            r = self._call(kp.API_VERSIONS, 3, body, flexible=True)
            err = r.i16()
            if err == kp.UNSUPPORTED_VERSION:
                return self._fetch_api_versions(version=0)
            if err:
                raise KafkaError(err, "ApiVersions")
            out = {}
            for _ in range(max(r.uvarint() - 1, 0)):
                key = r.i16()
                lo = r.i16()
                hi = r.i16()
                r.tagged_fields()
                out[key] = (lo, hi)
            r.i32()  # throttle
            r.tagged_fields()
            return out
        r = self._call(kp.API_VERSIONS, 0, b"")
        err = r.i16()
        if err:
            raise KafkaError(err, "ApiVersions")
        out = {}
        for _ in range(r.i32()):
            key = r.i16()
            lo = r.i16()
            hi = r.i16()
            out[key] = (lo, hi)
        return out

    # ------------------------------------------------------------- topics

    def metadata(self, topics: list[str] | None = None) -> dict:
        w = Writer()
        if topics is None:
            w.i32(-1)
        else:
            w.array(topics, lambda ww, t: ww.string(t))
        w.i8(1)  # allow_auto_topic_creation (v4+)
        r = self._call(kp.METADATA, 4, w.done())
        r.i32()  # throttle
        brokers = [
            (r.i32(), r.string(), r.i32(), r.nullable_string())
            for _ in range(r.i32())
        ]
        cluster_id = r.nullable_string()
        controller = r.i32()
        out_topics = {}
        for _ in range(r.i32()):
            err = r.i16()
            name = r.string()
            r.i8()  # is_internal
            parts = {}
            for _p in range(r.i32()):
                perr = r.i16()
                idx = r.i32()
                leader = r.i32()
                r.array(r.i32)  # replicas
                r.array(r.i32)  # isr
                parts[idx] = {"error": perr, "leader": leader}
            out_topics[name] = {"error": err, "partitions": parts}
        return {
            "brokers": brokers,
            "cluster_id": cluster_id,
            "controller": controller,
            "topics": out_topics,
        }

    def create_topic(self, name: str, partitions: int = 1) -> int:
        w = Writer()
        w.array(
            [name],
            lambda ww, t: ww.string(t)
            .i32(partitions)
            .i16(1)
            .i32(0)
            .i32(0),
        )
        w.i32(10_000)
        r = self._call(kp.CREATE_TOPICS, 0, w.done())
        r.i32()  # array count (1)
        r.string()
        return r.i16()

    def delete_topic(self, name: str) -> int:
        w = Writer().array([name], lambda ww, t: ww.string(t)).i32(10_000)
        r = self._call(kp.DELETE_TOPICS, 0, w.done())
        r.i32()
        r.string()
        return r.i16()

    # ------------------------------------------------------------ produce

    def produce(
        self,
        topic: str,
        partition: int,
        records: list[Record],
        acks: int = -1,
        version: int = 9,
        compression: int = 0,
    ) -> int:
        """Returns the base offset assigned to the first record.
        version 9 uses the flexible (KIP-482) encoding; compression is
        the batch codec id (0 none, 1 gzip, 2 snappy, 3 lz4, 4 zstd)."""
        base = encode_batch(records, base_offset=0, compression=compression)
        flex = version >= 9
        w = Writer()
        if flex:
            w.compact_nullable_string(None)  # transactional_id
            w.i16(acks).i32(10_000)
            w.compact_array(
                [(topic, partition, base)],
                lambda ww, tp: ww.compact_string(tp[0])
                .compact_array(
                    [tp],
                    lambda w3, tp2: w3.i32(tp2[1])
                    .compact_nullable_bytes(tp2[2])
                    .tags(),
                )
                .tags(),
            )
            w.tags()
        else:
            w.nullable_string(None)  # transactional_id
            w.i16(acks).i32(10_000)
            w.array(
                [(topic, partition, base)],
                lambda ww, tp: ww.string(tp[0]).array(
                    [tp],
                    lambda w3, tp2: w3.i32(tp2[1]).bytes_(tp2[2]),
                ),
            )
        r = self._call(
            kp.PRODUCE, version, w.done(), oneway=(acks == 0), flexible=flex
        )
        if r is None:
            return -1
        if flex:
            r.uvarint()  # topics count (compact)
            r.compact_string()
            r.uvarint()  # partitions count
            r.i32()  # index
            err = r.i16()
            base_offset = r.i64()
            if err:
                raise KafkaError(err, "Produce")
            return base_offset
        r.i32()  # topics count
        r.string()
        r.i32()  # partitions count
        r.i32()  # index
        err = r.i16()
        base_offset = r.i64()
        if err:
            raise KafkaError(err, "Produce")
        return base_offset

    # -------------------------------------------------------------- fetch

    def fetch(
        self,
        topic: str,
        partition: int,
        offset: int,
        max_wait_ms: int = 100,
        max_bytes: int = 4 * 1024 * 1024,
        version: int = 11,
    ) -> tuple[int, list[Record]]:
        """Returns (high_watermark, records)."""
        w = Writer()
        w.i32(-1).i32(max_wait_ms).i32(1).i32(max_bytes).i8(0)
        if version >= 7:
            w.i32(0)  # session_id
            w.i32(-1)  # session_epoch (-1 = full fetch, no session)

        def part_fields(w3: Writer, tp2):
            w3.i32(tp2[1])
            if version >= 9:
                w3.i32(-1)  # current_leader_epoch
            w3.i64(tp2[2])
            if version >= 5:
                w3.i64(0)  # log_start_offset
            w3.i32(max_bytes)

        w.array(
            [(topic, partition, offset)],
            lambda ww, tp: ww.string(tp[0]).array([tp], part_fields),
        )
        if version >= 7:
            w.array([], lambda *_: None)  # forgotten_topics_data
        if version >= 11:
            w.nullable_string(None)  # rack_id
        r = self._call(kp.FETCH, version, w.done())
        r.i32()  # throttle
        if version >= 7:
            top_err = r.i16()
            r.i32()  # session_id
            if top_err:
                raise KafkaError(top_err, "Fetch")
        r.i32()  # topics count
        r.string()
        r.i32()  # partitions count
        r.i32()  # index
        err = r.i16()
        hw = r.i64()
        r.i64()  # last_stable
        if version >= 5:
            r.i64()  # log_start_offset
        r.array(lambda: (r.i64(), r.i64()))  # aborted txns (pid, first_offset)
        if version >= 11:
            r.i32()  # preferred_read_replica
        blob = r.nullable_bytes()
        if err:
            raise KafkaError(err, "Fetch")
        # a broker may legally return a whole batch that STARTS BEFORE
        # the fetch offset (disk-backed serving — our sealed-segment
        # spool does exactly this); skipping records below the
        # requested offset is the client's job
        return hw, [
            rec
            for rec in decode_batches(blob or b"")
            if rec.offset >= offset
        ]

    def list_offset(self, topic: str, partition: int, ts: int = -1) -> int:
        """ts -1 = latest, -2 = earliest, >=0 = first offset at/after."""
        w = Writer().i32(-1)
        w.array(
            [(topic, partition, ts)],
            lambda ww, tp: ww.string(tp[0]).array(
                [tp], lambda w3, tp2: w3.i32(tp2[1]).i64(tp2[2])
            ),
        )
        r = self._call(kp.LIST_OFFSETS, 1, w.done())
        r.i32()  # topics
        r.string()
        r.i32()  # parts
        r.i32()  # index
        err = r.i16()
        r.i64()  # timestamp
        off = r.i64()
        if err:
            raise KafkaError(err, "ListOffsets")
        return off

    # ------------------------------------------------------------ offsets

    def commit_offset(
        self, group: str, topic: str, partition: int, offset: int
    ) -> int:
        w = Writer().string(group)
        w.array(
            [(topic, partition, offset)],
            lambda ww, tp: ww.string(tp[0]).array(
                [tp],
                lambda w3, tp2: w3.i32(tp2[1])
                .i64(tp2[2])
                .nullable_string(None),
            ),
        )
        r = self._call(kp.OFFSET_COMMIT, 0, w.done())
        r.i32()
        r.string()
        r.i32()
        r.i32()
        return r.i16()

    def fetch_offset(self, group: str, topic: str, partition: int) -> int:
        w = Writer().string(group)
        w.array(
            [(topic, partition)],
            lambda ww, tp: ww.string(tp[0]).array(
                [tp], lambda w3, tp2: w3.i32(tp2[1])
            ),
        )
        r = self._call(kp.OFFSET_FETCH, 1, w.done())
        r.i32()
        r.string()
        r.i32()
        r.i32()
        off = r.i64()
        r.nullable_string()
        err = r.i16()
        if err:
            raise KafkaError(err, "OffsetFetch")
        return off

    def find_coordinator(self, group: str) -> tuple[str, int]:
        r = self._call(kp.FIND_COORDINATOR, 0, Writer().string(group).done())
        err = r.i16()
        if err:
            raise KafkaError(err, "FindCoordinator")
        r.i32()  # node id
        return r.string(), r.i32()

    # -------------------------------------------------------------- groups

    def join_group(
        self,
        group: str,
        member_id: str = "",
        topics: list[str] | None = None,
        session_timeout_ms: int = 10_000,
    ) -> dict:
        meta = (
            Writer()
            .i16(0)
            .array(topics or [], lambda ww, t: ww.string(t))
            .bytes_(b"")
            .done()
        )
        w = Writer().string(group).i32(session_timeout_ms)
        w.string(member_id).string("consumer")
        w.array([("range", meta)], lambda ww, p: ww.string(p[0]).bytes_(p[1]))
        r = self._call(kp.JOIN_GROUP, 0, w.done())
        err = r.i16()
        gen = r.i32()
        protocol = r.string()
        leader = r.string()
        me = r.string()
        members = [(r.string(), r.bytes_()) for _ in range(r.i32())]
        if err:
            raise KafkaError(err, "JoinGroup")
        return {
            "generation": gen,
            "protocol": protocol,
            "leader": leader,
            "member_id": me,
            "members": members,
        }

    def sync_group(
        self,
        group: str,
        generation: int,
        member_id: str,
        assignments: list[tuple[str, bytes]] | None = None,
    ) -> bytes:
        w = Writer().string(group).i32(generation).string(member_id)
        w.array(
            assignments or [],
            lambda ww, a: ww.string(a[0]).bytes_(a[1]),
        )
        r = self._call(kp.SYNC_GROUP, 0, w.done())
        err = r.i16()
        blob = r.bytes_()
        if err:
            raise KafkaError(err, "SyncGroup")
        return blob

    def heartbeat(self, group: str, generation: int, member_id: str) -> int:
        w = Writer().string(group).i32(generation).string(member_id)
        r = self._call(kp.HEARTBEAT, 0, w.done())
        return r.i16()

    def leave_group(self, group: str, member_id: str) -> int:
        w = Writer().string(group).string(member_id)
        r = self._call(kp.LEAVE_GROUP, 0, w.done())
        return r.i16()


def assign_range(
    members: list[tuple[str, bytes]], partitions: dict[str, int]
) -> list[tuple[str, bytes]]:
    """Leader-side range assignment: partitions of each topic split
    contiguously across members (Kafka's RangeAssignor), encoded as
    ConsumerProtocolAssignment v0 blobs."""
    member_ids = sorted(m for m, _ in members)
    per_member: dict[str, dict[str, list[int]]] = {m: {} for m in member_ids}
    for topic, count in sorted(partitions.items()):
        n = len(member_ids)
        per = count // n
        extra = count % n
        start = 0
        for i, m in enumerate(member_ids):
            take = per + (1 if i < extra else 0)
            if take:
                per_member[m].setdefault(topic, []).extend(
                    range(start, start + take)
                )
            start += take
    out = []
    for m in member_ids:
        w = Writer().i16(0)  # version
        w.array(
            sorted(per_member[m].items()),
            lambda ww, tp: ww.string(tp[0]).array(
                tp[1], lambda w3, p: w3.i32(p)
            ),
        )
        w.bytes_(b"")  # user_data
        out.append((m, w.done()))
    return out


def parse_assignment(blob: bytes) -> dict[str, list[int]]:
    r = Reader(blob)
    r.i16()  # version
    out: dict[str, list[int]] = {}
    for _ in range(r.i32()):
        topic = r.string()
        out[topic] = r.array(r.i32)
    return out
