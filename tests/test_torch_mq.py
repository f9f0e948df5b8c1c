"""PyTorch port: the MQ broker (seaweedfs_tpu_torch/mq: `log_buffer`,
`logstore`, `broker`, `client`, `agent`; the launcher's `mq.broker` and
`mq.agent`; the filer's `MqNotifier`; the shell's 8 `mq.*`) held against
the JAX package on the CPU.

Every scenario of the JAX tests/test_mq.py and the parquet, archival and
schema tests of tests/test_mq_logstore.py runs on both packages, each on
its own stack (tests/torch_mq_twins.py), and what each call answered must
be equal, tolerance 0. Records carry their own timestamps where bytes are
compared: the segments, `topic.conf`, `offsets.json` and `schema.json`
the two brokers write into their filers are byte for byte the same.
Also: `pick_partition`, the record codec, the shared `mq.proto`, the
shell's commands string for string, `MqNotifier`'s events, the
launcher's two modes started by name (and `-pgPort` refused, naming
its item), and the archive loop, which the port keeps
alive after a failed cycle where the JAX loop's thread ends.
"""

import json
import os
import queue
import shlex
import signal
import subprocess
import sys
import threading
import time

import grpc
# pyarrow loaded on the main thread, for the JAX broker: it imports
# pyarrow at its first conversion, on a gRPC worker, and in a process
# that holds torch a pyarrow first loaded on a thread that exits leaves
# the next conversion to segfault (the port's broker loads it where it is
# built; test_pyarrow_loaded_where_the_broker_is_built)
import pyarrow.parquet  # noqa: F401
import numpy as np
import pytest
from conftest import allocate_port, wait_for
from test_torch_volume_server import _ports
from test_torch_launcher import REPO, launch
from torch_mq_twins import PKGS, Stack, filer_file, topic_files

SEED = 30


def rng_records(n: int, seed: int = SEED) -> list:
    """n seeded (ts_ns, key, value) records."""
    rng = np.random.default_rng(seed)
    return [(1_700_000_000_000_000_000 + i, rng.bytes(int(rng.integers(0, 12))),
             rng.bytes(int(rng.integers(1, 300)))) for i in range(n)]


def both(fn, *args, **kw) -> dict:
    """fn(pkg, ...) on each package: name -> what it returned."""
    return {name: fn(pkg, *args, **kw) for name, pkg in PKGS.items()}


def same(fn, *args, **kw):
    out = both(fn, *args, **kw)
    assert out["port"] == out["jax"]
    return out["port"]


class Broker:
    """One package's `MqBrokerServer` and an `MqClient` to it."""

    def __init__(self, pkg, **kw):
        self.pkg = pkg
        self.srv = pkg.broker.MqBrokerServer(ip="127.0.0.1", grpc_port=allocate_port(), **kw)
        self.srv.start()
        self.addr = f"127.0.0.1:{self.srv.grpc_port}"
        self.c = pkg.mq.MqClient(self.addr)
        self.ch = grpc.insecure_channel(self.addr)
        self.stub = pkg.rpc.mq_stub(self.ch)

    def publish_at(self, topic: str, part: int, ts: int, key: bytes, value: bytes):
        r = self.stub.Publish(self.pkg.pb.PublishRequest(
            topic=self.pkg.pb.Topic(namespace="default", name=topic), partition=part,
            message=self.pkg.pb.DataMessage(key=key, value=value, ts_ns=ts)), timeout=30)
        return r.error, r.partition, r.offset

    def stop(self):
        self.ch.close()
        self.c.close()
        self.srv.stop()


@pytest.fixture(scope="module")
def stacks(tmp_path_factory):
    root = tmp_path_factory.mktemp("mq")
    out = {}
    try:
        for name in PKGS:
            (root / name).mkdir()
            out[name] = Stack(name, root / name)
        yield out
    finally:
        for s in out.values():
            s.stop()


# ---------------------------------------------------------------- the log


def sc_log_append_read(pkg):
    log = pkg.mq.PartitionLog(segment_records=10)
    offs = [log.append(i, b"k%d" % i, b"v%d" % i) for i in range(25)]
    assert offs == list(range(25))
    return offs, log.read_from(0, max_records=100), log.read_from(20), log.read_from(25)


def test_partition_log_append_read_matches_jax():
    _, recs, tail, empty = same(sc_log_append_read)
    assert [r[0] for r in recs] == list(range(25))
    assert [r[0] for r in tail] == [20, 21, 22, 23, 24] and empty == []


def sc_log_spill(pkg):
    segments = {}
    log = pkg.mq.PartitionLog(segment_records=4, spill=segments.__setitem__, load=segments.get)
    for i in range(11):
        log.append(i * 10, b"", b"v%d" % i)
    return segments, log.read_from(2, max_records=100)


def test_partition_log_spill_and_load_matches_jax():
    segments, recs = same(sc_log_spill)
    assert sorted(segments) == [0, 1] and [r[0] for r in recs] == list(range(2, 11))
    assert recs[0][3] == b"v2"


def sc_log_wait(pkg):
    log = pkg.mq.PartitionLog()
    hit = []
    t = threading.Thread(target=lambda: hit.append(log.wait_for(0, timeout=5.0)))
    t.start()
    time.sleep(0.1)
    log.append(1, b"", b"x")
    t.join(timeout=2)
    return hit, log.wait_for(5, timeout=0.05)


def test_partition_log_wait_matches_jax():
    assert same(sc_log_wait) == ([True], False)


def sc_partial_flush(pkg):
    segments = {}
    log = pkg.mq.PartitionLog(segment_records=4, spill=segments.__setitem__, load=segments.get)
    for i in range(9):
        log.append(i, b"", b"v%d" % i)
    log.flush()
    log2 = pkg.mq.PartitionLog(segment_records=4, spill=segments.__setitem__,
                               load=segments.get, next_offset=9, earliest_offset=0)
    for i in range(9, 14):
        log2.append(i, b"", b"v%d" % i)
    log2.flush()
    return segments, log2.read_from(0, max_records=100)


def test_partial_segment_flush_then_append_matches_jax():
    segments, recs = same(sc_partial_flush)
    assert [r[3] for r in recs] == [b"v%d" % i for i in range(14)]
    assert sorted(segments) == [0, 1, 2, 3]


def sc_log_follower_and_truncate(pkg):
    """append_at (duplicate, gap, in order), append_batch, fast_forward
    and truncate_before, with a spilling log and the append observer."""
    segments, seen = {}, []
    log = pkg.mq.PartitionLog(segment_records=8, spill=segments.__setitem__, load=segments.get)
    log.on_append = lambda *r: seen.append(r)
    recs = rng_records(40)
    out = [log.append_at(0, *recs[0]), log.append_at(0, *recs[0]), log.append_at(5, *recs[5])]
    out.append(log.append_batch(recs[1:20]))
    out += [log.append_at(o, *recs[o]) for o in range(20, 30)]
    out.append(log.fast_forward(100))
    out.append(log.truncate_before(13))
    out.append(log.read_from(0, max_records=4))
    out.append(log.truncate_before(-1))
    out.append((log.next_offset, log.earliest_offset, log.read_from(0)))
    empty = pkg.mq.PartitionLog()
    out += [empty.fast_forward(0), empty.fast_forward(7), empty.append(1, b"", b"x")]
    return out, segments, seen


def test_follower_appends_batches_and_truncation_match_jax():
    out, segments, seen = same(sc_log_follower_and_truncate)
    assert out[:3] == [1, 1, 1] and out[3] == 1 and out[-3:] == [False, True, 7]
    assert len(seen) == 30 and sorted(segments) == [0, 1, 2, 3]


@pytest.mark.parametrize("case", ["plain", "keyed", "empty", "torn"])
def test_record_codec_matches_jax(case):
    recs = rng_records(50)
    raw = {
        "plain": b"".join(PKGS["jax"].log_buffer.encode_record(i, *r) for i, r in enumerate(recs)),
        "keyed": PKGS["jax"].log_buffer.encode_record(7, 123, b"key", b"value"),
        "empty": b"",
    }.get(case)
    if case == "torn":
        raw = b"".join(PKGS["jax"].log_buffer.encode_record(i, *r) for i, r in enumerate(recs))
        raw = raw[:-5]
    for i, r in enumerate(recs):
        assert (PKGS["port"].log_buffer.encode_record(i, *r)
                == PKGS["jax"].log_buffer.encode_record(i, *r))
    assert (list(PKGS["port"].mq.decode_records(raw))
            == list(PKGS["jax"].mq.decode_records(raw)))
    # the durable-parity stream frames records with the log's own codec
    from seaweedfs_tpu_torch.mq import stream_parity

    assert stream_parity.encode_record is PKGS["port"].log_buffer.encode_record


def test_pick_partition_matches_jax():
    rng = np.random.default_rng(SEED)
    keys = [rng.bytes(int(rng.integers(1, 40))) for _ in range(500)]
    for count in (1, 3, 4, 16):
        sts = {n: p.broker._TopicState(count) for n, p in PKGS.items()}
        brokers = {n: p.broker.MqBroker() for n, p in PKGS.items()}
        got = {n: [brokers[n].pick_partition(sts[n], k, -1) for k in keys]
               + [brokers[n].pick_partition(sts[n], b"", r) for r in range(-0, 40)]
               for n in PKGS}
        assert got["port"] == got["jax"]


def test_the_packages_share_one_mq_proto():
    assert PKGS["jax"].pb.PublishRequest is PKGS["port"].pb.PublishRequest
    assert PKGS["jax"].pb.DESCRIPTOR.serialized_pb == PKGS["port"].pb.DESCRIPTOR.serialized_pb
    for svc in ("MQ_SERVICE", "MQ_AGENT_SERVICE"):
        j, p = getattr(PKGS["jax"].rpc, svc), getattr(PKGS["port"].rpc, svc)
        assert j == p and PKGS["jax"].rpc.SERVICES[j] == PKGS["port"].rpc.SERVICES[p]


# ----------------------------------------------------------- the broker


def sc_pub_sub(pkg):
    b = Broker(pkg)
    try:
        c, out = b.c, []
        c.configure_topic("events", partitions=4)
        out.append(c.topics())
        parts = {c.publish("events", b"m%d" % i, key=b"user-42")[0] for i in range(5)}
        out.append(sorted(parts))
        part = parts.pop()
        out.append([r.message.value for r in c.subscribe("events", part, start_offset=0)])
        out.append(c.publish("events", b"direct", partition=2))
        with pytest.raises(RuntimeError) as e:
            c.publish("nope", b"x")
        out.append(str(e.value))
        out.append([(p.partition, p.earliest_offset, p.next_offset)
                    for p in c.partition_info("events")])
        return out
    finally:
        b.stop()


def test_pub_sub_roundtrip_matches_jax():
    out = same(sc_pub_sub)
    assert out[0] == [("default", "events", 4)] and len(out[1]) == 1
    assert out[2] == [b"m0", b"m1", b"m2", b"m3", b"m4"]
    assert "not configured" in out[4]


def sc_offsets(pkg):
    b = Broker(pkg)
    try:
        c = b.c
        c.configure_topic("work", partitions=1)
        for i in range(10):
            c.publish("work", b"job%d" % i, partition=0)
        recs = list(c.subscribe("work", 0, start_offset=0))
        c.commit("work", 0, "workers", recs[4].offset + 1)
        rest = [r.message.value
                for r in c.subscribe("work", 0, start_offset=-1, consumer_group="workers")]
        tail = list(c.subscribe("work", 0, start_offset=-1, consumer_group="nobody"))
        return len(recs), c.committed("work", 0, "workers"), c.committed("work", 0, "x"), rest, tail
    finally:
        b.stop()


def test_consumer_group_offsets_match_jax():
    assert same(sc_offsets) == (10, 5, -1, [b"job5", b"job6", b"job7", b"job8", b"job9"], [])


def sc_follow(pkg):
    b = Broker(pkg)
    try:
        c = b.c
        c.configure_topic("live", partitions=1)
        got = []

        def consume():
            for r in c.subscribe("live", 0, start_offset=0, follow=True, timeout=10):
                got.append(r.message.value)
                if len(got) == 3:
                    return

        t = threading.Thread(target=consume)
        t.start()
        time.sleep(0.2)
        for i in range(3):
            c.publish("live", b"tick%d" % i, partition=0)
            time.sleep(0.05)
        t.join(timeout=10)
        return got
    finally:
        b.stop()


def test_follow_streams_new_messages_matches_jax():
    assert same(sc_follow) == [b"tick0", b"tick1", b"tick2"]


def sc_persistence(pkg, stack):
    """Segments and offsets survive a restart of a filer-backed broker;
    the filer holds the same bytes whichever package wrote them."""
    recs = rng_records(9, seed=SEED + 1)
    b = Broker(pkg, filer=stack.filer_addr, segment_records=4)
    out = []
    try:
        b.c.configure_topic("durable", partitions=2)
        out += [b.publish_at("durable", 0, *r) for r in recs]
        b.c.commit("durable", 0, "g1", 3)
        b.c.commit("durable", 1, "g2", 0)
    finally:
        b.stop()
    files = topic_files(stack, "default", "durable")
    b2 = Broker(pkg, filer=stack.filer_addr, segment_records=4)
    try:
        out.append(b2.c.topics())
        out.append((b2.c.committed("durable", 0, "g1"), b2.c.committed("durable", 1, "g2")))
        out.append([(p.partition, p.earliest_offset, p.next_offset)
                    for p in b2.c.partition_info("durable")])
        out.append([(r.offset, r.message.ts_ns, r.message.key, r.message.value)
                    for r in b2.c.subscribe("durable", 0, start_offset=0)])
        out.append(b2.publish_at("durable", 0, 5, b"after", b"restart"))
        b2.srv.broker.delete_topic("default", "durable")
        out.append(topic_files(stack, "default", "durable"))
    finally:
        b2.stop()
    return out, files


def test_broker_persistence_via_filer_matches_jax(stacks):
    out = {n: sc_persistence(PKGS[n], stacks[n]) for n in PKGS}
    assert out["port"] == out["jax"]
    (answers, files) = out["port"]
    assert answers[-2] == ("", 0, 9) and answers[-1] == {}
    assert [r[3] for r in answers[-3]] == [r[2] for r in rng_records(9, seed=SEED + 1)]
    assert set(files) == {"topic.conf", "offsets.json", "0000/seg-00000000.log",
                          "0000/seg-00000001.log", "0000/seg-00000002.log"}
    assert json.loads(files["topic.conf"]) == {"partitionCount": 2, "durableParity": False}
    assert json.loads(files["offsets.json"]) == {"0|g1": 3, "1|g2": 0}


# ------------------------------------------------------------ the agent


def sc_agent_sessions(pkg):
    b = Broker(pkg)
    agent = pkg.agent.MqAgentServer(b.addr, ip="127.0.0.1")
    agent.start()
    try:
        ch = grpc.insecure_channel(f"127.0.0.1:{agent.port}")
        stub = pkg.rpc.Stub(ch, pkg.rpc.MQ_AGENT_SERVICE)
        r = stub.StartPublishSession(pkg.pb.AgentStartPublishRequest(
            name="agented", partition_count=1, publisher_name="t"), timeout=10)
        assert not r.error and r.session_id > 0
        sid = r.session_id
        pubs = (pkg.pb.AgentPublishRequest(session_id=sid if i == 0 else 0, key=b"k%d" % i,
                                           value=b"v%d" % i) for i in range(10))
        acks = [(a.ack_sequence, a.error, a.offset) for a in stub.PublishRecord(pubs, timeout=30)]
        reqs = queue.Queue()
        reqs.put(pkg.pb.AgentSubscribeRequest(init=pkg.pb.AgentSubscribeInit(
            consumer_group="g1", name="agented", partition=0, start_offset=0)))

        def req_iter():
            while (item := reqs.get()) is not None:
                yield item

        got = []
        for resp in stub.SubscribeRecord(req_iter(), timeout=30):
            if resp.is_end_of_stream:
                continue
            got.append((resp.offset, bytes(resp.key), bytes(resp.value)))
            if resp.offset == 9:
                reqs.put(pkg.pb.AgentSubscribeRequest(ack_sequence=10))
                reqs.put(None)
        wait_for(lambda: b.srv.broker.fetch_offset("default", "agented", 0, "g1") == 10,
                 timeout=30, msg="the ack committed")
        closed = stub.ClosePublishSession(pkg.pb.AgentClosePublishRequest(session_id=sid),
                                          timeout=10).error
        again = stub.ClosePublishSession(pkg.pb.AgentClosePublishRequest(session_id=sid),
                                         timeout=10).error
        # a session id is the agent's start second << 16, plus one a session
        bad = [(a.ack_sequence, a.error.replace(str(sid), "<sid>")) for a in stub.PublishRecord(
            iter([pkg.pb.AgentPublishRequest(session_id=sid, value=b"x")]), timeout=10)]
        no_init = [(x.error, x.is_end_of_stream) for x in stub.SubscribeRecord(
            iter([pkg.pb.AgentSubscribeRequest(ack_sequence=3)]), timeout=10)]
        ch.close()
        return acks, got, closed, again, bad, no_init
    finally:
        agent.stop()
        b.stop()


def test_mq_agent_sessions_match_jax():
    acks, got, closed, again, bad, no_init = same(sc_agent_sessions)
    assert acks == [(i + 1, "", i) for i in range(10)]
    assert got == [(i, b"k%d" % i, b"v%d" % i) for i in range(10)]
    assert (closed, again) == ("", "unknown session")
    assert bad == [(1, "unknown session <sid>")]
    assert no_init == [("first message must carry init", True)]


def sc_agent_half_close(pkg):
    b = Broker(pkg)
    agent = pkg.agent.MqAgentServer(b.addr, ip="127.0.0.1")
    agent.start()
    try:
        b.c.configure_topic("halfclose", partitions=1)
        for i in range(10):
            b.c.publish("halfclose", key=b"", value=b"r%d" % i)
        ch = grpc.insecure_channel(f"127.0.0.1:{agent.port}")
        stub = pkg.rpc.Stub(ch, pkg.rpc.MQ_AGENT_SERVICE)
        got = []
        for resp in stub.SubscribeRecord(iter([pkg.pb.AgentSubscribeRequest(
                init=pkg.pb.AgentSubscribeInit(name="halfclose", partition=0, start_offset=0))]),
                timeout=30):
            if resp.is_end_of_stream:
                break
            got.append((resp.offset, bytes(resp.value)))
        ch.close()
        return got
    finally:
        agent.stop()
        b.stop()


def test_mq_agent_ackless_half_close_matches_jax():
    assert same(sc_agent_half_close) == [(i, b"r%d" % i) for i in range(10)]


# --------------------------------------------------- parquet and schemas


def test_parquet_roundtrip_matches_jax():
    jl, pl = PKGS["jax"].logstore, PKGS["port"].logstore
    raw = b"".join(PKGS["port"].log_buffer.encode_record(i, 1_000_000 + i, f"k{i}".encode(),
                                                         b"v" * (i % 7)) for i in range(500))
    pq = pl.segment_to_parquet(raw)
    assert pl.parquet_to_segment(pq) == raw == jl.parquet_to_segment(pq)
    assert jl.parquet_to_segment(pl.segment_to_parquet(raw)) == raw
    assert pl.parquet_stats(pq) == jl.parquet_stats(jl.segment_to_parquet(raw))
    st = pl.parquet_stats(pq)
    assert st["rows"] == 500 and (st["offset_min"], st["offset_max"]) == (0, 499)


def sc_archival(pkg, stack):
    broker = pkg.broker.MqBroker(filer=stack.filer_addr, segment_records=50)
    broker.configure_topic("default", "arch", 1)
    plog = broker.topic("default", "arch").logs[0]
    for i in range(175):
        plog.append(i + 1, b"", json.dumps({"i": i}).encode())
    arch = pkg.logstore.SegmentArchiver(broker, min_age_segments=1)
    out = [arch.run_once()]
    recs, off = [], plog.earliest_offset
    while batch := plog.read_from(off, max_records=64):
        recs.extend(batch)
        off = batch[-1][0] + 1
    out += [recs, arch.run_once()]
    broker.flush()
    files = topic_files(stack, "default", "arch")
    stats = {k: json.loads(v) for k, v in files.items() if k.endswith(".stats.json")}
    broker2 = pkg.broker.MqBroker(filer=stack.filer_addr, segment_records=50)
    plog2 = broker2.topic("default", "arch").logs[0]
    out += [plog2.next_offset, plog2.earliest_offset, plog2.read_from(0, max_records=4)]
    counters = {}
    out.append(list(broker2.scan_records("default", "arch", 0, off_lo=120, counters=counters)))
    out.append(counters)
    out.append(broker2.compact_topic("default", "arch"))
    out.append(broker2.truncate_topic("default", "arch", before_offset=110))
    out.append(sorted(topic_files(stack, "default", "arch")))
    broker2.delete_topic("default", "arch")
    broker.close()
    broker2.close()
    return out, files, stats


def test_archival_keeps_consumers_working_as_jax(stacks):
    out = {n: sc_archival(PKGS[n], stacks[n]) for n in PKGS}
    assert out["port"] == out["jax"]
    answers, files, stats = out["port"]
    assert answers[0] >= 2 and answers[2] == 0
    assert [r[0] for r in answers[1]] == list(range(175))
    assert answers[3:5] == [175, 0] and [r[0] for r in answers[5]] == [0, 1, 2, 3]
    assert [r[0] for r in answers[6]] == list(range(120, 175))
    assert stats["0000/seg-00000000.stats.json"]["rows"] == 50


def sc_schema(pkg, stack):
    b = Broker(pkg, filer=stack.filer_addr, archive_interval=0)
    try:
        t = pkg.pb.Topic(namespace="default", name="typed")
        b.stub.ConfigureTopic(pkg.pb.ConfigureTopicRequest(topic=t, partition_count=1),
                              timeout=10)
        schema = json.dumps({"enforce": True, "fields": [
            {"name": "id", "type": "int", "required": True}, {"name": "note", "type": "string"},
            {"name": "ok", "type": "bool"}, {"name": "x", "type": "float"}]})
        out = [b.stub.RegisterSchema(pkg.pb.RegisterSchemaRequest(topic=t, schema_json=schema),
                                     timeout=10).error]
        for bad in ('{"fields": 3}', '{"fields": [{"type": "int"}]}', "not json"):
            out.append(b.stub.RegisterSchema(pkg.pb.RegisterSchemaRequest(
                topic=t, schema_json=bad), timeout=10).error)
        out.append(b.stub.RegisterSchema(pkg.pb.RegisterSchemaRequest(
            topic=pkg.pb.Topic(name="absent"), schema_json=schema), timeout=10).error)
        out.append(json.loads(b.stub.GetSchema(pkg.pb.GetSchemaRequest(topic=t),
                                               timeout=10).schema_json))
        for value in ({"id": 1, "note": "fine"}, {"note": "missing id"}, {"id": "not-an-int"},
                      {"id": True}, {"id": 2, "x": 3}, {"id": 2, "ok": 1}, [1, 2]):
            r = b.stub.Publish(pkg.pb.PublishRequest(topic=t, message=pkg.pb.DataMessage(
                value=json.dumps(value).encode(), ts_ns=1)), timeout=10)
            out.append((r.error, r.offset))
        out.append(b.stub.Publish(pkg.pb.PublishRequest(topic=t, message=pkg.pb.DataMessage(
            value=b"\x00\x01 not json", ts_ns=1)), timeout=10).error)
        out.append(filer_file(stack, "/topics/default/typed/schema.json"))
        broker2 = pkg.broker.MqBroker(filer=stack.filer_addr)
        out.append(broker2.get_schema("default", "typed"))
        broker2.set_schema("default", "typed", "")
        out.append(filer_file(stack, "/topics/default/typed/schema.json"))
        broker2.delete_topic("default", "typed")
        broker2.close()
        return out
    finally:
        b.stop()


def test_schema_registry_and_enforcement_match_jax(stacks):
    out = {n: sc_schema(PKGS[n], stacks[n]) for n in PKGS}
    assert out["port"] == out["jax"]
    out = out["port"]
    assert out[0] == "" and all(out[1:5]) and out[5]["enforce"] is True
    assert out[6] == ("", 0) and "schema violation" in out[7][0] and "schema violation" in out[8][0]
    assert "schema violation" in out[13] and out[14] == out[15].encode() and out[16] is None


# ------------------------------------------------------------ the shell


def shell_steps(broker: str) -> list:
    b = ["-broker", broker]
    schema = json.dumps({"enforce": True, "fields": [{"name": "id", "type": "int"}]})
    return [
        ["mq.topic.list", *b],
        ["mq.topic.configure", "-topic", "shelled", "-partitions", "3", *b],
        ["mq.topic.configure", "-topic", "other", "-namespace", "ns2", *b],
        ["mq.topic.list", *b],
        ["mq.topic.describe", "-topic", "shelled", *b],
        ["mq.schema.get", "-topic", "shelled", *b],
        ["mq.schema.set", "-topic", "shelled", "-schema", schema, *b],
        ["mq.schema.set", "-topic", "absent", "-schema", schema, *b],
        ["mq.schema.get", "-topic", "shelled", *b],
        ["PUBLISH"],
        ["mq.topic.describe", "-topic", "shelled", *b],
        ["mq.topic.compact", "-topic", "shelled", *b],
        ["mq.topic.compact", "-topic", "absent", *b],
        ["mq.topic.truncate", "-topic", "shelled", "-partition", "1", "-beforeOffset", "5", *b],
        ["mq.topic.truncate", "-topic", "shelled", *b],
        ["mq.topic.truncate", "-topic", "absent", *b],
        ["mq.topic.describe", "-topic", "shelled", *b],
        ["mq.topic.delete", "-topic", "shelled", *b],
        ["mq.topic.delete", "-topic", "other", "-ns", "ns2", *b],
        ["mq.topic.list", *b],
    ]


def shell_line(step: list) -> str:
    return " ".join(shlex.quote(a) for a in step)


def sc_shell(pkg, stack):
    """The shell's 8 mq.* against a filer-backed broker of the same
    package: each answer, with the broker's address masked."""
    b = Broker(pkg, filer=stack.filer_addr, segment_records=4, archive_interval=0)
    env = pkg.shell.ShellEnv(master=f"127.0.0.1:{stack.mport}", filer=stack.filer_addr)
    out = []
    try:
        for step in shell_steps(b.addr):
            if step == ["PUBLISH"]:
                for i in range(11):
                    out.append(b.publish_at("shelled", i % 3, i, b"",
                                            json.dumps({"id": i}).encode()))
                out.append(b.publish_at("shelled", 0, 99, b"", b'{"id": "x"}'))
                continue
            out.append(pkg.shell.run_command(env, shell_line(step)).replace(b.addr, "<broker>"))
        return out
    finally:
        env.close()
        b.stop()


def test_shell_mq_commands_answer_as_jax(stacks):
    out = {n: sc_shell(PKGS[n], stacks[n]) for n in PKGS}
    assert out["port"] == out["jax"]
    out = out["port"]
    assert out[0] == "(no topics)" and out[1] == "configured default/shelled with 3 partitions"
    assert out[3] == "default/shelled  partitions=3\nns2/other  partitions=4"
    assert out[6] == "schema registered for shelled" and out[7].startswith("error: ")
    assert out[-9] == "archived 3 segments of default/shelled"
    assert out[-1] == "(no topics)"


def test_chip_smoke_phase_20b_lines_hold_in_both_shells(stacks, tmp_path, monkeypatch):
    """The lines chip_smoke.py's phase 20b holds the port shell to on the
    card, answered alike by both shells against a filer-backed broker
    with durable parity of their own package (a small bench/omb)."""
    import importlib.util

    import chip_smoke

    monkeypatch.setenv("SEAWEED_EC_STREAM_BACKEND", "cpu")
    counts = [3, 2, 2, 1]
    archived = 2 if importlib.util.find_spec("pyarrow") else 0
    for name, pkg in PKGS.items():
        b = Broker(pkg, filer=stacks[name].filer_addr, parity_dir=str(tmp_path / name),
                   archive_interval=0)
        env = pkg.shell.ShellEnv(master=f"127.0.0.1:{stacks[name].mport}",
                                 filer=stacks[name].filer_addr)
        try:
            b.c.configure_topic(chip_smoke.MQ20_TOPIC, partitions=4, namespace=chip_smoke.MQ20_NS)
            for p, n in enumerate(counts):
                for i in range(n):
                    b.c.publish(chip_smoke.MQ20_TOPIC, b"r%d" % i, partition=p,
                                namespace=chip_smoke.MQ20_NS)
            for line, want in chip_smoke.mq20_shell_steps(b.addr, counts, archived):
                got = (chip_smoke.mq20_publish_smoke20b(b.c) if line is None
                       else pkg.shell.run_command(env, line))
                assert got == want, (name, line)
            b.srv.broker.delete_topic(chip_smoke.MQ20_NS, chip_smoke.MQ20_TOPIC)
        finally:
            env.close()
            b.stop()


def test_shell_mq_commands_against_no_broker_answer_alike():
    """No broker at the address: each command answers the same error
    line in both shells."""
    addr = f"127.0.0.1:{allocate_port()}"
    envs = {n: p.shell.ShellEnv(master="127.0.0.1:1", filer="127.0.0.1:1")
            for n, p in PKGS.items()}
    try:
        for step in shell_steps(addr):
            if step != ["PUBLISH"]:
                out = {n: PKGS[n].shell.run_command(envs[n], shell_line(step)) for n in PKGS}
                assert out["port"] == out["jax"], step
                assert out["port"].startswith("error: UNAVAILABLE"), out
    finally:
        for env in envs.values():
            env.close()


# -------------------------------------------------------- the notifier


def sc_notifier(pkg, stack):
    b = Broker(pkg)
    try:
        n = pkg.notification.make_notifier("mq", b.addr)
        stack.filer.subscribe(n)
        for i in range(6):
            stack.filer.write_file(f"/notify/d{i % 2}/f{i}.txt", b"x" * (i + 1))
        stack.filer.delete_entry("/notify/d0/f0.txt")
        events = []
        wait_for(lambda: sum(p.next_offset for p in b.c.partition_info("filer-events")) >= 10,
                 timeout=30, msg="the filer's events reached the broker")
        for p in range(4):
            for r in b.c.subscribe("filer-events", p, start_offset=0):
                ev = json.loads(r.message.value)
                ev.pop("tsNs")
                ev.pop("pb")
                events.append((p, r.message.key.decode(), ev))
        n.close()
        stack.filer._listeners.remove(n)
        return b.c.topics(), sorted(events, key=json.dumps), n.delivered, n.dropped
    finally:
        b.stop()


def test_mq_notifier_publishes_the_events_jax_does(stacks):
    out = {n: sc_notifier(PKGS[n], stacks[n]) for n in PKGS}
    assert out["port"] == out["jax"]
    topics, events, delivered, dropped = out["port"]
    assert topics == [("default", "filer-events", 4)] and dropped == 0
    assert delivered == len(events) >= 10
    assert {e[2]["newEntry"]["name"] for e in events if e[2]["newEntry"]} >= {"f5.txt"}


def test_kafka_notifier_still_names_its_item():
    with pytest.raises(RuntimeError, match="item 14b-2"):
        PKGS["port"].notification.make_notifier("kafka", "127.0.0.1:1")


# ----------------------------------------------------------- the launcher


def stop_child(proc) -> tuple:
    proc.send_signal(signal.SIGTERM)
    out, err = proc.communicate(timeout=30)
    return proc.returncode, err


def http_json(port: int, path: str):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return json.loads(r.read())


def test_launched_broker_and_agent_serve_by_name(tmp_path, stacks):
    """`mq.broker` (filer-backed, a status plane) and `mq.agent` by name:
    a session publishes through the agent, the records sit in the filer
    as the JAX broker would write them, the broker loaded no torch, and
    both exit 0 on SIGTERM."""
    bport, sport, aport = allocate_port(), allocate_port(), allocate_port()
    broker = launch(tmp_path, "mq.broker", "-ip", "127.0.0.1", "-port", str(bport), "-filer",
                    stacks["port"].filer_addr, "-segmentRecords", "4", "-statusPort", str(sport))
    agent = launch(tmp_path, "mq.agent", "-ip", "127.0.0.1", "-port", str(aport), "-broker",
                   f"127.0.0.1:{bport}")
    pkg = PKGS["port"]
    try:
        def up():
            assert broker.poll() is None and agent.poll() is None, (
                broker.stderr.read() if broker.poll() is not None else agent.stderr.read())
            try:
                return http_json(sport, "/status")["address"] == f"127.0.0.1:{bport}"
            except OSError:
                return False

        wait_for(up, timeout=60, msg="the broker's status plane")
        ch = grpc.insecure_channel(f"127.0.0.1:{aport}")
        grpc.channel_ready_future(ch).result(timeout=60)  # the agent serves
        stub = pkg.rpc.Stub(ch, pkg.rpc.MQ_AGENT_SERVICE)
        sid = stub.StartPublishSession(pkg.pb.AgentStartPublishRequest(
            name="launched", partition_count=1), timeout=60).session_id
        acks = list(stub.PublishRecord(iter([pkg.pb.AgentPublishRequest(
            session_id=sid, key=b"k%d" % i, value=b"v%d" % i) for i in range(6)]), timeout=30))
        ch.close()
        assert [(a.error, a.offset) for a in acks] == [("", i) for i in range(6)]
        status = http_json(sport, "/status")
        assert status["topics"] == [{"namespace": "default", "name": "launched", "partitions": 1}]
        assert http_json(sport, "/debug/kernels") == {"launches": {}, "masked": {},
                                                      "stream_dispatches": 0, "torch": False}
        segs = topic_files(stacks["port"], "default", "launched")
        assert list(pkg.mq.decode_records(segs["0000/seg-00000000.log"]))[-1][2:] == (b"k3", b"v3")
    finally:
        codes = [stop_child(p) for p in (agent, broker)]
    assert [c for c, _ in codes] == [0, 0], codes
    # the stopped broker flushed its tail into a segment
    segs = topic_files(stacks["port"], "default", "launched")
    assert [r[0] for r in pkg.mq.decode_records(segs["0000/seg-00000001.log"])] == [4, 5]


def test_launched_filer_notifies_a_broker(tmp_path, stacks):
    """`filer -notify.mq` by name, and `notification.toml`'s
    `[notification.mq]` where the flag is unset: the filer's writes
    arrive on `default/filer-events`."""
    pkg = PKGS["port"]
    for use_toml in (False, True):
        b = Broker(pkg)
        fport = _ports()
        cwd = tmp_path / f"toml{int(use_toml)}"
        cwd.mkdir()
        extra = ["-notify.mq", b.addr]
        if use_toml:
            (cwd / "notification.toml").write_text(
                f'[notification.mq]\nenabled = true\nbroker = "{b.addr}"\n')
            extra = []
        proc = launch(cwd, "filer", "-ip", "127.0.0.1", "-port", str(fport), "-master",
                      f"127.0.0.1:{stacks['port'].mport}", "-dir", str(cwd / "f"), "-store",
                      "memory", *extra)
        try:
            import http.client

            def put():
                assert proc.poll() is None, proc.stderr.read()
                try:
                    c = http.client.HTTPConnection("127.0.0.1", fport, timeout=10)
                    c.request("PUT", "/n/a.txt", body=b"hello")
                    return c.getresponse().status == 201
                except OSError:
                    return False

            wait_for(put, timeout=60, msg="the launched filer")

            def names() -> set:
                return {(json.loads(r.message.value)["newEntry"] or {}).get("name")
                        for p in range(4) for r in b.c.subscribe("filer-events", p, start_offset=0)}

            wait_for(lambda: "a.txt" in names(), timeout=30, msg="the file's event at the broker")
        finally:
            code, err = stop_child(proc)
            b.stop()
        assert code == 0, err


@pytest.mark.parametrize("flag,item", [("-pgPort", "19")])
def test_broker_refuses_the_gateways_of_later_items(tmp_path, flag, item):
    proc = launch(tmp_path, "mq.broker", "-ip", "127.0.0.1", "-port", str(allocate_port()), flag,
                  "0")
    _, err = proc.communicate(timeout=60)
    assert proc.returncode == 2 and f"ROADMAP.md item {item}" in err, err
    with pytest.raises(ValueError, match=f"item {item}"):
        PKGS["port"].broker.MqBrokerServer(ip="127.0.0.1", grpc_port=allocate_port(), pg_port=0)


def test_archive_loop_survives_a_failed_cycle():
    """A failed archival cycle: the port's loop logs it and goes on; the
    JAX loop names an undefined `log` and its thread ends."""
    calls = {}
    for name, pkg in PKGS.items():
        srv = pkg.broker.MqBrokerServer(ip="127.0.0.1", grpc_port=allocate_port())
        n = [0]

        def run_once(n=n, srv=srv):
            n[0] += 1
            if n[0] == 3:
                srv._archive_stop.set()
            raise OSError("filer down")

        srv.archiver = type("A", (), {"run_once": staticmethod(run_once)})()
        try:
            srv._archive_loop(0.01)
            calls[name] = n[0]
        except NameError:
            calls[name] = "NameError"
        finally:
            srv.stop()
    assert calls == {"port": 3, "jax": "NameError"}


# A child without jax that holds torch (as a broker with a durable-parity
# topic does), then converts segments on threads that come and go, as a
# broker's gRPC workers do. "built": a filer-backed port broker is built
# on the main thread and compacts on its gRPC worker first. "worker":
# pyarrow is first imported on a thread that exits, as the JAX broker's
# lazy import does on a gRPC worker.
_PYARROW_CHILD = r"""
import sys, threading
import torch  # noqa: F401
from seaweedfs_tpu_torch.mq import MqBrokerServer, MqClient, logstore
from seaweedfs_tpu_torch.pb import mq_pb2 as mq

mode, filer, gport = sys.argv[1], sys.argv[2], int(sys.argv[3])
if mode == "built":
    srv = MqBrokerServer(ip="127.0.0.1", grpc_port=gport, filer=filer, segment_records=8,
                         archive_interval=0)
    assert "pyarrow" in sys.modules
    srv.start()
    c = MqClient(f"127.0.0.1:{gport}")
    c.configure_topic("pyarrow-thread", partitions=1)
    for i in range(20):
        c.publish("pyarrow-thread", b"v%d" % i, key=b"k%d" % i, partition=0)
    r = c.stub.CompactTopic(mq.CompactTopicRequest(ns="default", name="pyarrow-thread"),
                            timeout=60)
    assert (r.error, r.archived_segments) == ("", 3), r
    srv.broker.delete_topic("default", "pyarrow-thread")
    c.close()
    srv.stop()
else:
    t = threading.Thread(target=lambda: __import__("pyarrow.parquet"))
    t.start()
    t.join()
raw = b"".join(logstore.encode_record(o, 1000 + o, b"k%d" % o, b"v" * (o % 300))
               for o in range(300))


def convert():
    assert logstore.parquet_to_segment(logstore.segment_to_parquet(raw)) == raw


for _ in range(20):
    t = threading.Thread(target=convert)
    t.start()
    t.join()
assert "jax" not in sys.modules and "seaweedfs_tpu" not in sys.modules
print("converted")
"""


@pytest.mark.parametrize("mode,survives", [("built", True), ("worker", False)])
def test_pyarrow_loaded_where_the_broker_is_built(stacks, mode, survives):
    """In a process without jax that holds torch, a pyarrow first loaded
    on a thread that exits leaves the next conversion on another thread
    to segfault; a filer-backed port broker loads it where it is built,
    so its compaction on a gRPC worker and later conversions on threads
    that come and go run clean."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _PYARROW_CHILD, mode,
                           stacks["port"].filer_addr, str(allocate_port())],
                          cwd=str(REPO), env=env, capture_output=True, text=True, timeout=120)
    if survives:
        assert proc.returncode == 0 and "converted" in proc.stdout, proc.stderr[-3000:]
    else:
        assert proc.returncode == -signal.SIGSEGV, (proc.returncode, proc.stderr[-3000:])
