"""PyTorch port: a group of MQ brokers (mq/balancer.py and the broker's
forwarding, replication, proxying and failover) held against the JAX
package on the CPU.

Every scenario of the JAX tests/test_mq_multibroker.py runs on a trio of
JAX brokers and on a trio of port brokers (a ping interval of 0.2 s, as
there). The trios listen on different ports, so HRW hashes them
differently: each scenario answers in terms of roles (the leader, the
follower, the third broker), and those answers must be equal, tolerance 0.
The HRW ranking itself, gravity's swap under the hysteresis and the
single-hop metadata are compared on the same broker names.
"""

import json
import time

import grpc
import numpy as np
import pytest
from conftest import allocate_port
from torch_mq_twins import PKGS


class Trio:
    def __init__(self, pkg):
        self.pkg = pkg
        self.ports = [allocate_port() for _ in range(3)]
        peers = [f"127.0.0.1:{p}" for p in self.ports]
        self.brokers = [pkg.broker.MqBrokerServer(ip="127.0.0.1", grpc_port=p, peers=peers)
                        for p in self.ports]
        for b in self.brokers:
            b.balancer.ping_interval = 0.2
            b.start()
        self.channels = [grpc.insecure_channel(a) for a in peers]
        self.stubs = [pkg.rpc.mq_stub(ch) for ch in self.channels]

    def topic(self, name):
        return self.pkg.pb.Topic(name=name)

    def configure(self, name, count):
        self.stubs[0].ConfigureTopic(self.pkg.pb.ConfigureTopicRequest(
            topic=self.topic(name), partition_count=count), timeout=30)

    def publish(self, i, name, part, value):
        r = self.stubs[i].Publish(self.pkg.pb.PublishRequest(
            topic=self.topic(name), partition=part,
            message=self.pkg.pb.DataMessage(key=b"k", value=value, ts_ns=7)), timeout=30)
        return r.error, r.partition, r.offset

    def roles(self, name, via=0):
        """partition -> (leader index, follower index, third index)."""
        look = self.stubs[via].LookupTopicBrokers(
            self.pkg.pb.LookupTopicBrokersRequest(topic=self.topic(name)), timeout=30)
        out = {}
        for a in look.assignments:
            lead = self.ports.index(int(a.leader.rsplit(":", 1)[1]))
            fol = self.ports.index(int(a.follower.rsplit(":", 1)[1]))
            out[a.partition] = (lead, fol, ({0, 1, 2} - {lead, fol}).pop())
        return out

    def held(self, i, name, part):
        st = self.brokers[i].broker.topic("default", name)
        return [(o, ts, bytes(k), bytes(v)) for o, ts, k, v in st.logs[part].read_from(0)]

    def subscribe(self, i, name, part):
        out = []
        for rec in self.stubs[i].Subscribe(self.pkg.pb.SubscribeRequest(
                topic=self.topic(name), partition=part, start_offset=0), timeout=30):
            if rec.end_of_stream:
                break
            out.append((rec.offset, bytes(rec.message.value)))
        return out

    def stop(self):
        for ch in self.channels:
            ch.close()
        for b in self.brokers:
            try:
                b.stop()
            except Exception:
                pass


def on_trios(fn):
    out = {}
    for name, pkg in PKGS.items():
        t = Trio(pkg)
        try:
            out[name] = fn(t)
        finally:
            t.stop()
    assert out["port"] == out["jax"]
    return out["port"]


@pytest.mark.parametrize("count", [1, 16, 64])
def test_hrw_assignment_matches_jax(count):
    peers = ["h1:1", "h2:2", "h3:3", "h4:4"]
    got = {}
    for name, pkg in PKGS.items():
        bals = [pkg.balancer.BrokerBalancer(p, peers) for p in peers]
        a0 = bals[0].assignments("default", "t", count)
        assert all(b.assignments("default", "t", count) == a0 for b in bals[1:])
        promoted = []
        for p, leader, follower in a0:
            survivor = pkg.balancer.BrokerBalancer("x:0", [b for b in peers if b != leader] + ["x:0"])
            survivor._live = {b for b in peers if b != leader}
            promoted.append(survivor.assignment("default", "t", p)[0] == follower)
        got[name] = a0, promoted, [pkg.balancer._score(b, "ns", "t", 3) for b in peers]
    assert got["port"] == got["jax"]
    assert all(got["port"][1])
    if count >= 16:
        assert len({lead for _p, lead, _f in got["port"][0]}) >= 2


def test_gravity_and_forward_metadata_match_jax(monkeypatch):
    rng = np.random.default_rng(30)
    peers = ["a:1", "b:2", "c:3"]

    class Ctx:
        def __init__(self, md):
            self.md = md

        def invocation_metadata(self):
            return self.md

    got = {}
    for name, pkg in PKGS.items():
        out = []
        for hyst in ("1.5", "0", "bad"):
            monkeypatch.setenv("SEAWEED_MQ_GRAVITY_HYSTERESIS", hyst)
            bal = pkg.balancer.BrokerBalancer("a:1", peers)
            for trial in range(20):
                bal._loads = {p: float(x) for p, x in zip(peers, rng.uniform(0, 4, 3))}
                out.append(bal.assignments("default", "g", 8))
            out.append(pkg.balancer.gravity_hysteresis())
        out += [pkg.balancer.is_forwarded(c) for c in (
            None, Ctx(pkg.balancer.FWD_METADATA), Ctx((("x", "1"),)), object())]
        got[name] = out
        rng = np.random.default_rng(30)
    assert got["port"] == got["jax"]
    assert got["port"][-4:] == [False, True, False, False]


def sc_forwarding(t: Trio):
    t.configure("spread", 6)
    listed = [[x.topic.name for x in s.ListTopics(t.pkg.pb.ListTopicsRequest(),
                                                  timeout=30).topics] for s in t.stubs]
    acks = [t.publish(0, "spread", part, b"v%d" % part) for part in range(6)]
    roles = t.roles("spread", via=1)
    held = [[t.held(i, "spread", part) for i in roles[part]] for part in range(6)]
    return listed, acks, held


def test_publish_forwarding_and_replication_match_jax():
    listed, acks, held = on_trios(sc_forwarding)
    assert listed == [["spread"]] * 3 and acks == [("", p, 0) for p in range(6)]
    for part, (lead, fol, third) in enumerate(held):
        assert lead == fol == [(0, 7, b"k", b"v%d" % part)] and third == []


def sc_proxy(t: Trio):
    t.configure("sub", 3)
    acks = [t.publish(i % 3, "sub", i % 3, b"m%d" % i) for i in range(9)]
    return acks, [t.subscribe(2, "sub", part) for part in range(3)]


def test_subscribe_proxies_to_leader_as_jax():
    acks, got = on_trios(sc_proxy)
    assert sorted(v for part in got for _o, v in part) == [b"m%d" % i for i in range(9)]


def sc_gap(t: Trio):
    t.configure("gap", 1)
    lead, fol, _third = t.roles("gap")[0]
    st = t.brokers[lead].broker.topic("default", "gap")
    for i in range(5):
        st.logs[0].append(1, b"", b"missed%d" % i)
    ack = t.publish(lead, "gap", 0, b"live")
    return ack, [v for _o, _ts, _k, v in t.held(fol, "gap", 0)]


def test_replica_gap_is_backfilled_as_jax():
    ack, follower = on_trios(sc_gap)
    assert ack == ("", 0, 5)
    assert follower == [b"missed0", b"missed1", b"missed2", b"missed3", b"missed4", b"live"]


def sc_offsets(t: Trio):
    t.configure("offs", 1)
    t.stubs[0].CommitOffset(t.pkg.pb.CommitOffsetRequest(
        topic=t.topic("offs"), partition=0, consumer_group="g", offset=42), timeout=30)
    lead = t.roles("offs")[0][0]
    return [s.FetchOffset(t.pkg.pb.FetchOffsetRequest(
        topic=t.topic("offs"), partition=0, consumer_group="g"), timeout=30).offset
        for s in t.stubs], [t.brokers[i].broker.fetch_offset("default", "offs", 0, "g") == 42
                            for i in range(3)].count(True), \
        t.brokers[lead].broker.fetch_offset("default", "offs", 0, "g")


def test_consumer_offsets_route_to_leader_as_jax():
    assert on_trios(sc_offsets) == ([42, 42, 42], 1, 42)


def sc_failover(t: Trio):
    t.configure("ha", 1)
    lead, fol, third = t.roles("ha")[0]
    acks = [t.publish(lead, "ha", 0, b"ha%d" % i) for i in range(20)]
    t.brokers[lead].stop()
    survivor = third
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        look = t.stubs[survivor].LookupTopicBrokers(
            t.pkg.pb.LookupTopicBrokersRequest(topic=t.topic("ha")), timeout=30)
        if look.assignments[0].leader == f"127.0.0.1:{t.ports[fol]}":
            break
        time.sleep(0.2)
    promoted = look.assignments[0].leader == f"127.0.0.1:{t.ports[fol]}"
    got = t.subscribe(fol, "ha", 0)
    after = t.publish(survivor, "ha", 0, b"post-failover")
    return acks, promoted, got, after


def test_leader_death_failover_preserves_data_as_jax():
    acks, promoted, got, after = on_trios(sc_failover)
    assert promoted and acks == [("", 0, i) for i in range(20)]
    assert got == [(i, b"ha%d" % i) for i in range(20)] and after == ("", 0, 20)


# ------------------------------------------- faults of the reference, kept


def sc_refused_follow(t: Trio):
    """The follower of partition 1 holds the topic with one partition
    only, so it refuses FollowAppend ("partition 1 absent"); the leader
    acknowledges the publish all the same."""
    t.configure("refused", 2)
    lead, fol, _third = t.roles("refused")[1]
    fb = t.brokers[fol].broker
    fb.delete_topic("default", "refused")
    fb.configure_topic("default", "refused", 1)
    ack = t.publish(lead, "refused", 1, b"acked")
    return ack, [v for _o, _ts, _k, v in t.held(lead, "refused", 1)], sorted(
        fb.topic("default", "refused").logs)


def test_a_follower_refusal_is_acknowledged_on_the_leader_as_jax():
    """Open in both packages (`_replicate`, seaweedfs_tpu/mq/broker.py:
    1066-1075): a non-gap refusal is logged and the record acked on the
    leader alone."""
    assert on_trios(sc_refused_follow) == (("", 1, 0), [b"acked"], [0])


@pytest.fixture(scope="module")
def stacks(tmp_path_factory):
    from torch_mq_twins import Stack

    root = tmp_path_factory.mktemp("mqgroup")
    out = {}
    try:
        for name in PKGS:
            (root / name).mkdir()
            out[name] = Stack(name, root / name)
        yield out
    finally:
        for s in out.values():
            s.stop()


def sc_filer_pair(pkg, stack):
    """Two filer-backed brokers in one group: each commits the offsets of
    the partitions it leads into the topic's one `offsets.json`, and each
    seals the segments it holds, leader and follower alike, into one
    path."""
    from torch_mq_twins import filer_file

    ports = [allocate_port() for _ in range(2)]
    peers = [f"127.0.0.1:{p}" for p in ports]
    brokers = [pkg.broker.MqBrokerServer(ip="127.0.0.1", grpc_port=p, peers=peers,
                                         filer=stack.filer_addr, segment_records=4,
                                         archive_interval=0) for p in ports]
    writes = []

    def listener(ev):
        if ev.directory.startswith("/topics/default/pair/") and ev.event.new_entry.name:
            writes.append(f"{ev.directory}/{ev.event.new_entry.name}")

    stack.filer.subscribe(listener)
    chans = [grpc.insecure_channel(a) for a in peers]
    try:
        for b in brokers:
            b.balancer.ping_interval = 0.2
            b.start()
        stubs = [pkg.rpc.mq_stub(ch) for ch in chans]
        stubs[0].ConfigureTopic(pkg.pb.ConfigureTopicRequest(
            topic=pkg.pb.Topic(name="pair"), partition_count=32), timeout=30)
        look = stubs[0].LookupTopicBrokers(pkg.pb.LookupTopicBrokersRequest(
            topic=pkg.pb.Topic(name="pair")), timeout=30)
        leaders = {a.partition: peers.index(a.leader) for a in look.assignments}
        # one partition led by each broker (with 32 partitions HRW leaves a
        # broker none in 1 of 2^31 runs)
        parts = [min(p for p, i in leaders.items() if i == want) for want in (0, 1)]
        for p in parts:
            for i in range(4):
                stubs[0].Publish(pkg.pb.PublishRequest(
                    topic=pkg.pb.Topic(name="pair"), partition=p,
                    message=pkg.pb.DataMessage(value=b"v%d" % i, ts_ns=i + 1)), timeout=30)
        for n, p in enumerate(parts):
            stubs[0].CommitOffset(pkg.pb.CommitOffsetRequest(
                topic=pkg.pb.Topic(name="pair"), partition=p, consumer_group="g",
                offset=10 + n), timeout=30)
        offsets = json.loads(filer_file(stack, "/topics/default/pair/offsets.json"))
        seg_writes = sorted(
            w.replace(f"/{parts[0]:04d}/", "/<p0>/").replace(f"/{parts[1]:04d}/", "/<p1>/")
            for w in writes if w.endswith(".log"))
        return [(k.split("|")[1], v) for k, v in offsets.items()], seg_writes
    finally:
        stack.filer._listeners.remove(listener)
        for ch in chans:
            ch.close()
        for b in brokers:
            b.stop()
        brokers[0].broker.delete_topic("default", "pair")


def test_a_filer_backed_group_overwrites_its_offsets_file_as_jax(stacks):
    """Open in both packages: the leaders of a topic's partitions each
    write the topic's `offsets.json` with the offsets they hold, so the
    file keeps the last writer's partitions only, and a restarted group
    loses the others' commits; every sealed segment is written once by
    its leader and once by its follower, into the same path."""
    out = {n: sc_filer_pair(PKGS[n], stacks[n]) for n in PKGS}
    assert out["port"] == out["jax"]
    offsets, seg_writes = out["port"]
    assert len(offsets) == 1 and offsets[0][0] == "g"
    assert seg_writes == ["/topics/default/pair/<p0>/seg-00000000.log"] * 2 + [
        "/topics/default/pair/<p1>/seg-00000000.log"] * 2
