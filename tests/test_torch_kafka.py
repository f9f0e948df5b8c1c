"""PyTorch port: the Kafka gateway and client (seaweedfs_tpu_torch/mq/kafka:
`protocol`, `records`, `codecs`, `groups`, `frame_pool`, `fetch_spool`,
`gateway`, `client`) and the broker's `-kafkaPort`, held against the JAX
package on the CPU.

- The codecs: seeded varints, writers and record sets encode to the same
  bytes in both packages under every codec (none, gzip, snappy, lz4,
  zstd; gzip's header clock pinned), and each package decodes the
  other's batches and compressed streams.
- The golden transcripts of the JAX tests/test_kafka_golden.py, hand-
  assembled from the spec, replayed against a JAX and a port gateway:
  each response matches the spec bytes, and the two gateways' responses
  are byte-identical (member ids pinned by a seeded uuid, the produce
  clock and the throttle pinned; only the advertised ephemeral port is
  masked).
- The scenarios of the JAX tests/test_kafka.py and tests/test_kafka_pool.py
  (the SQL scan under produce waits for item 19) on four stacks: each
  gateway driven by its own package's client and by the other's. The
  JAX test bodies run as they are, with their module globals pointed at
  the stack's classes.
- Saturation rejects, the fetch spool's batch files, `load_score` and
  `/status`, compared across the packages byte for byte or key for key.
- `mq.broker -kafkaPort 0` started by name in both packages serves the
  wire protocol.

The group commit under a crash runs in tests/test_torch_kafka_group_commit.py.
"""

import gzip
import json
import os
import re
import signal
import socket
import struct
import subprocess
import sys
import threading
import time
import types
import urllib.request
import uuid

import numpy as np
import pytest
from conftest import allocate_port, wait_for

import test_kafka as jk
import test_kafka_golden as jg
import test_kafka_pool as jp
import seaweedfs_tpu.faults.registry as j_faults
import seaweedfs_tpu.mq.broker as j_broker
import seaweedfs_tpu.mq.group_commit as j_group_commit
import seaweedfs_tpu.mq.kafka.client as j_client
import seaweedfs_tpu.mq.kafka.codecs as j_codecs
import seaweedfs_tpu.mq.kafka.frame_pool as j_frame_pool
import seaweedfs_tpu.mq.kafka.gateway as j_gateway
import seaweedfs_tpu.mq.kafka.groups as j_groups
import seaweedfs_tpu.mq.kafka.protocol as j_protocol
import seaweedfs_tpu.mq.kafka.records as j_records
import seaweedfs_tpu.utils.metrics as j_metrics
import seaweedfs_tpu_torch.faults.registry as p_faults
import seaweedfs_tpu_torch.mq.broker as p_broker
import seaweedfs_tpu_torch.mq.group_commit as p_group_commit
import seaweedfs_tpu_torch.mq.kafka.client as p_client
import seaweedfs_tpu_torch.mq.kafka.codecs as p_codecs
import seaweedfs_tpu_torch.mq.kafka.frame_pool as p_frame_pool
import seaweedfs_tpu_torch.mq.kafka.gateway as p_gateway
import seaweedfs_tpu_torch.mq.kafka.groups as p_groups
import seaweedfs_tpu_torch.mq.kafka.protocol as p_protocol
import seaweedfs_tpu_torch.mq.kafka.records as p_records
import seaweedfs_tpu_torch.utils.metrics as p_metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

KAFKA = {
    "jax": types.SimpleNamespace(
        name="jax", server="seaweedfs_tpu.server", broker=j_broker, client=j_client,
        codecs=j_codecs, frame_pool=j_frame_pool, gateway=j_gateway, groups=j_groups,
        protocol=j_protocol, records=j_records, faults=j_faults, metrics=j_metrics,
        group_commit=j_group_commit),
    "port": types.SimpleNamespace(
        name="port", server="seaweedfs_tpu_torch.server", broker=p_broker, client=p_client,
        codecs=p_codecs, frame_pool=p_frame_pool, gateway=p_gateway, groups=p_groups,
        protocol=p_protocol, records=p_records, faults=p_faults, metrics=p_metrics,
        group_commit=p_group_commit),
}
CODECS = (0, 1, 2, 3, 4)  # none, gzip, snappy, lz4, zstd


@pytest.fixture(autouse=True)
def _cpu_parity(monkeypatch):
    # a durable-parity topic's stream runs on each package's native CPU
    # backend here
    monkeypatch.setenv("SEAWEED_EC_STREAM_BACKEND", "cpu")
    monkeypatch.delenv("SEAWEED_MQ_GROUP_COMMIT_MS", raising=False)
    p_faults.clear()
    yield
    p_faults.clear()


def records_of(rng, n: int, pkg, base: int = 0) -> list:
    """A seeded record set of `pkg`'s Record: keys null, empty or bytes,
    values null or bytes (some compressible), headers, timestamps."""
    out = []
    for i in range(n):
        kind = int(rng.integers(0, 4))
        key = None if kind == 0 else b"" if kind == 1 else rng.bytes(int(rng.integers(1, 40)))
        if rng.random() < 0.1:
            value = None
        elif rng.random() < 0.5:
            value = b"seaweed-" * int(rng.integers(1, 300))
        else:
            value = rng.bytes(int(rng.integers(0, 3000)))
        headers = [(f"h{j}", None if j == 2 else rng.bytes(j + 1))
                   for j in range(int(rng.integers(0, 4)))]
        out.append(pkg.records.Record(key=key, value=value,
                                      timestamp_ms=1_700_000_000_000 + int(rng.integers(0, 10**6)),
                                      offset=base + i, headers=headers))
    return out


def fields(recs) -> list:
    return [(r.key, r.value, r.timestamp_ms, r.offset, r.headers) for r in recs]


# ---------------------------------------------------------------- codecs


def test_protocol_writer_reader_and_varints_as_jax():
    rng = np.random.default_rng(31)
    ints = [int(v) for v in rng.integers(-(2**62), 2**62, size=200)] + [0, -1, 1, 150, 2**31]
    for v in ints:
        assert p_protocol.write_varint(v) == j_protocol.write_varint(v)
        assert p_protocol.write_uvarint(abs(v)) == j_protocol.write_uvarint(abs(v))
        assert p_protocol.Reader(j_protocol.write_varint(v)).varint() == v
    out = {}
    for name, kp in (("jax", j_protocol), ("port", p_protocol)):
        w = kp.Writer().i8(-3).i16(-300).i32(70_000).i64(-(2**40)).u32(2**31)
        w.string("é-topic").nullable_string(None).bytes_(b"\x00\xff").nullable_bytes(None)
        w.array([1, 2, 3], lambda ww, x: ww.i32(x)).uvarint(300)
        w.compact_string("c").compact_nullable_string(None).compact_bytes(b"cb")
        w.compact_nullable_bytes(None).compact_array([7], lambda ww, x: ww.i16(x)).tags()
        out[name] = w.done()
    assert out["port"] == out["jax"]
    r = p_protocol.Reader(out["jax"])
    assert (r.i8(), r.i16(), r.i32(), r.i64(), r.u32()) == (-3, -300, 70_000, -(2**40), 2**31)
    assert (r.string(), r.nullable_string(), r.bytes_(), r.nullable_bytes()) == (
        "é-topic", None, b"\x00\xff", None)
    assert r.array(r.i32) == [1, 2, 3] and r.uvarint() == 300
    assert (r.compact_string(), r.compact_nullable_string(), r.compact_bytes(),
            r.compact_nullable_bytes(), r.compact_array(r.i16)) == ("c", None, b"cb", None, [7])
    r.tagged_fields()
    assert r.remaining() == 0
    with pytest.raises(EOFError):
        p_protocol.Reader(b"\x00").i16()
    assert {k: getattr(p_protocol, k) for k in dir(j_protocol) if k.isupper()} == {
        k: getattr(j_protocol, k) for k in dir(j_protocol) if k.isupper()}


@pytest.mark.parametrize("codec", CODECS, ids=["none", "gzip", "snappy", "lz4", "zstd"])
def test_encode_batch_byte_identical_under_every_codec(codec, monkeypatch):
    # gzip writes the clock into its header: one pinned reading for both
    monkeypatch.setattr(gzip, "time", types.SimpleNamespace(time=lambda: 1_700_000_000.0))
    for seed in range(4):
        blobs = {}
        for name, pkg in KAFKA.items():
            recs = records_of(np.random.default_rng(seed), 40 + seed * 30, pkg, base=seed * 100)
            blobs[name] = pkg.records.encode_batch(recs, base_offset=seed * 100, compression=codec)
        assert blobs["port"] == blobs["jax"], (codec, seed)
        want = fields(records_of(np.random.default_rng(seed), 40 + seed * 30, KAFKA["jax"],
                                 base=seed * 100))
        # each package decodes the other's batches, a multi-batch blob and
        # a truncated trailing batch included
        for dec in KAFKA.values():
            assert fields(dec.records.decode_batches(blobs["jax"])) == want
            two = blobs["jax"] + blobs["port"][: len(blobs["port"]) // 2]
            assert fields(dec.records.decode_batches(two)) == want
    assert p_records.encode_batch([]) == j_records.encode_batch([]) == b""


def test_corrupt_and_unknown_batches_fail_alike():
    recs = records_of(np.random.default_rng(5), 10, KAFKA["port"])
    blob = bytearray(p_records.encode_batch(recs, compression=2))
    for pkg in KAFKA.values():
        bad = bytearray(blob)
        bad[-1] ^= 0xFF
        with pytest.raises(ValueError, match="CRC"):
            pkg.records.decode_batches(bytes(bad))
    # codec 5 does not exist: UnsupportedCompression in both; a corrupt
    # compressed payload under a valid CRC: ValueError in both
    post = bytes(blob[21:])
    for attrs, payload, exc in ((5, post[40:], "UnsupportedCompression"),
                                (2, b"\xff\xff\xff\xff\x0f", "ValueError")):
        new_post = struct.pack(">h", attrs) + post[2:40] + payload
        crc = p_records.crc32c(new_post)
        rebuilt = struct.pack(">qiib", 0, 9 + len(new_post), -1, 2) + struct.pack(">I", crc) + new_post
        for pkg in KAFKA.values():
            with pytest.raises(ValueError) as ei:
                pkg.records.decode_batches(rebuilt)
            assert type(ei.value).__name__ == exc


def test_codecs_as_jax():
    rng = np.random.default_rng(7)
    datas = [b"", b"a", rng.bytes(100), b"abc" * 5000, rng.bytes(70_000),
             (b"x" * 61 + rng.bytes(3)) * 2000]
    for data in datas:
        assert p_codecs.xxh32(data) == j_codecs.xxh32(data)
        assert p_codecs.xxh32(data, seed=9) == j_codecs.xxh32(data, seed=9)
        for comp, decomp in (("snappy_compress", "snappy_decompress"),
                             ("lz4_compress", "lz4_decompress"),
                             ("zstd_compress", "zstd_decompress")):
            jb, pb = getattr(j_codecs, comp)(data), getattr(p_codecs, comp)(data)
            assert pb == jb, comp
            assert getattr(p_codecs, decomp)(jb) == getattr(j_codecs, decomp)(pb) == data
    # xerial-framed snappy, as Java clients frame it
    block = j_codecs.snappy_compress(datas[3])
    xerial = b"\x82SNAPPY\x00" + b"\x00" * 8 + struct.pack(">i", len(block)) + block
    assert p_codecs.snappy_decompress(xerial) == j_codecs.snappy_decompress(xerial) == datas[3]
    # a block-linked LZ4 frame: block 2 is a match into block 1's output
    flg, bd = 0x40, 0x40
    frame = (struct.pack("<I", 0x184D2204) + bytes([flg, bd, (j_codecs.xxh32(bytes([flg, bd])) >> 8) & 0xFF])
             + struct.pack("<I", 9) + bytes([0x80]) + b"abcdefgh"
             + struct.pack("<I", 3) + bytes([0x00, 0x08, 0x00]) + struct.pack("<I", 0))
    assert p_codecs.lz4_decompress(frame) == j_codecs.lz4_decompress(frame) == b"abcdefghabcd"


def test_golden_vectors_of_the_jax_codec_tests_hold_in_the_port(monkeypatch):
    """The JAX tests/test_kafka.py codec vectors, their module globals
    pointed at the port's protocol and records."""
    for name in ("Reader", "write_varint"):
        monkeypatch.setattr(jk, name, getattr(p_protocol, name))
    for name in ("Record", "decode_batches", "encode_batch"):
        monkeypatch.setattr(jk, name, getattr(p_records, name))
    jk.test_zigzag_varint_golden_vectors()
    jk.test_record_batch_golden_layout()
    jk.test_record_batch_round_trip_and_crc()
    jk.test_gzip_compressed_batch_decodes()
    from seaweedfs_tpu_torch.utils.crc import crc32c

    assert crc32c(b"123456789") == 0xE3069283


# ------------------------------------------------------- golden transcripts


class Recording(jg.Session):
    """The JAX golden Session, keeping each response with the advertised
    ephemeral port masked."""

    def __init__(self, port: int):
        super().__init__(port)
        self.responses: list = []

    def _match(self, resp: bytes, expected) -> None:
        super()._match(resp, expected)
        masked, pos = bytearray(resp), 0
        for seg in expected:
            n = seg.n if isinstance(seg, jg.W) else len(seg)
            if isinstance(seg, jg.W) and seg is jg.PORT_W:
                masked[pos:pos + n] = b"\x00" * n
            pos += n
        self.responses.append(bytes(masked))


def pin_gateway(monkeypatch, pkg) -> None:
    """Member ids from a seeded uuid, the produce clock fixed."""
    rnd = np.random.default_rng(0)
    monkeypatch.setattr(pkg.groups, "uuid", types.SimpleNamespace(
        uuid4=lambda: uuid.UUID(bytes=rnd.bytes(16))))
    monkeypatch.setattr(pkg.gateway, "time", types.SimpleNamespace(
        time_ns=lambda: 1_700_000_000_123_000_000, monotonic=time.monotonic, sleep=time.sleep,
        time=time.time))


GOLDEN = ["test_api_versions_golden", "test_metadata_topic_lifecycle_golden",
          "test_produce_fetch_version_matrix_golden", "test_produce_v9_flexible_golden",
          "test_produce_compressed_codecs_golden", "test_group_cycle_golden",
          "test_list_offsets_golden", "test_error_paths_golden",
          "test_group_introspection_golden"]


@pytest.mark.parametrize("transcript", GOLDEN)
def test_golden_transcript_on_both_gateways(transcript, monkeypatch):
    got = {}
    for name, pkg in KAFKA.items():
        pin_gateway(monkeypatch, pkg)
        srv = pkg.broker.MqBrokerServer(ip="127.0.0.1", grpc_port=allocate_port(), kafka_port=0)
        srv.kafka.server.suggested_throttle_ms = lambda: 0  # the throttle pinned
        srv.start()
        sess = Recording(srv.kafka.port)
        try:
            getattr(jg, transcript)(sess)
        finally:
            sess.close()
            srv.stop()
        got[name] = sess.responses
    assert got["port"] == got["jax"] and got["jax"]


# --------------------------------------------------------------- scenarios

COMBOS = [("jax", "jax"), ("port", "port"), ("port", "jax"), ("jax", "port")]
COMBO_IDS = [f"gateway_{g}-client_{c}" for g, c in COMBOS]


def metric_value_in(metrics):
    """tests/test_kafka_pool.py's `_metric_value`, read from `metrics`'s
    registry."""
    def value(name: str, **labels) -> float:
        want = name
        if labels:
            want = f"{name}{{{','.join(f'{k}={chr(34)}{v}{chr(34)}' for k, v in sorted(labels.items()))}}}"
        for line in metrics.REGISTRY.render().decode().splitlines():
            if line.startswith(want + " "):
                return float(line.split()[-1])
        return 0.0
    return value


@pytest.fixture
def stack(request, monkeypatch):
    """(gateway package, client package), with the JAX test modules'
    globals pointed at them."""
    G, C = (KAFKA[n] for n in request.param)
    names = {
        "MqBrokerServer": G.broker.MqBrokerServer, "MqBroker": G.broker.MqBroker,
        "MqService": G.broker.MqService, "KafkaGateway": G.gateway.KafkaGateway,
        "faults": G.faults, "_native_mod": G.frame_pool._native_mod,
        "_metric_value": metric_value_in(G.metrics),
        "KafkaClient": C.client.KafkaClient, "KafkaError": C.client.KafkaError,
        "assign_range": C.client.assign_range, "parse_assignment": C.client.parse_assignment,
        "kp": C.protocol, "Reader": C.protocol.Reader, "Writer": C.protocol.Writer,
        "write_varint": C.protocol.write_varint, "Record": C.records.Record,
        "encode_batch": C.records.encode_batch, "decode_batches": C.records.decode_batches,
    }
    for mod in (jk, jp):
        for name, value in names.items():
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, value)
    return G, C


KAFKA_SCENARIOS = ["test_api_versions_and_unsupported_fallback",
                   "test_metadata_auto_create_and_create_topics", "test_produce_fetch_round_trip",
                   "test_tombstones_and_empty_values_survive",
                   "test_fetch_partition_max_bytes_truncates",
                   "test_fetch_long_poll_wakes_on_produce",
                   "test_list_offsets_and_committed_offsets",
                   "test_consumer_group_rebalance_two_members",
                   "test_compressed_produce_all_codecs", "test_produce_version_matrix",
                   "test_xerial_snappy_produce"]


@pytest.mark.parametrize("scenario", KAFKA_SCENARIOS)
@pytest.mark.parametrize("stack", COMBOS, indirect=True, ids=COMBO_IDS)
def test_gateway_scenario(stack, scenario):
    G, _ = stack
    srv = G.broker.MqBrokerServer(ip="127.0.0.1", grpc_port=allocate_port(), kafka_port=0)
    srv.start()
    try:
        getattr(jk, scenario)(srv)
    finally:
        srv.stop()


POOL_SCENARIOS = ["test_oversized_length_prefix_closes_before_allocation",
                  "test_mid_frame_death_is_bounded", "test_32_clients_cross_connection_correctness",
                  "test_status_http_plane"]


@pytest.mark.parametrize("scenario", POOL_SCENARIOS)
@pytest.mark.parametrize("stack", COMBOS, indirect=True, ids=COMBO_IDS)
def test_pool_scenario(stack, scenario):
    G, _ = stack
    srv = G.broker.MqBrokerServer(ip="localhost", grpc_port=allocate_port(), kafka_port=0)
    srv.start()
    try:
        getattr(jp, scenario)(srv)
    finally:
        srv.stop()


@pytest.mark.parametrize("scenario", ["test_saturation_rejects_are_well_formed",
                                      "test_fetch_spool_bit_identical_across_planes"])
@pytest.mark.parametrize("stack", COMBOS, indirect=True, ids=COMBO_IDS)
def test_pool_scenario_with_its_own_gateway(stack, scenario, monkeypatch):
    getattr(jp, scenario)(monkeypatch)


def _reject_answers(pkg, monkeypatch) -> list:
    """The raw frames a saturated gateway of `pkg` answers a produce v3, a
    fetch v4 and a metadata v1 with, and the state it leaves."""
    monkeypatch.setenv("SEAWEED_MQ_KAFKA_QUEUE", "0")
    broker = pkg.broker.MqBroker()
    broker.configure_topic("kafka", "sat", 1)
    gw = pkg.gateway.KafkaGateway(broker, port=0, workers=1)
    gw.start()
    holder = p_client.KafkaClient("localhost", gw.port)
    out = []
    try:
        wait_for(lambda: gw.pool_status()["open_connections"] >= 1, timeout=5,
                 msg="the holder admitted")
        blob = p_records.encode_batch([p_records.Record(key=b"k", value=b"v", timestamp_ms=5)])
        for api, ver, body in ((0, 3, jp._produce_v3_body("sat", 0, blob)),
                               (1, 4, jp._fetch_v4_body("sat", 0, 0)),
                               (3, 1, struct.pack(">i", 1) + b"\x00\x03sat")):
            s = socket.create_connection(("localhost", gw.port), timeout=10)
            frame = struct.pack(">hhi", api, ver, 7) + b"\x00\x03raw" + body
            s.sendall(struct.pack(">i", len(frame)) + frame)
            (n,) = struct.unpack(">i", jp._recv_exact(s, 4))
            # the advertised ephemeral port masked (metadata names it)
            out.append(jp._recv_exact(s, n).replace(struct.pack(">i", gw.port), b"PORT"))
            assert s.recv(1) == b""  # closed after the reject
            s.close()
        st = gw.pool_status()
        out.append((broker.topic("kafka", "sat").logs[0].next_offset, st["rejected_total"],
                    st["max_connections"]))
    finally:
        holder.close()
        gw.stop()
        broker.close()
    return out


def test_saturation_rejects_carry_the_same_bytes(monkeypatch):
    got = {name: _reject_answers(pkg, monkeypatch) for name, pkg in KAFKA.items()}
    assert got["port"] == got["jax"]
    assert got["jax"][-1] == (0, 3, 1)


def _spooled(pkg) -> tuple:
    """A sealed partition of `pkg`'s gateway drained through the spool:
    the records fetched, the spool's batch files and its status."""
    srv = pkg.broker.MqBrokerServer(ip="localhost", grpc_port=allocate_port(), kafka_port=0,
                                    segment_records=64)
    srv.start()
    try:
        c = p_client.KafkaClient("localhost", srv.kafka.port)
        c.create_topic("sealed", partitions=1)
        plog = srv.broker.topic("kafka", "sealed").logs[0]
        segs: dict = {}
        plog._spill = segs.__setitem__
        plog._load = segs.get
        rng = np.random.default_rng(11)
        for i in range(0, 200, 8):
            c.produce("sealed", 0, [p_records.Record(key=b"k%03d" % j, value=rng.bytes(300),
                                                     timestamp_ms=1_700_000_000_000 + j)
                                    for j in range(i, i + 8)])
        got, off = [], 0
        while off < 200:
            _hw, recs = c.fetch("sealed", 0, off, max_wait_ms=0, max_bytes=1 << 22)
            got += fields(recs)
            off = recs[-1].offset + 1
        c.close()
        spool = srv.kafka.spool
        files = {os.path.basename(e.path): open(e.path, "rb").read()
                 for e in spool._entries.values()}
        return got, files, {k: v for k, v in spool.status().items() if k != "cap_bytes"}
    finally:
        srv.stop()


def test_fetch_spool_batches_byte_identical_across_packages():
    got = {name: _spooled(pkg) for name, pkg in KAFKA.items()}
    assert got["port"] == got["jax"]
    recs, files, status = got["port"]
    assert [r[3] for r in recs] == list(range(200))
    assert sorted(files) == [f"sealed-0-{s}.batch" for s in range(3)]
    assert status["builds"] == 3 and status["entries"] == 3


def test_load_score_and_status_as_jax():
    """`load_score` adds the gateway's pool pressure to the parity backlog
    by the same formula, and /status carries the same `kafka_pool` keys,
    in both packages."""
    out = {}
    for name, pkg in KAFKA.items():
        srv = pkg.broker.MqBrokerServer(ip="127.0.0.1", grpc_port=allocate_port(), kafka_port=0,
                                        status_port=0)
        srv.start()
        try:
            c = p_client.KafkaClient("127.0.0.1", srv.kafka.port)
            c.create_topic("obs", partitions=2)
            c.produce("obs", 0, [p_records.Record(key=b"k", value=b"v")])
            with urllib.request.urlopen(f"http://127.0.0.1:{srv.status_port}/status") as r:
                st = json.loads(r.read())
            idle = srv.load_score()  # one connection open of 80 slots
            c.close()
            srv.kafka.pool_status = lambda: {"workers": 4, "ready_backlog": 6,
                                             "max_connections": 10, "open_connections": 5}
            pressed = srv.load_score()
            srv.kafka.pool_status = lambda: 1 / 0
            broken = srv.load_score()
        finally:
            srv.stop()
        pool = st.pop("kafka_pool")
        out[name] = (sorted(st), sorted(pool), pool["kind"], pool["fetch_spool"]["builds"],
                     idle, pressed, broken)
    assert out["port"] == out["jax"]
    assert out["port"][4:] == (1 / 80, 1.5 + 0.5, 0.0)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_launched_broker_serves_kafka_by_name(tmp_path, pkg):
    """`mq.broker -kafkaPort 0` by name: the ephemeral port from the
    launcher's log line, a topic created, produced to and fetched back
    by the package's own client and the other's, exit 0 on SIGTERM."""
    env = dict(os.environ, PYTHONPATH=REPO, HOME=str(tmp_path))
    proc = subprocess.Popen([sys.executable, "-m", KAFKA[pkg].server, "mq.broker", "-ip",
                             "127.0.0.1", "-port", str(allocate_port()), "-kafkaPort", "0"],
                            cwd=str(tmp_path), env=env, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)
    lines: list = []
    reader = threading.Thread(target=lambda: lines.extend(proc.stderr), daemon=True)
    reader.start()
    try:
        def logged():
            assert proc.poll() is None, "".join(lines)
            return re.search(r"kafka on :(\d+)", "".join(lines))

        wait_for(logged, timeout=60, msg="the launched broker's kafka port")
        kport = int(logged().group(1))
        for name, other in KAFKA.items():
            c = other.client.KafkaClient("127.0.0.1", kport)
            topic = f"by-{name}"
            assert c.create_topic(topic, partitions=2) == 0
            assert c.produce(topic, 1, [other.records.Record(key=b"k", value=b"live")]) == 0
            hw, recs = c.fetch(topic, 1, 0)
            assert hw == 1 and [(r.key, r.value) for r in recs] == [(b"k", b"live")]
            c.close()
    finally:
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=30)
        reader.join(timeout=10)
    assert rc == 0, "".join(lines)
