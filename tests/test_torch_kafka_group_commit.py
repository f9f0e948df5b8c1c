"""PyTorch port: the broker's group commit (mq/group_commit.py,
`MqBroker.group_committer()`) under the Kafka gateway's durable produce,
held against the JAX package on the CPU.

- A broker is SIGKILLed in a crash child inside a group-commit window
  (`mq.produce.before_flush`, the 1st and the 4th window) while one Kafka
  client produces acked records; the child writes each acked index to an
  fsynced file. The port child runs its parity stream on the plain torch
  version of the card's kernel (`TorchBackend(device="cpu")`), the JAX
  child on its CPU backend. A port broker and a JAX broker, each on its
  own copy of the parity directory, replay the same dense, byte-exact
  prefix, which holds every acked record: what was acked is replayable,
  and what was not leaves no torn record.
- A window whose flush fails fails its whole cohort: three producers in
  one window each get KAFKA_STORAGE_ERROR, the next window commits, and
  the offsets go on dense, in both packages; the JAX test of it runs on
  the four gateway and client stacks.
- The committer follows SEAWEED_MQ_GROUP_COMMIT_MS live, as the JAX
  broker's does.
"""

import os
import shutil
import subprocess
import sys
import threading
import time

import pytest
from conftest import allocate_port
from test_torch_kafka import COMBO_IDS, COMBOS, KAFKA, stack  # noqa: F401 - the fixture

import test_kafka_pool as jp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT_S = 120
RECORDS = 500


def _msg(i: int) -> tuple:
    return b"key-%06d" % i, (b"val-%06d-" % i) * 8


@pytest.fixture(autouse=True)
def _cpu_parity(monkeypatch):
    monkeypatch.setenv("SEAWEED_EC_STREAM_BACKEND", "cpu")
    monkeypatch.delenv("SEAWEED_MQ_GROUP_COMMIT_MS", raising=False)
    for pkg in KAFKA.values():
        pkg.faults.clear()
    yield
    for pkg in KAFKA.values():
        pkg.faults.clear()


_CRASH_CHILD = r"""
import importlib, os, sys
pkg, pdir, acked_path, window, gport = sys.argv[1:6]
os.environ["SEAWEED_MQ_GROUP_COMMIT_MS"] = "10"
faults = importlib.import_module(pkg + ".faults.registry")
broker = importlib.import_module(pkg + ".mq.broker")
client = importlib.import_module(pkg + ".mq.kafka.client")
records = importlib.import_module(pkg + ".mq.kafka.records")
if pkg == "seaweedfs_tpu_torch":
    # the parity stream on the plain torch version of the card's kernel
    from seaweedfs_tpu_torch.ec import ECContext, TorchBackend
    import seaweedfs_tpu_torch.mq.stream_parity as sp
    sp.get_backend = lambda name, k, m: TorchBackend(ECContext(k, m), device="cpu")
else:
    os.environ["SEAWEED_EC_STREAM_BACKEND"] = "cpu"
faults.inject("mq.produce.before_flush", faults.hard_exit(137), when=faults.nth_call(int(window)))
srv = broker.MqBrokerServer(ip="127.0.0.1", grpc_port=int(gport), kafka_port=0, parity_dir=pdir)
srv.start()
c = client.KafkaClient("127.0.0.1", srv.kafka.port)
c.create_topic("gc", partitions=1)
acked = open(acked_path, "w")
for i in range(%d):
    key, value = b"key-%%06d" %% i, (b"val-%%06d-" %% i) * 8
    c.produce("gc", 0, [records.Record(key=key, value=value, timestamp_ms=1_700_000_000_000 + i)],
              acks=-1)
    # the ack certified durability: record it crash-consistently
    acked.write(f"{i}\n")
    acked.flush()
    os.fsync(acked.fileno())
os._exit(3)  # the armed window never fired
""" % RECORDS


def _replay(pkg, pdir: str) -> tuple:
    br = pkg.broker.MqBroker(parity_dir=pdir)
    try:
        plog = br.topic("kafka", "gc").logs[0]
        recs = plog.read_from(0, max_records=10_000)
        return recs, plog.append(7, b"\x01post", b"\x01crash")
    finally:
        br.close()


@pytest.mark.parametrize("window", [1, 4])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_killed_in_a_window_acked_replays_unacked_clean(tmp_path, writer, window):
    pdir, acked_file = tmp_path / "parity", tmp_path / "acked"
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", _CRASH_CHILD, KAFKA[writer].server.rsplit(".", 1)[0], str(pdir),
         str(acked_file), str(window), str(allocate_port())],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=CHILD_TIMEOUT_S)
    assert proc.returncode == 137, proc.stdout + proc.stderr
    lines = acked_file.read_text().split() if acked_file.exists() else []
    acked = int(lines[-1]) if lines else -1
    shutil.copytree(pdir, tmp_path / "copy")
    got = {"port": _replay(KAFKA["port"], str(pdir)),
           "jax": _replay(KAFKA["jax"], str(tmp_path / "copy"))}
    assert got["port"] == got["jax"]
    recs, nxt = got["port"]
    unpack = KAFKA["port"].gateway._unpack_null
    assert [(o, ts, unpack(k), unpack(v)) for o, ts, k, v in recs] == [
        (n, (1_700_000_000_000 + n) * 1_000_000, *_msg(n)) for n in range(len(recs))]
    # acked => replayable; the first window's kill leaves nothing acked
    assert len(recs) >= acked + 1 and nxt == len(recs)
    assert (acked == -1) == (window == 1)


def _cohort(pkg, pdir: str) -> tuple:
    """Three producers inside one 300 ms window whose flush fails, then a
    producer in the next window."""
    srv = pkg.broker.MqBrokerServer(ip="127.0.0.1", grpc_port=allocate_port(), kafka_port=0,
                                    parity_dir=pdir)
    srv.start()
    clients = [pkg.client.KafkaClient("127.0.0.1", srv.kafka.port) for _ in range(3)]
    try:
        clients[0].create_topic("cohort", partitions=3)
        clients[0].produce("cohort", 0, [pkg.records.Record(key=b"warm", value=b"up")])
        errs: list = [None] * 3
        gate = threading.Barrier(3)

        def produce(i: int) -> None:
            gate.wait()
            try:
                clients[i].produce("cohort", i, [pkg.records.Record(key=b"k", value=b"v%d" % i)])
            except pkg.client.KafkaError as e:
                errs[i] = e.code

        with pkg.faults.injected("mq.produce.before_flush", pkg.faults.io_error(), count=1):
            threads = [threading.Thread(target=produce, args=(i,)) for i in range(3)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
        after = clients[0].produce("cohort", 0, [pkg.records.Record(key=b"k2", value=b"v2")])
        _hw, recs = clients[0].fetch("cohort", 0, 0)
        return errs, after, [(r.offset, r.key, r.value) for r in recs]
    finally:
        for c in clients:
            c.close()
        srv.stop()


def test_a_failed_window_fails_its_whole_cohort(tmp_path, monkeypatch):
    monkeypatch.setenv("SEAWEED_MQ_GROUP_COMMIT_MS", "300")
    got = {name: _cohort(pkg, str(tmp_path / name)) for name, pkg in KAFKA.items()}
    assert got["port"] == got["jax"]
    errs, after, recs = got["port"]
    assert errs == [56] * 3  # KAFKA_STORAGE_ERROR, every producer of the window
    # the failed cohort's records were appended, only not certified
    assert after == 2 and recs == [(0, b"warm", b"up"), (1, b"k", b"v0"), (2, b"k2", b"v2")]


@pytest.mark.parametrize("stack", COMBOS, indirect=True, ids=COMBO_IDS)
def test_failed_window_scenario(stack, tmp_path, monkeypatch):
    jp.test_group_commit_failed_window_fails_cohort(tmp_path, monkeypatch)


def test_the_committer_follows_the_knob_as_jax(monkeypatch):
    out = {}
    for name, pkg in KAFKA.items():
        br = pkg.broker.MqBroker()
        seen = []
        monkeypatch.delenv("SEAWEED_MQ_GROUP_COMMIT_MS", raising=False)
        seen.append(br.group_committer())
        for ms in ("10", "10", "25", "junk", "-5", "0"):
            monkeypatch.setenv("SEAWEED_MQ_GROUP_COMMIT_MS", ms)
            seen.append(pkg.group_commit.group_commit_window_s())
            c = br.group_committer()
            seen.append(None if c is None else (c.window_s, id(c)))
        monkeypatch.setenv("SEAWEED_MQ_GROUP_COMMIT_MS", "5")
        c = br.group_committer()
        t0 = time.monotonic()
        c.wait_durable()  # no dirty stream: an empty window
        took = time.monotonic() - t0
        br.close()
        assert br._mq_committer is None and not c._thread.is_alive()
        ids = {}
        out[name] = ([s if not isinstance(s, tuple) else (s[0], ids.setdefault(s[1], len(ids)))
                      for s in seen], c.windows_committed, took < 2.0)
    assert out["port"] == out["jax"]
    assert out["port"][0] == [None, 0.01, (0.01, 0), 0.01, (0.01, 0), 0.025, (0.025, 1), 0.0, None,
                              0.0, None, 0.0, None]
    assert out["port"][1:] == (1, True)
