"""PyTorch port: a broker's durable-parity topics (mq/broker.py's
`_attach_parity`, `_recover_parity_only`, `parity_sweep`,
`parity_status`, `load_score` and stream_parity's `ParityFlusher`) held
against the JAX package on the CPU.

The broker-level scenarios of the JAX tests/test_mq_stream_parity.py run
on a JAX broker and on a port broker, with small stripes and a tight lag
deadline as there (16 KiB blocks, 4 KiB small blocks, 40 ms) and
SEAWEED_EC_STREAM_BACKEND=cpu: the port's partitions run its native
`CpuBackend`, the JAX package's its own. What each broker answers and
what a restarted broker replays must be equal, tolerance 0. Also: a
broker killed in a child at each `ec.stream.*` crash window, recovered by
both packages to the same dense prefix; parity directories written by one
package's broker and recovered by the other's.
"""

import os
import pathlib
import shutil
import subprocess
import sys
import time

import pytest
from conftest import allocate_port
from torch_mq_twins import PKGS

from seaweedfs_tpu_torch import faults as port_faults
from seaweedfs_tpu_torch.ec import ECContext, TorchBackend, recover_stream
from seaweedfs_tpu_torch.ec.stream_encode import load_stream_journal
from seaweedfs_tpu_torch.mq import stream_parity as port_sp

REPO = pathlib.Path(__file__).resolve().parent.parent
CHILD_TIMEOUT_S = 90


@pytest.fixture(autouse=True)
def _small_stripes(monkeypatch):
    monkeypatch.setenv("SEAWEED_EC_STREAM_BLOCK_KB", "16")
    monkeypatch.setenv("SEAWEED_EC_STREAM_SMALL_KB", "4")
    monkeypatch.setenv("SEAWEED_EC_STREAM_MAX_LAG_MS", "40")
    monkeypatch.setenv("SEAWEED_EC_STREAM_BACKEND", "cpu")
    monkeypatch.delenv("SEAWEED_EC_STREAM_REMOTE_ROOTS", raising=False)
    port_faults.clear()
    yield
    port_faults.clear()


def _msg(i: int) -> tuple[bytes, bytes]:
    return (b"k%06d" % i, b"value-%06d-" % i + b"x" * (900 + i % 191))


def _drain(broker, ns="default", topic="t", timeout=8.0):
    st = broker.topic(ns, topic)
    deadline = time.time() + timeout
    while time.time() < deadline:
        if all(p.pending_bytes() == 0 for p in st.parity.values()):
            return
        time.sleep(0.02)
    raise AssertionError(f"parity flusher never drained: {broker.parity_status()}")


def _gens(part_dir: str) -> list:
    return sorted({int(n[len(port_sp.GEN_PREFIX):].split(".", 1)[0])
                   for n in os.listdir(part_dir) if n.startswith(port_sp.GEN_PREFIX)})


def on_both(fn, tmp_path, *args) -> object:
    out = {}
    for name, pkg in PKGS.items():
        (tmp_path / name).mkdir()
        out[name] = fn(pkg, str(tmp_path / name / "parity"), *args)
    assert out["port"] == out["jax"]
    return out["port"]


def sc_lag_and_replay(pkg, pdir):
    br = pkg.broker.MqBroker(parity_dir=pdir)
    br.configure_topic("default", "t", 2)
    st = br.topic("default", "t")
    out = [st.durable_parity, sorted(st.parity)]
    for i in range(400):
        st.logs[i % 2].append(1_000_000 + i, *_msg(i))
    _drain(br)
    # the lag is a clock reading: its shape is compared, not its value
    status = {t: {p: (sorted(v), v["pending_bytes"], isinstance(v["parity_lag_ms"], float))
                  for p, v in parts.items()} for t, parts in br.parity_status().items()}
    out += [status, br.load_score(), type(br._parity_flusher).__name__]
    br.close()
    br2 = pkg.broker.MqBroker(parity_dir=pdir)
    st2 = br2.topic("default", "t")
    out.append(st2.partition_count)
    for part in (0, 1):
        out.append(st2.logs[part].read_from(0, max_records=1000))
        out.append(st2.logs[part].append(5, b"post", b"restart"))
    br2.close()
    return out


def test_durable_parity_bounded_lag_and_restart_replay_as_jax(tmp_path):
    out = on_both(sc_lag_and_replay, tmp_path)
    assert out[:2] == [True, [0, 1]] and out[3] == 0.0 and out[4] == "ParityFlusher"
    assert out[2] == {"default/t": {p: (["parity_lag_ms", "pending_bytes"], 0, True)
                                    for p in (0, 1)}}
    for part in (0, 1):
        recs = out[6 + 2 * part]
        assert [(ts, k, v) for _o, ts, k, v in recs] == [
            (1_000_000 + i, *_msg(i)) for i in range(400) if i % 2 == part]
        assert out[7 + 2 * part] == recs[-1][0] + 1


def sc_parity_off(pkg, pdir):
    br = pkg.broker.MqBroker()
    br.configure_topic("default", "t", 1, durable_parity=True)
    out = [dict(br.topic("default", "t").parity), br.load_score(), br.parity_status()]
    br.close()
    br2 = pkg.broker.MqBroker(parity_dir=pdir)
    br2.configure_topic("default", "plain", 1, durable_parity=False)
    br2.configure_topic("default", "dp", 1)
    out += [bool(br2.topic("default", "plain").parity), bool(br2.topic("default", "dp").parity),
            sorted(os.listdir(os.path.join(pdir, "default")))]
    br2.close()
    return out


def test_parity_off_topic_and_no_parity_dir_as_jax(tmp_path):
    assert on_both(sc_parity_off, tmp_path) == [{}, 0.0, {}, False, True, ["dp"]]


def sc_delete(pkg, pdir):
    br = pkg.broker.MqBroker(parity_dir=pdir)
    br.configure_topic("default", "t", 1)
    br.topic("default", "t").logs[0].append(1, b"k", b"v")
    br.flush()
    out = [os.path.isdir(os.path.join(pdir, "default", "t"))]
    br.delete_topic("default", "t")
    out.append(os.path.exists(os.path.join(pdir, "default", "t")))
    br2 = pkg.broker.MqBroker(parity_dir=pdir)
    with pytest.raises(KeyError) as e:
        br2.topic("default", "t")
    out.append(str(e.value))
    br2.close()
    br.close()
    return out


def test_delete_topic_removes_parity_dir_as_jax(tmp_path):
    assert on_both(sc_delete, tmp_path) == [True, False, "'topic default/t not configured'"]


def sc_rotation(pkg, pdir):
    br = pkg.broker.MqBroker(parity_dir=pdir, segment_records=64)
    br.configure_topic("default", "t", 1)
    st = br.topic("default", "t")
    payload = b"p" * 4096
    for i in range(350):
        st.logs[0].append(i, b"k%d" % i, payload)
    _drain(br)
    st.parity[0].flush()
    for i in range(350, 700):
        st.logs[0].append(i, b"k%d" % i, payload)
    _drain(br)
    st.parity[0].flush()
    br.parity_sweep()
    kept = _gens(os.path.join(pdir, "default", "t", "0000"))
    br.close()
    br2 = pkg.broker.MqBroker(parity_dir=pdir)
    recs = br2.topic("default", "t").logs[0].read_from(0, max_records=10_000)
    br2.close()
    return kept, recs


def test_generation_rotation_and_prune_as_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("SEAWEED_EC_STREAM_ROTATE_MB", "1")
    kept, recs = on_both(sc_rotation, tmp_path)
    assert kept and kept[0] >= 1
    offs = [r[0] for r in recs]
    assert offs == list(range(offs[0], offs[0] + len(offs))) and offs[-1] == 699
    assert all(r[3] == b"p" * 4096 for r in recs)


def sc_grpc_field(pkg, pdir):
    srv = pkg.broker.MqBrokerServer(ip="127.0.0.1", grpc_port=allocate_port(), parity_dir=pdir)
    srv.start()
    c = pkg.mq.MqClient(f"127.0.0.1:{srv.grpc_port}")
    try:
        c.configure_topic("on-default", partitions=1)
        c.configure_topic("forced-off", partitions=1, durable_parity=False)
        c.configure_topic("forced-on", partitions=1, durable_parity=True)
        topics = srv.broker._topics
        out = [topics[("default", n)].durable_parity
               for n in ("on-default", "forced-off", "forced-on")]
        c.publish("forced-off", b"v", key=b"k")
        c.publish("forced-on", b"v", key=b"k")
        srv.broker.parity_sweep()
        out.append(sorted(srv.broker.parity_status()))
        return out
    finally:
        c.close()
        srv.stop()


def test_configure_topic_grpc_durable_parity_field_as_jax(tmp_path):
    assert on_both(sc_grpc_field, tmp_path) == [
        True, False, True, ["default/forced-on", "default/on-default"]]


def test_debug_kernels_counts_the_streams_dispatches(tmp_path, monkeypatch):
    """The port broker's `/debug/kernels` reports every parity batch its
    streams dispatched (one `gf2_apply` launch each on the card), so the
    launches of a broker child can be held to its flushes; a restart's
    replay applies per stripe outside that count."""
    from seaweedfs_tpu_torch.ec.stream_encode import EcStreamEncoder

    dispatch, counted = EcStreamEncoder._dispatch_apply, [0]

    def counted_apply(self, coeffs, batch):
        counted[0] += 1
        return dispatch(self, coeffs, batch)

    monkeypatch.setattr(EcStreamEncoder, "_dispatch_apply", counted_apply)
    pkg, pdir = PKGS["port"], str(tmp_path / "parity")
    srv = pkg.broker.MqBrokerServer(ip="127.0.0.1", grpc_port=allocate_port(), parity_dir=pdir)
    before = srv.kernels()["stream_dispatches"]
    srv.broker.configure_topic("default", "t", 2)
    st = srv.broker.topic("default", "t")
    for i in range(300):
        st.logs[i % 2].append(1_000_000 + i, *_msg(i))
    _drain(srv.broker)
    srv.broker.close()
    assert counted[0] >= 2
    assert srv.kernels()["stream_dispatches"] - before == counted[0]
    # the replay of the unsealed tail dispatches nothing through the streams
    br2 = pkg.broker.MqBroker(parity_dir=pdir)
    mark = srv.kernels()["stream_dispatches"]
    assert len(br2.topic("default", "t").logs[0].read_from(0, max_records=1000)) == 150
    assert srv.kernels()["stream_dispatches"] == mark and counted[0] == mark - before
    br2.close()


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_parity_written_by_one_broker_replays_in_the_other(tmp_path, writer, reader):
    """A memory-only broker of one package takes records and closes; a
    broker of the other package recovers every topic and record from the
    parity directory alone, and takes the next offset."""
    pdir = str(tmp_path / "parity")
    br = PKGS[writer].broker.MqBroker(parity_dir=pdir)
    br.configure_topic("default", "x", 3)
    br.configure_topic("ns2", "y", 1)
    st = br.topic("default", "x")
    for i in range(300):
        st.logs[i % 3].append(1_000_000 + i, *_msg(i))
    br.topic("ns2", "y").logs[0].append(9, b"only", b"one")
    br.close()
    shutil.copytree(pdir, tmp_path / "copy")
    got = {}
    for name, d in ((reader, pdir), (writer, str(tmp_path / "copy"))):
        br2 = PKGS[name].broker.MqBroker(parity_dir=d)
        got[name] = [br2.list_topics()] + [
            br2.topic("default", "x").logs[p].read_from(0, max_records=1000) for p in range(3)
        ] + [br2.topic("ns2", "y").logs[0].read_from(0), br2.topic("ns2", "y").logs[0].append(
            1, b"", b"next")]
        br2.close()
    assert got[reader] == got[writer]
    assert got[reader][0] == [("default", "x", 3), ("ns2", "y", 1)]
    assert [len(got[reader][1 + p]) for p in range(3)] == [100, 100, 100]
    assert got[reader][-1] == 1


# -------------------------------------------------------------- crashes

_BROKER_CRASH_CHILD = r"""
import importlib, os, sys
pkg, root, point, nth, n = sys.argv[1:6]
faults = importlib.import_module(pkg + ".faults")
broker = importlib.import_module(pkg + ".mq.broker")
faults.inject(point, faults.hard_exit(137), when=faults.nth_call(int(nth)))
br = broker.MqBroker(parity_dir=root)
br.configure_topic("default", "t", 1)
st = br.topic("default", "t")
parity = st.parity[0]
for i in range(int(n)):
    key, value = b"k%06d" % i, b"value-%06d-" % i + b"x" * (900 + i % 191)
    st.logs[0].append(1_000_000 + i, key, value)
    parity.flush()
    print("flushed", i + 1, flush=True)
os._exit(3)  # the armed point never fired
"""

# point -> the arrival it kills at, as tests/test_torch_mq_parity.py sets them
CRASH_POINTS = {"ec.stream.seal": 2, "ec.stream.before_fsync": 50, "ec.stream.before_journal": 50}


@pytest.mark.parametrize("point", list(CRASH_POINTS))
def test_broker_killed_at_each_window_recovers_as_jax(tmp_path, point):
    """A port broker is killed in a child inside a crash window; a port
    broker and a JAX broker (on a copy) replay the same dense, byte-exact
    prefix, reaching the last flush the child completed, no retained
    generation's parity disagrees with its data, and appends go on dense."""
    root = tmp_path / "parity"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", _BROKER_CRASH_CHILD, "seaweedfs_tpu_torch", str(root), point,
         str(CRASH_POINTS[point]), "300"],
        cwd=str(REPO), env=env, capture_output=True, text=True, timeout=CHILD_TIMEOUT_S)
    assert proc.returncode == 137, proc.stdout + proc.stderr
    flushed = [int(ln.split()[1]) for ln in proc.stdout.splitlines() if ln.startswith("flushed")]
    assert flushed, proc.stdout
    shutil.copytree(root, tmp_path / "copy")
    got = {}
    for name, d in (("port", root), ("jax", tmp_path / "copy")):
        br = PKGS[name].broker.MqBroker(parity_dir=str(d))
        st = br.topic("default", "t")
        recs = st.logs[0].read_from(0, max_records=1000)
        got[name] = recs, st.logs[0].append(7, b"post", b"crash")
        br.close()
    assert got["port"] == got["jax"]
    recs, nxt = got["port"]
    assert [(o, ts, k, v) for o, ts, k, v in recs] == [
        (n, 1_000_000 + n, *_msg(n)) for n in range(len(recs))]
    assert len(recs) >= flushed[-1] and nxt == len(recs)
    d = root / "default" / "t" / "0000"
    ctx = ECContext(4, 2)
    be = TorchBackend(ctx, device="cpu")
    checked = 0
    for g in _gens(str(d)):
        base = str(d / f"gen-{g:08d}")
        j = load_stream_journal(base)
        if j is None:
            continue
        again = recover_stream(base, ctx, be, frame_scan=port_sp.dense_frame_scan(j.meta))
        if again is not None:
            assert again.parity_rewritten == 0
            checked += 1
    assert checked >= 1
