"""PyTorch port: the fault registry (seaweedfs_tpu_torch.faults) held
against the JAX package's (seaweedfs_tpu.faults).

Each case arms the same trigger and action, with the same seeds, in
both packages and drives the same arrivals through the same point:
the firing sequence, what each arrival raised or slept, and the bytes
each mutation returned must be identical (exact). The two registries
are separate: a point armed in one package never fires in the other.

The rebuild chaos cases of tests/test_ec_chaos.py (a sibling read and a
rebuilt row bit-flipped mid-rebuild) run through each package's rebuild
under its own registry with the same seeds: both must fail closed the
same way, publish nothing and leak no temp, and a clean retry must give
the same bytes.
"""

import os
import pathlib
import shutil
import subprocess
import sys

import pytest

from seaweedfs_tpu import faults as jax_faults
from seaweedfs_tpu.ec import CpuBackend as JaxCpuBackend
from seaweedfs_tpu.ec import ECContext as JaxECContext
from seaweedfs_tpu.ec import ECError as JaxECError
from seaweedfs_tpu.ec import ec_encode_volume as jax_ec_encode_volume
from seaweedfs_tpu.ec import rebuild_ec_files as jax_rebuild_ec_files
from seaweedfs_tpu_torch import faults as port_faults
from seaweedfs_tpu_torch.ec import CpuBackend, ECContext, ECError, TorchBackend, rebuild_ec_files
from test_ec_chaos import make_volume

REPO = pathlib.Path(__file__).resolve().parent.parent
POINT = "ec.volume.shard_read"
PAYLOAD = bytes(range(256)) * 3 + b"tail"
ARRIVALS = 40


@pytest.fixture(autouse=True)
def _clear_both_registries():
    jax_faults.clear()
    port_faults.clear()
    yield
    jax_faults.clear()
    port_faults.clear()


TRIGGERS = {
    "always": lambda F: F.always(),
    "nth_call": lambda F: F.nth_call(3),
    "every": lambda F: F.every(4),
    "probability": lambda F: F.probability(0.3, seed=5),
}

ACTIONS = {
    "io_error": lambda F, slept: F.io_error("disk gone"),
    "latency": lambda F, slept: F.latency(0.25, sleep=slept.append),
    "crash": lambda F, slept: F.crash("power cut"),
    "bit_flip": lambda F, slept: F.bit_flip(seed=7, flips=3),
    "truncate": lambda F, slept: F.truncate(0.25),
    "zero_fill": lambda F, slept: F.zero_fill(),
}


def _drive(F, trigger, action, count=None):
    """Arm one fault at POINT and run ARRIVALS arrivals through it;
    returns (per-arrival outcomes, fired, hits, counters, sleeps)."""
    slept = []
    h = F.inject(POINT, ACTIONS[action](F, slept), when=TRIGGERS[trigger](F), count=count)
    outcomes = []
    for i in range(ARRIVALS):
        try:
            if h._fault.mutates:
                outcomes.append(F.mutate(POINT, PAYLOAD, shard=i))
            else:
                F.fire(POINT, shard=i)
                outcomes.append("ok")
        except BaseException as e:  # InjectedCrash is a BaseException by design
            outcomes.append((type(e).__name__, str(e), isinstance(e, IOError)))
    return outcomes, h.fired, h.hits, F.REGISTRY.counters(), slept


@pytest.mark.parametrize("action", sorted(ACTIONS))
@pytest.mark.parametrize("trigger", sorted(TRIGGERS))
def test_trigger_and_action_fire_identically_in_both_packages(trigger, action):
    want = _drive(jax_faults, trigger, action)
    got = _drive(port_faults, trigger, action)
    assert got == want
    outcomes, fired, slept = got[0], got[1], got[4]
    changed = sum(o != "ok" and o != PAYLOAD for o in outcomes)
    assert fired > 0 and fired == (len(slept) if action == "latency" else changed)


@pytest.mark.parametrize("count", [1, 5])
def test_fire_cap_and_handle_bookkeeping_match(count):
    want = _drive(jax_faults, "always", "bit_flip", count=count)
    got = _drive(port_faults, "always", "bit_flip", count=count)
    assert got == want and got[1] == count and got[2] == ARRIVALS


def test_registries_are_separate_and_disarmed_fast_path_is_a_no_op():
    assert not port_faults.active() and not jax_faults.active()
    with port_faults.injected(POINT, port_faults.zero_fill()):
        assert port_faults.active() and not jax_faults.active()
        assert port_faults.armed_points() == frozenset({POINT})
        assert jax_faults.armed_points() == frozenset()
        assert jax_faults.mutate(POINT, PAYLOAD) is PAYLOAD  # JAX's not armed
        assert port_faults.mutate(POINT, PAYLOAD) == bytes(len(PAYLOAD))
    assert not port_faults.active()
    assert port_faults.mutate(POINT, PAYLOAD) is PAYLOAD  # disarmed: same object
    port_faults.fire(POINT)  # disarmed: nothing raises
    assert port_faults.REGISTRY is not jax_faults.REGISTRY


_HARD_EXIT = r"""
from {pkg} import faults
faults.inject("ec.volume.shard_read", faults.hard_exit(137), when=faults.nth_call(3))
for i in range(5):
    print(i, flush=True)
    faults.fire("ec.volume.shard_read")
"""


@pytest.mark.parametrize("pkg", ["seaweedfs_tpu", "seaweedfs_tpu_torch"])
def test_hard_exit_kills_at_the_same_arrival(pkg):
    proc = subprocess.run(
        [sys.executable, "-c", _HARD_EXIT.format(pkg=pkg)],
        cwd=str(REPO), capture_output=True, text=True, timeout=60,
    )
    assert proc.returncode == 137, proc.stderr
    assert proc.stdout.split() == ["0", "1", "2"]


# --------------------------------------------------- rebuild chaos cases

# (lost shard, mutate point, action, trigger, volume seed): the two cases
# of tests/test_ec_chaos.py, with its seeds
REBUILD_CHAOS = {
    "corrupt_sibling_read": (1, "ec.rebuild.read_shard", lambda F: F.bit_flip(seed=5),
                             lambda F: F.nth_call(3), 11),
    "corrupt_output": (13, "ec.rebuild.shard_bytes", lambda F: F.bit_flip(seed=6), None, 12),
}


def _chaos_rebuild(F, rebuild, error, base, ctx, backend, case):
    sid, point, action, when, _ = REBUILD_CHAOS[case]
    with F.injected(point, action(F), when=when(F) if when else None) as h:
        with pytest.raises(error, match="sidecar verification") as ei:
            rebuild(base, ctx, backend=backend)
        fired = (h.fired, h.hits)
    published = os.path.exists(base + ctx.to_ext(sid))
    temp = os.path.exists(base + ctx.to_ext(sid) + ".rebuilding")
    return str(ei.value).replace(base, "<base>"), fired, published, temp


@pytest.mark.parametrize("port_backend", ["cpu", "torch_cpu"])
@pytest.mark.parametrize("case", sorted(REBUILD_CHAOS))
def test_rebuild_chaos_fails_closed_like_jax(tmp_path, case, port_backend):
    """A bit flip injected mid-rebuild: verified up front, caught by the
    output verification, nothing published, no temp leaked, in both
    packages alike; the clean retry rebuilds the same bytes."""
    sid, *_, seed = REBUILD_CHAOS[case]
    (tmp_path / "seed").mkdir()
    src, _ = make_volume(tmp_path / "seed", needles=15, seed=seed)
    jax_ec_encode_volume(src, JaxECContext(10, 4))
    want = pathlib.Path(src + f".ec{sid:02d}").read_bytes()
    os.unlink(src + f".ec{sid:02d}")
    jdir = shutil.copytree(tmp_path / "seed", tmp_path / "jax")
    pdir = shutil.copytree(tmp_path / "seed", tmp_path / "port")
    jctx, ctx = JaxECContext(10, 4), ECContext(10, 4)
    be = CpuBackend(ctx) if port_backend == "cpu" else TorchBackend(ctx, device="cpu")
    theirs = _chaos_rebuild(jax_faults, jax_rebuild_ec_files, JaxECError, str(jdir / "1"), jctx,
                            JaxCpuBackend(jctx), case)
    ours = _chaos_rebuild(port_faults, rebuild_ec_files, ECError, str(pdir / "1"), ctx, be, case)
    assert ours == theirs
    assert ours[1][0] == 1 and not ours[2] and not ours[3]  # one flip; nothing left behind
    assert rebuild_ec_files(str(pdir / "1"), ctx, backend=be) == [sid]
    assert jax_rebuild_ec_files(str(jdir / "1"), jctx, backend=JaxCpuBackend(jctx)) == [sid]
    assert (pdir / f"1.ec{sid:02d}").read_bytes() == (jdir / f"1.ec{sid:02d}").read_bytes() == want
