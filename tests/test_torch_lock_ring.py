"""PyTorch port: the filer lock ring (seaweedfs_tpu_torch/filer/lock_ring.py,
reference weed/cluster/lock_manager) and the master's `dlm_filers`, held
against the JAX package on the CPU:

- `_score`, `candidates` and `owner_for` equal over seeded member sets,
  names and dead members;
- a three-filer ring of port `FilerServer`s and one of JAX ones take one
  seeded lock / renew / unlock / status sequence: equal `DlmResponse`s once
  tokens are numbered by first appearance and remaining seconds reduced
  to their sign. Then the owner of a name is stopped: its holder's renewal
  re-creates the lease on a survivor, a thief is held back, then a second
  name's fresh acquire waits out the failover grace; the stopped filer
  comes back on its port and the mover hands the lease back, the original
  token still renewing (tests/test_lock_ring.py's cases, waits on
  conditions only);
- the verbatim filer_pb2 lets the port's `DlmClient` drive a JAX ring and
  the JAX client a port ring;
- a port master with `dlm_filers` serves the shell's `lock` / `lock.status`
  / `unlock` and a mutating command's `cluster_guard` through the ring,
  as the JAX master does; its own lease table stays empty.
"""

import re
import types

import numpy as np
import pytest
from conftest import wait_for
from test_torch_volume_server import _ports

import seaweedfs_tpu.filer.lock_ring as j_ring
from seaweedfs_tpu.filer import Filer as JaxFiler
from seaweedfs_tpu.filer import MemoryStore as JaxMemoryStore
from seaweedfs_tpu.server.filer_server import FilerServer as JaxFilerServer
from seaweedfs_tpu.server.master import MasterServer as JaxMasterServer
from seaweedfs_tpu.shell import commands as jax_shell
import seaweedfs_tpu_torch.filer.lock_ring as p_ring
from seaweedfs_tpu_torch.filer import Filer, MemoryStore
from seaweedfs_tpu_torch.server.filer_server import FilerServer
from seaweedfs_tpu_torch.server.master import MasterServer
from seaweedfs_tpu_torch.shell import commands as port_shell

PKGS = {
    "jax": types.SimpleNamespace(ring=j_ring, filer=JaxFiler, memory=JaxMemoryStore,
                                 server=JaxFilerServer, master=JaxMasterServer, shell=jax_shell),
    "port": types.SimpleNamespace(ring=p_ring, filer=Filer, memory=MemoryStore,
                                  server=FilerServer, master=MasterServer, shell=port_shell),
}
GRACE = 3.0  # the rings' failover grace, short for the test
PROBE = 0.2


def test_score_and_owner_match_jax():
    rng = np.random.default_rng(25)
    for _ in range(60):
        members = [f"h{int(rng.integers(0, 9))}:{int(rng.integers(1000, 65000))}"
                   for _ in range(int(rng.integers(1, 6)))]
        me = members[0]
        rings = [pkg.ring.LockRing(me, members[1:]) for pkg in PKGS.values()]
        dead = [m for m in members[1:] if rng.random() < 0.4]
        for r in rings:
            for m in dead:
                r.mark(m, False)
        for name in (f"n{int(rng.integers(0, 1 << 30))}", "admin", "volume/7", "é/日本"):
            for m in members:
                assert p_ring._score(m, name) == j_ring._score(m, name)
            assert rings[0].candidates(name) == rings[1].candidates(name)
            assert rings[0].owner_for(name) == rings[1].owner_for(name)
            assert rings[0].live_members() == rings[1].live_members()
    assert p_ring.LockRing.FAILOVER_GRACE == j_ring.LockRing.FAILOVER_GRACE == 15.0


class Ring:
    """Three filer servers of one package in one lock ring."""

    def __init__(self, name: str):
        self.pkg = PKGS[name]
        self.grpc = [_ports() for _ in range(3)]
        self.addrs = [f"127.0.0.1:{p}" for p in self.grpc]
        self.servers = [self.start(i) for i in range(3)]

    def start(self, i: int):
        f = self.pkg.filer(self.pkg.memory(), master="127.0.0.1:1")
        fs = self.pkg.server(f, ip="127.0.0.1", port=_ports(), grpc_port=self.grpc[i],
                             peers=[a for a in self.addrs if a != self.addrs[i]])
        fs.lock_ring.probe_interval = PROBE
        fs.lock_ring.FAILOVER_GRACE = GRACE
        fs.start()
        return fs

    def holding(self, name: str) -> list[int]:
        return [i for i, fs in enumerate(self.servers)
                if fs is not None and any(r[0] == name for r in fs.lock_ring.locks.status())]

    def stop(self):
        for fs in self.servers:
            if fs is not None:
                fs.stop()


@pytest.fixture(params=["jax", "port"])
def ring_pair(request):
    """A JAX ring and a port ring, and the client of the param's package
    for both (so each package's client drives each package's ring)."""
    rings = {}
    try:
        for name in PKGS:
            rings[name] = Ring(name)
        yield rings, PKGS[request.param].ring.DlmClient
    finally:
        for r in rings.values():
            r.stop()


class Norm:
    """DlmResponses with tokens numbered by first appearance, remaining
    seconds reduced to their sign and addresses named by role."""

    def __init__(self, roles: dict):
        self.tokens: dict[str, int] = {}
        self.roles = roles

    def tok(self, t: str):
        return self.tokens.setdefault(t, len(self.tokens)) if t else ""

    def text(self, s: str) -> str:
        return re.sub(r"127\.0\.0\.1:\d+", lambda m: self.roles.get(m[0], "?"), s)

    def __call__(self, r) -> tuple:
        return (r.ok, self.tok(r.token), r.holder, r.remaining > 0, self.text(r.error),
                [(x.name, x.owner, x.remaining > 0) for x in r.locks])


def seeded_ops(seed: int, n: int = 60) -> list:
    rng = np.random.default_rng(seed)
    names = ["admin", "volume/1", "volume/2", "jobs/a", "jobs/b"]
    owners = ["w1", "w2", "w3"]
    ops = []
    for _ in range(n):
        op = ["lock", "lock", "renew", "unlock", "status"][int(rng.integers(0, 5))]
        ops.append((op, names[int(rng.integers(0, len(names)))],
                    owners[int(rng.integers(0, len(owners)))], bool(rng.random() < 0.7),
                    float(rng.choice([5.0, 30.0, 60.0]))))
    return ops


def run_ops(client, ops, held: dict) -> list:
    out = []
    for op, name, owner, good, ttl in ops:
        tok = held.get(name, "") if good else "bogus"
        if op == "lock":
            r = client.lock(name, owner, ttl=ttl, token=tok if good and name in held else "")
        elif op == "renew":
            r = client.renew(name, owner, tok, ttl=ttl)
        elif op == "unlock":
            r = client.unlock(name, tok)
        else:
            out.append(("status", [(n, o, rem > 0) for n, o, rem in client.status()]))
            continue
        if r.ok and r.token:
            held[name] = r.token
        elif op == "unlock" and r.ok:
            held.pop(name, None)
        out.append((op, name, r))
    return out


def test_ring_answers_match_jax(ring_pair):
    rings, client_cls = ring_pair
    got = {}
    for name, ring in rings.items():
        c = client_cls(ring.addrs)
        try:
            wait_for(lambda: all(fs.lock_ring.live_members() == sorted(ring.addrs)
                                 for fs in ring.servers), timeout=30, msg="the ring is up")
            norm = Norm({a: f"f{i}" for i, a in enumerate(ring.addrs)})
            held: dict = {}
            out = [(x[0], x[1], norm(x[2])) if len(x) == 3 else x
                   for x in run_ops(c, seeded_ops(25), held)]
            # every live lease sits on its ring owner
            for lname in {x[1] for x in out if len(x) == 3}:
                hold = ring.holding(lname)
                owner = ring.servers[0].lock_ring.owner_for(lname)
                assert hold in ([], [ring.addrs.index(owner)]), (lname, hold)

            # the owner of a held name stopped: the renewal survives on a
            # successor, a thief is held back
            lname = "jobs/failover"
            order = sorted(ring.addrs, key=lambda m: p_ring._score(m, lname), reverse=True)
            top = ring.addrs.index(order[0])
            norm.roles = {order[0]: "owner", order[1]: "second", order[2]: "third"}
            r = c.lock(lname, "original", ttl=30.0)
            out.append(("locked", norm(r), ring.holding(lname) == [top]))
            token = r.token
            ring.servers[top].stop()
            ring.servers[top] = None
            # a fresh acquire of another name the stopped filer owned waits
            # out the grace (a live survivor has no lease for it)
            other = next(f"jobs/g{i}" for i in range(1000) if max(
                ring.addrs, key=lambda m: p_ring._score(m, f"jobs/g{i}")) == order[0])
            second = ring.servers[ring.addrs.index(order[1])]
            wait_for(lambda: order[0] not in second.lock_ring.live_members(), timeout=30,
                     msg="the survivors notice the stopped filer")
            fresh = c.lock(other, "thief", ttl=5.0)
            renewed = c.renew(lname, "original", token, ttl=30.0)
            thief = c.lock(lname, "thief", ttl=5.0)
            out += [("grace", norm(fresh)), ("renewed", norm(renewed)), ("thief", norm(thief))]
            wait_for(lambda: c.lock(other, "thief", ttl=5.0).ok, timeout=30,
                     msg="the grace runs out")
            out.append(("after grace", norm(c.lock(other, "thief", ttl=5.0))))
            out.append(("moved to", ring.holding(lname) == [ring.addrs.index(order[1])]))
            # the stopped filer comes back on its port: the lease moves home
            ring.servers[top] = ring.start(top)
            wait_for(lambda: ring.holding(lname) == [top], timeout=30,
                     msg="the mover hands the lease back to its ring owner")
            out.append(("home", norm(c.renew(lname, "original", token, ttl=30.0))))
            out.append(("unlocked", norm(c.unlock(lname, token)),
                        norm(c.lock(lname, "thief", ttl=5.0))))
            got[name] = out
        finally:
            c.close()
    assert got["port"] == got["jax"]
    flat = [x[-1] for x in got["port"] if len(x) == 3 and isinstance(x[-1], tuple)]
    assert any(x[0] for x in flat) and any(not x[0] for x in flat)
    tagged = {x[0]: x[1:] for x in got["port"] if isinstance(x[0], str) and len(x) <= 3}
    assert tagged["grace"][0][4] == "ring owner owner in failover grace; retry"
    assert tagged["renewed"][0][0] and not tagged["thief"][0][0]
    assert tagged["moved to"] == (True,) and tagged["after grace"][0][2] == "thief"


def test_master_lease_api_rides_the_ring():
    """AdminLock / AdminUnlock / AdminLockStatus of a master given
    `dlm_filers` are a client of the ring, in both packages: the shell's
    session lock and a mutating command's guard land on a filer."""
    outs = {}
    for name, pkg in PKGS.items():
        ring = Ring(name)
        mport = _ports()
        master = pkg.master(ip="127.0.0.1", port=mport, vacuum_interval=3600,
                            dlm_filers=ring.addrs)
        master.start()
        env = pkg.shell.ShellEnv(f"127.0.0.1:{mport}")
        try:
            out = [pkg.shell.run_command(env, "lock").replace(env.owner, "<owner>")]
            out.append(bool(ring.holding("admin")) and not master.service.locks.status())
            status = pkg.shell.run_command(env, "lock.status")
            out.append(re.sub(r"\d+\.\ds left", "<t>s left", status.replace(env.owner, "<owner>")))
            out.append(pkg.shell.run_command(env, "unlock"))
            out.append(ring.holding("admin"))
            # a mutating command's cluster_guard: the admin and volume leases
            # taken and given back through the ring
            out.append(pkg.shell.run_command(env, "volume.vacuum.disable -volumeId 9"))
            out.append([ring.holding(n) for n in ("admin", "volume/9")])
            other = pkg.ring.DlmClient(ring.addrs)
            r = other.lock("admin", "someone-else", ttl=30.0)
            env.lock_wait = 0.3
            out.append(pkg.shell.run_command(env, "volume.vacuum.enable -volumeId 9")
                       .replace(env.owner, "<owner>"))
            other.unlock("admin", r.token)
            other.close()
            outs[name] = out
        finally:
            env.close()
            master.stop()
            ring.stop()
    assert outs["port"] == outs["jax"]
    assert outs["port"][1] is True and outs["port"][4] == []
    assert "someone-else" in outs["port"][-1]
