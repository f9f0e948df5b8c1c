"""Multi-broker partition balancing + liveness.

Port of seaweedfs_tpu/mq/balancer.py, whole: the same HRW ranking, so a
group of port brokers assigns every partition as a JAX group would.
Reference: weed/mq/pub_balancer — brokers share partition ownership;
clients look up per-partition leaders. Here ownership is computed by
rendezvous (HRW) hashing over the LIVE broker set: every broker ranks
(broker, topic, partition) and the top-ranked live broker leads, the
runner-up follows. HRW gives the failover property for free: when a
leader dies, the new top-ranked broker IS the old follower, which holds
the replica fed by FollowAppend — so promotion loses nothing.

Gravity: BrokerStatus pings now carry each peer's live
load_score (parity backlog + Kafka gateway pool pressure). Assignment
keeps the HRW ranking for stability but demotes the top-ranked broker
to follower when it is hotter than the runner-up by more than
SEAWEED_MQ_GRAVITY_HYSTERESIS — load noise inside the margin cannot
flap leadership, and brokers with divergent load views are absorbed by
the is_forwarded single-hop rule.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time

import grpc

from ..pb import mq_pb2 as mq
from ..pb import rpc
from ..utils.glog import logger

log = logger("mq-balancer")

FORWARDED_KEY = "sw-forwarded"


def _score(broker: str, ns: str, name: str, part: int) -> bytes:
    return hashlib.md5(f"{broker}|{ns}|{name}|{part}".encode()).digest()


def gravity_hysteresis() -> float:
    """SEAWEED_MQ_GRAVITY_HYSTERESIS: how much hotter (in load-score
    units) the HRW leader must be than the runner-up before assignment
    swaps them. Read live per call."""
    try:
        return float(os.environ.get("SEAWEED_MQ_GRAVITY_HYSTERESIS", "1.5"))
    except ValueError:
        return 1.5


def is_forwarded(context) -> bool:
    """True when a peer broker already routed this request to us — a
    second hop must serve locally (divergent live-set views must not
    forward in a loop)."""
    if context is None:
        return False
    try:
        return any(
            k == FORWARDED_KEY for k, _v in context.invocation_metadata()
        )
    except AttributeError:
        return False


FWD_METADATA = ((FORWARDED_KEY, "1"),)


class BrokerBalancer:
    def __init__(
        self,
        self_addr: str,
        peers: list[str],
        ping_interval: float = 1.0,
        ping_timeout: float = 0.75,
    ):
        """peers: every broker's grpc host:port, including (or not)
        this one."""
        self.self_addr = self_addr
        self.peers = sorted(set(peers) | {self_addr})
        self.ping_interval = ping_interval
        self.ping_timeout = ping_timeout
        self._live = set(self.peers)  # optimistic until pings say otherwise
        self._loads: dict[str, float] = {}  # addr -> last load_score
        self.load_fn = None  # server-injected: this broker's own load
        self._lock = threading.Lock()
        self._channels: dict[str, grpc.Channel] = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._ping_loop, daemon=True)
        self.started_at = time.time()

    @property
    def single(self) -> bool:
        return len(self.peers) == 1

    def start(self) -> None:
        if not self.single:
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        # join the ping loop FIRST: an in-flight iteration would
        # recreate (and leak) channels after the clear below
        if self._thread.is_alive():
            self._thread.join(timeout=2 * self.ping_timeout + 1)
        with self._lock:
            for ch in self._channels.values():
                ch.close()
            self._channels.clear()

    # --------------------------------------------------------- liveness

    def stub(self, addr: str) -> rpc.Stub:
        with self._lock:
            ch = self._channels.get(addr)
            if ch is None:
                ch = grpc.insecure_channel(addr)
                self._channels[addr] = ch
        return rpc.mq_stub(ch)

    def live(self) -> list[str]:
        with self._lock:
            return sorted(self._live)

    def _ping_loop(self) -> None:
        while not self._stop.wait(self.ping_interval):
            live = {self.self_addr}
            loads: dict[str, float] = {}
            if self.load_fn is not None:
                try:
                    loads[self.self_addr] = float(self.load_fn())
                except Exception:  # noqa: BLE001 — telemetry only
                    pass
            for peer in self.peers:
                if peer == self.self_addr:
                    continue
                try:
                    resp = self.stub(peer).BrokerStatus(
                        mq.BrokerStatusRequest(), timeout=self.ping_timeout
                    )
                    live.add(peer)
                    loads[peer] = float(getattr(resp, "load_score", 0.0))
                except grpc.RpcError:
                    pass
            with self._lock:
                if live != self._live:
                    log.info(
                        "live broker set: %s -> %s",
                        sorted(self._live),
                        sorted(live),
                    )
                self._live = live
                self._loads = loads

    def loads(self) -> dict[str, float]:
        """Last observed load_score per broker (missing = no telemetry
        yet — gravity then leaves the HRW ranking alone)."""
        with self._lock:
            return dict(self._loads)

    # ------------------------------------------------------- assignment

    def assignment(
        self, ns: str, name: str, part: int
    ) -> tuple[str, str]:
        """(leader, follower) for one partition over the live set.

        Gravity: when both the HRW leader and runner-up have load
        telemetry and the leader is hotter by more than the hysteresis
        margin, the pair swaps — the partition lands on the cooler
        broker while the HRW winner keeps the replica, so failover
        still loses nothing."""
        live = self.live()
        if not live:
            return self.self_addr, ""
        ranked = sorted(
            live, key=lambda b: _score(b, ns, name, part), reverse=True
        )
        leader = ranked[0]
        follower = ranked[1] if len(ranked) > 1 else ""
        if follower:
            loads = self.loads()
            hot, cool = loads.get(leader), loads.get(follower)
            if (
                hot is not None
                and cool is not None
                and hot > cool + gravity_hysteresis()
            ):
                leader, follower = follower, leader
        return leader, follower

    def assignments(
        self, ns: str, name: str, count: int
    ) -> list[tuple[int, str, str]]:
        return [
            (p, *self.assignment(ns, name, p)) for p in range(count)
        ]
