"""MetaAggregator: converge this filer's namespace with its peers.

Port of seaweedfs_tpu/filer/meta_aggregator.py, whole (reference
weed/filer/meta_aggregator.go): each filer subscribes to every peer's
metadata stream and merges the events. The merge applies peer events to
the local store with last-writer-wins semantics
(Filer.apply_remote_event); applied events are re-logged locally with
is_from_other_cluster=true, and peer subscriptions request
local_only=true, so events propagate exactly one hop in a full mesh — no
echo loops, no relays needed. The wire is the JAX one: a port aggregator
follows a JAX filer's service and the other way round.
"""

from __future__ import annotations

import threading

import grpc

from ..pb import filer_pb2 as fpb
from ..pb import rpc
from ..utils.glog import logger
from .filer import Filer

log = logger("filer.aggregator")


class MetaAggregator:
    def __init__(self, filer: Filer, peers: list[str], client_name: str = ""):
        """peers: list of peer filer gRPC addresses (host:port)."""
        self.filer = filer
        self.peers = [p for p in peers if p]
        self.client_name = client_name or "aggregator"
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        # per-peer replication watermark, persisted in the filer KV so
        # a restart resumes instead of replaying each peer's whole log
        self._watermark: dict[str, int] = {}
        self._saved: dict[str, int] = {}
        for p in self.peers:
            raw = filer.store.kv_get(f"meta-agg/{p}".encode())
            if raw:
                try:
                    self._watermark[p] = int(raw)
                except ValueError:
                    pass
        self.applied = 0

    def _advance(self, peer: str, ts_ns: int) -> None:
        cur = max(self._watermark.get(peer, 0), ts_ns)
        self._watermark[peer] = cur
        # throttled persistence: every second of log time is plenty
        if cur - self._saved.get(peer, 0) > 1_000_000_000:
            self.filer.store.kv_put(
                f"meta-agg/{peer}".encode(), str(cur).encode()
            )
            self._saved[peer] = cur

    def start(self) -> None:
        for peer in self.peers:
            t = threading.Thread(
                target=self._follow_peer, args=(peer,), daemon=True
            )
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        for p, ts in self._watermark.items():
            if ts != self._saved.get(p):
                try:
                    self.filer.store.kv_put(
                        f"meta-agg/{p}".encode(), str(ts).encode()
                    )
                except Exception:  # noqa: BLE001 — store may be closing
                    pass

    def _follow_peer(self, peer: str) -> None:
        while not self._stop.is_set():
            try:
                with grpc.insecure_channel(peer) as ch:
                    stub = rpc.filer_stub(ch)
                    stream = stub.SubscribeMetadata(
                        fpb.SubscribeMetadataRequest(
                            client_name=self.client_name,
                            since_ns=self._watermark.get(peer, 0),
                            local_only=True,
                        )
                    )
                    for ev in stream:
                        if self._stop.is_set():
                            return
                        if self.filer.apply_remote_event(ev):
                            self.applied += 1
                        self._advance(peer, ev.ts_ns)
            except grpc.RpcError as e:
                if e.code() == grpc.StatusCode.OUT_OF_RANGE:
                    # our watermark predates the peer's log retention:
                    # events were rotated away. Replay what remains —
                    # LWW apply makes the replay idempotent; entries
                    # mutated only inside the gap stay divergent until
                    # the next write (full resync is filer.sync's job).
                    log.warning(
                        "peer %s rotated past our watermark %d; replaying",
                        peer,
                        self._watermark.get(peer, 0),
                    )
                    self._watermark[peer] = 0
                # peer down or restarting: retry with backoff, resuming
                # from the watermark
                self._stop.wait(1.0)
            except Exception as e:  # noqa: BLE001
                log.warning("peer %s: %s", peer, e)
                self._stop.wait(1.0)
