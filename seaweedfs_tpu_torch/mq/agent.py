"""MQ agent: a session facade in front of the broker group.

Port of seaweedfs_tpu/mq/agent.py, whole. Reference: weed/mq/agent (agent_server.go, agent_grpc_publish.go,
agent_grpc_subscribe.go) — thin clients start a publish session, stream
records, and stream subscriptions WITHOUT carrying broker-balancing or
topic-configuration logic themselves; the agent owns the broker
connection.

Sessions auto-configure the topic at StartPublishSession (like the
reference's schema registration step); the publish stream acks every
record with its assigned offset; the subscribe stream replays from the
requested (or committed-group) offset and commits cumulative acks back
to the broker's offset store.
"""

from __future__ import annotations

import threading
import time
from concurrent import futures

import grpc

from ..pb import mq_pb2 as mq
from ..pb import rpc
from ..utils.glog import logger
from .client import MqClient

log = logger("mqagent")


class MqAgentService:
    def __init__(self, broker_addr: str):
        self.broker_addr = broker_addr
        self._client = MqClient(broker_addr)
        self._lock = threading.Lock()
        self._sessions: dict[int, tuple[str, str]] = {}  # id -> (ns, name)
        self._next_session = int(time.time()) << 16

    def _session(self, sid: int) -> tuple[str, str]:
        with self._lock:
            got = self._sessions.get(sid)
        if got is None:
            raise KeyError(sid)
        return got

    # ----------------------------------------------------------- publish

    def StartPublishSession(self, request, context):
        ns = request.ns or "default"
        try:
            self._client.configure_topic(
                request.name,
                partitions=max(request.partition_count, 1),
                namespace=ns,
            )
        except grpc.RpcError as e:
            return mq.AgentStartPublishResponse(error=e.details() or str(e))
        with self._lock:
            self._next_session += 1
            sid = self._next_session
            self._sessions[sid] = (ns, request.name)
        log.v(
            1,
            f"publish session {sid} -> {ns}/{request.name} "
            f"({request.publisher_name or 'anonymous'})",
        )
        return mq.AgentStartPublishResponse(session_id=sid)

    def ClosePublishSession(self, request, context):
        with self._lock:
            gone = self._sessions.pop(request.session_id, None)
        if gone is None:
            return mq.AgentClosePublishResponse(error="unknown session")
        return mq.AgentClosePublishResponse()

    def PublishRecord(self, request_iterator, context):
        """BIDI: each request publishes one record; each response acks
        with the assigned offset. The session id rides the FIRST
        message (later ones may omit it, like the reference)."""
        sid = 0
        seq = 0
        for req in request_iterator:
            seq += 1
            if req.session_id:
                sid = req.session_id
            try:
                ns, name = self._session(sid)
            except KeyError:
                yield mq.AgentPublishResponse(
                    ack_sequence=seq, error=f"unknown session {sid}"
                )
                return
            try:
                _part, off = self._client.publish(
                    name, bytes(req.value), key=bytes(req.key), namespace=ns
                )
            except (RuntimeError, grpc.RpcError) as e:
                yield mq.AgentPublishResponse(
                    ack_sequence=seq, error=str(e)
                )
                continue
            yield mq.AgentPublishResponse(ack_sequence=seq, offset=off)

    # --------------------------------------------------------- subscribe

    def SubscribeRecord(self, request_iterator, context):
        """BIDI: first message carries init; later messages carry
        cumulative acks which commit the group offset."""
        first = next(request_iterator, None)
        if first is None or not first.init.name:
            yield mq.AgentSubscribeResponse(
                error="first message must carry init", is_end_of_stream=True
            )
            return
        init = first.init
        ns = init.ns or "default"
        group = init.consumer_group

        reqs_done = threading.Event()

        def ack_pump():
            # acks commit the furthest offset the consumer has durably
            # handled — the agent owns the CommitOffset calls. The
            # request stream ENDING is a normal half-close (ack-less
            # consumers send only init), NOT a reason to stop records.
            try:
                for req in request_iterator:
                    # proto3 int64 has no presence: 0 means "no ack in
                    # this message" (committing 0 would REGRESS the
                    # group to the beginning)
                    if group and req.ack_sequence > 0:
                        self._client.commit(
                            init.name,
                            init.partition,
                            group,
                            int(req.ack_sequence),
                            namespace=ns,
                        )
            except (grpc.RpcError, RuntimeError):
                pass
            finally:
                reqs_done.set()

        threading.Thread(target=ack_pump, daemon=True).start()
        try:
            for rec in self._client.subscribe(
                init.name,
                init.partition,
                start_offset=init.start_offset,
                namespace=ns,
                consumer_group=group,
                follow=init.follow,
            ):
                if not context.is_active():
                    return  # client disconnected
                yield mq.AgentSubscribeResponse(
                    key=rec.message.key,
                    value=rec.message.value,
                    ts_ns=rec.message.ts_ns,
                    offset=rec.offset,
                )
        except grpc.RpcError as e:
            yield mq.AgentSubscribeResponse(
                error=e.details() or str(e), is_end_of_stream=True
            )
            return
        yield mq.AgentSubscribeResponse(is_end_of_stream=True)
        # Grace for the FINAL cumulative ack: the client typically acks
        # after the end marker, then half-closes; returning immediately
        # would cancel the RPC and discard that ack mid-flight. The
        # grace must be LOAD-TOLERANT: under a loaded host the client's
        # ack + half-close and the pump's CommitOffset RPC can take
        # well over the old fixed 2 s, and an expired grace silently
        # dropped the committed offset ("ack never committed" flake).
        # reqs_done is set the moment the pump drains the half-closed
        # request stream (ack-less consumers half-close immediately, so
        # the common case returns without waiting), and a DISCONNECTED
        # client stops the wait early — only a consumer that keeps its
        # request stream open without acking pays the full grace.
        deadline = time.monotonic() + 30.0
        while not reqs_done.wait(0.25):
            if time.monotonic() > deadline or not context.is_active():
                break

    def close(self) -> None:
        self._client.close()


class MqAgentServer:
    """Standalone agent process: gRPC server fronting one broker
    (group)."""

    def __init__(self, broker: str, ip: str = "localhost", port: int = 0):
        self.service = MqAgentService(broker)
        self._grpc = grpc.server(futures.ThreadPoolExecutor(max_workers=16))
        rpc.add_service(self._grpc, rpc.MQ_AGENT_SERVICE, self.service)
        self.port = self._grpc.add_insecure_port(f"{ip}:{port}")
        self.ip = ip

    def start(self) -> None:
        self._grpc.start()

    def stop(self) -> None:
        self._grpc.stop(grace=1)
        self.service.close()
