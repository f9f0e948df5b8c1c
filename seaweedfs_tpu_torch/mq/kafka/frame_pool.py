"""Bounded worker-pool TCP front end for length-prefixed Kafka framing.

Port of seaweedfs_tpu/mq/kafka/frame_pool.py, whole: `PooledFrameServer`,
`NaiveFrameServer` and `build_frame_server`, with the fault point
`mq.gateway.accept`. Egress goes through the port's host library
(`utils/native.py` `sendv` and `send_file`), which the port builds with
g++ at first use; where it fails to build or load, a send raises (the
port keeps no quiet Python fallback, as `utils/http_pool.send_body`),
and `SEAWEED_EC_NATIVE=0` (read live) sends every response through the
Python plane, the same bytes on the wire.

A thread per connection held for the connection's whole life grows
without bound, as the HTTP data planes did before `utils/http_pool.py`,
and a client that died mid-frame parked its thread in a timeout-less
``recv`` forever. :class:`PooledFrameServer` is that pool/parked-selector
design generalized to the Kafka wire format (i32 length prefix | frame):

- a FIXED worker pool (``workers``) handles frames; a connection
  occupies a worker only while a frame is actually being served;
- between frames the connection is PARKED in a selector — thousands of
  idle consumers cost file descriptors, not threads;
- a bounded admission budget (``workers + accept_queue`` live
  connections): past it, the first frame of a new connection is
  answered with a WELL-FORMED Kafka response (per-api error +
  throttle_time, built by the gateway's ``reject_handler``) and the
  connection is closed — explicit saturation backpressure a Kafka
  client parses and backs off from, instead of silent thread pile-up;
- connection hygiene: the frame length prefix is validated BEFORE any
  allocation (``max_frame_bytes`` cap), and every read runs under
  ``request_timeout`` so a peer dying mid-frame costs one timeout, not
  a stuck thread;
- zero-copy egress: a handler may return :class:`Parts` — a mix of
  byte chunks and :class:`FileExtent` spans — which the server sends
  via the native ``sn_sendv``/``sn_send_file`` plane, or through plain
  socket writes emitting the SAME wire bytes.

``workers=0`` opts out to :class:`NaiveFrameServer`, the
thread-per-connection shape (``SEAWEED_MQ_KAFKA_WORKERS=0``).
"""

from __future__ import annotations

import os
import queue
import selectors
import socket
import struct
import threading
import time

from ...faults import registry as faults
from ...utils.glog import logger

log = logger("kafka.pool")

_MAX_FRAMES_PER_DISPATCH = 32
_IDLE_SWEEP_INTERVAL = 5.0

# Below this many payload bytes a response is cheaper to push through
# the interpreter than to flush + cross the ctypes boundary (same
# threshold rationale as http_pool._NATIVE_BODY_MIN).
_NATIVE_MIN = 8 << 10


def default_workers() -> int:
    return int(os.environ.get("SEAWEED_MQ_KAFKA_WORKERS", "16"))


def default_accept_queue() -> int:
    return int(os.environ.get("SEAWEED_MQ_KAFKA_QUEUE", "64"))


def max_frame_bytes() -> int:
    return int(os.environ.get("SEAWEED_MQ_KAFKA_MAX_FRAME_MB", "64")) << 20


class FileExtent:
    """A [offset, offset+length) span of an on-disk file to egress
    verbatim — the zero-copy half of a fetch response."""

    __slots__ = ("path", "offset", "length")

    def __init__(self, path: str, offset: int, length: int):
        self.path = path
        self.offset = offset
        self.length = length

    def __len__(self) -> int:
        return self.length

    def read(self) -> bytes:
        with open(self.path, "rb") as f:
            f.seek(self.offset)
            return f.read(self.length)


class Parts:
    """An ordered response body: bytes chunks and FileExtents. The
    frame server length-prefixes the total and sends each part in
    order; which plane carries each part is an egress detail that never
    changes the wire bytes."""

    __slots__ = ("parts", "api")

    def __init__(self, parts=None, api: str = ""):
        self.parts = [p for p in (parts or []) if len(p)]
        self.api = api  # metrics attribution ("fetch", ...)

    def append(self, part) -> None:
        if len(part):
            self.parts.append(part)

    def total(self) -> int:
        return sum(len(p) for p in self.parts)


def _native_mod():
    """The host library's module, or None where SEAWEED_EC_NATIVE=0."""
    if os.environ.get("SEAWEED_EC_NATIVE", "1") == "0":
        return None
    from ...utils import native

    return native


class _FConn:
    """One live client connection: socket, per-connection handler
    state (the gateway keeps request context here), idle bookkeeping."""

    __slots__ = ("sock", "state", "last_active")

    def __init__(self, sock):
        self.sock = sock
        self.state = {}
        self.last_active = time.monotonic()


def _read_exact(sock: socket.socket, n: int) -> bytes | None:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


def read_frame(sock: socket.socket, cap: int) -> bytes | None:
    """One length-prefixed frame, or None on EOF / bad prefix. The
    length is validated against `cap` BEFORE any payload allocation —
    an adversarial 2 GiB prefix costs 4 bytes of reading, not memory."""
    head = _read_exact(sock, 4)
    if head is None:
        return None
    (size,) = struct.unpack(">i", head)
    if size <= 0 or size > cap:
        return None
    return _read_exact(sock, size)


def send_response(sock: socket.socket, resp, timeout_ms: int = -1) -> int:
    """Length-prefix + send a handler response (bytes or Parts).
    Returns how many payload bytes went out on the native plane (0 on
    the Python fallback). FileExtent parts go kernel-to-kernel via
    sn_send_file when the native plane is up; byte chunks via sn_sendv;
    the Python fallback reads and sendall()s the SAME bytes. Raises
    OSError on a broken send — the framing is dead, the caller closes
    the connection."""
    if isinstance(resp, Parts):
        parts = resp.parts
    else:
        parts = [resp] if len(resp) else []
    total = sum(len(p) for p in parts)
    prefix = struct.pack(">i", total)
    native = _native_mod() if total >= _NATIVE_MIN else None
    if native is None:
        buf = bytearray(prefix)
        for p in parts:
            buf += p.read() if isinstance(p, FileExtent) else p
        sock.sendall(buf)
        return 0
    # native plane: coalesce adjacent byte chunks into one sendv, ship
    # file extents straight from the page cache
    fd = sock.fileno()
    native_sent = 0
    pending: list = [prefix]
    for p in parts:
        if isinstance(p, FileExtent):
            if pending:
                native_sent += native.sendv(fd, pending, timeout_ms=timeout_ms)
                pending = []
            in_f = open(p.path, "rb")
            try:
                sent = native.send_file(
                    fd, in_f.fileno(), p.offset, p.length, timeout_ms=timeout_ms
                )
            finally:
                in_f.close()
            if sent != p.length:
                raise OSError(
                    f"short sendfile {sent}/{p.length} for {p.path}"
                )
            native_sent += sent
        else:
            pending.append(p)
    if pending:
        native_sent += native.sendv(fd, pending, timeout_ms=timeout_ms)
    return max(native_sent - len(prefix), 0)


def _account(resp, native_sent: int) -> None:
    """Per-plane byte accounting for fetch responses (the api tag is
    set only by the fetch handler)."""
    if not isinstance(resp, Parts) or resp.api != "fetch":
        return
    from ...utils import metrics

    total = resp.total()
    if native_sent > 0:
        metrics.mq_fetch_bytes_total.inc(native_sent, plane="native")
    if total - native_sent > 0:
        metrics.mq_fetch_bytes_total.inc(total - native_sent, plane="python")


class PooledFrameServer:
    """The bounded front end. `handler(state, frame) -> bytes | Parts |
    None` serves one frame (None = no response frame, the acks=0
    produce case); `reject_handler(state, frame)` builds the
    well-formed saturation response for the first frame of an
    over-budget connection."""

    def __init__(
        self,
        sock: socket.socket,
        handler,
        reject_handler=None,
        workers: int = 16,
        accept_queue: int = 64,
        idle_timeout: float = 30.0,
        request_timeout: float = 120.0,
        server_kind: str = "kafka",
    ):
        self.sock = sock
        self.handler = handler
        self.reject_handler = reject_handler
        self.workers = max(1, int(workers))
        self.accept_queue = max(0, int(accept_queue))
        self.max_connections = self.workers + self.accept_queue
        self.idle_timeout = float(idle_timeout)
        self.request_timeout = float(request_timeout)
        self.server_kind = server_kind
        self._ready: "queue.Queue[_FConn | None]" = queue.Queue()
        self._park_q: "queue.Queue[_FConn]" = queue.Queue()
        self._conns: set[_FConn] = set()
        self._conns_lock = threading.Lock()
        self._stop_evt = threading.Event()
        self._loop_done = threading.Event()
        self._loop_done.set()
        self._threads: list[threading.Thread] = []
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        # a few threads may be busy answering rejects; never unbounded
        self._reject_slots = threading.Semaphore(4)
        self.rejected = 0
        self.frames_served = 0

    # ----------------------------------------------------------- lifecycle

    def start(self) -> None:
        self._stop_evt.clear()
        self._loop_done.clear()
        self._threads = [
            threading.Thread(
                target=self._worker,
                name=f"kafka-pool-{i}",
                daemon=True,
            )
            for i in range(self.workers)
        ]
        for t in self._threads:
            t.start()
        threading.Thread(
            target=self._loop, name="kafka-pool-loop", daemon=True
        ).start()

    def stop(self) -> None:
        self._stop_evt.set()
        self._wake()
        try:
            self.sock.close()
        except OSError:
            pass
        self._loop_done.wait(timeout=10.0)
        with self._conns_lock:
            leftover = list(self._conns)
        for c in leftover:
            self._close_conn(c)
        for s in (self._wake_r, self._wake_w):
            try:
                s.close()
            except OSError:
                pass

    def _loop(self) -> None:
        sel = selectors.DefaultSelector()
        self.sock.setblocking(False)
        try:
            sel.register(self.sock, selectors.EVENT_READ, "accept")
        except (ValueError, OSError):
            self._loop_done.set()
            return
        sel.register(self._wake_r, selectors.EVENT_READ, "wake")
        last_sweep = time.monotonic()
        try:
            while not self._stop_evt.is_set():
                for key, _ in sel.select(timeout=0.5):
                    if key.data == "accept":
                        self._accept()
                    elif key.data == "wake":
                        self._drain_wake(sel)
                    else:
                        sel.unregister(key.fileobj)
                        conn = key.data
                        conn.last_active = time.monotonic()
                        self._ready.put(conn)
                now = time.monotonic()
                if now - last_sweep >= _IDLE_SWEEP_INTERVAL:
                    last_sweep = now
                    self._sweep_idle(sel)
        finally:
            for _t in self._threads:
                self._ready.put(None)
            for key in list(sel.get_map().values()):
                if isinstance(key.data, _FConn):
                    self._close_conn(key.data)
            sel.close()
            for t in self._threads:
                t.join(timeout=2.0)
            while True:
                try:
                    c = self._ready.get_nowait()
                except queue.Empty:
                    break
                if c is not None:
                    self._close_conn(c)
            self._loop_done.set()

    # ------------------------------------------------------------- accept

    def _accept(self) -> None:
        while True:
            try:
                sock, addr = self.sock.accept()
            except (BlockingIOError, InterruptedError, OSError):
                return
            with self._conns_lock:
                saturated = len(self._conns) >= self.max_connections
            try:
                faults.fire(
                    "mq.gateway.accept", addr=addr, saturated=saturated
                )
            except Exception:
                try:
                    sock.close()
                except OSError:
                    pass
                continue
            if saturated:
                self._reject(sock)
                continue
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                sock.settimeout(self.request_timeout)
            except OSError:
                try:
                    sock.close()
                except OSError:
                    pass
                continue
            conn = _FConn(sock)
            with self._conns_lock:
                self._conns.add(conn)
            self._park_q.put(conn)
            self._wake()

    def _reject(self, sock: socket.socket) -> None:
        """Explicit saturation backpressure: answer the connection's
        FIRST frame with a well-formed per-api Kafka response carrying
        an error/throttle (built by the gateway), then close. Runs on a
        short-lived thread so the selector loop never blocks on a slow
        rejected peer; reject threads are capped — beyond the cap the
        socket is simply closed (the client sees a retriable reset)."""
        self.rejected += 1
        from ...utils import metrics

        metrics.gateway_rejected_total.inc(server=self.server_kind)
        if self.reject_handler is None or not self._reject_slots.acquire(
            blocking=False
        ):
            try:
                sock.close()
            except OSError:
                pass
            return

        def answer():
            try:
                sock.settimeout(2.0)
                frame = read_frame(sock, max_frame_bytes())
                if frame is not None:
                    resp = self.reject_handler({}, frame)
                    if resp is not None:
                        send_response(sock, resp, timeout_ms=2000)
            except (OSError, EOFError, ValueError):
                pass
            finally:
                self._reject_slots.release()
                try:
                    sock.close()
                except OSError:
                    pass

        threading.Thread(target=answer, daemon=True).start()

    # ----------------------------------------------------------- dispatch

    def _worker(self) -> None:
        while True:
            conn = self._ready.get()
            if conn is None:
                return
            try:
                self._serve_dispatch(conn)
            except Exception:
                self._close_conn(conn)

    def _serve_dispatch(self, conn: _FConn) -> None:
        from ...utils import metrics

        for _ in range(_MAX_FRAMES_PER_DISPATCH):
            try:
                conn.sock.settimeout(self.request_timeout)
                frame = read_frame(conn.sock, max_frame_bytes())
            except (OSError, ValueError):
                frame = None
            if frame is None:
                self._close_conn(conn)
                return
            metrics.gateway_inflight.inc(server=self.server_kind)
            try:
                resp = self.handler(conn.state, frame)
                if resp is not None:
                    native_sent = send_response(
                        conn.sock,
                        resp,
                        timeout_ms=int(self.request_timeout * 1000),
                    )
                    _account(resp, native_sent)
                with self._conns_lock:
                    self.frames_served += 1
            except (OSError, EOFError, ValueError, struct.error) as e:
                log.v(1, "connection dropped: %s", e)
                self._close_conn(conn)
                return
            finally:
                metrics.gateway_inflight.dec(server=self.server_kind)
            if not self._readable_now(conn):
                conn.last_active = time.monotonic()
                self._park_q.put(conn)
                self._wake()
                return
        # fairness: a client with more buffered frames goes to the back
        # of the ready queue instead of monopolizing this worker
        self._ready.put(conn)

    def _readable_now(self, conn: _FConn) -> bool:
        try:
            conn.sock.setblocking(False)
        except OSError:
            return False
        try:
            return bool(conn.sock.recv(1, socket.MSG_PEEK))
        except (BlockingIOError, InterruptedError):
            return False
        except OSError:
            return False
        finally:
            try:
                conn.sock.settimeout(self.request_timeout)
            except OSError:
                pass

    # ------------------------------------------------------------ parking

    def _wake(self) -> None:
        try:
            self._wake_w.send(b"x")
        except OSError:
            pass

    def _drain_wake(self, sel) -> None:
        try:
            while self._wake_r.recv(4096):
                pass
        except (BlockingIOError, InterruptedError, OSError):
            pass
        while True:
            try:
                conn = self._park_q.get_nowait()
            except queue.Empty:
                return
            try:
                sel.register(conn.sock, selectors.EVENT_READ, conn)
            except (ValueError, KeyError, OSError):
                self._close_conn(conn)

    def _sweep_idle(self, sel) -> None:
        now = time.monotonic()
        for key in list(sel.get_map().values()):
            conn = key.data
            if not isinstance(conn, _FConn):
                continue
            if now - conn.last_active > self.idle_timeout:
                try:
                    sel.unregister(key.fileobj)
                except (KeyError, ValueError):
                    continue
                self._close_conn(conn)

    def _close_conn(self, conn: _FConn) -> None:
        with self._conns_lock:
            self._conns.discard(conn)
        try:
            conn.sock.close()
        except OSError:
            pass

    # ------------------------------------------------------------- status

    def suggested_throttle_ms(self) -> int:
        """Backpressure hint for response throttle_time_ms: 0 while the
        pool has headroom, ramping with the ready backlog once frames
        queue behind busy workers."""
        backlog = self._ready.qsize()
        if backlog <= self.workers:
            return 0
        return min(1000, (backlog - self.workers) * 10)

    def pool_status(self) -> dict:
        with self._conns_lock:
            open_conns = len(self._conns)
            served = self.frames_served
        return {
            "kind": "pooled",
            "server": self.server_kind,
            "workers": self.workers,
            "accept_queue": self.accept_queue,
            "max_connections": self.max_connections,
            "open_connections": open_conns,
            "ready_backlog": self._ready.qsize(),
            "frames_served": served,
            "rejected_total": self.rejected,
            "throttle_ms": self.suggested_throttle_ms(),
        }


class NaiveFrameServer:
    """The original thread-per-connection accept loop, kept behind
    ``SEAWEED_MQ_KAFKA_WORKERS=0`` as the measured baseline. Frame
    reads still go through the capped/timed `read_frame` (hygiene is
    not optional), but there is no admission budget, no parking, no
    backpressure — every connection owns a thread for life."""

    def __init__(
        self,
        sock: socket.socket,
        handler,
        reject_handler=None,
        request_timeout: float = 120.0,
        server_kind: str = "kafka",
        **_ignored,
    ):
        self.sock = sock
        self.handler = handler
        self.request_timeout = float(request_timeout)
        self.server_kind = server_kind
        self._stop_evt = threading.Event()
        self.frames_served = 0
        self._conns = 0
        self._lock = threading.Lock()

    def start(self) -> None:
        threading.Thread(
            target=self._accept_loop, name="kafka-naive-accept", daemon=True
        ).start()

    def stop(self) -> None:
        self._stop_evt.set()
        try:
            self.sock.close()
        except OSError:
            pass

    def _accept_loop(self) -> None:
        while not self._stop_evt.is_set():
            try:
                conn, addr = self.sock.accept()
            except OSError:
                return
            try:
                faults.fire("mq.gateway.accept", addr=addr, saturated=False)
            except Exception:
                try:
                    conn.close()
                except OSError:
                    pass
                continue
            threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True
            ).start()

    def _serve_conn(self, sock: socket.socket) -> None:
        state: dict = {}
        with self._lock:
            self._conns += 1
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sock.settimeout(self.request_timeout)
            while not self._stop_evt.is_set():
                frame = read_frame(sock, max_frame_bytes())
                if frame is None:
                    return
                resp = self.handler(state, frame)
                if resp is not None:
                    native_sent = send_response(
                        sock, resp, timeout_ms=int(self.request_timeout * 1000)
                    )
                    _account(resp, native_sent)
                with self._lock:
                    self.frames_served += 1
        except (OSError, EOFError, ValueError, struct.error) as e:
            log.v(1, "connection dropped: %s", e)
        finally:
            with self._lock:
                self._conns -= 1
            try:
                sock.close()
            except OSError:
                pass

    def suggested_throttle_ms(self) -> int:
        return 0

    def pool_status(self) -> dict:
        with self._lock:
            return {
                "kind": "naive",
                "server": self.server_kind,
                "workers": 0,
                "accept_queue": 0,
                "max_connections": -1,
                "open_connections": self._conns,
                "ready_backlog": 0,
                "frames_served": self.frames_served,
                "rejected_total": 0,
                "throttle_ms": 0,
            }


def build_frame_server(
    sock: socket.socket,
    handler,
    reject_handler=None,
    workers: int | None = None,
    accept_queue: int | None = None,
    request_timeout: float = 120.0,
    idle_timeout: float = 30.0,
    server_kind: str = "kafka",
):
    """Factory mirroring ``utils/http_pool.build_http_server``: the
    pooled server unless workers resolves to 0 (explicit opt-out to the
    unbounded thread-per-connection baseline)."""
    if workers is None:
        workers = default_workers()
    if accept_queue is None:
        accept_queue = default_accept_queue()
    cls = PooledFrameServer if workers else NaiveFrameServer
    return cls(
        sock,
        handler,
        reject_handler=reject_handler,
        workers=workers,
        accept_queue=accept_queue,
        request_timeout=request_timeout,
        idle_timeout=idle_timeout,
        server_kind=server_kind,
    )
