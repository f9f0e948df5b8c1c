"""Bounded worker-pool HTTP front end for the volume server's data plane.

Port of seaweedfs_tpu/utils/http_pool.py. ``ThreadingHTTPServer`` holds
one thread per connection for the connection's whole life: at 100+
keep-alive clients that is unbounded thread growth and, past the thread
limit, collapse. :class:`PooledHTTPServer` has the acceptor, poller and
worker shape instead:

- a fixed worker pool (``workers``) handles requests; a connection holds
  a worker only while a request is in flight;
- between requests a keep-alive connection is parked in a selector, so
  idle connections cost file descriptors, not threads;
- a bounded accept budget (``workers + accept_queue`` live connections):
  past it a new connection is answered at once with ``503 Service
  Unavailable``, ``Retry-After`` and the server's error body;
- ``sw_gateway_inflight{server}``, ``sw_gateway_rejected_total{server}``
  and :meth:`PooledHTTPServer.pool_status` (``/debug/gateway``) show the
  load and the saturation.

The stdlib ``BaseHTTPRequestHandler`` contract holds: the same handler
classes run unmodified (the request-tracing mixin included); one handler
instance lives per connection and is driven one ``handle_one_request``
at a time by whichever worker the dispatcher picks.

`send_body` sends a response body through the host library's
scatter-gather writer (`sn_sendv`, the GIL released for the whole send),
or through ``wfile`` where SEAWEED_EC_NATIVE=0: the same bytes on the
wire; a library that fails to build or load raises.

TLS: servers wrap their listener AFTER construction (``utils/tls.py``).
The pooled front end serves plain-HTTP data planes only: a server given
``tls`` gets ``ThreadingHTTPServer`` (the pool's non-blocking readiness
probe is not SSLSocket-safe), and `send_body` never hands an
``ssl.SSLSocket`` to the native sender.
"""

from __future__ import annotations

import os
import queue
import selectors
import socket
import ssl
import threading
import time
from http.server import HTTPServer

# How many back-to-back requests one dispatch may serve before the
# connection is re-queued behind other ready work — bounds how long a
# pipelining client can monopolize a worker.
_MAX_REQUESTS_PER_DISPATCH = 32

_IDLE_SWEEP_INTERVAL = 5.0


def _plain_reject_body() -> tuple[str, bytes]:
    return (
        "text/plain",
        b"503 server saturated: worker pool and accept queue are full\n",
    )


class _Conn:
    """One live client connection: its socket, its persistent handler
    instance (rfile/wfile survive across requests — keep-alive), and
    its idle bookkeeping."""

    __slots__ = ("sock", "handler", "last_active")

    def __init__(self, sock, handler):
        self.sock = sock
        self.handler = handler
        self.last_active = time.monotonic()


def _deferred_handler(cls, request_timeout: float):
    """Subclass `cls` so constructing it runs ONLY setup (rfile/wfile
    creation): the pool drives `handle_one_request` itself, one request
    per dispatch, instead of the stdlib's construct-and-serve-to-close.
    """

    class Deferred(cls):
        timeout = request_timeout  # setup() applies it to the socket

        def handle(self):  # the pool dispatches requests itself
            pass

        def finish(self):  # the pool closes the connection itself
            pass

        def _pool_finish(self):
            try:
                cls.finish(self)  # the real flush-and-close chain
            except Exception:
                pass

    Deferred.__name__ = f"Pooled{cls.__name__}"
    return Deferred


class PooledHTTPServer(HTTPServer):
    """Drop-in for ``ThreadingHTTPServer`` (same ``serve_forever`` /
    ``shutdown`` / ``server_close`` lifecycle) with a fixed worker pool
    and explicit backpressure. See the module docstring."""

    allow_reuse_address = 1
    # Kernel accept-queue depth (socket.listen backlog). The stdlib
    # default of 5 would drop SYNs from a 100-client connection burst
    # long before the pool's own explicit-503 admission logic ever saw
    # them (retransmit stalls of 1s+ on exactly the concurrency path
    # this server exists for). The kernel clamps to somaxconn.
    request_queue_size = 1024

    def __init__(
        self,
        server_address,
        RequestHandlerClass,
        workers: int = 32,
        accept_queue: int = 128,
        idle_timeout: float = 30.0,
        request_timeout: float = 120.0,
        server_kind: str = "http",
        reject_body=None,
        retry_after: int = 1,
    ):
        """`workers`: threads handling requests. `accept_queue`: live
        connections allowed beyond the worker count before new ones are
        503-rejected. `idle_timeout`: parked keep-alive connections idle
        longer than this are closed. `request_timeout`: socket timeout
        while a request is in flight (a stalled mid-request peer gets
        its connection closed, stdlib semantics). `reject_body`: zero-
        arg callable -> (content_type, bytes) for the 503 body (the volume
        server's is a JSON error document)."""
        super().__init__(server_address, RequestHandlerClass)
        self.workers = max(1, int(workers))
        self.accept_queue = max(0, int(accept_queue))
        self.max_connections = self.workers + self.accept_queue
        self.idle_timeout = float(idle_timeout)
        self.request_timeout = float(request_timeout)
        self.server_kind = server_kind
        self.retry_after = int(retry_after)
        self._reject_body = reject_body or _plain_reject_body
        self._handler_cls = _deferred_handler(
            RequestHandlerClass, self.request_timeout
        )
        self._ready: "queue.Queue[_Conn | None]" = queue.Queue()
        self._park_q: "queue.Queue[_Conn]" = queue.Queue()
        self._conns: set[_Conn] = set()
        self._conns_lock = threading.Lock()
        self._stop_evt = threading.Event()
        self._loop_done = threading.Event()
        self._loop_done.set()  # not serving yet
        self._threads: list[threading.Thread] = []
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self.rejected = 0
        self.requests_served = 0

    # ----------------------------------------------------------- lifecycle

    def serve_forever(self, poll_interval: float = 0.5) -> None:
        self._stop_evt.clear()
        self._loop_done.clear()
        self._threads = [
            threading.Thread(
                target=self._worker,
                name=f"http-pool-{self.server_kind}-{i}",
                daemon=True,
            )
            for i in range(self.workers)
        ]
        for t in self._threads:
            t.start()
        sel = selectors.DefaultSelector()
        self.socket.setblocking(False)
        sel.register(self.socket, selectors.EVENT_READ, "accept")
        sel.register(self._wake_r, selectors.EVENT_READ, "wake")
        last_sweep = time.monotonic()
        try:
            while not self._stop_evt.is_set():
                for key, _ in sel.select(timeout=poll_interval):
                    if key.data == "accept":
                        self._accept()
                    elif key.data == "wake":
                        self._drain_wake(sel)
                    else:
                        # parked connection has bytes (or EOF): hand it
                        # to the pool; the selector forgets it until the
                        # worker parks it again
                        sel.unregister(key.fileobj)
                        conn = key.data
                        conn.last_active = time.monotonic()
                        self._ready.put(conn)
                now = time.monotonic()
                if now - last_sweep >= _IDLE_SWEEP_INTERVAL:
                    last_sweep = now
                    self._sweep_idle(sel)
        finally:
            for t in self._threads:
                self._ready.put(None)
            for key in list(sel.get_map().values()):
                if isinstance(key.data, _Conn):
                    self._close_conn(key.data)
            sel.close()
            for t in self._threads:
                t.join(timeout=2.0)
            # connections still queued or mid-request: close them so
            # server_close leaves no fds behind
            while True:
                try:
                    c = self._ready.get_nowait()
                except queue.Empty:
                    break
                if c is not None:
                    self._close_conn(c)
            self._loop_done.set()

    def shutdown(self) -> None:
        self._stop_evt.set()
        self._wake()
        self._loop_done.wait(timeout=10.0)

    def server_close(self) -> None:
        super().server_close()
        with self._conns_lock:
            leftover = list(self._conns)
        for c in leftover:
            self._close_conn(c)
        for s in (self._wake_r, self._wake_w):
            try:
                s.close()
            except OSError:
                pass

    # ------------------------------------------------------------- accept

    def _accept(self) -> None:
        while True:
            try:
                sock, addr = self.socket.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                return
            with self._conns_lock:
                saturated = len(self._conns) >= self.max_connections
            if saturated:
                self._send_503(sock)
                continue
            try:
                sock.settimeout(self.request_timeout)
                handler = self._handler_cls(sock, addr, self)
                handler.close_connection = True
            except Exception:
                try:
                    sock.close()
                except OSError:
                    pass
                continue
            conn = _Conn(sock, handler)
            with self._conns_lock:
                self._conns.add(conn)
            # straight into the selector: the request bytes may not
            # have arrived yet, and readiness is what dispatches work
            self._park_q.put(conn)
            self._wake()

    def _send_503(self, sock) -> None:
        """Explicit saturation signal: never accepted into the pool, so
        the client sees immediate, parseable backpressure instead of a
        connect that hangs until some thread frees up."""
        self.rejected += 1
        from . import metrics

        metrics.gateway_rejected_total.inc(server=self.server_kind)
        try:
            ctype, body = self._reject_body()
        except Exception:
            ctype, body = _plain_reject_body()
        head = (
            "HTTP/1.1 503 Service Unavailable\r\n"
            f"Retry-After: {self.retry_after}\r\n"
            f"Content-Type: {ctype}\r\n"
            f"Content-Length: {len(body)}\r\n"
            "Connection: close\r\n\r\n"
        ).encode("ascii")
        try:
            sock.settimeout(2.0)
            sock.sendall(head + body)
        except OSError:
            pass
        finally:
            try:
                sock.close()
            except OSError:
                pass

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

    def _serve_dispatch(self, conn: _Conn) -> None:
        """Serve request(s) on one ready connection, then park or
        close. The worker is pinned only while requests are actually
        flowing."""
        from . import metrics

        h = conn.handler
        for _ in range(_MAX_REQUESTS_PER_DISPATCH):
            metrics.gateway_inflight.inc(server=self.server_kind)
            try:
                h.handle_one_request()
                with self._conns_lock:  # += is not atomic across workers
                    self.requests_served += 1
            except Exception:
                h.close_connection = True
            finally:
                metrics.gateway_inflight.dec(server=self.server_kind)
            if getattr(h, "close_connection", True):
                self._close_conn(conn)
                return
            if not self._readable_now(conn):
                conn.last_active = time.monotonic()
                self._park_q.put(conn)
                self._wake()
                return
        # fairness: a pipelining client with more buffered requests goes
        # to the back of the ready queue instead of monopolizing this
        # worker
        self._ready.put(conn)

    def _readable_now(self, conn: _Conn) -> bool:
        """True when the connection's NEXT request is already here —
        either buffered in the handler's rfile (pipelining) or sitting
        in the kernel — so the worker keeps serving instead of paying a
        park/wake round trip. A momentary non-blocking peek: rfile.peek
        returns buffered bytes without a raw read, and an empty buffer
        does one non-blocking raw read that yields b'' when the wire is
        quiet."""
        try:
            conn.sock.setblocking(False)
        except OSError:
            return False
        try:
            return bool(conn.handler.rfile.peek(1))
        except Exception:
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
        except (BlockingIOError, InterruptedError):
            pass
        except OSError:
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
            if not isinstance(conn, _Conn):
                continue
            if now - conn.last_active > self.idle_timeout:
                try:
                    sel.unregister(key.fileobj)
                except (KeyError, ValueError):
                    continue
                self._close_conn(conn)

    def _close_conn(self, conn: _Conn) -> None:
        with self._conns_lock:
            self._conns.discard(conn)
        conn.handler._pool_finish()
        try:
            conn.sock.close()
        except OSError:
            pass

    # ------------------------------------------------------------- status

    def pool_status(self) -> dict:
        """Live front-end state for /debug/gateway and /status."""
        with self._conns_lock:
            open_conns = len(self._conns)
        return {
            "kind": "pooled",
            "server": self.server_kind,
            "workers": self.workers,
            "accept_queue": self.accept_queue,
            "max_connections": self.max_connections,
            "open_connections": open_conns,
            "ready_backlog": self._ready.qsize(),
            "requests_served": self.requests_served,
            "rejected_total": self.rejected,
        }


def build_http_server(
    server_address,
    RequestHandlerClass,
    server_kind: str = "http",
    workers: int = 32,
    accept_queue: int = 128,
    tls=None,
    reject_body=None,
    idle_timeout: float = 30.0,
    request_timeout: float = 120.0,
):
    """The data-plane server factory: a :class:`PooledHTTPServer`
    (bounded workers and backpressure) unless `workers` is 0 (the
    explicit opt-out to the unbounded one-thread-per-connection stdlib
    server) or `tls` is set (the TLS wrapper targets the threaded server;
    see the module docstring). Both share the ``serve_forever`` /
    ``shutdown`` / ``server_close`` lifecycle."""
    if workers and tls is None:
        return PooledHTTPServer(
            server_address,
            RequestHandlerClass,
            workers=workers,
            accept_queue=accept_queue,
            server_kind=server_kind,
            reject_body=reject_body,
            idle_timeout=idle_timeout,
            request_timeout=request_timeout,
        )
    from http.server import ThreadingHTTPServer

    return ThreadingHTTPServer(server_address, RequestHandlerClass)


def status_of(http_server) -> dict:
    """`pool_status` for either server flavor (the threaded fallback
    reports its kind so /debug/gateway always answers)."""
    if isinstance(http_server, PooledHTTPServer):
        return http_server.pool_status()
    return {"kind": "threading", "server": "", "workers": 0}


# --------------------------------------------------------------------------
# Native response-body egress: `send_body` hands a body to the host
# library's scatter-gather sender (`sn_sendv`: writev straight from the
# body buffers, the GIL released for the whole send, poll-driven on the
# pool's non-blocking sockets), so N workers push N responses at once.
# It engages when the handler runs under a PooledHTTPServer, the body
# clears _NATIVE_BODY_MIN (header-sized bodies are cheaper under the GIL
# than a flush and a ctypes call), SEAWEED_EC_NATIVE is not 0 and the
# connection is not TLS; else wfile.write sends the same bytes.
# --------------------------------------------------------------------------

_NATIVE_BODY_MIN = 8 << 10


def send_body(handler, *parts) -> int:
    """Write an HTTP response body (headers already sent by end_headers)
    through the native egress where it engages, else through wfile: the
    same bytes on the wire either way. Returns bytes written. A short or
    failed native send marks the connection dead and raises OSError (the
    framing is broken; the pool closes the socket), as a wfile.write
    OSError would; a host library that fails to build or load raises
    too."""
    parts = [p for p in parts if len(p)]
    total = sum(len(p) for p in parts)
    if handler.command == "HEAD" or total == 0:
        return 0
    from . import metrics

    srv = getattr(handler, "server", None)
    if (total >= _NATIVE_BODY_MIN and isinstance(srv, PooledHTTPServer) and _native_enabled()
            and not isinstance(handler.connection, ssl.SSLSocket)):
        from . import native

        handler.wfile.flush()
        try:
            native.sendv(handler.connection.fileno(), parts, timeout_ms=int(srv.request_timeout * 1000))
        except OSError:
            # a partial body is broken framing: never reuse this
            # connection, and surface as a stdlib write error
            handler.close_connection = True
            raise
        metrics.net_bytes_sent_total.inc(total, plane="native", direction="read")
        return total
    for p in parts:
        handler.wfile.write(p)
    metrics.net_bytes_sent_total.inc(total, plane="python", direction="read")
    metrics.net_bytes_copied_total.inc(total, plane="python", direction="read")
    return total


def _native_enabled() -> bool:
    """False where SEAWEED_EC_NATIVE=0 (read live, as ec/native_io.py
    reads it)."""
    return os.environ.get("SEAWEED_EC_NATIVE", "1") != "0"
