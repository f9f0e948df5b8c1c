"""Shard net plane: the network half of the zero-copy EC byte path.

Port of seaweedfs_tpu/ec/net_plane.py, trimmed to the shard-read opcode
(`SWNP`): a small TCP sidecar next to a volume server that serves EC
shard byte ranges with

- **native egress**: `sn_send_file` splices the shard fd straight into
  the socket (sendfile(2), kernel to kernel, GIL released); Python
  touches only the 38-byte request header and the trace metadata;
- **native ingress**: the client lands streams DIRECTLY in caller-owned
  pooled 4096-aligned buffers (`sn_recv_into`) with the granule CRC32C
  rolled during the copy-in, so the sidecar verify in
  ec/peer_rebuild.py costs no extra byte pass.

Fallback routing, as in the JAX package:

- `SEAWEED_EC_NATIVE=0`: the server egresses through Python
  (pread, sendall), and peer_rebuild never calls the native landing
  (ec/native_io.enabled() is the one gate);
- an ARMED fault registry: the server answers through the Python egress
  so byte-mutating chaos has materialized bytes to work on, and
  peer_rebuild routes its client side to the Python fetch;
- a peer without the sidecar: the client memoizes the refused connect
  and raises :class:`NetPlaneUnavailable`, which peer_rebuild turns into
  a per-stream fallback to the Python fetch.

A port server has no needle, write or blob resolver (those opcodes are
the JAX package's gateway and stream-shard paths, not ported yet). It
answers needle-read (`SWNR`) and write (`SWNW`) frames exactly as a JAX
`ShardNetPlane` built without those resolvers does: a status-1 refusal,
after draining a write's payload, so the connection stays in frame sync.

Protocol (little-endian, persistent connection, one in-flight request
per connection):

    request:  b"SWNP" | u32 volume_id | u32 shard_id | u64 generation
              | u64 offset | u64 size | u16 meta_len       (38 bytes)
              | meta_len bytes of "key\\tvalue" lines: the
              x-sw-trace-id / x-sw-parent-span / x-request-id metadata,
              so a peer fetch lands in the caller's one trace
    response: u8 status | u64 n | n bytes
              status 0 = ok (n = payload length, may be < size at EOF);
              status 1 = error (n = UTF-8 message length);
              status 2 = volume-level refusal (same frame shape as 1)

The sidecar listens on ``grpc_port + NET_PLANE_PORT_OFFSET`` so peers
derive its address from the holder map's gRPC address (`net_addr`).
"""

from __future__ import annotations

import os
import socket
import struct
import threading
import time

import numpy as np

from .. import faults
from ..utils import metrics as M
from ..utils import native
from ..utils import request_id as _rid
from ..utils import trace
from . import native_io

MAGIC = b"SWNP"
# Needle-read and write opcodes of the JAX package's sidecar: the same
# 38-byte header; a port server refuses both in protocol.
MAGIC_NEEDLE = b"SWNR"
MAGIC_WRITE = b"SWNW"
# magic, volume, shard, gen, offset, size, meta_len
_REQ = struct.Struct("<4sIIQQQH")
_RESP = struct.Struct("<BQ")  # status, n
NET_PLANE_PORT_OFFSET = 10000  # net plane port = grpc port + this

_SEND_CHUNK = 1 << 20  # python-plane egress chunking
_MAX_REQUEST = 1 << 32
_MAX_META = 4096
# error-response bodies are short refusal strings; a length beyond this
# means the stream desynced (or a hostile peer)
_MAX_ERROR = 1 << 16
# the largest write payloads a JAX server would take (needle, blob): a
# larger write frame is a desynced or hostile one and drops the
# connection, as it does there
_MAX_NEEDLE = 64 << 20
_MAX_BLOB = 256 << 20


def _encode_meta() -> bytes:
    """The active request-id / trace context as a metadata blob: what
    trace.grpc_metadata() would put on the RPC."""
    md = list(trace.grpc_metadata() or [])
    if not md:
        return b""
    blob = "\n".join(f"{k}\t{v}" for k, v in md).encode()
    return blob[:_MAX_META]


def _decode_meta(blob: bytes) -> dict:
    md: dict = {}
    for line in blob.decode(errors="replace").splitlines():
        k, _, v = line.partition("\t")
        if k and v:
            md[k.lower()] = v
    return md


class NetPlaneError(Exception):
    """Transport/protocol failure on an established plane connection:
    transient from the caller's point of view (retry or fall back)."""


class NetPlaneVolumeRefusal(NetPlaneError):
    """A refusal that applies to the WHOLE volume (status 2)."""


class NetPlaneUnavailable(Exception):
    """The peer serves no shard net plane (connect refused). Memoized per
    peer; callers route the stream to the Python fetch instead."""


def derive_port(grpc_port: int) -> int:
    """Net-plane port derived from a gRPC port: the same pure function on
    the serving and the connecting side. High ports wrap back into the
    valid range deterministically."""
    p = grpc_port + NET_PLANE_PORT_OFFSET
    if p > 65535:
        p = 1024 + (p % 64512)
    return p


def net_addr(grpc_peer: str) -> tuple[str, int]:
    """Net-plane (host, port) derived from a holder-map gRPC address."""
    host, _, port = grpc_peer.rpartition(":")
    return host, derive_port(int(port))


def egress_native() -> bool:
    """True when the server should splice with sendfile: the native
    plane on AND the fault registry disarmed (byte-mutating chaos needs
    materialized bytes)."""
    return native_io.enabled() and not faults.active()


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            raise NetPlaneError("connection closed mid-message")
        got += r
    return bytes(buf)


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------


class ShardNetPlane:
    """TCP sidecar serving EC shard byte ranges: the generation fence,
    the short-read-at-EOF torn-stream contract and the
    ``server.ec_shard_read`` chaos point of the shard-read RPC.

    ``resolve(volume_id, shard_id, generation) -> (fd, size)`` supplies
    the shard fd and its byte size; it raises :class:`NetPlaneError`
    with the refusal message (not mounted / stale generation / shard not
    local). The server never closes resolved fds: they belong to the
    caller's mounted volume.
    """

    def __init__(self, ip: str, port: int, resolve, request_timeout: float = 60.0,
                 server_label: str = ""):
        self.resolve = resolve
        self.request_timeout = request_timeout
        self.server_label = server_label
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((ip, port))
        self._sock.listen(128)
        self.ip, self.port = self._sock.getsockname()[:2]
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._accept_loop, daemon=True,
                                        name="shard-net-plane")
        self._conns: set[socket.socket] = set()
        self._conns_lock = threading.Lock()
        self.requests = 0
        self.sendfile_bytes = 0
        self.python_bytes = 0

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        try:
            # close() alone does not wake a thread blocked in accept();
            # shutdown() does, so the join below returns at once
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.close()
            except OSError:
                pass
        self._thread.join(timeout=2.0)

    # ------------------------------------------------------------ serving

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return  # listener closed
            with self._conns_lock:
                self._conns.add(conn)
            threading.Thread(target=self._serve_conn, args=(conn,), daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            conn.settimeout(self.request_timeout)
            while not self._stop.is_set():
                try:
                    hdr = _recv_exact(conn, _REQ.size)
                except (NetPlaneError, OSError):
                    return  # client went away between requests
                magic, vid, sid, gen, off, size, mlen = _REQ.unpack(hdr)
                if (
                    magic not in (MAGIC, MAGIC_NEEDLE, MAGIC_WRITE)
                    or size > _MAX_REQUEST
                    or mlen > _MAX_META
                ):
                    return  # not our protocol: drop the connection
                try:
                    md = _decode_meta(_recv_exact(conn, mlen)) if mlen else {}
                except (NetPlaneError, OSError):
                    return
                self.requests += 1
                # adopt the caller's request id and trace context: a peer
                # fetch stays ONE trace whichever transport carried it
                _rid.ensure(md.get(trace.REQUEST_ID_KEY))
                # the JAX server's span per opcode (sid slot = cookie and
                # gen slot = needle id in the needle opcodes)
                if magic == MAGIC_WRITE:
                    op, attrs = "rpc.needle_write", {"volume": vid, "needle": gen, "size": size}
                elif magic == MAGIC_NEEDLE:
                    op, attrs = "rpc.needle_read", {"volume": vid, "needle": gen}
                else:
                    op, attrs = "rpc.ec_shard_read", {
                        "volume": vid, "shard": sid, "offset": off, "size": size,
                    }
                sp = trace.start_from_metadata(op, md, server=self.server_label, plane="native",
                                               **attrs)
                t0 = time.perf_counter()
                try:
                    if magic == MAGIC_WRITE:
                        ok = self._refuse_write(conn, size, md)
                    elif magic == MAGIC_NEEDLE:
                        ok = self._error(conn, "needle reads not served here")
                    else:
                        ok = self._serve_one(conn, vid, sid, gen, off, size)
                finally:
                    trace.add_stage(sp, "stream", time.perf_counter() - t0)
                    trace.finish(sp)
                if not ok:
                    return
        finally:
            with self._conns_lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _error(self, conn, msg: str, status: int = 1) -> bool:
        body = msg.encode(errors="replace")
        try:
            conn.sendall(_RESP.pack(status, len(body)) + body)
            return True
        except OSError:
            return False

    def _serve_one(self, conn, vid, sid, gen, off, size) -> bool:
        """Serve one range request; False = connection must close."""
        try:
            # the shard-read RPC's chaos point: a raised IOError is a
            # refused stream (the client replans); a mutate applies on
            # the Python egress below, where the armed registry routes
            faults.fire("server.ec_shard_read", volume=vid, shard=sid)
        except IOError as e:
            return self._error(conn, str(e))
        try:
            fd, fsize = self.resolve(vid, sid, gen)
        except NetPlaneError as e:
            return self._error(conn, str(e))
        n = max(0, min(size, fsize - off)) if off < fsize else 0
        try:
            conn.sendall(_RESP.pack(0, n))
        except OSError:
            return False
        if n == 0:
            return True
        if egress_native():
            try:
                sent = native.send_file(conn.fileno(), fd, off, n,
                                        timeout_ms=int(self.request_timeout * 1000))
            except OSError:
                return False  # peer died mid-splice: header already out
            self.sendfile_bytes += sent
            M.net_bytes_sent_total.inc(sent, plane="native", direction="read")
            return sent == n
        # Python egress (SEAWEED_EC_NATIVE=0 or an armed registry):
        # pread, mutate, sendall. A mutate that shrinks the chunk tears
        # the stream, which the client must catch.
        remaining, o = n, off
        while remaining > 0:
            chunk = os.pread(fd, min(_SEND_CHUNK, remaining), o)
            if not chunk:
                break
            orig = len(chunk)
            chunk = faults.mutate("server.ec_shard_read", chunk, volume=vid, shard=sid, offset=o)
            M.net_bytes_copied_total.inc(orig, plane="python", direction="read")
            try:
                if chunk:
                    conn.sendall(chunk)
            except OSError:
                return False
            self.python_bytes += len(chunk)
            M.net_bytes_sent_total.inc(len(chunk), plane="python", direction="read")
            if len(chunk) < orig:
                return False  # torn stream: the connection is dead
            o += orig
            remaining -= orig
        return remaining == 0

    @staticmethod
    def _drain(conn, n: int) -> bool:
        """Consume `n` unread payload bytes so a refusal sent after the
        header leaves the connection in frame sync."""
        if n <= 0:
            return True
        buf = bytearray(min(n, _SEND_CHUNK))
        view = memoryview(buf)
        left = n
        try:
            while left > 0:
                r = conn.recv_into(view[: min(left, len(buf))])
                if r == 0:
                    return False
                left -= r
        except OSError:
            return False
        return True

    def _refuse_write(self, conn, size: int, md: dict) -> bool:
        """A write frame to a server with no write resolver: drop a
        desynced frame (unknown kind, oversized payload), else drain the
        payload and refuse in protocol."""
        kind = md.get("x-sw-w-kind", "")
        if kind not in ("needle", "blob") or size > (_MAX_NEEDLE if kind == "needle" else _MAX_BLOB):
            return False
        if not self._drain(conn, size):
            return False
        return self._error(conn, f"{kind} writes not served here")

    def status(self) -> dict:
        """Sidecar state for status surfaces (the JAX package's keys; a
        port server serves no needle or write request)."""
        return {
            "port": self.port,
            "requests": self.requests,
            "needle_requests": 0,
            "sendfile_bytes": self.sendfile_bytes,
            "python_bytes": self.python_bytes,
            "write_requests": 0,
            "write_native_bytes": 0,
            "write_python_bytes": 0,
        }


# ---------------------------------------------------------------------------
# Client
# ---------------------------------------------------------------------------


class NetPlaneClient:
    """Cached client connections to peers' shard net planes, landing
    payload bytes straight in caller buffers (``sn_recv_into``) with the
    granule CRC rolled during the copy-in.

    One cached connection per peer address (requests on one address are
    serialized: peer fetch streams one shard from a given holder at a
    time). A peer whose plane port refuses the connect is memoized, and
    later calls raise :class:`NetPlaneUnavailable` at once, for
    ``unavailable_ttl`` seconds (``SEAWEED_EC_NET_PLANE_RETRY_S``,
    default 30): a sidecar that comes up later is re-probed and
    re-adopted. :meth:`reset` drops the memo at once.
    """

    def __init__(self, timeout: float = 30.0, connect_timeout: float = 2.0,
                 unavailable_ttl: float | None = None):
        self.timeout = timeout
        self.connect_timeout = connect_timeout
        if unavailable_ttl is None:
            try:
                unavailable_ttl = float(os.environ.get("SEAWEED_EC_NET_PLANE_RETRY_S", "30"))
            except ValueError:
                unavailable_ttl = 30.0
        self.unavailable_ttl = unavailable_ttl
        self._conns: dict[tuple[str, int], socket.socket] = {}
        self._locks: dict[tuple[str, int], threading.Lock] = {}
        # addr -> monotonic time of the refused connect (TTL'd memo)
        self._no_plane: dict[tuple[str, int], float] = {}
        self._lock = threading.Lock()

    def close(self) -> None:
        with self._lock:
            conns = list(self._conns.values())
            self._conns.clear()
        for c in conns:
            try:
                c.close()
            except OSError:
                pass

    def reset(self, addr: tuple[str, int] | None = None) -> None:
        """Forget the no-plane memo for `addr` (or every peer): the next
        call re-probes the connect instead of waiting out the TTL."""
        with self._lock:
            if addr is None:
                self._no_plane.clear()
            else:
                self._no_plane.pop(addr, None)

    def _addr_lock(self, addr) -> threading.Lock:
        with self._lock:
            return self._locks.setdefault(addr, threading.Lock())

    def _check_memo(self, addr) -> None:
        """Raise if `addr` is inside its no-plane TTL; forget an expired
        refusal so the next connect re-probes. Caller holds self._lock."""
        refused_at = self._no_plane.get(addr)
        if refused_at is not None:
            if time.monotonic() - refused_at < self.unavailable_ttl:
                raise NetPlaneUnavailable(f"{addr[0]}:{addr[1]}")
            del self._no_plane[addr]

    def _connect(self, addr) -> socket.socket:
        """Fresh plane connection; a refused connect is memoized for
        `unavailable_ttl` seconds."""
        try:
            s = socket.create_connection(addr, timeout=self.connect_timeout)
        except OSError as e:
            with self._lock:
                self._no_plane[addr] = time.monotonic()
            raise NetPlaneUnavailable(f"{addr[0]}:{addr[1]}: {e}") from e
        s.settimeout(self.timeout)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return s

    def _conn(self, addr) -> socket.socket:
        with self._lock:
            self._check_memo(addr)
            s = self._conns.get(addr)
        if s is not None:
            return s
        s = self._connect(addr)
        with self._lock:
            self._conns[addr] = s
        return s

    def _drop(self, addr) -> None:
        with self._lock:
            s = self._conns.pop(addr, None)
        if s is not None:
            try:
                s.close()
            except OSError:
                pass

    @staticmethod
    def _read_refusal(addr, s, n: int) -> str:
        """Decode a status != 0 frame's body. Raises NetPlaneError when
        the frame is desynced or the body cannot be read: the connection
        is then unusable."""
        if n > _MAX_ERROR:
            raise NetPlaneError(f"{addr}: desynced error frame ({n})")
        try:
            return _recv_exact(s, n).decode(errors="replace")
        except (OSError, NetPlaneError) as e:
            raise NetPlaneError(f"{addr}: error body lost ({e})") from e

    def _request(self, addr, vid, sid, gen, off, size) -> socket.socket:
        """Send one range request and parse the response header; returns
        the connection positioned at the payload. A server-side EOF clamp
        raises: range callers sized their landing buffer."""
        s = self._conn(addr)
        meta = _encode_meta()
        try:
            s.sendall(_REQ.pack(MAGIC, vid, sid, gen, off, size, len(meta)) + meta)
            head = _recv_exact(s, _RESP.size)
        except (OSError, NetPlaneError) as e:
            self._drop(addr)
            raise NetPlaneError(f"{addr}: {e}") from e
        status, n = _RESP.unpack(head)
        if status != 0:
            try:
                msg = self._read_refusal(addr, s, n)
            except NetPlaneError:
                self._drop(addr)
                raise
            raise NetPlaneError(f"{addr}: {msg}")
        if n > size:
            # the server only ever clamps DOWN; a longer claim is a
            # desynced or hostile peer
            self._drop(addr)
            raise NetPlaneError(f"{addr}: oversized frame {n}/{size}")
        if n != size:
            # EOF clamp: the shard-read RPC's short read. The connection
            # still holds n payload bytes; cheaper to drop than to drain
            self._drop(addr)
            raise NetPlaneError(f"{addr}: short stream {n}/{size}")
        return s

    def read_into(
        self,
        addr: tuple[str, int],
        vid: int,
        sid: int,
        gen: int,
        off: int,
        size: int,
        dst: np.ndarray,
        *,
        granule: int = 0,
    ) -> np.ndarray | None:
        """Land `size` bytes of shard `sid` @`off` DIRECTLY in `dst` (1-D
        C-contiguous uint8 view of a pooled aligned buffer) through
        `sn_recv_into`. With granule > 0 returns the granule CRCs rolled
        during the copy-in (completed granules plus the partial tail) as
        a u32 ndarray: the caller compares them against the .ecsum
        sidecar with no extra pass over the bytes."""
        with self._addr_lock(addr):
            s = self._request(addr, vid, sid, gen, off, size)
            try:
                crc_state = np.zeros(1, np.uint32)
                filled = np.zeros(1, np.uint64)
                out_crcs = np.zeros((size // granule + 2) if granule else 1, np.uint32)
                out_counts = np.zeros(1, np.int32)
                got = native.recv_into(
                    s.fileno(), dst, size, timeout_ms=int(self.timeout * 1000),
                    granule=granule, crc_state=crc_state, filled_state=filled,
                    out_crcs=out_crcs, out_counts=out_counts,
                )
                if got != size:
                    raise NetPlaneError(f"{addr}: torn stream {got}/{size}")
            except (OSError, NetPlaneError) as e:
                self._drop(addr)
                if isinstance(e, NetPlaneError):
                    raise
                raise NetPlaneError(f"{addr}: {e}") from e
        M.net_bytes_received_total.inc(got, plane="native", direction="read")
        if not granule:
            return None
        crcs = list(out_crcs[: int(out_counts[0])])
        if size % granule:
            crcs.append(int(crc_state[0]))
        return np.asarray(crcs, dtype=np.uint32)

    def read_bytes(self, addr, vid, sid, gen, off, size) -> bytes:
        """Python-plane fetch over the same wire: materializes the payload
        as `bytes` (counted against the python plane's received and
        copied totals). Granule re-reads and the Python-plane stream use
        it."""
        with self._addr_lock(addr):
            s = self._request(addr, vid, sid, gen, off, size)
            try:
                data = _recv_exact(s, size)
            except (OSError, NetPlaneError) as e:
                self._drop(addr)
                raise NetPlaneError(f"{addr}: {e}") from e
        M.net_bytes_received_total.inc(size, plane="python", direction="read")
        M.net_bytes_copied_total.inc(size, plane="python", direction="read")
        return data


def make_fetch_into(client: NetPlaneClient, vid: int, generation: int, addr_of=net_addr):
    """Adapt a :class:`NetPlaneClient` to peer_rebuild's injected
    ``fetch_into(peer, sid, off, size, dst, granule)`` transport,
    translating plane exceptions into the rebuild's retry and fallback
    vocabulary (NetPlaneError -> PeerFetchTransient, NetPlaneUnavailable
    -> PeerPlaneUnavailable)."""
    from .peer_rebuild import PeerFetchTransient, PeerPlaneUnavailable

    def fetch_into(peer, sid, off, size, dst, granule):
        try:
            return client.read_into(addr_of(peer), vid, sid, generation, off, size, dst,
                                    granule=granule)
        except NetPlaneUnavailable as e:
            raise PeerPlaneUnavailable(str(e)) from e
        except NetPlaneError as e:
            raise PeerFetchTransient(str(e)) from e

    return fetch_into
