"""Shard net plane: the network half of the zero-copy EC byte path.

Port of seaweedfs_tpu/ec/net_plane.py, whole: a small TCP sidecar next to
a volume server that serves EC shard byte ranges (`SWNP`, whole shards
for `fetch_shard_to_file` too), whole needle payloads (`SWNR`) and needle
and blob writes (`SWNW`) with

- **native egress**: `sn_send_file` splices the shard fd straight into
  the socket (sendfile(2), kernel to kernel, GIL released); Python
  touches only the 38-byte request header and the trace metadata;
- **native ingress**: the client lands streams DIRECTLY in caller-owned
  pooled 4096-aligned buffers (`sn_recv_into`) with the granule CRC32C
  rolled during the copy-in, so the sidecar verify in
  ec/peer_rebuild.py costs no extra byte pass;
- **needle reads**: a server built with `resolve_needle` splices a
  needle's payload with sendfile; the client's `read_needle` lands it in
  a pooled aligned buffer with the CRC32C fused into the copy-in and
  checked against the needle's stored CRC, on a connection checked out
  of a per-address pool, so concurrent readers fan out;
- **needle writes**: a server built with `resolve_write` lands a
  needle's payload in a pooled buffer (`_land_payload`, CRC fused),
  checks it against the CRC the client sent, appends it through the
  resolver and ACKs the stored CRC; `write_needle` is the client side;
- **blob writes**: a server built with `resolve_blob` lands the durable
  parity's remote stream-shard extents socket to disk (`sn_recv_file`,
  CRC32C fused) and fsyncs before it ACKs; `write_blob` and
  `unlink_blob` are the client side (mq/stream_parity.py's `net:` roots).

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

A server built without one of the resolvers answers its frames as a JAX
`ShardNetPlane` built without it does: a status-1 refusal, after
draining a write's payload, so the connection stays in frame sync. An
armed fault registry refuses needle reads, and writes unless every armed
point is on the write path (`write_plane_admissible`).

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
    needle:   b"SWNR" header with shard slot = cookie, generation slot =
              needle id; the OK response is u8 0 | u64 n | u32 stored
              CRC32C | n payload bytes
    write:    b"SWNW" header | meta | payload (size bytes). kind=needle:
              shard slot = cookie, generation slot = needle id, offset
              slot = the client's CRC32C of the payload, meta
              x-sw-w-flags / -name / -mime (urlsafe base64) / -jwt /
              -fsync / -replicate. kind=blob: offset slot = the blob
              offset, meta x-sw-w-op / -path (urlsafe base64) / -crc /
              -fsync / -jwt. The ACK is status 0, n = bytes stored, then
              u32 CRC32C as stored

The sidecar listens on ``grpc_port + NET_PLANE_PORT_OFFSET`` so peers
derive its address from the holder map's gRPC address (`net_addr`).
"""

from __future__ import annotations

import base64
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
from ..utils.crc import crc32c as _crc
from . import native_io

MAGIC = b"SWNP"
# The needle-read and write opcodes: the same 38-byte header with its
# fields reinterpreted (see the module docstring).
MAGIC_NEEDLE = b"SWNR"
MAGIC_WRITE = b"SWNW"
# magic, volume, shard, gen, offset, size, meta_len
_REQ = struct.Struct("<4sIIQQQH")
_RESP = struct.Struct("<BQ")  # status, n
_NEEDLE_CRC = struct.Struct("<I")  # appended to an OK write response
NET_PLANE_PORT_OFFSET = 10000  # net plane port = grpc port + this

_SEND_CHUNK = 1 << 20  # python-plane egress chunking
_FETCH_CHUNK = 4 << 20  # fetch_shard_to_file's landing buffer
_MAX_REQUEST = 1 << 32
_MAX_META = 4096
# error-response bodies are short refusal strings; a length beyond this
# means the stream desynced (or a hostile peer)
_MAX_ERROR = 1 << 16
# the largest write payloads a server takes (needle, blob): a larger
# write frame is a desynced or hostile one and drops the connection
_MAX_NEEDLE = 64 << 20
_MAX_BLOB = 256 << 20
# never park landing buffers wider than this in the process-wide pool
_POOL_MAX_WIDTH = 8 << 20

# Write-opcode chaos routing: the write plane keeps serving while the only
# armed fault points live on the write path's own seams (the net plane's
# pwrite window and the volume's append/fsync window). Any other armed
# point refuses write service, so the fallback transport stays the chaos
# surface, as for the read opcodes.
_WRITE_CHAOS_NS = ("ec.net.write.", "volume.write.")


def write_plane_admissible() -> bool:
    """True when the write opcode may serve despite an armed registry:
    every armed point lives in the write path's own chaos namespaces (or
    nothing is armed at all)."""
    return all(p.startswith(_WRITE_CHAOS_NS) for p in faults.armed_points())


def _pool_width(n: int) -> int:
    """Landing-pool width class of an n-byte payload: the next power of
    two, at least 64 KiB. The pool keeps a free list per exact width for
    the life of the process, so pooling raw payload sizes would keep one
    buffer per distinct size; the classes bound them to about a dozen."""
    return max(64 * 1024, 1 << (max(1, n) - 1).bit_length())


def _encode_meta(extra: dict | None = None) -> bytes:
    """The active request-id / trace context as a metadata blob (what
    trace.grpc_metadata() would put on the RPC), plus any opcode-specific
    key/value pairs (the write opcode's kind / op / path / crc / fsync /
    jwt lines). Values must not contain tab or newline; binary fields
    ride urlsafe base64 (`_b64`)."""
    md = list(trace.grpc_metadata() or [])
    if extra:
        md.extend((k, str(v)) for k, v in extra.items() if v is not None and str(v) != "")
    if not md:
        return b""
    blob = "\n".join(f"{k}\t{v}" for k, v in md).encode()
    return blob[:_MAX_META]


def _b64(value: bytes | str) -> str:
    if isinstance(value, str):
        value = value.encode()
    return base64.urlsafe_b64encode(value).decode()


def _unb64(value: str) -> bytes:
    try:
        return base64.urlsafe_b64decode(value.encode())
    except (ValueError, TypeError):
        return b""


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
    """A refusal that applies to the WHOLE volume or blob root: the
    server answers status 2. Raised by resolvers server-side; surfaces
    client-side as a NetPlaneError with ``volume_refusal=True``."""


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


def free_grpc_port(host: str = "127.0.0.1") -> int:
    """A free port whose +10000 shadow is free too, so that `derive_port`
    of it is that shadow: a gRPC port and its net plane, or a master's
    HTTP port and its gRPC port. Free when asked; a later bind by another
    process can still take either."""
    while True:
        with socket.socket() as s:
            s.bind((host, 0))
            p = s.getsockname()[1]
        if p + NET_PLANE_PORT_OFFSET > 65535:
            continue
        try:
            with socket.socket() as s:
                s.bind((host, p + NET_PLANE_PORT_OFFSET))
        except OSError:
            continue
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

    ``resolve_needle(volume_id, needle_id, cookie) -> (fd, offset, size,
    crc32c, close_after)`` (optional) locates a needle's payload for the
    needle-read opcode; ``close_after`` marks an fd the server closes
    once the response is sent (a per-request open). It raises
    :class:`NetPlaneVolumeRefusal` where no needle of the volume is
    served here (status 2: the client may negative-cache the volume) and
    :class:`NetPlaneError` for this needle only (status 1).

    ``resolve_write(volume_id, needle_id, cookie, data, md) ->
    (stored_size, stored_crc)`` (optional) appends one needle for the
    write opcode, building the record the volume server's other
    transports build. :class:`NetPlaneVolumeRefusal` means the volume can
    never take plane writes here; :class:`NetPlaneError`, ``OSError`` and
    ``ValueError`` refuse this one write.

    ``resolve_blob(path, op, md) -> fd | None`` (optional) serves
    kind=blob writes: remote durable-parity stream-shard extents. It
    validates `path` against the server's blob root and returns an fd
    the server pwrites into and closes (``op == "write"``), or handles
    the operation itself and returns None (``op == "unlink"``).
    """

    def __init__(self, ip: str, port: int, resolve, request_timeout: float = 60.0,
                 server_label: str = "", resolve_needle=None, resolve_write=None,
                 resolve_blob=None):
        self.resolve = resolve
        self.resolve_needle = resolve_needle
        self.resolve_write = resolve_write
        self.resolve_blob = resolve_blob
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
        self.needle_requests = 0
        self.sendfile_bytes = 0
        self.python_bytes = 0
        self.write_requests = 0
        self.write_native_bytes = 0
        self.write_python_bytes = 0

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
                        ok = self._serve_write(conn, vid, sid, gen, off, size, md)
                    elif magic == MAGIC_NEEDLE:
                        ok = self._serve_needle(conn, vid, gen, sid)
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

    def _serve_needle(self, conn, vid, nid, cookie) -> bool:
        """Serve one whole needle payload; False = the connection must
        close. Refused outright while the fault registry is armed: the
        storage fault points live on the HTTP path, which the client
        falls back to."""
        if self.resolve_needle is None:
            return self._error(conn, "needle reads not served here")
        if faults.active():
            return self._error(conn, "fault registry armed: use HTTP")
        try:
            fd, off, size, crc, close_after = self.resolve_needle(vid, nid, cookie)
        except NetPlaneVolumeRefusal as e:
            return self._error(conn, str(e), status=2)
        except NetPlaneError as e:
            return self._error(conn, str(e))
        self.needle_requests += 1
        try:
            try:
                conn.sendall(_RESP.pack(0, size) + _NEEDLE_CRC.pack(crc & 0xFFFFFFFF))
            except OSError:
                return False
            if size == 0:
                return True
            if native_io.enabled():
                try:
                    sent = native.send_file(conn.fileno(), fd, off, size,
                                            timeout_ms=int(self.request_timeout * 1000))
                except OSError:
                    return False
                self.sendfile_bytes += sent
                M.net_bytes_sent_total.inc(sent, plane="native", direction="read")
                return sent == size
            # Python egress (SEAWEED_EC_NATIVE=0): pread, sendall
            remaining, o = size, off
            while remaining > 0:
                chunk = os.pread(fd, min(_SEND_CHUNK, remaining), o)
                if not chunk:
                    return False  # a short file: torn stream
                M.net_bytes_copied_total.inc(len(chunk), plane="python", direction="read")
                try:
                    conn.sendall(chunk)
                except OSError:
                    return False
                self.python_bytes += len(chunk)
                M.net_bytes_sent_total.inc(len(chunk), plane="python", direction="read")
                o += len(chunk)
                remaining -= len(chunk)
            return True
        finally:
            if close_after:
                try:
                    os.close(fd)
                except OSError:
                    pass

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

    def _land_payload(self, conn, row: np.ndarray, size: int, native_on: bool) -> int:
        """Land `size` payload bytes into the pooled row `row`, rolling the
        CRC32C during the copy-in (fused in `sn_recv_into` on the native
        plane). Returns the landed CRC; raises NetPlaneError / OSError on
        a torn ingress (the connection is then dead)."""
        if size == 0:
            return 0
        if native_on:
            crc_state = np.zeros(1, np.uint32)
            filled = np.zeros(1, np.uint64)
            out_crcs = np.zeros(2, np.uint32)
            out_counts = np.zeros(1, np.int32)
            got = native.recv_into(
                conn.fileno(), row, size, timeout_ms=int(self.request_timeout * 1000),
                granule=size, crc_state=crc_state, filled_state=filled,
                out_crcs=out_crcs, out_counts=out_counts,
            )
            if got != size:
                raise NetPlaneError(f"torn write payload {got}/{size}")
            self.write_native_bytes += got
            M.net_bytes_received_total.inc(got, plane="native", direction="write")
            return int(out_crcs[0]) if int(out_counts[0]) > 0 else int(crc_state[0])
        view = memoryview(row)[:size]
        got = 0
        while got < size:
            r = conn.recv_into(view[got:], size - got)
            if r == 0:
                raise NetPlaneError(f"torn write payload {got}/{size}")
            got += r
        self.write_python_bytes += size
        M.net_bytes_received_total.inc(size, plane="python", direction="write")
        return _crc(row[:size])

    def _serve_write(self, conn, vid, cookie, nid, off_or_crc, size, md: dict) -> bool:
        """Serve one write request; False = the connection must close.
        Drops a desynced frame (unknown kind, oversized payload); drains
        and refuses a write without its resolver, or any write while the
        fault registry holds points outside the write path's own chaos
        namespaces (`write_plane_admissible`)."""
        kind = md.get("x-sw-w-kind", "")
        op = md.get("x-sw-w-op", "write")
        if kind == "needle":
            if size > _MAX_NEEDLE:
                return False
            refusal = None if self.resolve_write is not None else "needle writes not served here"
        elif kind == "blob":
            if size > _MAX_BLOB:
                return False
            refusal = None if self.resolve_blob is not None else "blob writes not served here"
        else:
            return False  # unknown kind: protocol desync
        if refusal is None and not write_plane_admissible():
            refusal = "fault registry armed: use the fallback transport"
        if refusal is not None:
            if not self._drain(conn, size):
                return False
            return self._error(conn, refusal)
        self.write_requests += 1
        if kind == "blob":
            return self._serve_blob_write(conn, op, md, off_or_crc, size)
        return self._serve_needle_write(conn, vid, cookie, nid, off_or_crc, size, md)

    def _serve_needle_write(self, conn, vid, cookie, nid, want_crc, size, md) -> bool:
        native_on = native_io.enabled()
        pool = native_io.landing_pool()
        buf = pool.get(_pool_width(size))
        row = buf[0]
        try:
            try:
                landed_crc = self._land_payload(conn, row, size, native_on)
            except (OSError, NetPlaneError):
                return False
            if size and landed_crc != (want_crc & 0xFFFFFFFF):
                # the payload was consumed whole, so the stream is in sync:
                # a refusal (not a drop) lets the client retry or fall back
                return self._error(conn, "write payload CRC mismatch")
            # the one Python-level copy on this path: the needle record
            # keeps bytes
            data = row[:size].tobytes()
            M.net_bytes_copied_total.inc(size, plane="native" if native_on else "python",
                                         direction="write")
        finally:
            if buf.shape[1] <= _POOL_MAX_WIDTH:
                pool.put(buf)
        try:
            faults.fire("ec.net.write.before_pwrite", volume=vid, needle=nid, size=size)
            stored_size, stored_crc = self.resolve_write(vid, nid, cookie, data, md)
            faults.fire("ec.net.write.after_pwrite", volume=vid, needle=nid)
        except NetPlaneVolumeRefusal as e:
            return self._error(conn, str(e), status=2)
        except (NetPlaneError, OSError, ValueError) as e:
            return self._error(conn, str(e))
        try:
            conn.sendall(_RESP.pack(0, stored_size) + _NEEDLE_CRC.pack(stored_crc & 0xFFFFFFFF))
        except OSError:
            return False
        return True

    def _serve_blob_write(self, conn, op: str, md: dict, off: int, size: int) -> bool:
        try:
            path = _unb64(md.get("x-sw-w-path", "")).decode()
        except (ValueError, UnicodeDecodeError):
            path = ""
        try:
            want_crc = int(md.get("x-sw-w-crc", "0"))
        except ValueError:
            want_crc = 0
        do_fsync = md.get("x-sw-w-fsync", "0") == "1"
        try:
            fd = self.resolve_blob(path, op, md)
        except NetPlaneVolumeRefusal as e:
            if not self._drain(conn, size):
                return False
            return self._error(conn, str(e), status=2)
        except (NetPlaneError, OSError) as e:
            if not self._drain(conn, size):
                return False
            return self._error(conn, str(e))
        if fd is None:
            # op handled entirely by the resolver (unlink)
            if not self._drain(conn, size):
                return False
            try:
                conn.sendall(_RESP.pack(0, 0) + _NEEDLE_CRC.pack(0))
            except OSError:
                return False
            return True
        try:
            try:
                faults.fire("ec.net.write.before_pwrite", path=path, size=size)
            except IOError as e:
                if not self._drain(conn, size):
                    return False
                return self._error(conn, str(e))
            landed_crc = 0
            if size and native_io.enabled():
                # socket to disk with the CRC fused into the landing loop:
                # Python never touches a payload byte
                try:
                    got, landed_crc = native.recv_file(
                        conn.fileno(), fd, off, size,
                        timeout_ms=int(self.request_timeout * 1000),
                    )
                except OSError:
                    return False
                if got != size:
                    return False
                self.write_native_bytes += got
                M.net_bytes_received_total.inc(got, plane="native", direction="write")
            elif size:
                chunk = bytearray(min(size, _SEND_CHUNK))
                view = memoryview(chunk)
                remaining, o, crc = size, off, 0
                try:
                    while remaining > 0:
                        want = min(len(chunk), remaining)
                        got = conn.recv_into(view[:want], want)
                        if got == 0:
                            return False
                        crc = _crc(view[:got], crc)
                        os.pwrite(fd, view[:got], o)
                        o += got
                        remaining -= got
                except OSError:
                    return False
                landed_crc = crc
                self.write_python_bytes += size
                M.net_bytes_received_total.inc(size, plane="python", direction="write")
                M.net_bytes_copied_total.inc(size, plane="python", direction="write")
            if want_crc and landed_crc != (want_crc & 0xFFFFFFFF):
                # the corrupt extent is on disk, but the pushed watermark
                # only advances on an ACK: the client retries the same
                # extent at the same offset
                return self._error(conn, "blob payload CRC mismatch")
            try:
                faults.fire("ec.net.write.after_pwrite", path=path)
                if do_fsync:
                    os.fsync(fd)
            except OSError as e:
                return self._error(conn, str(e))
            try:
                conn.sendall(_RESP.pack(0, size) + _NEEDLE_CRC.pack(landed_crc & 0xFFFFFFFF))
            except OSError:
                return False
            return True
        finally:
            try:
                os.close(fd)
            except OSError:
                pass

    def status(self) -> dict:
        """Sidecar state for the /status surface."""
        return {
            "port": self.port,
            "requests": self.requests,
            "needle_requests": self.needle_requests,
            "sendfile_bytes": self.sendfile_bytes,
            "python_bytes": self.python_bytes,
            "write_requests": self.write_requests,
            "write_native_bytes": self.write_native_bytes,
            "write_python_bytes": self.write_python_bytes,
        }


# ---------------------------------------------------------------------------
# Client
# ---------------------------------------------------------------------------


class NetPlaneClient:
    """Cached client connections to peers' shard net planes, landing
    payload bytes straight in caller buffers (``sn_recv_into``) with the
    granule CRC rolled during the copy-in.

    One cached connection per peer address for the shard reads (requests
    on one address are serialized: peer fetch streams one shard from a
    given holder at a time); needle reads and writes check a connection
    out of a per-address pool instead, one per request in flight. A peer
    whose plane port refuses the connect is memoized, and
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
        # The needle connection pool: concurrent readers and writers check
        # a connection out per request (dialing one when the pool is
        # empty) instead of serializing on one socket. Entries are
        # (socket, check-in time): the server reaps idle connections at its
        # request timeout (60 s), so one parked longer than _npool_idle_s
        # is discarded at checkout rather than spent on a request.
        self._npool: dict[tuple[str, int], list[tuple[socket.socket, float]]] = {}
        self._npool_max = 16
        self._npool_idle_s = 30.0
        # addr -> monotonic time of the refused connect (TTL'd memo)
        self._no_plane: dict[tuple[str, int], float] = {}
        self._lock = threading.Lock()

    def close(self) -> None:
        with self._lock:
            conns = list(self._conns.values())
            self._conns.clear()
            for lst in self._npool.values():
                conns.extend(s for s, _t in lst)
            self._npool.clear()
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

    def _checkout(self, addr) -> socket.socket:
        """A pooled needle connection, or a new one. Connections parked
        longer than `_npool_idle_s` are discarded: the server reaps idle
        peers, and a dead pooled socket would cost the next request."""
        stale: list[socket.socket] = []
        fresh = None
        with self._lock:
            self._check_memo(addr)
            lst = self._npool.get(addr)
            now = time.monotonic()
            while lst:
                s, t = lst.pop()
                if now - t < self._npool_idle_s:
                    fresh = s
                    break
                stale.append(s)
        for s in stale:
            try:
                s.close()
            except OSError:
                pass
        if fresh is not None:
            return fresh
        return self._connect(addr)

    def _checkin(self, addr, s: socket.socket) -> None:
        now = time.monotonic()
        expired: list[socket.socket] = []
        with self._lock:
            lst = self._npool.setdefault(addr, [])
            # reap expired entries from the front (the oldest): checkout
            # pops from the back and stops at the first fresh socket, so
            # the old ones below it would otherwise hold dead fds forever
            while lst and now - lst[0][1] >= self._npool_idle_s:
                expired.append(lst.pop(0)[0])
            if len(lst) < self._npool_max:
                lst.append((s, now))
                s = None  # type: ignore[assignment]
        for dead in expired:
            try:
                dead.close()
            except OSError:
                pass
        if s is not None:
            try:
                s.close()
            except OSError:
                pass

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

    def _request(self, addr, vid, sid, gen, off, size, exact: bool = True):
        """Send one range request and parse the response header; returns
        (connection positioned at the payload, payload length). With
        `exact` (the default) a server-side EOF clamp raises: range callers
        sized their landing buffer; `exact=False` takes the clamp (a whole
        shard asked for by its protocol maximum)."""
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
        if exact and n != size:
            # EOF clamp: the shard-read RPC's short read. The connection
            # still holds n payload bytes; cheaper to drop than to drain
            self._drop(addr)
            raise NetPlaneError(f"{addr}: short stream {n}/{size}")
        return s, n

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
            s, _n = self._request(addr, vid, sid, gen, off, size)
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
            s, _n = self._request(addr, vid, sid, gen, off, size)
            try:
                data = _recv_exact(s, size)
            except (OSError, NetPlaneError) as e:
                self._drop(addr)
                raise NetPlaneError(f"{addr}: {e}") from e
        M.net_bytes_received_total.inc(size, plane="python", direction="read")
        M.net_bytes_copied_total.inc(size, plane="python", direction="read")
        return data

    def fetch_shard_to_file(self, addr, vid, sid, gen, fobj) -> int:
        """Fetch one whole shard (its size from the server's EOF clamp)
        into an open binary file: the native path of VolumeEcShardsCopy.
        The source splices the shard file with sendfile(2) and this side
        lands it through a pooled aligned buffer in `_FETCH_CHUNK` pieces
        (`sn_recv_into`), counted in `sw_net_bytes_received_total`.
        Returns the bytes written. Raises NetPlaneUnavailable (memoized)
        for a peer without the plane and NetPlaneError for a refusal
        (stale generation, shard not local): callers take the gRPC
        CopyFile stream then, as they do with the native plane off."""
        pool = native_io.landing_pool()
        buf = pool.get(_FETCH_CHUNK)
        row = buf[0]
        total = 0
        try:
            with self._addr_lock(addr):
                # one request for the whole file: the protocol maximum,
                # which the server clamps to the shard's size
                s, n = self._request(addr, vid, sid, gen, 0, _MAX_REQUEST, exact=False)
                try:
                    while total < n:
                        want = min(_FETCH_CHUNK, n - total)
                        got = native.recv_into(
                            s.fileno(), row, want, timeout_ms=int(self.timeout * 1000),
                            granule=0, crc_state=np.zeros(1, np.uint32),
                            filled_state=np.zeros(1, np.uint64),
                            out_crcs=np.zeros(1, np.uint32), out_counts=np.zeros(1, np.int32),
                        )
                        if got != want:
                            raise NetPlaneError(f"{addr}: torn stream {total + got}/{n}")
                        M.net_bytes_received_total.inc(want, plane="native", direction="read")
                        fobj.write(row[:want])
                        total += want
                except (OSError, NetPlaneError) as e:
                    self._drop(addr)
                    if isinstance(e, NetPlaneError):
                        raise
                    raise NetPlaneError(f"{addr}: {e}") from e
        finally:
            pool.put(buf)
        return total

    # ------------------------------------------------------- needle reads

    def read_needle(self, addr: tuple[str, int], vid: int, nid: int, cookie: int) -> bytes:
        """A whole needle payload over the needle-read opcode: the server
        resolves (fd, offset, size, crc) from its needle map and splices
        the payload with sendfile; this side lands it in a pooled
        4096-aligned buffer (``sn_recv_into``) with the CRC32C fused into
        the copy-in and checked against the needle's stored CRC, so a
        vacuum racing the read or a stale location raises rather than
        returns wrong bytes. A refusal raises NetPlaneError, with
        ``volume_refusal=True`` for status 2. Raises
        :class:`NetPlaneUnavailable` for a peer without the sidecar
        (memoized with its TTL)."""
        s = self._checkout(addr)
        healthy = False
        try:
            meta = _encode_meta()
            try:
                s.sendall(_REQ.pack(MAGIC_NEEDLE, vid, cookie & 0xFFFFFFFF, nid, 0, 0, len(meta))
                          + meta)
                head = _recv_exact(s, _RESP.size)
            except (OSError, NetPlaneError) as e:
                raise NetPlaneError(f"{addr}: {e}") from e
            status, n = _RESP.unpack(head)
            if status != 0:
                msg = self._read_refusal(addr, s, n)
                healthy = True  # a refusal leaves the stream in sync
                err = NetPlaneError(f"{addr}: {msg}")
                # status 2 = a volume-level refusal: callers may
                # negative-cache the volume instead of asking per needle
                err.volume_refusal = status == 2
                raise err
            if n > _MAX_NEEDLE:
                raise NetPlaneError(f"{addr}: oversized needle {n}")
            try:
                (want_crc,) = _NEEDLE_CRC.unpack(_recv_exact(s, _NEEDLE_CRC.size))
            except (OSError, NetPlaneError) as e:
                raise NetPlaneError(f"{addr}: {e}") from e
            if n == 0:
                healthy = True
                return b""
            data = self._land_needle(addr, s, int(n), want_crc)
            healthy = True
            return data
        finally:
            if healthy:
                self._checkin(addr, s)
            else:
                try:
                    s.close()
                except OSError:
                    pass

    def _land_needle(self, addr, s, n: int, want_crc: int) -> bytes:
        native_on = native_io.enabled()
        pool = native_io.landing_pool()
        buf = pool.get(_pool_width(n))
        row = buf[0]
        try:
            try:
                if native_on:
                    crc_state = np.zeros(1, np.uint32)
                    filled = np.zeros(1, np.uint64)
                    out_crcs = np.zeros(2, np.uint32)
                    out_counts = np.zeros(1, np.int32)
                    got = native.recv_into(
                        s.fileno(), row, n, timeout_ms=int(self.timeout * 1000),
                        granule=n, crc_state=crc_state, filled_state=filled,
                        out_crcs=out_crcs, out_counts=out_counts,
                    )
                    if got != n:
                        raise NetPlaneError(f"{addr}: torn needle stream {got}/{n}")
                    landed_crc = int(out_crcs[0]) if int(out_counts[0]) > 0 else int(crc_state[0])
                    M.net_bytes_received_total.inc(got, plane="native", direction="read")
                else:
                    view = memoryview(row)[:n]
                    got = 0
                    while got < n:
                        r = s.recv_into(view[got:], n - got)
                        if r == 0:
                            raise NetPlaneError(f"{addr}: torn needle stream {got}/{n}")
                        got += r
                    landed_crc = _crc(row[:n])
                    M.net_bytes_received_total.inc(n, plane="python", direction="read")
            except OSError as e:
                raise NetPlaneError(f"{addr}: {e}") from e
            if landed_crc != (want_crc & 0xFFFFFFFF):
                raise NetPlaneError(f"{addr}: needle CRC mismatch")
            # the one Python-level copy on this path: the caller keeps bytes
            data = row[:n].tobytes()
            M.net_bytes_copied_total.inc(n, plane="native" if native_on else "python",
                                         direction="read")
            return data
        finally:
            # a raise out of here (torn stream, CRC mismatch) leaves the
            # caller to close the checked-out socket; an oversized landing
            # never parks in the process-wide pool
            if buf.shape[1] <= _POOL_MAX_WIDTH:
                pool.put(buf)

    # ------------------------------------------------------------ writes

    def _write_request(self, addr, vid, sid, gen, off, payload, extra_meta) -> tuple[int, int]:
        """One write-opcode round trip on a pooled connection: header,
        meta and payload out; (status, n, stored CRC) back. Returns
        (stored_size, stored_crc). A refusal leaves the stream in sync
        (the server drains the payload first), so the connection goes
        back to the pool even then; any other failure closes it."""
        s = self._checkout(addr)
        healthy = False
        try:
            meta = _encode_meta(extra_meta)
            try:
                s.sendall(_REQ.pack(MAGIC_WRITE, vid, sid, gen, off, len(payload), len(meta))
                          + meta)
                if payload:
                    s.sendall(payload)
                head = _recv_exact(s, _RESP.size)
            except (OSError, NetPlaneError) as e:
                raise NetPlaneError(f"{addr}: {e}") from e
            status, n = _RESP.unpack(head)
            if status != 0:
                msg = self._read_refusal(addr, s, n)
                healthy = True
                err = NetPlaneError(f"{addr}: {msg}")
                err.volume_refusal = status == 2
                raise err
            try:
                (stored_crc,) = _NEEDLE_CRC.unpack(_recv_exact(s, _NEEDLE_CRC.size))
            except (OSError, NetPlaneError) as e:
                raise NetPlaneError(f"{addr}: {e}") from e
            healthy = True
            M.net_bytes_sent_total.inc(
                len(payload), plane="native" if native_io.enabled() else "python",
                direction="write",
            )
            return int(n), int(stored_crc)
        finally:
            if healthy:
                self._checkin(addr, s)
            else:
                try:
                    s.close()
                except OSError:
                    pass

    def write_needle(self, addr: tuple[str, int], vid: int, nid: int, cookie: int, data: bytes, *,
                     flags: int = 0, name: bytes | str = b"", mime: bytes | str = b"",
                     jwt: str = "", fsync: bool = False, replicate: bool = True) -> tuple[int, int]:
        """Append one needle over the write opcode. The payload's CRC32C
        rides the header; the server's fused copy-in CRC checks transit,
        and the ACK's stored CRC is checked here against what was sent,
        so an accepted write certifies the bytes on disk. Returns
        (stored_size, stored_crc). `replicate=False` marks the write as a
        replication leg (``x-sw-w-replicate: 0``): the server fans it out
        no further. Raises :class:`NetPlaneUnavailable` (memoized) for a
        peer without the sidecar; a refusal with ``volume_refusal=True``
        means the volume can never take plane writes there."""
        crc = _crc(data) if data else 0
        extra = {"x-sw-w-kind": "needle", "x-sw-w-flags": str(int(flags))}
        if name:
            extra["x-sw-w-name"] = _b64(name)
        if mime:
            extra["x-sw-w-mime"] = _b64(mime)
        if jwt:
            extra["x-sw-w-jwt"] = jwt
        if fsync:
            extra["x-sw-w-fsync"] = "1"
        if not replicate:
            extra["x-sw-w-replicate"] = "0"
        stored_size, stored_crc = self._write_request(addr, vid, cookie & 0xFFFFFFFF, nid, crc,
                                                      data, extra)
        if data and stored_crc != crc:
            raise NetPlaneError(f"{addr}: stored CRC mismatch "
                                f"(ack {stored_crc:#010x} != sent {crc:#010x})")
        return stored_size, stored_crc

    def write_blob(self, addr: tuple[str, int], path: str, off: int, data, *,
                   fsync: bool = True, jwt: str = "") -> int:
        """Write one extent of a remote stream-shard blob at `off`
        (kind=blob): the network transport behind `net:` remote roots.
        The server lands socket to disk (`sn_recv_file`, CRC fused) and,
        with `fsync`, fsyncs before it ACKs: the remote extent is durable
        once this returns. Returns bytes stored."""
        data = bytes(data)
        extra = {
            "x-sw-w-kind": "blob",
            "x-sw-w-path": _b64(path),
            "x-sw-w-crc": str(_crc(data) if data else 0),
        }
        if fsync:
            extra["x-sw-w-fsync"] = "1"
        if jwt:
            extra["x-sw-w-jwt"] = jwt
        stored, _crc_ack = self._write_request(addr, 0, 0, 0, off, data, extra)
        return stored

    def unlink_blob(self, addr: tuple[str, int], path: str, *, jwt: str = "") -> None:
        """Remove a remote stream-shard blob (best-effort GC of superseded
        generations)."""
        extra = {"x-sw-w-kind": "blob", "x-sw-w-op": "unlink", "x-sw-w-path": _b64(path)}
        if jwt:
            extra["x-sw-w-jwt"] = jwt
        self._write_request(addr, 0, 0, 0, 0, b"", extra)


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
