"""LDAP identity provider: simple-bind authentication for STS.

Port of seaweedfs_tpu/iam/ldap.py, whole: the same BER bytes, bind
client and stand-in server.

Reference: weed/iam/ldap/ldap_provider.go (go-ldap backed; this is the
same provider surface on a hand-rolled LDAPv3 wire client — BER
encoding of BindRequest/BindResponse and a minimal search, RFC 4511).
Used by the gateway's ``AssumeRoleWithLdapIdentity`` STS action: a
successful bind as the templated user DN mints temporary credentials
for the mapped role.

Also ships ``MiniLdapServer``, an in-process LDAPv3 subset (bind +
unbind) used by the tests the way the reference uses its
mock_provider.go — and usable as a development stand-in.
"""

from __future__ import annotations

import socket
import threading


class LdapError(Exception):
    pass


# ------------------------------------------------------------------ BER


def _ber_len(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    out = b""
    while n:
        out = bytes([n & 0xFF]) + out
        n >>= 8
    return bytes([0x80 | len(out)]) + out


def _tlv(tag: int, payload: bytes) -> bytes:
    return bytes([tag]) + _ber_len(len(payload)) + payload


def _ber_int(v: int) -> bytes:
    out = v.to_bytes(max((v.bit_length() + 8) // 8, 1), "big", signed=True)
    return _tlv(0x02, out)


def _parse_tlv(buf: bytes, pos: int) -> tuple[int, bytes, int]:
    """-> (tag, payload, next_pos)."""
    if pos + 2 > len(buf):
        raise LdapError("short BER element")
    tag = buf[pos]
    ln = buf[pos + 1]
    pos += 2
    if ln & 0x80:
        n = ln & 0x7F
        if pos + n > len(buf):
            raise LdapError("short BER length")
        ln = int.from_bytes(buf[pos : pos + n], "big")
        pos += n
    if pos + ln > len(buf):
        # the declared content has not fully arrived: callers must
        # treat this as "read more", never parse a truncated payload
        # (a sliced-short resultCode of b"" reads as SUCCESS)
        raise LdapError("incomplete BER element")
    return tag, buf[pos : pos + ln], pos + ln


# ----------------------------------------------------------- the client


class LdapProvider:
    """Authenticates (username, password) by binding as the templated
    DN. ``bind_dn_template`` uses ``{username}``; e.g.
    ``uid={username},ou=users,dc=example,dc=com``."""

    def __init__(
        self,
        server: str,
        bind_dn_template: str,
        timeout: float = 5.0,
    ):
        if server.startswith("ldaps://"):
            # this client has no TLS: misparsing the URL would ship a
            # plaintext bind to host "ldaps" — refuse loudly instead
            raise LdapError(
                "ldaps:// is not supported by this client; terminate "
                "TLS in front of it or use ldap:// on a trusted network"
            )
        if server.startswith("ldap://"):
            server = server[len("ldap://") :]
        host, _, port = server.partition(":")
        self.host = host
        self.port = int(port or 389)
        self.bind_dn_template = bind_dn_template
        self.timeout = timeout

    def authenticate(self, username: str, password: str) -> str:
        """-> the bound DN on success; raises LdapError on bad
        credentials or transport failure. Empty passwords are REFUSED
        locally: RFC 4513 treats them as anonymous binds, which many
        servers 'succeed' — accepting that would authenticate anyone."""
        if not username or not password:
            raise LdapError("username and password required")
        if any(c in username for c in ",+=\"\\<>;\r\n\x00"):
            raise LdapError("invalid characters in username")
        dn = self.bind_dn_template.replace("{username}", username)
        try:
            return self._bind(dn, password)
        except OSError as e:
            raise LdapError(f"ldap transport: {e}") from None

    def _bind(self, dn: str, password: str) -> str:
        bind = _tlv(
            0x60,  # [APPLICATION 0] BindRequest
            _ber_int(3)  # version
            + _tlv(0x04, dn.encode())  # name
            + _tlv(0x80, password.encode()),  # simple auth [context 0]
        )
        msg = _tlv(0x30, _ber_int(1) + bind)
        with socket.create_connection(
            (self.host, self.port), timeout=self.timeout
        ) as sock:
            sock.sendall(msg)
            buf = b""
            while True:
                got = sock.recv(4096)
                if not got:
                    raise LdapError("connection closed during bind")
                buf += got
                try:
                    tag, payload, _ = _parse_tlv(buf, 0)
                except LdapError:
                    continue
                if tag != 0x30:
                    raise LdapError(f"unexpected LDAP message tag {tag:#x}")
                break
            # LDAPMessage ::= { messageID, BindResponse }
            _t, _mid, pos = _parse_tlv(payload, 0)
            op_tag, op, _ = _parse_tlv(payload, pos)
            if op_tag != 0x61:  # [APPLICATION 1] BindResponse
                raise LdapError(f"unexpected response op {op_tag:#x}")
            code_tag, code, _ = _parse_tlv(op, 0)
            if code_tag != 0x0A or not code:
                # an EMPTY resultCode would int() to 0 == success —
                # fail-open on a malicious/buggy endpoint
                raise LdapError("malformed BindResponse")
            result = int.from_bytes(code, "big")
            # polite unbind; best effort
            try:
                sock.sendall(_tlv(0x30, _ber_int(2) + _tlv(0x42, b"")))
            except OSError:
                pass
        if result != 0:
            raise LdapError(f"bind failed (resultCode {result})")
        return dn


# ------------------------------------------------- test/dev LDAP server


class MiniLdapServer:
    """LDAPv3 subset: simple bind against a {dn: password} table.
    Wrong passwords get resultCode 49 (invalidCredentials); empty
    passwords get 53 (unwillingToPerform) like hardened servers."""

    def __init__(self, users: dict[str, str], ip: str = "127.0.0.1"):
        self.users = users
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((ip, 0))
        self._sock.listen(16)
        self.port = self._sock.getsockname()[1]
        self._stop = threading.Event()
        self.binds = 0
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(
                target=self._serve, args=(conn,), daemon=True
            ).start()

    def _serve(self, conn: socket.socket) -> None:
        try:
            buf = b""
            while True:
                got = conn.recv(4096)
                if not got:
                    return
                buf += got
                while buf:
                    try:
                        _tag, payload, end = _parse_tlv(buf, 0)
                    except LdapError:
                        break
                    if end > len(buf):
                        break
                    buf = buf[end:]
                    _t, mid_raw, pos = _parse_tlv(payload, 0)
                    mid = int.from_bytes(mid_raw, "big", signed=True)
                    op_tag, op, _ = _parse_tlv(payload, pos)
                    if op_tag == 0x42:  # UnbindRequest
                        return
                    if op_tag != 0x60:
                        continue
                    _vt, _ver, p2 = _parse_tlv(op, 0)
                    _nt, name, p3 = _parse_tlv(op, p2)
                    at, secret, _ = _parse_tlv(op, p3)
                    dn = name.decode(errors="replace")
                    self.binds += 1
                    if at != 0x80 or not secret:
                        code = 53  # unwillingToPerform
                    elif self.users.get(dn) == secret.decode(
                        errors="replace"
                    ):
                        code = 0
                    else:
                        code = 49  # invalidCredentials
                    resp = _tlv(
                        0x61,
                        _tlv(0x0A, bytes([code]))
                        + _tlv(0x04, b"")
                        + _tlv(0x04, b""),
                    )
                    conn.sendall(_tlv(0x30, _ber_int(mid) + resp))
        except OSError:
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def close(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
