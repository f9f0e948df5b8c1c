"""PyTorch port: the OIDC and LDAP identity providers
(seaweedfs_tpu_torch/iam/oidc.py, iam/ldap.py) and the gateway paths that
use them, held against the JAX package on the CPU.

- OIDC: `verify` and `identity_for` over a seeded table of good and bad
  bearers, HS256 and RS256 (wrong issuer, audience, exp, nbf, signature,
  `alg: none`, malformed tokens), both modules' clocks pinned; the claims
  or the `OidcError` message, and the identity, must be equal.
- LDAP: the BER helpers byte for byte; each package's `MiniLdapServer`
  answers the same request bytes with the same bytes; the port's
  `LdapProvider` binds against the JAX server and the JAX provider
  against the port's, with the same verdicts and messages.
- The gateway (twins of tests/torch_s3_twins.py whose identities file
  carries `oidc` and `ldap` blocks): the bearer path, the OIDC-only rule
  (no SigV4 identities is anonymous, not open mode) for requests and
  POST-policy forms, and `AssumeRoleWithLdapIdentity` with the key it
  mints. Answers, `/buckets` trees and KV equal (tolerance 0).
"""

import base64
import dataclasses
import hashlib
import hmac
import json
import socket
import time
import types

import numpy as np
import pytest
from torch_s3_twins import IDENTITIES, norm, run_scenario

import seaweedfs_tpu.iam.ldap as j_ldap
import seaweedfs_tpu.iam.oidc as j_oidc
import seaweedfs_tpu_torch.iam.ldap as p_ldap
import seaweedfs_tpu_torch.iam.oidc as p_oidc

OIDC = {"jax": j_oidc, "port": p_oidc}
LDAP = {"jax": j_ldap, "port": p_ldap}
NOW = 1_790_000_000.0
ISSUER = "https://idp.example"
SECRET = "hs-shared-secret"
ROLES = {"reader": {"actions": ["Read", "List"]},
         "writer": {"policies": [{"Version": "2012-10-17", "Statement": [
             {"Effect": "Allow", "Action": ["s3:PutObject"], "Resource": ["arn:aws:s3:::gw/*"]}]}]},
         "admin": {"actions": ["Admin"]}}
USERS = {"uid=alice,ou=users,dc=example": "alice-pw", "uid=bob,ou=users,dc=example": "bob-pw"}
DN_TEMPLATE = "uid={username},ou=users,dc=example"
FORM = {"Content-Type": "application/x-www-form-urlencoded"}


def b64(b: bytes) -> str:
    return base64.urlsafe_b64encode(b).rstrip(b"=").decode()


@pytest.fixture(scope="module")
def rsa_key():
    from cryptography.hazmat.primitives.asymmetric import rsa

    return rsa.generate_private_key(public_exponent=65537, key_size=2048)


def public_pem(key) -> str:
    from cryptography.hazmat.primitives import serialization

    return key.public_key().public_bytes(
        serialization.Encoding.PEM, serialization.PublicFormat.SubjectPublicKeyInfo).decode()


def token(claims: dict, alg: str = "HS256", key=None, secret: str = SECRET,
          header: dict | None = None) -> str:
    """A JWT signed as an IdP signs it (RS256 with `key`)."""
    from cryptography.hazmat.primitives.asymmetric import padding
    from cryptography.hazmat.primitives.hashes import SHA256

    signing = f"{b64(json.dumps(header or {'alg': alg, 'typ': 'JWT'}).encode())}." \
              f"{b64(json.dumps(claims).encode())}"
    if alg == "RS256":
        sig = key.sign(signing.encode(), padding.PKCS1v15(), SHA256())
    elif alg == "HS256":
        sig = hmac.new(secret.encode(), signing.encode(), hashlib.sha256).digest()
    else:
        sig = b""
    return f"{signing}.{b64(sig)}"


# ------------------------------------------------------------------ OIDC


def _verdict(provider, tok):
    try:
        claims = provider.verify(tok)
    except Exception as e:  # noqa: BLE001 — the refusal is compared
        return (type(e).__name__, str(e))
    return ("ok", claims, dataclasses.astuple(provider.identity_for(claims)))


def _bad_tokens(rng, key):
    """(label, token) pairs: one IdP's good and bad bearers."""
    base = {"iss": ISSUER, "aud": "seaweedfs", "sub": "u1", "exp": NOW + 600, "iat": NOW}
    out = []
    for alg in ("HS256", "RS256"):
        def t(claims=None, **kw):
            return token({**base, **(claims or {})}, alg=alg, key=key, **kw)

        roles = [["reader"], "writer", ["reader", "ghost"], ["admin"], [], 7][
            int(rng.integers(0, 6))]
        out += [
            (f"{alg} good", t({"roles": roles})),
            (f"{alg} aud list", t({"aud": ["x", "seaweedfs"], "roles": "reader"})),
            (f"{alg} wrong aud", t({"aud": "other"})),
            (f"{alg} aud list without us", t({"aud": ["x", "y"]})),
            (f"{alg} wrong iss", t({"iss": "https://evil"})),
            (f"{alg} expired", t({"exp": NOW - 61 - float(rng.integers(0, 10**5))})),
            (f"{alg} expired within skew", t({"exp": NOW - 59})),
            (f"{alg} no exp", t({"exp": None})),
            (f"{alg} exp not a number", t({"exp": "never"})),
            (f"{alg} nbf future", t({"nbf": NOW + 61 + float(rng.integers(0, 10**5))})),
            (f"{alg} nbf within skew", t({"nbf": NOW + 59})),
            (f"{alg} nbf not a number", t({"nbf": [1]})),
            (f"{alg} sub missing", t({"sub": None, "roles": "reader"})),
        ]
        good = t({"roles": "reader"})
        h, p, sig = good.split(".")
        flipped = b64(bytes([base64.urlsafe_b64decode(sig + "==")[0] ^ 1])
                      + base64.urlsafe_b64decode(sig + "==")[1:])
        out += [(f"{alg} forged signature", f"{h}.{p}.{flipped}"),
                (f"{alg} payload swapped", f"{h}.{b64(json.dumps({**base, 'roles': 'admin'}).encode())}.{sig}")]
    out += [
        ("alg none", token({**base, "roles": "admin"}, alg="none")),
        ("alg HS512", token(base, header={"alg": "HS512"})),
        ("HS256 wrong secret", token(base, secret="guess")),
        ("two parts", "a.b"),
        ("not base64", "!!!.???.***"),
        ("header not JSON", f"{b64(b'nope')}.{b64(b'{}')}.{b64(b'')}"),
        ("empty", ""),
    ]
    return out


@pytest.fixture
def pinned_oidc_clocks(monkeypatch):
    for m in OIDC.values():
        monkeypatch.setattr(m, "time", types.SimpleNamespace(time=lambda: NOW))


@pytest.mark.parametrize("seed", range(3))
def test_oidc_verify_and_identity_equal_on_seeded_tokens(pinned_oidc_clocks, rsa_key, seed):
    rng = np.random.default_rng(500 + seed)
    pem = public_pem(rsa_key)
    configs = [dict(hs256_secret=SECRET, rs256_public_key_pem=pem),
               dict(hs256_secret=SECRET), dict(rs256_public_key_pem=pem)]
    verdicts = set()
    for conf in configs:
        provs = {n: m.OidcProvider(ISSUER, audience="seaweedfs", roles=ROLES, **conf)
                 for n, m in OIDC.items()}
        for label, tok in _bad_tokens(rng, rsa_key):
            got = {n: _verdict(p, tok) for n, p in provs.items()}
            assert got["port"] == got["jax"], label
            verdicts.add(got["port"][0] if got["port"][0] == "ok" else got["port"][1][:14])
    assert "ok" in verdicts and len(verdicts) >= 8, verdicts


def test_oidc_without_audience_and_with_a_role_claim_of_its_own(pinned_oidc_clocks):
    provs = {n: m.OidcProvider(ISSUER, hs256_secret=SECRET, role_claim="groups", roles=ROLES,
                               clock_skew=0.0) for n, m in OIDC.items()}
    for claims in ({"iss": ISSUER, "exp": NOW + 1, "groups": "reader"},
                   {"iss": ISSUER, "exp": NOW - 0.5, "groups": "reader"},
                   {"iss": ISSUER, "exp": NOW + 1, "roles": "admin", "aud": "anything"}):
        tok = token(claims)
        assert _verdict(provs["port"], tok) == _verdict(provs["jax"], tok), claims


@pytest.mark.parametrize("kw", [{}, {"rs256_public_key_pem": "-----BEGIN nonsense"},
                                {"hs256_secret": "", "rs256_public_key_pem": ""}])
def test_oidc_refuses_a_provider_without_a_key_alike(kw):
    got = []
    for m in OIDC.values():
        try:
            m.OidcProvider(ISSUER, **kw)
            got.append("ok")
        except Exception as e:  # noqa: BLE001 — the refusal is compared
            got.append((type(e).__name__, str(e)))
    assert got[0] == got[1] != "ok"


# ------------------------------------------------------------------ LDAP


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as e:  # noqa: BLE001 — the refusal is compared
        return (type(e).__name__, str(e))


def test_ber_helpers_are_byte_identical():
    rng = np.random.default_rng(61)
    lens = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**24, 2**31] + [
        int(x) for x in rng.integers(0, 2**20, 40)]
    ints = [0, 1, -1, 127, 128, -128, -129, 255, 256, 2**31, -(2**31)] + [
        int(x) for x in rng.integers(-(2**40), 2**40, 40)]
    for n in lens:
        assert p_ldap._ber_len(n) == j_ldap._ber_len(n), n
    for v in ints:
        assert p_ldap._ber_int(v) == j_ldap._ber_int(v), v
    for _ in range(40):
        payload = rng.bytes(int(rng.integers(0, 300)))
        tag = int(rng.integers(0, 256))
        assert p_ldap._tlv(tag, payload) == j_ldap._tlv(tag, payload)
    # parsing: whole, truncated, long-form lengths, garbage
    bufs = [j_ldap._tlv(0x30, rng.bytes(n)) for n in (0, 5, 127, 128, 300, 70000)]
    bufs += [b[: int(rng.integers(0, len(b) + 1))] for b in bufs]
    bufs += [rng.bytes(int(rng.integers(0, 12))) for _ in range(60)] + [b"\x30\x84\x00"]
    for buf in bufs:
        for pos in (0, 1):
            got = [_outcome(m._parse_tlv, buf, pos) for m in (j_ldap, p_ldap)]
            assert got[0] == got[1], (buf[:16], pos)


def _exchange(port: int, request: bytes) -> bytes:
    with socket.create_connection(("127.0.0.1", port), timeout=10) as sock:
        sock.sendall(request)
        sock.shutdown(socket.SHUT_WR)
        out = b""
        while True:
            got = sock.recv(4096)
            if not got:
                return out
            out += got


def _bind_request(mid: int, dn: str, secret: bytes, auth_tag: int = 0x80) -> bytes:
    op = j_ldap._tlv(0x60, j_ldap._ber_int(3) + j_ldap._tlv(0x04, dn.encode())
                     + j_ldap._tlv(auth_tag, secret))
    return j_ldap._tlv(0x30, j_ldap._ber_int(mid) + op)


@pytest.fixture
def ldap_servers():
    servers = {n: m.MiniLdapServer(dict(USERS)) for n, m in LDAP.items()}
    yield servers
    for s in servers.values():
        s.close()


def test_mini_ldap_servers_answer_the_same_bytes(ldap_servers):
    dn = "uid=alice,ou=users,dc=example"
    unbind = j_ldap._tlv(0x30, j_ldap._ber_int(9) + j_ldap._tlv(0x42, b""))
    search = j_ldap._tlv(0x30, j_ldap._ber_int(4) + j_ldap._tlv(0x63, b""))
    requests = [
        _bind_request(1, dn, b"alice-pw"),
        _bind_request(2, dn, b"wrong"),
        _bind_request(3, dn, b""),
        _bind_request(300, "uid=nobody", b"x"),
        _bind_request(-5, dn, b"alice-pw"),
        _bind_request(6, dn, b"alice-pw", auth_tag=0xA3),  # SASL: unwilling
        _bind_request(7, dn, b"alice-pw") + _bind_request(8, dn, b"bad") + unbind
        + _bind_request(10, dn, b"alice-pw"),
        search + _bind_request(11, dn, b"alice-pw"),
        _bind_request(12, dn, b"alice-pw")[:9],
    ]
    for req in requests:
        got = {n: _exchange(s.port, req) for n, s in ldap_servers.items()}
        assert got["port"] == got["jax"], req[:24]
    assert ldap_servers["port"].binds == ldap_servers["jax"].binds == 9  # none after unbind


CASES = [("alice", "alice-pw"), ("alice", "wrong"), ("bob", "bob-pw"), ("carol", "x"),
         ("alice", ""), ("", "x"), ("al,ice", "x"), ("a\\b", "x"), ("a\x00", "x")]


@pytest.mark.parametrize("client", ["jax", "port"])
def test_each_ldap_provider_binds_against_the_other_packages_server(ldap_servers, client):
    """The port's provider against the JAX server and the JAX provider
    against the port's: the same DN or the same refusal as the provider
    of the server's own package."""
    server = ldap_servers["jax" if client == "port" else "port"]
    twin = ldap_servers[client]
    for user, pw in CASES:
        got = _outcome(LDAP[client].LdapProvider(f"ldap://127.0.0.1:{server.port}",
                                                 DN_TEMPLATE).authenticate, user, pw)
        want = _outcome(LDAP["jax" if client == "port" else "port"].LdapProvider(
            f"127.0.0.1:{twin.port}", DN_TEMPLATE).authenticate, user, pw)
        assert got == want, (user, pw)
    assert server.binds == twin.binds == 4


def test_ldap_provider_refusals_are_alike():
    closed = socket.socket()
    closed.bind(("127.0.0.1", 0))
    port = closed.getsockname()[1]
    closed.close()  # nothing listens there now
    for server in ("ldaps://idp:636", f"ldap://127.0.0.1:{port}", f"127.0.0.1:{port}"):
        got = []
        for m in LDAP.values():
            try:
                p = m.LdapProvider(server, DN_TEMPLATE, timeout=2.0)
                got.append(("built", p.host, p.port, _outcome(p.authenticate, "alice", "pw")))
            except Exception as e:  # noqa: BLE001 — the refusal is compared
                got.append((type(e).__name__, str(e)))
        assert got[0] == got[1], server
    assert LDAP["port"].LdapProvider("idp", DN_TEMPLATE).port == 389


# ---------------------------------------------------- through the gateway


def _xml_text(body: bytes, tag: str) -> str:
    import xml.etree.ElementTree as ET

    for el in ET.fromstring(body).iter():
        if el.tag.split("}")[-1] == tag:
            return el.text or ""
    return ""


def _form(**kv) -> bytes:
    import urllib.parse

    return urllib.parse.urlencode(kv).encode()


def _bearer(tok: str) -> dict:
    return {"Authorization": f"Bearer {tok}"}


def s_bearer(s, key):
    c = s.call
    good = {"iss": ISSUER, "aud": "seaweedfs", "sub": "u1", "exp": time.time() + 3600}
    reader = token({**good, "roles": "reader"}, alg="RS256", key=key)
    writer = token({**good, "roles": ["writer"]})
    return [
        c("PUT", "/gw"), c("PUT", "/gw/a.txt", body=b"hello bearer"),
        c("GET", "/gw/a.txt", headers=_bearer(reader), who=None),
        c("GET", "/gw", "list-type=2", headers=_bearer(reader), who=None),
        c("PUT", "/gw/r.txt", body=b"x", headers=_bearer(reader), who=None),
        c("PUT", "/gw/w.txt", body=b"written by a bearer", headers=_bearer(writer), who=None),
        c("GET", "/gw/w.txt", headers=_bearer(writer), who=None),
        c("GET", "/gw/a.txt", headers=_bearer(token({**good, "roles": "ghost"})), who=None),
        c("GET", "/gw/a.txt", headers=_bearer(reader[:-4] + "AAAA"), who=None),
        c("GET", "/gw/a.txt", headers=_bearer(token({**good, "exp": time.time() - 7200,
                                                     "roles": "reader"})), who=None),
        c("GET", "/gw/a.txt", headers=_bearer(token({**good, "roles": "admin"}, alg="none")),
          who=None),
        c("GET", "/gw/a.txt", headers=_bearer("not.a.jwt"), who=None),
        c("GET", "/gw/a.txt", who=None),
        c("GET", "/gw/a.txt", who="reader"),
        c("POST", "/", body=b"{}", headers={**_bearer(reader),
                                            "X-Amz-Target": "S3Tables.ListTableBuckets"},
          who=None),
    ]


def s_ldap_sts(s, key):
    c = s.call
    status, hs, body = s.raw("POST", "/", body=_form(
        Action="AssumeRoleWithLdapIdentity", LdapUsername="alice", LdapPassword="alice-pw",
        RoleArn="arn:aws:iam:::role/uploader", DurationSeconds="900"), headers=FORM, who=None)
    out = [norm(status, hs, body)]
    s.keys["ldap"] = (_xml_text(body, "AccessKeyId"), _xml_text(body, "SecretAccessKey"),
                      _xml_text(body, "SessionToken"))

    def sts(**kv):
        return c("POST", "/", body=_form(Action="AssumeRoleWithLdapIdentity", **kv),
                 headers=FORM, who=None)

    out += [
        c("PUT", "/gw/sts/ldap.bin", body=b"written with an LDAP role", who="ldap"),
        c("GET", "/gw/sts/ldap.bin", who="ldap"),
        c("PUT", "/gw/elsewhere", body=b"x", who="ldap"),
        sts(LdapUsername="alice", LdapPassword="wrong", RoleName="uploader"),
        sts(LdapUsername="alice", LdapPassword="", RoleName="uploader"),
        sts(LdapUsername="carol", LdapPassword="x", RoleName="uploader"),
        sts(LdapUsername="al,ice", LdapPassword="x", RoleName="uploader"),
        sts(LdapUsername="bob", LdapPassword="bob-pw", RoleName="ghost"),
        sts(LdapUsername="bob", LdapPassword="bob-pw", RoleName="uploader",
            DurationSeconds="x"),
        sts(LdapUsername="bob", LdapPassword="bob-pw", RoleName="uploader",
            DurationSeconds="60"),
    ]
    return out


def _twin_config(ldap_port: int, key, identities: bool = True) -> dict:
    conf = {"oidc": {"issuer": ISSUER, "audience": "seaweedfs", "hs256_secret": SECRET,
                     "rs256_public_key_pem": public_pem(key), "roles": ROLES},
            "ldap": {"server": f"ldap://127.0.0.1:{ldap_port}", "bind_dn_template": DN_TEMPLATE}}
    if identities:
        conf.update(IDENTITIES)
    return conf


@pytest.fixture(scope="module")
def gateway_scenario(tmp_path_factory, rsa_key):
    server = p_ldap.MiniLdapServer(dict(USERS))
    try:
        steps = [("bearer", lambda s: s_bearer(s, rsa_key)),
                 ("ldap_sts", lambda s: s_ldap_sts(s, rsa_key))]
        yield run_scenario(tmp_path_factory.mktemp("s3-providers"), steps,
                           config=_twin_config(server.port, rsa_key))
    finally:
        server.close()


@pytest.mark.parametrize("step", ["bearer", "ldap_sts"])
def test_gateway_provider_step_against_jax(gateway_scenario, step):
    jax, port = gateway_scenario["jax"][step], gateway_scenario["port"][step]
    assert port[0] != "raised", port[1]
    assert port[0] == jax[0], "the answers"
    assert port[1] == jax[1], "the /buckets tree"
    assert port[2] == jax[2], "the filer's KV"


def test_the_provider_steps_reach_what_they_mean_to(gateway_scenario):
    bearer = gateway_scenario["port"]["bearer"][0]
    assert [a[0] for a in bearer] == [200, 200, 200, 200, 403, 200, 403, 403, 403, 403, 403,
                                      403, 403, 200, 403]
    assert b"<Code>InvalidToken</Code>" in bearer[8][2]
    assert b"OIDC: token expired" in bearer[9][2]
    assert b"OIDC: unsupported alg 'none'" in bearer[10][2]
    sts = gateway_scenario["port"]["ldap_sts"][0]
    assert [a[0] for a in sts] == [200, 200, 200, 403, 403, 403, 403, 403, 403, 400, 200]
    assert b"LDAP: bind failed (resultCode 49)" in sts[4][2]


def s_oidc_only(s, key):
    c = s.call
    good = {"iss": ISSUER, "aud": "seaweedfs", "sub": "ops", "exp": time.time() + 3600}
    admin = _bearer(token({**good, "roles": "admin"}))
    reader = _bearer(token({**good, "roles": "reader"}, alg="RS256", key=key))
    public = json.dumps({"Version": "2012-10-17", "Statement": [
        {"Effect": "Allow", "Principal": "*", "Action": ["s3:GetObject"],
         "Resource": ["arn:aws:s3:::pub/*"]}]}).encode()
    return [
        c("PUT", "/pub", who=None),
        c("PUT", "/pub", headers=admin, who=None),
        c("PUT", "/pub/o.txt", body=b"public body", headers=admin, who=None),
        c("GET", "/pub/o.txt", who=None),
        c("GET", "/pub/o.txt", headers=reader, who=None),
        c("PUT", "/pub", "policy", body=public, headers=admin, who=None),
        c("GET", "/pub/o.txt", who=None),
        c("PUT", "/pub/anon.txt", body=b"x", who=None),
        c("GET", "/", who=None),
        s.post_form("pub", {"key": "form/${filename}"}, b"form body", who=None),
        c("GET", "/pub/form/up.bin", headers=admin, who=None),
        c("GET", "/iceberg/v1/config", who=None),
        c("GET", "/iceberg/v1/config", headers=admin, who=None),
        c("POST", "/", body=_form(Action="ListUsers"), headers={**FORM, **admin}, who=None),
        c("POST", "/", body=_form(Action="ListUsers"), headers=FORM, who=None),
    ]


@pytest.fixture(scope="module")
def oidc_only_scenario(tmp_path_factory, rsa_key):
    conf = {"oidc": _twin_config(1, rsa_key)["oidc"]}
    return run_scenario(tmp_path_factory.mktemp("s3-oidc-only"),
                        [("oidc_only", lambda s: s_oidc_only(s, rsa_key))], config=conf)


def test_oidc_only_gateway_is_anonymous_not_open_against_jax(oidc_only_scenario):
    jax, port = oidc_only_scenario["jax"]["oidc_only"], oidc_only_scenario["port"]["oidc_only"]
    assert port[0] != "raised", port[1]
    assert port == jax
    assert [a[0] for a in port[0]] == [403, 200, 200, 403, 200, 204, 200, 403, 403, 403, 404,
                                       403, 200, 200, 403]
