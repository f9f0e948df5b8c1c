"""PyTorch port: iam/policy and iam/sts (seaweedfs_tpu_torch/iam), held
against the JAX package on the CPU.

Documents and requests come from a numpy seed and go through both
packages: every verdict, every refusal (its type and message) and every
credential must be equal, with tolerance 0. The STS clocks and the
randomness of its credentials are pinned, so both packages mint the same
keys and tokens and expire them at the same instant.
"""

import os
import time

import numpy as np
import pytest

import seaweedfs_tpu.iam as jax_iam
import seaweedfs_tpu.iam.policy as jax_policy
import seaweedfs_tpu.iam.sts as jax_sts
import seaweedfs_tpu_torch.iam as port_iam
import seaweedfs_tpu_torch.iam.policy as port_policy
import seaweedfs_tpu_torch.iam.sts as port_sts

PKGS = (jax_policy, port_policy)

ACTIONS = ["s3:GetObject", "s3:PutObject", "s3:DeleteObject", "s3:ListBucket", "s3:*",
           "s3:Get*", "s3:?utObject", "*", "iam:PassRole", "sts:AssumeRole", "s3:[ab]*"]
RESOURCES = ["arn:aws:s3:::logs/*", "arn:aws:s3:::logs", "arn:aws:s3:::*", "*",
             "arn:aws:s3:::logs/2024/??.gz", "arn:aws:s3:::data/[x]/*", "arn:aws:iam:::role/up*"]
REQ_ACTIONS = ["s3:GetObject", "s3:PutObject", "s3:DeleteObject", "s3:ListBucket",
               "sts:AssumeRole", "s3:aGet", "iam:PassRole"]
REQ_RESOURCES = ["arn:aws:s3:::logs/a.txt", "arn:aws:s3:::logs", "arn:aws:s3:::logs/2024/01.gz",
                 "arn:aws:s3:::data/[x]/y", "arn:aws:s3:::data/x/y", "arn:aws:iam:::role/uploader",
                 "arn:aws:s3:::other/k"]
# one block per operator, each with values that pass and fail on CONTEXTS
CONDITIONS = [
    {"StringEquals": {"aws:username": ["ann", "bob"]}},
    {"StringNotEquals": {"aws:username": "ann"}},
    {"StringLike": {"s3:prefix": ["home/*", "pub?c"]}},
    {"StringNotLike": {"s3:prefix": "home/*"}},
    {"IpAddress": {"aws:SourceIp": ["10.0.0.0/8", "not-a-cidr", "2001:db8::/32"]}},
    {"NotIpAddress": {"aws:SourceIp": "192.168.1.0/24"}},
    {"NumericEquals": {"s3:max-keys": "100"}},
    {"NumericLessThan": {"s3:max-keys": ["50", "x"]}},
    {"NumericLessThanEquals": {"s3:max-keys": 100}},
    {"NumericGreaterThan": {"s3:max-keys": "10"}},
    {"NumericGreaterThanEquals": {"s3:max-keys": "1000"}},
    {"Bool": {"aws:SecureTransport": "true"}},
    {"Bool": {"aws:SecureTransport": [False]}},
    {"StringEqualsIgnoreCaseNope": {"aws:username": "ann"}},  # unknown: fails closed
    {"StringEquals": {"aws:username": "ann"}, "IpAddress": {"aws:SourceIp": "10.1.0.0/16"}},
    {"StringLike": {"aws:username": "*", "s3:prefix": "pub*"}},
]
CONTEXTS = [
    {},
    {"aws:username": "ann", "aws:SourceIp": "10.1.2.3", "s3:prefix": "home/ann",
     "s3:max-keys": "100", "aws:SecureTransport": "true"},
    {"aws:username": "bob", "aws:SourceIp": "192.168.1.7", "s3:prefix": "public",
     "s3:max-keys": "5", "aws:SecureTransport": False},
    {"aws:username": "eve", "aws:SourceIp": "2001:db8::1", "s3:prefix": "pubic",
     "s3:max-keys": "not-a-number"},
    {"aws:username": "ann", "aws:SourceIp": "bogus", "s3:max-keys": 1000},
]
PRINCIPALS = ["*", {"AWS": "*"}, {"AWS": ["arn:aws:iam:::user/ann", "arn:aws:iam:::user/b*"]},
              {"AWS": "arn:aws:iam:::user/eve"}, "arn:aws:iam:::user/ann"]
REQ_PRINCIPALS = ["arn:aws:iam:::user/ann", "arn:aws:iam:::user/bob", "arn:aws:iam:::user/eve",
                  "*"]


def _pick(rng, seq, k=None):
    if k is None:
        return seq[int(rng.integers(len(seq)))]
    return [seq[int(i)] for i in rng.choice(len(seq), size=k, replace=False)]


def _statement(rng, bucket_policy: bool = False) -> dict:
    stmt = {"Effect": _pick(rng, ["Allow", "Deny", "allow", "DENY", "Audit"])}
    if rng.random() < 0.2:
        stmt["Sid"] = f"s{int(rng.integers(100))}"
    acts = _pick(rng, ACTIONS, int(rng.integers(1, 4)))
    key = "NotAction" if rng.random() < 0.25 else "Action"
    stmt[key] = acts[0] if len(acts) == 1 and rng.random() < 0.5 else acts
    r = rng.random()
    if r < 0.2:
        stmt["NotResource"] = _pick(rng, RESOURCES, int(rng.integers(1, 3)))
    elif r < 0.85:
        res = _pick(rng, RESOURCES, int(rng.integers(1, 3)))
        stmt["Resource"] = res[0] if len(res) == 1 else res
    if rng.random() < 0.45:
        stmt["Condition"] = _pick(rng, CONDITIONS)
    if bucket_policy:
        r = rng.random()
        if r < 0.15:
            stmt["NotPrincipal"] = _pick(rng, PRINCIPALS)
        elif r < 0.9:
            stmt["Principal"] = _pick(rng, PRINCIPALS)
    return stmt


def _documents(seed: int, n: int, bucket_policy: bool = False) -> list[dict]:
    rng = np.random.default_rng(seed)
    docs = []
    for _ in range(n):
        k = int(rng.integers(0, 4))
        doc = {"Version": "2012-10-17", "Statement": [_statement(rng, bucket_policy)
                                                      for _ in range(k)]}
        if k == 1 and rng.random() < 0.3:
            doc["Statement"] = doc["Statement"][0]  # a lone statement, not a list
        docs.append(doc)
    return docs


def _outcome(fn, *args, **kwargs):
    try:
        return ("ok", fn(*args, **kwargs))
    except Exception as e:  # noqa: BLE001 — the refusal is compared
        return (type(e).__name__, str(e))


# ---------------------------------------------------------------- policy


@pytest.mark.parametrize("seed", range(4))
def test_policy_verdicts_equal_over_a_seeded_table(seed):
    docs = _documents(1000 + seed, 40)
    rng = np.random.default_rng(2000 + seed)
    n_allow = n_deny = 0
    for i in range(len(docs)):
        group = [docs[i]] + ([docs[(i + 1) % len(docs)]] if i % 3 == 0 else [])
        for action in REQ_ACTIONS:
            for resource in REQ_RESOURCES:
                ctx = CONTEXTS[int(rng.integers(len(CONTEXTS)))]
                got = [_outcome(m.evaluate_policies_verdict, group, action, resource, ctx)
                       for m in PKGS]
                assert got[0] == got[1], (group, action, resource, ctx)
                n_allow += got[0] == ("ok", "allow")
                n_deny += got[0] == ("ok", "deny")
                assert (_outcome(port_policy.evaluate_policies, group, action, resource, ctx)
                        == _outcome(jax_policy.evaluate_policies, group, action, resource, ctx))
    # the table reaches every verdict
    assert n_allow and n_deny


def test_every_condition_operator_against_every_context():
    for cond in CONDITIONS:
        for ctx in CONTEXTS:
            # a malformed number in the document raises, in both packages
            got = [_outcome(m._conditions_met, cond, ctx) for m in PKGS]
            assert got[0] == got[1], (cond, ctx)
    assert set(port_policy._CONDITION_EVALUATORS) == set(jax_policy._CONDITION_EVALUATORS)


def test_wildcards_match_alike():
    rng = np.random.default_rng(7)
    alphabet = list("ab*?[]/:-")
    for _ in range(3000):
        pat = "".join(_pick(rng, alphabet) for _ in range(int(rng.integers(0, 6))))
        val = "".join(_pick(rng, list("ab[]/:-")) for _ in range(int(rng.integers(0, 6))))
        assert port_policy._wildcard_match(pat, val) == jax_policy._wildcard_match(pat, val)


@pytest.mark.parametrize("seed", range(3))
def test_bucket_policies_equal(seed):
    docs = _documents(3000 + seed, 40, bucket_policy=True)
    rng = np.random.default_rng(4000 + seed)
    for doc in docs:
        assert (port_policy.bucket_policy_is_public(doc)
                == jax_policy.bucket_policy_is_public(doc))
        for bucket in ("logs", "data"):
            got = [_outcome(m.validate_bucket_policy, doc, bucket) for m in PKGS]
            assert got[0] == got[1], doc
        for principal in REQ_PRINCIPALS:
            action = _pick(rng, REQ_ACTIONS)
            resource = _pick(rng, REQ_RESOURCES)
            ctx = _pick(rng, CONTEXTS)
            got = [_outcome(m.evaluate_bucket_policy, doc, action, resource, principal, ctx)
                   for m in PKGS]
            assert got[0] == got[1], (doc, action, resource, principal)


def test_validate_bucket_policy_refusals_equal():
    cases = [
        {},
        {"Statement": []},
        {"Statement": [{"Effect": "Permit", "Principal": "*", "Action": "s3:*"}]},
        {"Statement": [{"Effect": "Allow", "Action": "s3:*"}]},
        {"Statement": [{"Effect": "Allow", "Principal": "*"}]},
        {"Statement": [{"Effect": "Allow", "Principal": "*", "Action": "s3:*",
                        "Resource": "arn:aws:s3:::other/*"}]},
        {"Statement": [{"Effect": "Allow", "Principal": "*", "Action": "s3:*",
                        "Resource": "arn:aws:s3:::logsx"}]},
        {"Statement": {"Effect": "Deny", "NotPrincipal": {"AWS": "*"}, "NotAction": "s3:Get*",
                       "Resource": ["arn:aws:s3:::logs", "arn:aws:s3:::logs/*"]}},
    ]
    outs = [[_outcome(m.validate_bucket_policy, doc, "logs") for doc in cases] for m in PKGS]
    assert outs[0] == outs[1]
    assert [o[0] for o in outs[1]] == ["PolicyError"] * 7 + ["ok"]


def test_s3_action_and_resource_equal():
    queries = [{}, {"tagging": ""}, {"retention": ""}, {"legal-hold": ""}, {"acl": ""},
               {"uploadId": "u"}, {"versionId": "v"}, {"uploads": ""}, {"policy": ""},
               {"policyStatus": ""}, {"encryption": ""}, {"lifecycle": ""}, {"versioning": ""},
               {"object-lock": ""}, {"cors": ""}, {"versions": ""}, {"delete": ""},
               {"uploadId": "u", "versionId": "v"}]
    seen = set()
    for method in ("GET", "HEAD", "PUT", "POST", "DELETE", "PATCH"):
        for bucket, key in (("", ""), ("b", ""), ("b", "k/x.txt")):
            for q in queries:
                got = [m.s3_action_and_resource(method, bucket, key, q) for m in PKGS]
                assert got[0] == got[1], (method, bucket, key, q)
                seen.add(got[0][0])
    assert len(seen) >= 35


def test_policy_engine_equal():
    docs = _documents(5000, 6)
    engines = [m.PolicyEngine() for m in PKGS]
    for e, m in zip(engines, PKGS):
        for i, doc in enumerate(docs):
            if "Statement" in doc:
                e.put_policy(f"p{i}", doc)
        assert _outcome(e.put_policy, "bad", {"Version": "x"})[0] == "PolicyError"
        e.delete_policy("p1")
        e.delete_policy("nope")
    assert engines[0].names() == engines[1].names()
    for name in engines[0].names() + ["nope"]:
        assert engines[0].get_policy(name) == engines[1].get_policy(name)
    for action in REQ_ACTIONS:
        for resource in REQ_RESOURCES:
            got = [_outcome(e.is_allowed, ["p0", "p2", "p3", "nope"], action, resource,
                            CONTEXTS[1]) for e in engines]
            assert got[0] == got[1]
    assert (port_iam.PolicyEngine, port_iam.evaluate_policies, port_iam.StsService) == (
        port_policy.PolicyEngine, port_policy.evaluate_policies, port_sts.StsService)
    assert sorted(n for n in dir(port_iam) if not n.startswith("_")) == sorted(
        n for n in dir(jax_iam) if not n.startswith("_"))


# ------------------------------------------------------------------- sts


class Clock:
    """time.time / time.time_ns pinned to a settable instant, and
    os.urandom to a seeded stream restarted per package run."""

    def __init__(self, monkeypatch):
        self.now = 1_760_000_000.25
        self.rng = np.random.default_rng(0)
        monkeypatch.setattr(time, "time", lambda: self.now)
        monkeypatch.setattr(time, "time_ns", lambda: int(self.now * 1e9))
        monkeypatch.setattr(os, "urandom", lambda n: self.rng.bytes(n))

    def restart(self, seed: int) -> None:
        self.now = 1_760_000_000.25
        self.rng = np.random.default_rng(seed)


def _cred(c):
    return (c.access_key, c.secret_key, c.session_token, c.role.name, c.role.arn,
            c.expires_at, c.expired)


def _sts_run(mod, pol, clock) -> list:
    clock.restart(61)
    svc = mod.StsService()
    allow = {"Statement": [{"Effect": "Allow", "Action": "sts:AssumeRole",
                            "Resource": "arn:aws:iam:::role/up*"}]}
    deny = {"Statement": [{"Effect": "Deny", "Action": "sts:*", "Resource": "*"}]}
    svc.put_role(mod.Role("uploader", policies=[allow], trusted=["AKANN", "AKBOB"]))
    svc.put_role(mod.Role("reader"))
    out = [svc.get_role("uploader").arn, svc.get_role("nope")]
    creds = []
    for caller, policies, role, duration in (
        ("AKANN", [allow], "uploader", 3600), ("AKANN", [allow], "uploader", 60),
        ("AKANN", [allow], "uploader", 10**9), ("AKEVE", [allow], "uploader", 3600),
        ("AKANN", [deny], "uploader", 3600), ("AKANN", [allow, deny], "uploader", 3600),
        ("AKANN", [], "uploader", 3600), ("AKANN", None, "reader", 1200),
        ("AKEVE", [allow], "reader", 3600), ("AKANN", [allow], "nope", 3600),
        ("AKBOB", [allow], "uploader", "1800"),
    ):
        r = _outcome(svc.assume_role, caller, policies, role, duration)
        if r[0] == "ok":
            creds.append(r[1])
            r = ("ok", _cred(r[1]))
        out.append(r)
        clock.now += 1.5
    # expiry: each credential lives until its instant, not a tick longer
    for step in (0, 900 - 20, 1, 1200 - 900, 1800 - 1200, 3600 - 1800, 43200 - 3600, 60):
        clock.now += step
        out.append([(c.expired, None if svc.lookup(c.access_key) is None
                     else _cred(svc.lookup(c.access_key))) for c in creds])
    out.append(svc.lookup("AKNONE"))
    out.append(sorted(svc._creds))
    return out


def test_sts_outcomes_equal_with_pinned_clocks(monkeypatch):
    clock = Clock(monkeypatch)
    got = [_sts_run(mod, pol, clock) for mod, pol in ((jax_sts, jax_policy),
                                                        (port_sts, port_policy))]
    assert got[0] == got[1]
    kinds = [o[0] for o in got[1][2:13]]
    assert kinds.count("ok") == 5 and kinds.count("PermissionError") == 6
    assert got[1][-1] == []  # every credential expired and collected
