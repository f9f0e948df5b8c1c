"""PyTorch port: the Iceberg REST catalog and S3 Tables
(seaweedfs_tpu_torch/s3/tables.py) and the embedded IAM API (s3/iamapi.py),
held against the JAX package on the CPU.

Twin gateways (tests/torch_s3_twins.py, the catalog's uuids and clock and
the IAM API's request ids and key pairs pinned per package) take each
scenario of the JAX tests/test_s3_tables.py step by step, signed as the
admin: the catalog's lifecycle, a prefixed catalog, the S3 Tables target
protocol and its REST aliases, the Admin gate, snapshot commits, a
multi-table transaction, views and the maintenance route's snapshot
expiry (posted directly; the worker's `iceberg` task posts it in
tests/test_torch_remote.py); then the IAM API's actions and the keys they mint. Each step's
statuses, headers and bodies (JSON parsed, XML whole), the `/buckets`
tree and the filer's KV must be equal (tolerance 0).

Also: `_apply_metadata_update`, `_check_table_requirement` and
`_apply_view_update` over seeded documents, every refusal's type and
message included; a seeded sequence of IAM API forms through both
`execute`s (XML bytes and KV documents equal); and the two packages'
locks, which are each their own.
"""

import copy
import json
import threading
import types
import urllib.parse
import xml.etree.ElementTree as ET

import numpy as np
import pytest
from torch_s3_twins import CATALOG_T0, MASKED_HEADERS, PKGS, norm, run_scenario, seeded_bytes

FORM = {"Content-Type": "application/x-www-form-urlencoded"}
SCHEMA = {
    "type": "struct",
    "schema-id": 0,
    "fields": [
        {"id": 1, "name": "id", "required": True, "type": "long"},
        {"id": 2, "name": "data", "required": False, "type": "string"},
    ],
}
# ids nested past the top level: a table created with it records the
# top-level maximum as its last-column-id (ROADMAP.md Queue 3)
NESTED = {"type": "struct", "fields": [
    {"id": 1, "name": "id", "required": True, "type": "long"},
    {"id": 2, "name": "s", "required": False, "type": {"type": "struct", "fields": [
        {"id": 3, "name": "a", "required": False, "type": "string"},
        {"id": 4, "name": "b", "required": False, "type": {
            "type": "list", "element-id": 5, "element": "int", "element-required": False}}]}}]}
T0_MS = int(CATALOG_T0 * 1000)
DAY_MS = 86400_000


def form(**kv) -> bytes:
    return urllib.parse.urlencode(kv).encode()


def j(s, method, path, doc=None, headers=None, who="admin", query=""):
    """One catalog request: (status, headers, the JSON body parsed), or
    any other answer as `norm` gives it."""
    body = b"" if doc is None else (doc if isinstance(doc, bytes) else json.dumps(doc).encode())
    hs = {"Content-Type": "application/json", **(headers or {})}
    status, rh, raw = s.raw(method, path, query, body, hs, who)
    if not raw.startswith((b"{", b"[")):
        return norm(status, rh, raw)
    rh = {k.lower(): v for k, v in rh.items() if k.lower() not in MASKED_HEADERS}
    return status, rh, json.loads(raw)


def tgt(op: str) -> dict:
    return {"X-Amz-Target": f"S3Tables.{op}"}


def _xml_text(body: bytes, tag: str) -> str:
    for el in ET.fromstring(body).iter():
        if el.tag.split("}")[-1] == tag:
            return el.text or ""
    return ""


# ---------------------------------------------------------------- steps


def s_lifecycle(s):
    ib = "/iceberg/v1"
    out = [j(s, "GET", f"{ib}/config"), j(s, "GET", f"{ib}/config", query="warehouse=wh"),
           j(s, "POST", f"{ib}/namespaces",
             {"namespace": ["analytics"], "properties": {"owner": "t"}}),
           j(s, "POST", f"{ib}/namespaces", {"namespace": []}),
           j(s, "POST", f"{ib}/namespaces", {"namespace": ["analytics"]}),
           j(s, "POST", f"{ib}/namespaces", {"namespace": ["a:b"]}),
           j(s, "GET", f"{ib}/namespaces"), j(s, "GET", f"{ib}/namespaces/analytics"),
           j(s, "HEAD", f"{ib}/namespaces/analytics"), j(s, "HEAD", f"{ib}/namespaces/nope"),
           j(s, "POST", f"{ib}/namespaces/analytics/properties",
             {"removals": ["owner", "ghost"], "updates": {"team": "core"}})]
    created = j(s, "POST", f"{ib}/namespaces/analytics/tables",
                {"name": "events", "schema": copy.deepcopy(SCHEMA), "properties": {"p": "1"}})
    out.append(created)
    loc = created[2]["metadata-location"]
    key = loc[len("s3://default/"):]
    out += [j(s, "GET", f"{ib}/namespaces/analytics/tables/events"),
            j(s, "HEAD", f"{ib}/namespaces/analytics/tables/events"),
            j(s, "HEAD", f"{ib}/namespaces/analytics/tables/ghost"),
            j(s, "GET", f"/default/{key}"),
            j(s, "POST", f"{ib}/namespaces/analytics/tables",
              {"name": "events", "schema": copy.deepcopy(SCHEMA)}),
            j(s, "POST", f"{ib}/namespaces/analytics/tables", {"name": "bad/name"}),
            j(s, "POST", f"{ib}/namespaces/analytics/tables/events",
              {"updates": [{"action": "set-properties", "updates": {"x": "y"}}]}),
            j(s, "POST", f"{ib}/namespaces/analytics/tables/events",
              {"updates": [{"action": "add-snapshot", "snapshot": {}}]}),
            j(s, "POST", f"{ib}/namespaces/analytics/tables/events",
              {"updates": [{"action": "set-statistics"}]}),
            j(s, "POST", f"{ib}/namespaces/analytics/tables/events", b"{not json"),
            j(s, "POST", f"{ib}/namespaces", {"namespace": ["archive"]}),
            j(s, "POST", f"{ib}/tables/rename",
              {"source": {"namespace": ["analytics"], "name": "events"},
               "destination": {"namespace": ["archive"], "name": "events_v2"}}),
            j(s, "POST", f"{ib}/tables/rename",
              {"source": {"namespace": ["analytics"], "name": "events"},
               "destination": {"namespace": ["nope"], "name": "x"}}),
            j(s, "GET", f"{ib}/namespaces/archive/tables"),
            j(s, "GET", f"{ib}/namespaces/nope/tables"),
            j(s, "GET", f"{ib}/namespaces/analytics/tables/events"),
            j(s, "DELETE", f"{ib}/namespaces/archive"),
            j(s, "DELETE", f"{ib}/namespaces/archive/tables/events_v2"),
            j(s, "DELETE", f"{ib}/namespaces/archive/tables/events_v2"),
            j(s, "DELETE", f"{ib}/namespaces/archive"),
            j(s, "PUT", f"{ib}/namespaces"), j(s, "GET", f"{ib}/bogus/route/x/y/z"),
            j(s, "POST", f"{ib}/namespaces/analytics/tables",
              {"name": "nested", "schema": copy.deepcopy(NESTED)})]
    return out


def s_prefixed(s):
    ib = "/iceberg/v1/warehouse1"
    return [j(s, "POST", "/", {"name": "warehouse1"}, tgt("CreateTableBucket")),
            j(s, "POST", f"{ib}/namespaces", {"namespace": ["raw"]}),
            j(s, "POST", f"{ib}/namespaces/raw/tables",
              {"name": "t1", "schema": copy.deepcopy(SCHEMA)}),
            j(s, "GET", f"{ib}/namespaces/raw/tables/t1"),
            j(s, "POST", "/iceberg/v1/ghostbucket/namespaces", {"namespace": ["raw"]}),
            s.call("PUT", "/warehouse1/raw/t1/data/00000-0.parquet", body=seeded_bytes(29, 5000)),
            s.call("GET", "/warehouse1/raw/t1/data/00000-0.parquet"),
            j(s, "GET", "/warehouse1", query="list-type=2")]


def s_s3tables(s):
    out = [j(s, "POST", "/", {"name": "tb1"}, tgt("CreateTableBucket")),
           j(s, "POST", "/", {"name": "tb1"}, tgt("CreateTableBucket")),
           j(s, "POST", "/", {"name": ""}, tgt("CreateTableBucket")),
           j(s, "POST", "/", {}, tgt("ListTableBuckets"))]
    arn = out[0][2]["arn"]
    out += [j(s, "POST", "/", {"tableBucketARN": arn, "namespace": ["ns1"]},
              tgt("CreateNamespace")),
            j(s, "POST", "/", {"tableBucketARN": arn, "namespace": "ns1", "name": "t"},
              tgt("CreateTable")),
            j(s, "POST", "/", {"tableBucketARN": arn, "namespace": "ns1", "name": "t"},
              tgt("GetTable")),
            j(s, "POST", "/", {"tableBucketARN": arn, "namespace": "ns1"}, tgt("GetNamespace")),
            j(s, "POST", "/", {"tableBucketARN": arn}, tgt("ListNamespaces")),
            j(s, "POST", "/", {"tableBucketARN": arn}, tgt("ListTables")),
            j(s, "POST", "/", {"tableBucketARN": arn}, tgt("GetTableBucket")),
            j(s, "POST", "/", {}, tgt("GetTableBucket")),
            j(s, "POST", "/", {}, tgt("PutTablePolicy")),
            j(s, "POST", "/", {"tableBucketARN": arn}, tgt("DeleteTableBucket")),
            j(s, "GET", f"/buckets/{arn}"), j(s, "GET", "/buckets"), j(s, "GET", "/buckets/"),
            j(s, "GET", f"/namespaces/{arn}"), j(s, "GET", f"/namespaces/{arn}/ns1"),
            j(s, "GET", f"/tables/{arn}"), j(s, "GET", f"/tables/{arn}/ns1/t"),
            j(s, "PUT", f"/namespaces/{arn}", {"namespace": ["ns2"]}),
            j(s, "PUT", f"/tables/{arn}/ns2", {"name": "t2"}),
            j(s, "POST", f"/tables/{arn}"),
            j(s, "DELETE", f"/tables/{arn}/ns1/t"), j(s, "DELETE", f"/tables/{arn}/ns2/t2"),
            j(s, "DELETE", f"/namespaces/{arn}/ns1"), j(s, "DELETE", f"/namespaces/{arn}/ns2"),
            j(s, "PUT", "/buckets", {"name": "tb2"}),
            j(s, "DELETE", f"/buckets/{arn}"), j(s, "GET", f"/buckets/{arn}")]
    return out


def s_admin_gate(s):
    body = {"name": "gated"}
    return [j(s, "POST", "/", body, tgt("CreateTableBucket"), who="reader"),
            j(s, "POST", "/", body, tgt("CreateTableBucket"), who="policy"),
            j(s, "POST", "/", {}, tgt("ListTableBuckets"), who=None),
            j(s, "GET", "/iceberg/v1/namespaces", who=None),
            j(s, "GET", "/iceberg/v1/namespaces", who="ghost"),
            j(s, "POST", "/", body, tgt("CreateTableBucket")),
            j(s, "POST", "/", {}, tgt("ListTableBuckets"))]


def s_snapshots(s):
    ib = "/iceberg/v1/namespaces/snapns/tables/t"
    out = [j(s, "POST", "/iceberg/v1/namespaces", {"namespace": ["snapns"]}),
           j(s, "POST", "/iceberg/v1/namespaces/snapns/tables",
             {"name": "t", "schema": copy.deepcopy(SCHEMA)})]

    def commit(updates, requirements=None):
        out.append(j(s, "POST", ib, {"updates": updates, "requirements": requirements or []}))
        return out[-1]

    snap = {"snapshot-id": 4242, "sequence-number": 1, "timestamp-ms": 1700000000000,
            "manifest-list": "s3://default/snapns/t/metadata/snap-4242.avro",
            "summary": {"operation": "append"}}
    commit([{"action": "add-snapshot", "snapshot": snap},
            {"action": "set-snapshot-ref", "ref-name": "main", "snapshot-id": 4242,
             "type": "branch"}])
    new_schema = {"type": "struct", "schema-id": 1, "fields": SCHEMA["fields"] + [
        {"id": 3, "name": "extra", "required": False, "type": "string"}]}
    commit([{"action": "add-schema", "schema": new_schema},
            {"action": "set-current-schema", "schema-id": -1}])
    nested = {"type": "struct", "schema-id": 2, "fields": new_schema["fields"] + [
        {"id": 4, "name": "s", "required": False, "type": {"type": "struct", "fields": [
            {"id": 5, "name": "inner", "required": False, "type": "string"}]}}]}
    commit([{"action": "add-schema", "schema": nested}])
    snap2 = dict(snap, **{"snapshot-id": 4343, "sequence-number": 2})
    advance = [{"action": "add-snapshot", "snapshot": snap2},
               {"action": "set-snapshot-ref", "ref-name": "main", "snapshot-id": 4343,
                "type": "branch"}]
    commit(advance, [{"type": "assert-ref-snapshot-id", "ref": "main", "snapshot-id": 777}])
    md = j(s, "GET", ib)
    out.append(md)
    commit(advance, [{"type": "assert-ref-snapshot-id", "ref": "main", "snapshot-id": 4242},
                     {"type": "assert-table-uuid", "uuid": md[2]["metadata"]["table-uuid"]}])
    commit([], [{"type": "assert-table-uuid", "uuid": "nope"}])
    commit([], [{"type": "assert-bogus"}])
    commit([], [{"type": "assert-create"}])
    commit([], [{"type": "assert-current-schema-id", "current-schema-id": 1},
                {"type": "assert-last-assigned-field-id", "last-assigned-field-id": 5}])
    commit([], [{"type": "assert-default-spec-id", "default-spec-id": 3}])
    commit([{"action": "add-spec", "spec": {"spec-id": 1, "fields": [{"field-id": 1000}]}},
            {"action": "set-default-spec", "spec-id": -1},
            {"action": "add-sort-order", "sort-order": {"order-id": 1, "fields": []}},
            {"action": "set-default-sort-order", "sort-order-id": -1},
            {"action": "set-snapshot-ref", "ref-name": "audit", "snapshot-id": 4242,
             "type": "tag"}])
    commit([{"action": "set-snapshot-ref", "ref-name": "main", "snapshot-id": 4242,
             "type": "branch"},
            {"action": "remove-snapshots", "snapshot-ids": [4343]},
            {"action": "remove-snapshot-ref", "ref-name": "audit"}])
    commit([{"action": "set-snapshot-ref", "ref-name": "main", "snapshot-id": 999}])
    commit([{"action": "upgrade-format-version", "format-version": 3}])
    commit([{"action": "remove-snapshots", "snapshot-ids": [4242]}])
    out.append(j(s, "GET", ib))
    return out


def s_transaction(s):
    ib = "/iceberg/v1"
    out = [j(s, "POST", f"{ib}/namespaces", {"namespace": ["txn"]})]
    out += [j(s, "POST", f"{ib}/namespaces/txn/tables",
              {"name": n, "schema": copy.deepcopy(SCHEMA)}) for n in ("a", "b")]

    def change(name, props, reqs=None):
        return {"identifier": {"namespace": ["txn"], "name": name},
                "updates": [{"action": "set-properties", "updates": props}],
                "requirements": reqs or []}

    for changes in ([change("a", {"k": "1"}), change("b", {"k": "2"})],
                    [change("a", {"k": "9"}),
                     change("b", {"k": "9"}, [{"type": "assert-table-uuid", "uuid": "wrong"}])],
                    [change("a", {"x": "1"}), change("a", {"y": "2"})],
                    [change("a", {"k": "3"}), change("ghost", {"k": "3"})]):
        out.append(j(s, "POST", f"{ib}/transactions/commit", {"table-changes": changes}))
        out += [j(s, "GET", f"{ib}/namespaces/txn/tables/{n}") for n in ("a", "b")]
    return out


def s_views(s):
    ib = "/iceberg/v1"
    rep = {"type": "sql", "sql": "SELECT id FROM t", "dialect": "spark"}
    out = [j(s, "POST", f"{ib}/namespaces", {"namespace": ["vws"]}),
           j(s, "POST", f"{ib}/namespaces/vws/views",
             {"name": "v1", "schema": copy.deepcopy(SCHEMA),
              "view-version": {"version-id": 1, "representations": [rep],
                               "summary": {"engine-name": "spark"}}})]
    uid = out[-1][2]["metadata"]["view-uuid"]
    rep2 = {"type": "sql", "sql": "SELECT id, data FROM t", "dialect": "spark"}
    out += [j(s, "GET", f"{ib}/namespaces/vws/views/v1"),
            j(s, "HEAD", f"{ib}/namespaces/vws/views/v1"),
            j(s, "HEAD", f"{ib}/namespaces/vws/views/v9"),
            j(s, "GET", f"{ib}/namespaces/vws/views"),
            j(s, "POST", f"{ib}/namespaces/vws/views/v1", {
                "updates": [{"action": "add-view-version",
                             "view-version": {"version-id": 2, "schema-id": 0,
                                              "representations": [rep2]}},
                            {"action": "set-current-view-version", "view-version-id": -1},
                            {"action": "set-properties", "updates": {"a": "b"}}],
                "requirements": [{"type": "assert-view-uuid", "uuid": uid}]}),
            j(s, "POST", f"{ib}/namespaces/vws/views/v1",
              {"updates": [], "requirements": [{"type": "assert-view-uuid", "uuid": "x"}]}),
            j(s, "POST", f"{ib}/namespaces/vws/views/v1",
              {"updates": [], "requirements": [{"type": "assert-bogus"}]}),
            j(s, "POST", f"{ib}/namespaces/vws/views/v1",
              {"updates": [{"action": "add-view-version", "view-version": {"version-id": 2}}]}),
            j(s, "POST", f"{ib}/namespaces/vws/views/v1",
              {"updates": [{"action": "set-current-view-version", "view-version-id": 7}]}),
            j(s, "POST", f"{ib}/namespaces/vws/views/v1",
              {"updates": [{"action": "drop-everything"}]}),
            j(s, "POST", f"{ib}/namespaces/vws/tables",
              {"name": "v1", "schema": copy.deepcopy(SCHEMA)}),
            j(s, "POST", f"{ib}/namespaces/vws/tables",
              {"name": "t1", "schema": copy.deepcopy(SCHEMA)}),
            j(s, "POST", f"{ib}/namespaces/vws/views",
              {"name": "t1", "schema": copy.deepcopy(SCHEMA), "view-version": {}}),
            j(s, "POST", f"{ib}/views/rename",
              {"source": {"namespace": ["vws"], "name": "v1"},
               "destination": {"namespace": ["vws"], "name": "t1"}}),
            j(s, "POST", f"{ib}/tables/rename",
              {"source": {"namespace": ["vws"], "name": "t1"},
               "destination": {"namespace": ["vws"], "name": "v1"}}),
            j(s, "POST", f"{ib}/views/rename",
              {"source": {"namespace": ["vws"], "name": "v1"},
               "destination": {"namespace": ["vws"], "name": "v2"}}),
            j(s, "GET", f"{ib}/namespaces/vws/views/v1"),
            j(s, "DELETE", f"{ib}/namespaces/vws/tables/t1"),
            j(s, "DELETE", f"{ib}/namespaces/vws"),
            j(s, "DELETE", f"{ib}/namespaces/vws/views/v2"),
            j(s, "DELETE", f"{ib}/namespaces/vws/views/v2"),
            j(s, "DELETE", f"{ib}/namespaces/vws")]
    return out


def s_maintenance(s):
    ib = "/iceberg/v1"

    def snap(sid, ts):
        return {"snapshot-id": sid, "sequence-number": sid, "timestamp-ms": ts,
                "manifest-list": f"s3://x/{sid}", "summary": {"operation": "append"}}

    out = [j(s, "POST", f"{ib}/namespaces", {"namespace": ["expns"]}),
           j(s, "POST", f"{ib}/namespaces/expns/tables",
             {"name": "t", "schema": copy.deepcopy(SCHEMA)}),
           j(s, "POST", f"{ib}/namespaces/expns/tables/t", {"updates": [
               {"action": "add-snapshot", "snapshot": snap(1, T0_MS - 90 * DAY_MS)},
               {"action": "add-snapshot", "snapshot": snap(2, T0_MS - 60 * DAY_MS)},
               {"action": "add-snapshot", "snapshot": snap(3, T0_MS - 45 * DAY_MS)},
               {"action": "add-snapshot", "snapshot": snap(4, T0_MS)},
               {"action": "set-snapshot-ref", "ref-name": "keep", "snapshot-id": 2,
                "type": "tag"},
               {"action": "set-snapshot-ref", "ref-name": "main", "snapshot-id": 4,
                "type": "branch"}]}),
           j(s, "POST", f"{ib}/maintenance", {"older-than-days": 30, "dry-run": True}),
           j(s, "POST", f"{ib}/maintenance", {"older-than-ms": T0_MS - 80 * DAY_MS}),
           j(s, "GET", f"{ib}/namespaces/expns/tables/t"),
           j(s, "POST", f"{ib}/maintenance", {"older-than-days": 30, "all-buckets": True}),
           j(s, "GET", f"{ib}/namespaces/expns/tables/t"),
           j(s, "POST", f"{ib}/maintenance",
             {"older-than-days": 30, "all-buckets": True, "dry-run": True}),
           j(s, "POST", f"{ib}/maintenance", {"older-than-days": "x"}),
           j(s, "POST", f"{ib}/maintenance", {"older-than-ms": None}),
           j(s, "POST", f"{ib}/warehouse1/maintenance", {"older-than-days": 1})]
    return out


def s_iam(s):
    c = s.call
    out = [c("POST", "/", body=form(Action="CreateUser", UserName="ann"), headers=FORM),
           c("POST", "/", body=form(Action="CreateUser", UserName="ann"), headers=FORM),
           c("POST", "/", body=form(Action="CreateUser"), headers=FORM),
           c("POST", "/", body=form(Action="ListUsers"), headers=FORM)]
    status, hs, body = s.raw("POST", "/", body=form(Action="CreateAccessKey", UserName="ann"),
                             headers=FORM)
    out.append((status, {k: v for k, v in hs.items() if k.lower() != "date"}, body))
    s.keys["ann"] = (_xml_text(body, "AccessKeyId"), _xml_text(body, "SecretAccessKey"), "")
    policy = {"Version": "2012-10-17", "Statement": [
        {"Effect": "Allow", "Action": ["s3:PutObject", "s3:GetObject", "s3:ListBucket"],
         "Resource": ["arn:aws:s3:::tb-data", "arn:aws:s3:::tb-data/*"]}]}
    out += [c("POST", "/", body=form(Action="PutUserPolicy", UserName="ann",
                                     PolicyName="tbl", PolicyDocument="{nope"), headers=FORM),
            c("POST", "/", body=form(Action="PutUserPolicy", UserName="ann", PolicyName="tbl",
                                     PolicyDocument=json.dumps(policy)), headers=FORM),
            c("POST", "/", body=form(Action="GetUserPolicy", UserName="ann"), headers=FORM),
            c("POST", "/", body=form(Action="ListAccessKeys", UserName="ann"), headers=FORM),
            c("PUT", "/tb-data")]
    s.s3.identities._next = 0.0  # the identity store's reload, now
    out += [c("PUT", "/tb-data/k", body=seeded_bytes(28, 3000), who="ann"),
            c("GET", "/tb-data/k", who="ann"),
            c("PUT", "/other-bucket", who="ann"),
            c("POST", "/", body=form(Action="ListUsers"), headers=FORM, who="ann"),
            c("POST", "/", body=form(Action="DeleteAccessKey", AccessKeyId=s.keys["ann"][0]),
              headers=FORM),
            c("POST", "/", body=form(Action="DeleteAccessKey", AccessKeyId="AKNONE"),
              headers=FORM)]
    s.s3.identities._next = 0.0
    out += [c("GET", "/tb-data/k", who="ann"),
            c("POST", "/", body=form(Action="CreateAccessKey", UserName="ann"), headers=FORM),
            c("POST", "/", body=form(Action="DeleteUserPolicy", UserName="ann"), headers=FORM),
            c("POST", "/", body=form(Action="GetUserPolicy", UserName="ann"), headers=FORM),
            c("POST", "/", body=form(Action="CreateAccessKey", UserName="ghost"), headers=FORM),
            c("POST", "/", body=form(Action="DeleteUser", UserName="ann"), headers=FORM),
            c("POST", "/", body=form(Action="DeleteUser", UserName="ann"), headers=FORM),
            c("POST", "/", body=form(Action="ListUsers"), headers=FORM)]
    return out


STEPS = [(f.__name__[2:], f) for f in (
    s_lifecycle, s_prefixed, s_s3tables, s_admin_gate, s_snapshots, s_transaction, s_views,
    s_maintenance, s_iam)]


@pytest.fixture(scope="module")
def scenario(tmp_path_factory):
    return run_scenario(tmp_path_factory.mktemp("s3-tables"), STEPS)


@pytest.mark.parametrize("step", [name for name, _ in STEPS])
def test_catalog_and_iam_step_against_jax(scenario, step):
    jax, port = scenario["jax"][step], scenario["port"][step]
    assert port[0] != "raised", port[1]
    assert port[0] == jax[0], "the answers"
    assert port[1] == jax[1], "the /buckets tree"
    assert port[2] == jax[2], "the filer's KV"


def test_the_scenario_reaches_what_it_means_to(scenario):
    """Not vacuous: each class of answer the JAX tests check occurs."""
    ans = {step: got[0] for step, got in scenario["port"].items()}
    life = ans["lifecycle"]
    assert life[2][0] == 200 and life[11][2]["metadata"]["last-column-id"] == 2
    loc = life[11][2]["metadata-location"]
    assert loc.startswith("s3://default/analytics/events/metadata/00000-")
    assert life[15][0] == 200 and life[15][2]["table-uuid"] == life[11][2]["metadata"]["table-uuid"]
    commit = life[18][2]
    assert commit["metadata"]["metadata-log"][-1]["metadata-file"] == loc
    assert commit["metadata-location"].split("/")[-1].startswith("00001-")
    assert [a[0] for a in life[19:22]] == [400, 400, 400]
    assert ans["prefixed"][2][2]["metadata-location"].startswith("s3://warehouse1/raw/t1/")
    assert [a[0] for a in ans["prefixed"][5:7]] == [200, 200]  # a data file in the table bucket
    assert life[-1][2]["metadata"]["last-column-id"] == 2  # not 5: the reference's top-level scan
    tables = ans["s3tables"]
    assert tables[1][0] == 409 and tables[6][2]["format"] == "ICEBERG"
    assert [a[0] for a in ans["admin_gate"]] == [403, 403, 403, 403, 403, 200, 200]
    snaps = ans["snapshots"]
    assert snaps[2][2]["metadata"]["current-snapshot-id"] == 4242
    assert snaps[4][2]["metadata"]["last-column-id"] == 5
    assert snaps[5][0] == 409 and snaps[5][2]["error"]["type"] == "CommitFailedException"
    assert snaps[-1][2]["metadata"]["snapshots"] == []
    txn = ans["transaction"]
    assert [txn[i][0] for i in (3, 6, 9, 12)] == [204, 409, 400, 404]
    assert txn[-2][2]["metadata"]["properties"]["k"] == "1"
    views = ans["views"]
    assert views[6][2]["metadata"]["current-version-id"] == 2
    maint = ans["maintenance"]
    assert maint[3][2]["tables_updated"] == 1 and maint[3][2]["snapshots_expired"] == 2
    assert [sn["snapshot-id"] for sn in maint[7][2]["metadata"]["snapshots"]] == [2, 4]
    assert maint[8][2]["snapshots_expired"] == 0
    iam = ans["iam"]
    assert [a[0] for a in iam[:4]] == [200, 409, 400, 200]
    assert [iam[i][0] for i in (10, 11, 12, 13)] == [200, 200, 403, 403]
    assert iam[16][0] == 403  # the deleted key, refused


# --------------------------------------------- the pure update functions


def _outcome(fn, *args):
    try:
        fn(*args)
        return ("ok",)
    except Exception as e:  # noqa: BLE001 — the refusal is compared
        return (type(e).__name__, getattr(e, "code", None), getattr(e, "typ", None), str(e))


def _base_table() -> dict:
    return {"format-version": 2, "table-uuid": "u-1", "location": "s3://b/n/t",
            "last-sequence-number": 0, "last-updated-ms": T0_MS, "last-column-id": 2,
            "current-schema-id": 0, "schemas": [copy.deepcopy(SCHEMA)], "default-spec-id": 0,
            "partition-specs": [{"spec-id": 0, "fields": []}], "last-partition-id": 999,
            "default-sort-order-id": 0, "sort-orders": [{"order-id": 0, "fields": []}],
            "properties": {"a": "1"}, "current-snapshot-id": -1, "snapshots": [],
            "snapshot-log": [], "metadata-log": []}


def _table_update(rng) -> dict:
    sid = int(rng.integers(1, 6))
    kinds = [
        lambda: {"action": "set-properties", "updates": {f"k{sid}": str(sid)}},
        lambda: {"action": "remove-properties", "removals": ["a", f"k{sid}"]},
        lambda: {"action": "assign-uuid", "uuid": f"u-{sid}"},
        lambda: {"action": "upgrade-format-version", "format-version": int(rng.integers(1, 4))},
        lambda: {"action": "set-location", "location": f"s3://b/n/t{sid}"},
        lambda: {"action": "add-schema", "schema": {"schema-id": sid, "fields": [
            {"id": sid + 2, "name": "f", "type": {"type": "list", "element-id": sid + 7}}]},
            **({"last-column-id": sid} if rng.random() < 0.5 else {})},
        lambda: {"action": "set-current-schema", "schema-id": int(rng.integers(-1, 4))},
        lambda: {"action": "add-spec", "spec": {"spec-id": sid, "fields": [
            {"field-id": 999 + sid}]}},
        lambda: {"action": "set-default-spec", "spec-id": int(rng.integers(-1, 4))},
        lambda: {"action": "add-sort-order", "sort-order": {"order-id": sid}},
        lambda: {"action": "set-default-sort-order", "sort-order-id": int(rng.integers(-1, 4))},
        lambda: {"action": "add-snapshot", "snapshot": (
            {"snapshot-id": sid, "sequence-number": sid} if rng.random() < 0.8 else {})},
        lambda: {"action": "set-snapshot-ref", "ref-name": ["main", "b1"][sid % 2],
                 "snapshot-id": sid, "type": "branch"},
        lambda: {"action": "remove-snapshot-ref", "ref-name": ["main", "b1"][sid % 2]},
        lambda: {"action": "remove-snapshots", "snapshot-ids": [sid, sid + 1]},
        lambda: {"action": "set-statistics"},
        lambda: {"action": "set-current-schema", "schema-id": None},
    ]
    return kinds[int(rng.integers(0, len(kinds)))]()


def _requirement(rng, md) -> dict:
    kinds = [
        lambda: {"type": "assert-create"},
        lambda: {"type": "assert-table-uuid",
                 "uuid": md.get("table-uuid") if rng.random() < 0.5 else "other"},
        lambda: {"type": "assert-ref-snapshot-id", "ref": "main",
                 "snapshot-id": [None, 1, 2, md.get("current-snapshot-id")][
                     int(rng.integers(0, 4))]},
        lambda: {"type": "assert-current-schema-id",
                 "current-schema-id": int(rng.integers(0, 3))},
        lambda: {"type": "assert-last-assigned-field-id",
                 "last-assigned-field-id": int(rng.integers(1, 9))},
        lambda: {"type": "assert-last-assigned-partition-id",
                 "last-assigned-partition-id": 999 + int(rng.integers(0, 3))},
        lambda: {"type": "assert-default-spec-id", "default-spec-id": int(rng.integers(0, 2))},
        lambda: {"type": "assert-default-sort-order-id",
                 "default-sort-order-id": int(rng.integers(0, 2))},
        lambda: {"type": "assert-nothing"},
    ]
    return kinds[int(rng.integers(0, len(kinds)))]()


def _view_update(rng) -> dict:
    vid = int(rng.integers(-1, 4))
    kinds = [
        lambda: {"action": "assign-uuid", "uuid": f"v-{vid}"},
        lambda: {"action": "set-properties", "updates": {"p": str(vid)}},
        lambda: {"action": "remove-properties", "removals": ["p", "q"]},
        lambda: {"action": "set-location", "location": f"s3://b/v{vid}"},
        lambda: {"action": "add-schema", "schema": {"schema-id": vid}},
        lambda: {"action": "add-view-version", "view-version": (
            {"version-id": vid, "representations": []} if rng.random() < 0.8 else {})},
        lambda: {"action": "set-current-view-version", "view-version-id": vid},
        lambda: {"action": "replace-everything"},
    ]
    return kinds[int(rng.integers(0, len(kinds)))]()


@pytest.fixture
def frozen_catalog_clocks(monkeypatch):
    for pkg in PKGS.values():
        monkeypatch.setattr(pkg.tables, "time", types.SimpleNamespace(time=lambda: CATALOG_T0))


@pytest.mark.parametrize("seed", range(4))
def test_metadata_updates_and_requirements_equal_on_seeded_documents(frozen_catalog_clocks,
                                                                     seed):
    rng = np.random.default_rng(100 + seed)
    docs = {name: _base_table() for name in PKGS}
    kinds = set()
    for _ in range(120):
        u = _table_update(rng)
        got = {name: _outcome(PKGS[name].tables._apply_metadata_update, docs[name],
                              copy.deepcopy(u)) for name in PKGS}
        assert got["port"] == got["jax"], u
        assert docs["port"] == docs["jax"], u
        kinds.add(got["port"][0])
        req = _requirement(rng, docs["jax"])
        got = {name: _outcome(PKGS[name].tables._check_table_requirement, docs[name],
                              copy.deepcopy(req)) for name in PKGS}
        assert got["port"] == got["jax"], req
        kinds.add(got["port"][0])
    assert {"ok", "TablesError", "TypeError"} <= kinds, kinds


@pytest.mark.parametrize("seed", range(2))
def test_view_updates_equal_on_seeded_documents(frozen_catalog_clocks, seed):
    rng = np.random.default_rng(200 + seed)

    def base():
        return {"view-uuid": "v-0", "format-version": 1, "location": "s3://b/v",
                "schemas": [copy.deepcopy(SCHEMA)], "current-version-id": 1,
                "versions": [{"version-id": 1, "representations": []}],
                "version-log": [{"timestamp-ms": T0_MS, "version-id": 1}], "properties": {}}

    docs = {name: base() for name in PKGS}
    kinds = set()
    for _ in range(80):
        u = _view_update(rng)
        got = {name: _outcome(PKGS[name].tables._apply_view_update, docs[name],
                              copy.deepcopy(u)) for name in PKGS}
        assert got["port"] == got["jax"], u
        assert docs["port"] == docs["jax"], u
        kinds.add(got["port"][:2])
    assert {("ok",), ("TablesError", 400), ("TablesError", 409)} <= kinds, kinds


def test_names_paths_and_arns_route_alike():
    rng = np.random.default_rng(7)
    alphabet = list("ab0.-_:/ ") + ["", "é"]
    names = ["".join(rng.choice(alphabet, int(rng.integers(0, 6)))) for _ in range(200)]
    names += ["a" * 255, "a" * 256, "-x", "x"]
    for n in names:
        got = [_outcome(PKGS[p].tables._check_name, "table", n) for p in PKGS]
        assert got[0] == got[1], n
    paths = ["/buckets", "/buckets/", "/buckets/x", "/buckets/arn:aws:s3tables:r:1:bucket/t",
             "/namespaces/arn:aws:s3tables:", "/tables/arn:aws:s3tables:x", "/tables/x",
             "/gw/buckets/arn:aws:s3tables:", "/iceberg/v1/config", "/namespaces"]
    for p in paths:
        assert PKGS["port"].tables.is_s3tables_path(p) == PKGS["jax"].tables.is_s3tables_path(p)
        assert (PKGS["port"].tables._arn_bucket(p) == PKGS["jax"].tables._arn_bucket(p))
    assert PKGS["port"].tables._ns_of("a%1Fb") == PKGS["jax"].tables._ns_of("a%1Fb") == "a.b"


# ------------------------------------------------------------ the IAM API


class KvStore:
    """The filer store's KV surface, alone."""

    def __init__(self):
        self.kv = {}

    def kv_get(self, k):
        return self.kv.get(k)

    def kv_put(self, k, v):
        self.kv[k] = v


def _iam_form(rng, keys) -> dict:
    user = ["ann", "bob", ""][int(rng.integers(0, 3))]
    action = sorted(PKGS["jax"].iamapi.ACTIONS | {"Bogus"})[int(rng.integers(0, 10))]
    f = {"Action": action, "UserName": user}
    if action == "PutUserPolicy":
        f["PolicyDocument"] = ('{"Statement": []}' if rng.random() < 0.7 else "{nope")
        if rng.random() < 0.5:
            f["PolicyName"] = "p"
    if action == "DeleteAccessKey":
        f["AccessKeyId"] = (keys[int(rng.integers(0, len(keys)))]
                            if keys and rng.random() < 0.7 else "AKNONE")
    return f


@pytest.mark.parametrize("seed", range(3))
def test_iam_execute_equal_on_a_seeded_sequence(monkeypatch, seed):
    rng = np.random.default_rng(300 + seed)
    stores = {name: KvStore() for name in PKGS}
    for name, pkg in PKGS.items():
        rids, keys = iter(range(1, 10**6)), iter(range(1, 10**6))
        monkeypatch.setattr(pkg.iamapi, "uuid", types.SimpleNamespace(
            uuid4=lambda r=rids: types.SimpleNamespace(hex=f"{next(r):032x}")))
        monkeypatch.setattr(pkg.iamapi, "mint_key_pair",
                            lambda k=keys: (f"SWSEED{next(k):014d}", f"sk/{next(k)}"))
    minted, codes = [], set()
    for _ in range(150):
        f = _iam_form(rng, minted)
        got = {}
        for name, pkg in PKGS.items():
            try:
                got[name] = ("ok", pkg.iamapi.execute(stores[name], dict(f)))
            except pkg.iamapi.IamError as e:
                got[name] = (e.code, e.typ, str(e), pkg.iamapi.error_xml(e))
        assert got["port"] == got["jax"], f
        assert stores["port"].kv == stores["jax"].kv, f
        codes.add(got["port"][0])
        if f["Action"] == "CreateAccessKey" and got["port"][0] == "ok":
            minted.append(_xml_text(got["port"][1], "AccessKeyId"))
    assert {"ok", 400, 404, 409} <= codes, codes
    assert minted


def test_the_two_packages_locks_are_their_own():
    """The IAM API's lock is each module's; the catalog's is each
    catalog's: nothing of one package waits on the other's."""
    j_iam, p_iam = PKGS["jax"].iamapi, PKGS["port"].iamapi
    assert p_iam._MUTATE_LOCK is not j_iam._MUTATE_LOCK
    assert p_iam.IamError is not j_iam.IamError
    srv = types.SimpleNamespace(filer=None)
    a, b = PKGS["port"].tables.TablesCatalog(srv), PKGS["port"].tables.TablesCatalog(srv)
    assert a._lock is not b._lock
    assert not isinstance(a, PKGS["jax"].tables.TablesCatalog)
    assert PKGS["port"].tables.TablesError is not PKGS["jax"].tables.TablesError
    # held on one side, the other side's lock is free
    with j_iam._MUTATE_LOCK:
        got = []
        t = threading.Thread(target=lambda: got.append(p_iam._MUTATE_LOCK.acquire(timeout=5)))
        t.start()
        t.join()
        assert got == [True]
        p_iam._MUTATE_LOCK.release()
