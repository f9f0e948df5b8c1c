"""Embedded IAM API: AWS IAM query protocol on the S3 service endpoint.

Port of seaweedfs_tpu/s3/iamapi.py, whole: the same XML bodies and
identity KV documents, under this module's own lock.

Reference: weed/iamapi (CreateUser/ListUsers/DeleteUser,
Create/Delete/ListAccessKeys, Put/Get/DeleteUserPolicy over the
2010-05-08 query protocol). Backed by the SAME filer-persisted identity
config the shell's s3.* commands maintain (s3/identity.json in the
filer KV), so keys minted here authenticate on every gateway within
the identity store's reload TTL.

Model mapping: one config entry per (user, accessKey); a user created
before any key is a keyless placeholder entry the credential loader
skips. PutUserPolicy attaches the document to every entry of the user
(replacing coarse actions, exactly like the shell's s3.policy.put).
"""

from __future__ import annotations

import json
import threading
import uuid
import xml.etree.ElementTree as ET

from .config import S3_IDENTITY_KV, mint_key_pair

# ThreadingHTTPServer serves IAM calls concurrently; every action is a
# whole-document read-modify-write of the identity KV, so a lost update
# would hand a caller a 200 + credentials that were never persisted
_MUTATE_LOCK = threading.Lock()

IAM_XMLNS = "https://iam.amazonaws.com/doc/2010-05-08/"

ACTIONS = {
    "CreateUser",
    "DeleteUser",
    "ListUsers",
    "CreateAccessKey",
    "DeleteAccessKey",
    "ListAccessKeys",
    "PutUserPolicy",
    "GetUserPolicy",
    "DeleteUserPolicy",
}


class IamError(Exception):
    def __init__(self, code: int, typ: str, message: str):
        super().__init__(message)
        self.code = code
        self.typ = typ


def _load(store) -> dict:
    raw = store.kv_get(S3_IDENTITY_KV)
    if not raw:
        return {"identities": []}
    try:
        return json.loads(raw)
    except ValueError:
        return {"identities": []}


def _save(store, conf: dict) -> None:
    store.kv_put(S3_IDENTITY_KV, json.dumps(conf).encode())


def _entries(conf: dict, user: str) -> list[dict]:
    return [i for i in conf.get("identities", []) if i.get("name") == user]


def _require_user(conf: dict, user: str) -> list[dict]:
    got = _entries(conf, user)
    if not got:
        raise IamError(404, "NoSuchEntity", f"user {user} not found")
    return got


def _response(action: str, fill) -> bytes:
    root = ET.Element(f"{action}Response", xmlns=IAM_XMLNS)
    result = ET.SubElement(root, f"{action}Result")
    fill(result)
    meta = ET.SubElement(root, "ResponseMetadata")
    ET.SubElement(meta, "RequestId").text = uuid.uuid4().hex
    return b'<?xml version="1.0" encoding="UTF-8"?>' + ET.tostring(root)


def _user_el(parent, name: str):
    u = ET.SubElement(parent, "User")
    ET.SubElement(u, "UserName").text = name
    ET.SubElement(u, "UserId").text = name
    ET.SubElement(u, "Arn").text = f"arn:aws:iam:::user/{name}"
    ET.SubElement(u, "Path").text = "/"
    return u


def execute(store, form: dict) -> bytes:
    """Run one IAM action against the identity config; returns the XML
    response body or raises IamError."""
    with _MUTATE_LOCK:
        return _execute_locked(store, form)


def _execute_locked(store, form: dict) -> bytes:
    action = form.get("Action", "")
    user = form.get("UserName", "")
    conf = _load(store)
    idents = conf.setdefault("identities", [])

    if action == "CreateUser":
        if not user:
            raise IamError(400, "InvalidInput", "UserName required")
        if _entries(conf, user):
            raise IamError(409, "EntityAlreadyExists", f"user {user} exists")
        idents.append(
            {"name": user, "accessKey": "", "secretKey": "", "actions": []}
        )
        _save(store, conf)
        return _response("CreateUser", lambda r: _user_el(r, user))

    if action == "ListUsers":
        names = sorted({i.get("name", "") for i in idents if i.get("name")})

        def fill(r):
            ET.SubElement(r, "IsTruncated").text = "false"
            users = ET.SubElement(r, "Users")
            for n in names:
                m = ET.SubElement(users, "member")
                ET.SubElement(m, "UserName").text = n
                ET.SubElement(m, "UserId").text = n
                ET.SubElement(m, "Arn").text = f"arn:aws:iam:::user/{n}"

        return _response("ListUsers", fill)

    if action == "DeleteUser":
        _require_user(conf, user)
        conf["identities"] = [i for i in idents if i.get("name") != user]
        _save(store, conf)
        return _response("DeleteUser", lambda r: None)

    if action == "CreateAccessKey":
        existing = _require_user(conf, user)
        ak, sk = mint_key_pair()
        policies = next(
            (i.get("policies") for i in existing if i.get("policies")), []
        )
        # the ["Admin"] default applies ONLY to a user with neither
        # actions nor policies: a PutUserPolicy-restricted user (whose
        # actions were deliberately emptied) must NEVER regain Admin
        # through a key mint — that would be privilege escalation
        actions = next(
            (i.get("actions") for i in existing if i.get("actions")),
            [] if policies else ["Admin"],
        )
        entry = {
            "name": user,
            "accessKey": ak,
            "secretKey": sk,
            "actions": list(actions),
        }
        if policies:
            entry["policies"] = list(policies)
            pn = next(
                (i.get("policyName") for i in existing if i.get("policyName")),
                "",
            )
            if pn:
                entry["policyName"] = pn
        # replace a keyless placeholder if one exists
        placeholders = [
            i for i in existing if not i.get("accessKey")
        ]
        if placeholders:
            idents.remove(placeholders[0])
        idents.append(entry)
        _save(store, conf)

        def fill(r):
            k = ET.SubElement(r, "AccessKey")
            ET.SubElement(k, "UserName").text = user
            ET.SubElement(k, "AccessKeyId").text = ak
            ET.SubElement(k, "SecretAccessKey").text = sk
            ET.SubElement(k, "Status").text = "Active"

        return _response("CreateAccessKey", fill)

    if action == "DeleteAccessKey":
        ak = form.get("AccessKeyId", "")
        victim = next(
            (i for i in idents if i.get("accessKey") == ak), None
        )
        if victim is None:
            raise IamError(404, "NoSuchEntity", f"access key {ak} not found")
        idents.remove(victim)
        owner = victim.get("name", "")
        if owner and not _entries(conf, owner):
            # the USER outlives its last key (AWS semantics: keys and
            # users are separate entities) — keep a keyless placeholder
            # carrying BOTH actions and policies, or delete+recreate of
            # a key would silently shed the user's restrictions
            placeholder = {
                "name": owner,
                "accessKey": "",
                "secretKey": "",
                "actions": victim.get("actions", []),
            }
            if victim.get("policies"):
                placeholder["policies"] = victim["policies"]
                if victim.get("policyName"):
                    placeholder["policyName"] = victim["policyName"]
            idents.append(placeholder)
        _save(store, conf)
        return _response("DeleteAccessKey", lambda r: None)

    if action == "ListAccessKeys":
        existing = _require_user(conf, user)

        def fill(r):
            ET.SubElement(r, "IsTruncated").text = "false"
            keys = ET.SubElement(r, "AccessKeyMetadata")
            for i in existing:
                if not i.get("accessKey"):
                    continue
                m = ET.SubElement(keys, "member")
                ET.SubElement(m, "UserName").text = user
                ET.SubElement(m, "AccessKeyId").text = i["accessKey"]
                ET.SubElement(m, "Status").text = "Active"

        return _response("ListAccessKeys", fill)

    if action == "PutUserPolicy":
        existing = _require_user(conf, user)
        try:
            doc = json.loads(form.get("PolicyDocument", ""))
        except ValueError:
            raise IamError(
                400, "MalformedPolicyDocument", "PolicyDocument is not JSON"
            ) from None
        for i in existing:
            i["policies"] = [doc]
            i["actions"] = []  # policies REPLACE coarse actions
            i["policyName"] = form.get("PolicyName", "default")
        _save(store, conf)
        return _response("PutUserPolicy", lambda r: None)

    if action == "GetUserPolicy":
        existing = _require_user(conf, user)
        pol = next((i.get("policies") for i in existing if i.get("policies")), None)
        if not pol:
            raise IamError(404, "NoSuchEntity", f"user {user} has no policy")

        def fill(r):
            ET.SubElement(r, "UserName").text = user
            ET.SubElement(r, "PolicyName").text = next(
                (i.get("policyName", "default") for i in existing), "default"
            )
            ET.SubElement(r, "PolicyDocument").text = json.dumps(pol[0])

        return _response("GetUserPolicy", fill)

    if action == "DeleteUserPolicy":
        existing = _require_user(conf, user)
        for i in existing:
            i.pop("policies", None)
            i.pop("policyName", None)
        _save(store, conf)
        return _response("DeleteUserPolicy", lambda r: None)

    raise IamError(400, "InvalidAction", f"unsupported action {action!r}")


def error_xml(e: IamError) -> bytes:
    root = ET.Element("ErrorResponse", xmlns=IAM_XMLNS)
    err = ET.SubElement(root, "Error")
    ET.SubElement(err, "Code").text = e.typ
    ET.SubElement(err, "Message").text = str(e)
    ET.SubElement(
        ET.SubElement(root, "ResponseMetadata"), "RequestId"
    ).text = uuid.uuid4().hex
    return b'<?xml version="1.0" encoding="UTF-8"?>' + ET.tostring(root)
