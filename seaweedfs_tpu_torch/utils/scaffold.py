"""`scaffold` templates — commented TOML the operator edits in place.

Port of seaweedfs_tpu/utils/scaffold.py, whole: every template's text is
the JAX one's.

Reference: weed/command/scaffold/*.toml (security, master, volume,
filer, notification, replication) emitted by `weed scaffold -config=X`.
"""

from __future__ import annotations

TEMPLATES: dict[str, str] = {
    "security": """\
# security.toml — searched in ./, ~/.seaweedfs_tpu/, /etc/seaweedfs_tpu/
# Flags override these values.

[jwt.signing]
# shared secret for write-authorization JWTs minted by the master at
# Assign time and checked by volume servers before accepting writes
key = ""
expires_after_seconds = 10

[https.default]
# cert/key turn every HTTP listener on this node into TLS (hot-reload
# on file change); ca additionally enforces mutual TLS
cert = ""
key = ""
ca = ""

[access]
# ip whitelist for admin endpoints ("" = allow all)
ui = ""
""",
    "master": """\
# master.toml
[master.volume_growth]
# how many volumes to grow per replication class when none is writable
copy_1 = 7
copy_2 = 6
copy_3 = 3
copy_other = 1

[master.maintenance]
# auto-EC scanner: volumes at this fraction of the size limit (and
# write-quiet for quiet_seconds) get ec_encode tasks
ec_auto_fullness = 0.0
ec_quiet_seconds = 60

[master.vacuum]
garbage_threshold = 0.3
interval_seconds = 60
""",
    "volume": """\
# volume.toml
[volume]
# durable needle map: "sqlite" reopens in O(delta); "memory" is O(live)
index = "memory"
# erasure-coding backend: auto | cpu | xla | pallas | native
ec_backend = "auto"

[volume.store]
max_volumes = 8
""",
    "filer": """\
# filer.toml — store backend selection
[sqlite]
enabled = true
dbFile = "./filerdb/filer.db"

[memory]
# volatile, for tests only
enabled = false
""",
    "s3": """\
# s3.toml
[s3]
region = "us-east-1"
# identities/roles JSON (same schema as -s3Config)
config = ""
""",
    "notification": """\
# notification.toml — filer event sinks
[notification.webhook]
enabled = false
endpoint = "http://localhost:8999/hook"

[notification.mq]
enabled = false
broker = "localhost:17777"
topic = "filer-events"
""",
    "replication": """\
# replication.toml — cross-cluster sync (filer.sync daemon),
# consumed by `python -m seaweedfs_tpu.replication`
[source.filer]
address = "localhost:8888"

[sink.filer]
address = "localhost:28888"
directory = "/"
""",
}


def scaffold(name: str) -> str:
    if name not in TEMPLATES:
        raise KeyError(
            f"unknown config {name!r}; one of {', '.join(sorted(TEMPLATES))}"
        )
    return TEMPLATES[name]
