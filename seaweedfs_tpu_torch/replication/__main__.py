"""`python -m seaweedfs_tpu_torch.replication` — continuous filer replication.

  python -m seaweedfs_tpu_torch.replication -from hostA:8888 -to hostB:8888 \
      [-path /buckets] [-state sync.state] [-s3.accessKey k -s3.secretKey s]

Sinks by -to shape: another filer (host:port), a cloud bucket
(s3://endpoint/bucket[/prefix]), or a LOCAL DIRECTORY (absolute path
or file:// URL — the reference's `weed filer.backup`). `replication.toml`
(utils/config.py) supplies the defaults of -from, -to and -path.
SIGTERM or SIGINT stops the daemon: its state file holds the last
event applied, and it exits 0.

Port of seaweedfs_tpu/replication/__main__.py, whole."""

from __future__ import annotations

import argparse
import signal
import sys

from .sync import FilerSync


def main(argv=None) -> int:
    # replication.toml supplies source/sink defaults (scaffold template)
    from ..utils.config import load_config

    rcfg = load_config("replication")
    p = argparse.ArgumentParser(prog="seaweedfs_tpu_torch.replication")
    p.add_argument(
        "-from", dest="source",
        default=rcfg.get_str("source.filer.address"),
    )
    p.add_argument(
        "-to", dest="target",
        default=rcfg.get_str("sink.filer.address"),
    )
    p.add_argument(
        "-path", default=rcfg.get_str("sink.filer.directory", "/") or "/"
    )
    p.add_argument("-state", default="filer.sync.state")
    p.add_argument("-s3.accessKey", dest="s3_access", default="")
    p.add_argument("-s3.secretKey", dest="s3_secret", default="")
    a = p.parse_args(argv)
    if not a.source or not a.target:
        p.error("-from/-to required (or replication.toml source/sink)")
    if a.target.startswith("file://") or a.target.startswith("/"):
        from .backup import FilerBackup

        dest = a.target[len("file://") :] if a.target.startswith("file://") else a.target
        job = FilerBackup(
            a.source, dest, path=a.path,
            state_path=a.state
            if a.state != "filer.sync.state"
            else "filer.backup.state",
        )
        signal.signal(signal.SIGTERM, lambda *_: job.stop())
        signal.signal(signal.SIGINT, lambda *_: job.stop())
        print(
            f"filer.backup {a.source}{a.path} -> {dest}", flush=True
        )
        job.run()
        return 0
    if a.target.startswith("s3://"):
        # cloud sink: -to s3://endpoint-host:port/bucket[/key-prefix]
        from ..remote.s3_client import RemoteS3Client
        from .s3_sink import S3Sink

        rest = a.target[len("s3://") :]
        host, _, bucket_path = rest.partition("/")
        bucket, _, key_prefix = bucket_path.partition("/")
        if not bucket:
            p.error("s3 target needs s3://host:port/bucket[/prefix]")
        client = RemoteS3Client(
            endpoint=f"http://{host}",
            access_key=a.s3_access,
            secret_key=a.s3_secret,
        )
        sync = S3Sink(
            a.source, client, bucket,
            key_prefix=key_prefix, path_prefix=a.path, state_file=a.state,
        )
    else:
        sync = FilerSync(a.source, a.target, a.path, a.state)
    signal.signal(signal.SIGTERM, lambda *x: sync.stop())
    signal.signal(signal.SIGINT, lambda *x: sync.stop())
    print(f"syncing {a.source}{a.path} -> {a.target}", flush=True)
    sync.run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
