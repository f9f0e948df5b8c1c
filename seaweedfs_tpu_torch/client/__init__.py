"""Clients of the port: the master client (master_client.py), which the
volume server's cluster half and the shell use for their lookups, the
volume tail and incremental-sync helpers (volume_sync.py) of
VolumeTailReceiver, the blob operations (operations.py: upload,
read, delete) of the shell's `upload` and `download`, and the filer's
listing helpers (filer_client.py) of its fs.* commands."""
