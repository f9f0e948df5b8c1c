"""Clients of the port: the master client (master_client.py), which the
volume server's cluster half uses for its lookups, and the volume tail
and incremental-sync helpers (volume_sync.py) of VolumeTailReceiver."""
