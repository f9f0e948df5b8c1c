"""Offline volume tools (weed fix/export/compact equivalents): the port's
copy of seaweedfs_tpu/tools."""
