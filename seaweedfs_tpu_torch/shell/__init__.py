"""The operator's shell of the port (`python -m seaweedfs_tpu_torch.shell`):
the command registry and its commands (commands.py), over the port's
master client, volume servers' gRPC service and client/operations."""
