"""Servers of the port: the volume server's data plane (volume_server.py),
its gRPC service and cluster half (volume_grpc.py), the master (master.py
over topology.py, raft.py and cluster_lock.py), the filer's HTTP server
(filer_server.py), and the launcher (`python -m seaweedfs_tpu_torch.server
master|volume|filer|server`, __main__.py).

volume_server.py imports neither grpc nor protobuf: the HTTP handlers and
the net plane's resolvers call plain methods of the server, and the gRPC
edge stays in volume_grpc.py, master.py, raft.py, client/ and pb/.
"""
