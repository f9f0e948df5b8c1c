"""Servers of the port: the volume server's data plane (volume_server.py).

Nothing here imports grpc or protobuf: the HTTP handlers and the net
plane's resolvers call plain methods of the server.
"""
