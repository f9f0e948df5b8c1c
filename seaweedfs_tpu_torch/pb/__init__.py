"""The port's protobuf messages (cluster_pb2, a verbatim copy of the JAX
package's) and its gRPC service tables (rpc). Only the gRPC modules of the
port import this package: server/volume_grpc.py and client/."""
