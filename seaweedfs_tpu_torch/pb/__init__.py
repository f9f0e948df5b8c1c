"""The port's protobuf messages (cluster_pb2, filer_pb2 and worker_pb2,
verbatim copies of the JAX package's: protobuf's default pool holds one
cluster.proto, one filer.proto and one worker.proto per process, and a
process may import both packages) and its gRPC service tables (rpc). Only
the gRPC modules of the port import this package: server/, client/,
shell/, worker/ and filer/."""
