"""Hand-rolled gRPC service wiring: a method table per service, from which
both server handlers and client stubs are built.

Port of seaweedfs_tpu/pb/rpc.py, trimmed to the services the port serves
or calls: every RPC of the master, of the volume server, of raft, of the
worker fleet's control plane and of the filer. The MQ services are not
here yet. Server impls
are plain classes with one method per RPC (same names); streaming RPCs
take and return iterators, as generated servicers do. `add_service`
registers exactly the rows of a table.
"""

from __future__ import annotations

import grpc

from . import cluster_pb2 as pb
from . import filer_pb2 as fpb
from . import worker_pb2 as wk

UNARY = "unary_unary"
SERVER_STREAM = "unary_stream"
BIDI = "stream_stream"

MASTER_SERVICE = "sw.Seaweed"
VOLUME_SERVICE = "sw.VolumeServer"
FILER_SERVICE = "swfiler.SeaweedFiler"
WORKER_SERVICE = "swworker.WorkerControl"
RAFT_SERVICE = "sw.Raft"

SERVICES: dict[str, dict[str, tuple[str, type, type]]] = {
    # the RPCs server/master.py serves: every row of the JAX table
    MASTER_SERVICE: {
        "SendHeartbeat": (BIDI, pb.Heartbeat, pb.HeartbeatResponse),
        "Assign": (UNARY, pb.AssignRequest, pb.AssignResponse),
        "LookupVolume": (UNARY, pb.LookupVolumeRequest, pb.LookupVolumeResponse),
        "LookupEcVolume": (UNARY, pb.LookupEcVolumeRequest, pb.LookupEcVolumeResponse),
        "Statistics": (UNARY, pb.StatisticsRequest, pb.StatisticsResponse),
        "Topology": (UNARY, pb.TopologyRequest, pb.TopologyResponse),
        "VolumeGrow": (UNARY, pb.VolumeGrowRequest, pb.VolumeGrowResponse),
        "CollectionList": (UNARY, pb.CollectionListRequest, pb.CollectionListResponse),
        "CollectionDelete": (UNARY, pb.CollectionDeleteRequest, pb.CollectionDeleteResponse),
        "KeepConnected": (SERVER_STREAM, pb.KeepConnectedRequest, pb.VolumeLocationUpdate),
        "AdminLock": (UNARY, pb.LockRequest, pb.LockResponse),
        "AdminUnlock": (UNARY, pb.UnlockRequest, pb.UnlockResponse),
        "AdminLockStatus": (UNARY, pb.LockStatusRequest, pb.LockStatusResponse),
        "VacuumControl": (UNARY, pb.VacuumControlRequest, pb.VolumeCommandResponse),
    },
    # the RPCs server/volume_grpc.py serves: every row of the JAX table
    VOLUME_SERVICE: {
        "AllocateVolume": (UNARY, pb.AllocateVolumeRequest, pb.AllocateVolumeResponse),
        "VolumeDelete": (UNARY, pb.VolumeCommandRequest, pb.VolumeCommandResponse),
        "VolumeMount": (UNARY, pb.AllocateVolumeRequest, pb.VolumeCommandResponse),
        "VolumeCopy": (UNARY, pb.EcShardsCopyRequest, pb.VolumeCommandResponse),
        "VolumeMarkReadonly": (UNARY, pb.VolumeCommandRequest, pb.VolumeCommandResponse),
        "VolumeMarkWritable": (UNARY, pb.VolumeCommandRequest, pb.VolumeCommandResponse),
        "VacuumVolume": (UNARY, pb.VacuumRequest, pb.VacuumResponse),
        "WriteNeedle": (UNARY, pb.WriteNeedleRequest, pb.WriteNeedleResponse),
        "ReadNeedle": (UNARY, pb.ReadNeedleRequest, pb.ReadNeedleResponse),
        "DeleteNeedle": (UNARY, pb.DeleteNeedleRequest, pb.DeleteNeedleResponse),
        "VolumeEcShardsGenerate": (UNARY, pb.EcShardsGenerateRequest, pb.EcShardsGenerateResponse),
        "VolumeEcShardsRebuild": (UNARY, pb.EcShardsRebuildRequest, pb.EcShardsRebuildResponse),
        "VolumeEcShardsCopy": (UNARY, pb.EcShardsCopyRequest, pb.EcShardsCopyResponse),
        "VolumeEcShardsDelete": (UNARY, pb.EcShardsDeleteRequest, pb.EcShardsDeleteResponse),
        "VolumeEcShardsMount": (UNARY, pb.EcShardsMountRequest, pb.EcShardsMountResponse),
        "VolumeEcShardsUnmount": (UNARY, pb.EcShardsUnmountRequest, pb.EcShardsUnmountResponse),
        "VolumeEcShardRead": (SERVER_STREAM, pb.EcShardReadRequest, pb.EcShardReadChunk),
        "VolumeEcBlobDelete": (UNARY, pb.EcBlobDeleteRequest, pb.EcBlobDeleteResponse),
        "VolumeEcShardsToVolume": (UNARY, pb.EcShardsToVolumeRequest, pb.EcShardsToVolumeResponse),
        "CopyFile": (SERVER_STREAM, pb.CopyFileRequest, pb.CopyFileChunk),
        "VolumeServerStatus": (UNARY, pb.VolumeServerStatusRequest, pb.VolumeServerStatusResponse),
        "ScrubVolume": (UNARY, pb.ScrubRequest, pb.ScrubResponse),
        "ScrubEcVolume": (UNARY, pb.ScrubRequest, pb.ScrubResponse),
        "VolumeTierUpload": (UNARY, pb.TierRequest, pb.TierResponse),
        "VolumeTierDownload": (UNARY, pb.TierRequest, pb.TierResponse),
        "VolumeUnmount": (UNARY, pb.VolumeCommandRequest, pb.VolumeCommandResponse),
        "VolumeConfigure": (UNARY, pb.VolumeConfigureRequest, pb.VolumeCommandResponse),
        "VolumeTailSender": (SERVER_STREAM, pb.VolumeTailRequest, pb.VolumeTailChunk),
        "VolumeTailReceiver": (UNARY, pb.VolumeTailReceiverRequest, pb.VolumeTailReceiverResponse),
        "VolumeIncrementalCopy": (SERVER_STREAM, pb.VolumeIncrementalCopyRequest, pb.VolumeIncrementalCopyChunk),
        "ReadVolumeFileStatus": (UNARY, pb.VolumeFileStatusRequest, pb.VolumeFileStatusResponse),
    },
    # the RPCs filer/grpc_service.py serves: every row of the JAX table
    FILER_SERVICE: {
        "LookupDirectoryEntry": (UNARY, fpb.LookupEntryRequest, fpb.LookupEntryResponse),
        "ListEntries": (SERVER_STREAM, fpb.ListEntriesRequest, fpb.ListEntriesResponse),
        "CreateEntry": (UNARY, fpb.CreateEntryRequest, fpb.FilerOpResponse),
        "UpdateEntry": (UNARY, fpb.UpdateEntryRequest, fpb.FilerOpResponse),
        "DeleteEntry": (UNARY, fpb.DeleteEntryRequest, fpb.FilerOpResponse),
        "AtomicRenameEntry": (UNARY, fpb.AtomicRenameEntryRequest, fpb.FilerOpResponse),
        "SubscribeMetadata": (SERVER_STREAM, fpb.SubscribeMetadataRequest, fpb.FullEventNotification),
        "AssignVolume": (UNARY, fpb.AssignVolumeRequest, fpb.AssignVolumeResponse),
        "KvGet": (UNARY, fpb.FilerKvGetRequest, fpb.FilerKvGetResponse),
        "KvPut": (UNARY, fpb.FilerKvPutRequest, fpb.FilerOpResponse),
        "LockRange": (UNARY, fpb.LockRangeRequest, fpb.LockRangeResponse),
        "HardLink": (UNARY, fpb.HardLinkRequest, fpb.FilerOpResponse),
        "DistributedLock": (UNARY, fpb.DlmRequest, fpb.DlmResponse),
        "RunLifecycle": (UNARY, fpb.LifecycleRunRequest, fpb.LifecycleRunResponse),
        # volume location passthrough: mounts resolve chunk fids to
        # volume-server URLs through the filer
        "LookupVolume": (UNARY, pb.LookupVolumeRequest, pb.LookupVolumeResponse),
    },
    # worker/control.py's WorkerControl, hosted by the master
    WORKER_SERVICE: {
        "WorkerStream": (BIDI, wk.WorkerMessage, wk.ServerMessage),
        "ListTasks": (UNARY, wk.ListTasksRequest, wk.ListTasksResponse),
        "SubmitTask": (UNARY, wk.SubmitTaskRequest, wk.SubmitTaskResponse),
        "ListWorkers": (UNARY, wk.ListWorkersRequest, wk.ListWorkersResponse),
        "GetMaintenanceConfig": (UNARY, wk.GetMaintenanceConfigRequest, wk.MaintenanceConfig),
        "SetMaintenanceConfig": (UNARY, wk.MaintenanceConfig, wk.SetMaintenanceConfigResponse),
    },
    # server/raft.py's peer RPCs, and the master client's leader resolution
    RAFT_SERVICE: {
        "RaftRequestVote": (UNARY, pb.RaftVoteRequest, pb.RaftVoteResponse),
        "RaftAppendEntries": (UNARY, pb.RaftAppendRequest, pb.RaftAppendResponse),
        "RaftStatus": (UNARY, pb.RaftStatusRequest, pb.RaftStatusResponse),
        "RaftInstallSnapshot": (UNARY, pb.RaftInstallSnapshotRequest, pb.RaftInstallSnapshotResponse),
        "RaftChangeMembership": (UNARY, pb.RaftChangeRequest, pb.RaftChangeResponse),
    },
}


def add_service(server: grpc.Server, service_name: str, impl: object) -> None:
    methods = {}
    for name, (kind, req_t, resp_t) in SERVICES[service_name].items():
        handler_factory = getattr(grpc, f"{kind}_rpc_method_handler")
        methods[name] = handler_factory(
            getattr(impl, name),
            request_deserializer=req_t.FromString,
            response_serializer=resp_t.SerializeToString,
        )
    server.add_generic_rpc_handlers((grpc.method_handlers_generic_handler(service_name, methods),))


class Stub:
    """Client stub: one callable attribute per RPC."""

    def __init__(self, channel: grpc.Channel, service_name: str):
        for name, (kind, req_t, resp_t) in SERVICES[service_name].items():
            factory = getattr(channel, kind)
            setattr(
                self,
                name,
                factory(
                    f"/{service_name}/{name}",
                    request_serializer=req_t.SerializeToString,
                    response_deserializer=resp_t.FromString,
                ),
            )


def master_stub(channel: grpc.Channel) -> Stub:
    return Stub(channel, MASTER_SERVICE)


def volume_stub(channel: grpc.Channel) -> Stub:
    return Stub(channel, VOLUME_SERVICE)


def worker_stub(channel: grpc.Channel) -> Stub:
    return Stub(channel, WORKER_SERVICE)


def filer_stub(channel: grpc.Channel) -> Stub:
    return Stub(channel, FILER_SERVICE)
