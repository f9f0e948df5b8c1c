# The cluster.proto messages of the port: a verbatim copy of
# seaweedfs_tpu/pb/cluster_pb2.py, serialized descriptor and all.
#
# Keep it verbatim. protobuf's default descriptor pool holds one file named
# cluster.proto per process. Adding the same serialized bytes twice is a
# no-op that hands back the same descriptors and message classes, so a
# process may import this module beside the JAX package's (the tests do,
# and a port server then exchanges messages with a JAX master). A copy
# trimmed or edited in any byte is a different file under the same name,
# and the second import in such a process fails.
# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: cluster.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\rcluster.proto\x12\x02sw"\xde\x01\n\rVolumeInfoMsg\x12\n\n\x02id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x0c\n\x04size\x18\x03 \x01(\x04\x12\x12\n\nfile_count\x18\x04 \x01(\x04\x12\x15\n\rdeleted_count\x18\x05 \x01(\x04\x12\x15\n\rdeleted_bytes\x18\x06 \x01(\x04\x12\x11\n\tread_only\x18\x07 \x01(\x08\x12\x19\n\x11replica_placement\x18\x08 \x01(\t\x12\x0f\n\x07version\x18\t \x01(\r\x12\x0b\n\x03ttl\x18\n \x01(\t\x12\x11\n\tdisk_type\x18\x0b \x01(\t"\x98\x01\n\x0eEcShardInfoMsg\x12\n\n\x02id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x12\n\nshard_bits\x18\x03 \x01(\r\x12\x12\n\nshard_size\x18\x04 \x01(\x04\x12\x13\n\x0bdata_shards\x18\x05 \x01(\r\x12\x15\n\rparity_shards\x18\x06 \x01(\r\x12\x12\n\ngeneration\x18\x07 \x01(\x04"\xbc\x03\n\tHeartbeat\x12\n\n\x02ip\x18\x01 \x01(\t\x12\x0c\n\x04port\x18\x02 \x01(\r\x12\x12\n\npublic_url\x18\x03 \x01(\t\x12\x11\n\tgrpc_port\x18\x04 \x01(\r\x12\x18\n\x10max_volume_count\x18\x05 \x01(\x04\x12"\n\x07volumes\x18\x06 \x03(\x0b2\x11.sw.VolumeInfoMsg\x12%\n\tec_shards\x18\x07 \x03(\x0b2\x12.sw.EcShardInfoMsg\x12&\n\x0bnew_volumes\x18\x08 \x03(\x0b2\x11.sw.VolumeInfoMsg\x12\x17\n\x0fdeleted_volumes\x18\t \x03(\r\x12)\n\rnew_ec_shards\x18\n \x03(\x0b2\x12.sw.EcShardInfoMsg\x12-\n\x11deleted_ec_shards\x18\x0b \x03(\x0b2\x12.sw.EcShardInfoMsg\x12\x13\n\x0bdata_center\x18\x0c \x01(\t\x12\x0c\n\x04rack\x18\r \x01(\t\x12\x16\n\x0ehas_no_volumes\x18\x0e \x01(\x08\x12\x18\n\x10has_no_ec_shards\x18\x0f \x01(\x08\x12\x19\n\x11ec_telemetry_json\x18\x10 \x01(\t">\n\x11HeartbeatResponse\x12\x19\n\x11volume_size_limit\x18\x01 \x01(\x04\x12\x0e\n\x06leader\x18\x02 \x01(\t"\x8a\x01\n\rAssignRequest\x12\r\n\x05count\x18\x01 \x01(\x04\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x13\n\x0breplication\x18\x03 \x01(\t\x12\x0b\n\x03ttl\x18\x04 \x01(\t\x12\x13\n\x0bdata_center\x18\x05 \x01(\t\x12\x0c\n\x04rack\x18\x06 \x01(\t\x12\x11\n\tdisk_type\x18\x07 \x01(\t"S\n\x08Location\x12\x0b\n\x03url\x18\x01 \x01(\t\x12\x12\n\npublic_url\x18\x02 \x01(\t\x12\x11\n\tgrpc_port\x18\x03 \x01(\r\x12\x13\n\x0bdata_center\x18\x04 \x01(\t"\x88\x01\n\x0eAssignResponse\x12\x0b\n\x03fid\x18\x01 \x01(\t\x12\r\n\x05count\x18\x02 \x01(\x04\x12\r\n\x05error\x18\x03 \x01(\t\x12\x1e\n\x08location\x18\x04 \x01(\x0b2\x0c.sw.Location\x12\x1e\n\x08replicas\x18\x05 \x03(\x0b2\x0c.sw.Location\x12\x0b\n\x03jwt\x18\x06 \x01(\t")\n\x13LookupVolumeRequest\x12\x12\n\nvolume_ids\x18\x01 \x03(\r"T\n\x0fVolumeLocations\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x1f\n\tlocations\x18\x02 \x03(\x0b2\x0c.sw.Location\x12\r\n\x05error\x18\x03 \x01(\t"E\n\x14LookupVolumeResponse\x12-\n\x10volume_locations\x18\x01 \x03(\x0b2\x13.sw.VolumeLocations"*\n\x15LookupEcVolumeRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r"D\n\x0fEcShardLocation\x12\x10\n\x08shard_id\x18\x01 \x01(\r\x12\x1f\n\tlocations\x18\x02 \x03(\x0b2\x0c.sw.Location"h\n\x16LookupEcVolumeResponse\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12,\n\x0fshard_locations\x18\x02 \x03(\x0b2\x13.sw.EcShardLocation\x12\r\n\x05error\x18\x03 \x01(\t"\x13\n\x11StatisticsRequest"\x92\x01\n\x12StatisticsResponse\x12\x12\n\ntotal_size\x18\x01 \x01(\x04\x12\x11\n\tused_size\x18\x02 \x01(\x04\x12\x12\n\nfile_count\x18\x03 \x01(\x04\x12\x14\n\x0cvolume_count\x18\x04 \x01(\r\x12\x17\n\x0fec_volume_count\x18\x05 \x01(\r\x12\x12\n\nnode_count\x18\x06 \x01(\r"\x11\n\x0fTopologyRequest"\xc2\x01\n\x0cDataNodeInfo\x12\n\n\x02id\x18\x01 \x01(\t\x12\x1e\n\x08location\x18\x02 \x01(\x0b2\x0c.sw.Location\x12"\n\x07volumes\x18\x03 \x03(\x0b2\x11.sw.VolumeInfoMsg\x12%\n\tec_shards\x18\x04 \x03(\x0b2\x12.sw.EcShardInfoMsg\x12\x18\n\x10max_volume_count\x18\x05 \x01(\x04\x12\x0c\n\x04rack\x18\x06 \x01(\t\x12\x13\n\x0bdata_center\x18\x07 \x01(\t"J\n\x10TopologyResponse\x12\x1f\n\x05nodes\x18\x01 \x03(\x0b2\x10.sw.DataNodeInfo\x12\x15\n\rmax_volume_id\x18\x02 \x01(\r"k\n\x11VolumeGrowRequest\x12\r\n\x05count\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x13\n\x0breplication\x18\x03 \x01(\t\x12\x0b\n\x03ttl\x18\x04 \x01(\t\x12\x11\n\tdisk_type\x18\x05 \x01(\t"(\n\x12VolumeGrowResponse\x12\x12\n\nvolume_ids\x18\x01 \x03(\r"\x17\n\x15CollectionListRequest"-\n\x16CollectionListResponse\x12\x13\n\x0bcollections\x18\x01 \x03(\t"\'\n\x17CollectionDeleteRequest\x12\x0c\n\x04name\x18\x01 \x01(\t"E\n\x18CollectionDeleteResponse\x12\x1a\n\x12deleted_volume_ids\x18\x01 \x03(\r\x12\r\n\x05error\x18\x02 \x01(\t"\x84\x01\n\x15AllocateVolumeRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x13\n\x0breplication\x18\x03 \x01(\t\x12\x0b\n\x03ttl\x18\x04 \x01(\t\x12\x0f\n\x07version\x18\x05 \x01(\r\x12\x11\n\tdisk_type\x18\x06 \x01(\t"\x18\n\x16AllocateVolumeResponse")\n\x14VolumeCommandRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r"&\n\x15VolumeCommandResponse\x12\r\n\x05error\x18\x01 \x01(\t"=\n\rVacuumRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x19\n\x11garbage_threshold\x18\x02 \x01(\x02"@\n\x0eVacuumResponse\x12\x17\n\x0freclaimed_bytes\x18\x01 \x01(\x04\x12\x15\n\rgarbage_ratio\x18\x02 \x01(\x02"\x99\x01\n\x12WriteNeedleRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x11\n\tneedle_id\x18\x02 \x01(\x04\x12\x0e\n\x06cookie\x18\x03 \x01(\r\x12\x0c\n\x04data\x18\x04 \x01(\x0c\x12\x0c\n\x04name\x18\x05 \x01(\t\x12\x0c\n\x04mime\x18\x06 \x01(\t\x12\x14\n\x0cis_replicate\x18\x07 \x01(\x08\x12\r\n\x05flags\x18\x08 \x01(\r"2\n\x13WriteNeedleResponse\x12\x0c\n\x04size\x18\x01 \x01(\r\x12\r\n\x05error\x18\x02 \x01(\t"I\n\x11ReadNeedleRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x11\n\tneedle_id\x18\x02 \x01(\x04\x12\x0e\n\x06cookie\x18\x03 \x01(\r"d\n\x12ReadNeedleResponse\x12\x0c\n\x04data\x18\x01 \x01(\x0c\x12\x0c\n\x04name\x18\x02 \x01(\t\x12\x0c\n\x04mime\x18\x03 \x01(\t\x12\x15\n\rlast_modified\x18\x04 \x01(\x04\x12\r\n\x05error\x18\x05 \x01(\t"Q\n\x13DeleteNeedleRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x11\n\tneedle_id\x18\x02 \x01(\x04\x12\x14\n\x0cis_replicate\x18\x03 \x01(\x08":\n\x14DeleteNeedleResponse\x12\x13\n\x0bfreed_bytes\x18\x01 \x01(\x04\x12\r\n\x05error\x18\x02 \x01(\t"\x8f\x01\n\x17EcShardsGenerateRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x13\n\x0bdata_shards\x18\x03 \x01(\r\x12\x15\n\rparity_shards\x18\x04 \x01(\r\x12\x0f\n\x07backend\x18\x05 \x01(\t\x12\x10\n\x08batch_mb\x18\x06 \x01(\r".\n\x18EcShardsGenerateResponse\x12\x12\n\ngeneration\x18\x01 \x01(\x04"d\n\x16EcShardsRebuildRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x0f\n\x07backend\x18\x03 \x01(\t\x12\x12\n\nfrom_peers\x18\x04 \x01(\x08"\x8a\x01\n\x17EcShardsRebuildResponse\x12\x19\n\x11rebuilt_shard_ids\x18\x01 \x03(\r\x12\x19\n\x11fetched_shard_ids\x18\x02 \x03(\r\x12\x1d\n\x15distributed_shard_ids\x18\x03 \x03(\r\x12\x1a\n\x12repaired_shard_ids\x18\x04 \x03(\r"\xad\x01\n\x13EcShardsCopyRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x11\n\tshard_ids\x18\x03 \x03(\r\x12\x12\n\nsource_url\x18\x04 \x01(\t\x12\x10\n\x08copy_ecx\x18\x05 \x01(\x08\x12\x10\n\x08copy_ecj\x18\x06 \x01(\x08\x12\x10\n\x08copy_vif\x18\x07 \x01(\x08\x12\x12\n\ncopy_ecsum\x18\x08 \x01(\x08"\x16\n\x14EcShardsCopyResponse"Q\n\x15EcShardsDeleteRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x11\n\tshard_ids\x18\x03 \x03(\r"\x18\n\x16EcShardsDeleteResponse"P\n\x14EcShardsMountRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x11\n\tshard_ids\x18\x03 \x03(\r"\x17\n\x15EcShardsMountResponse">\n\x16EcShardsUnmountRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x11\n\tshard_ids\x18\x02 \x03(\r"\x19\n\x17EcShardsUnmountResponse"k\n\x12EcShardReadRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x10\n\x08shard_id\x18\x02 \x01(\r\x12\x0e\n\x06offset\x18\x03 \x01(\x04\x12\x0c\n\x04size\x18\x04 \x01(\x04\x12\x12\n\ngeneration\x18\x05 \x01(\x04"4\n\x10EcShardReadChunk\x12\x0c\n\x04data\x18\x01 \x01(\x0c\x12\x12\n\nis_deleted\x18\x02 \x01(\x08"O\n\x13EcBlobDeleteRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x11\n\tneedle_id\x18\x03 \x01(\x04"\x16\n\x14EcBlobDeleteResponse"@\n\x17EcShardsToVolumeRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t"\x1a\n\x18EcShardsToVolumeResponse"p\n\x0fCopyFileRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x0b\n\x03ext\x18\x03 \x01(\t\x12\x13\n\x0bstop_offset\x18\x04 \x01(\x04\x12\x14\n\x0cstart_offset\x18\x05 \x01(\x04"\x1d\n\rCopyFileChunk\x12\x0c\n\x04data\x18\x01 \x01(\x0c"\x1b\n\x19VolumeServerStatusRequest"v\n\x1aVolumeServerStatusResponse\x12"\n\x07volumes\x18\x01 \x03(\x0b2\x11.sw.VolumeInfoMsg\x12%\n\tec_shards\x18\x02 \x03(\x0b2\x12.sw.EcShardInfoMsg\x12\r\n\x05error\x18\x03 \x01(\t"5\n\x0cScrubRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t"\xae\x01\n\rScrubResponse\x12\x0f\n\x07checked\x18\x01 \x01(\x04\x12\x13\n\x0bbad_needles\x18\x02 \x03(\x04\x12\x12\n\nbad_shards\x18\x03 \x03(\r\x12\r\n\x05error\x18\x04 \x01(\t\x12\x16\n\x0echecked_shards\x18\x05 \x03(\r\x12\x1a\n\x12quarantined_shards\x18\x06 \x03(\r\x12 \n\x18repair_journal_recovered\x18\x07 \x01(\x04"S\n\tRaftEntry\x12\x0c\n\x04term\x18\x01 \x01(\x04\x12\r\n\x05index\x18\x02 \x01(\x04\x12\x0c\n\x04kind\x18\x03 \x01(\t\x12\r\n\x05value\x18\x04 \x01(\x04\x12\x0c\n\x04data\x18\x05 \x01(\t"d\n\x0fRaftVoteRequest\x12\x0c\n\x04term\x18\x01 \x01(\x04\x12\x14\n\x0ccandidate_id\x18\x02 \x01(\t\x12\x16\n\x0elast_log_index\x18\x03 \x01(\x04\x12\x15\n\rlast_log_term\x18\x04 \x01(\x04"1\n\x10RaftVoteResponse\x12\x0c\n\x04term\x18\x01 \x01(\x04\x12\x0f\n\x07granted\x18\x02 \x01(\x08"\x9a\x01\n\x11RaftAppendRequest\x12\x0c\n\x04term\x18\x01 \x01(\x04\x12\x11\n\tleader_id\x18\x02 \x01(\t\x12\x16\n\x0eprev_log_index\x18\x03 \x01(\x04\x12\x15\n\rprev_log_term\x18\x04 \x01(\x04\x12\x1e\n\x07entries\x18\x05 \x03(\x0b2\r.sw.RaftEntry\x12\x15\n\rleader_commit\x18\x06 \x01(\x04"`\n\x12RaftAppendResponse\x12\x0c\n\x04term\x18\x01 \x01(\x04\x12\x0f\n\x07success\x18\x02 \x01(\x08\x12\x13\n\x0bmatch_index\x18\x03 \x01(\x04\x12\x16\n\x0econflict_index\x18\x04 \x01(\x04"\x96\x01\n\x1aRaftInstallSnapshotRequest\x12\x0c\n\x04term\x18\x01 \x01(\x04\x12\x11\n\tleader_id\x18\x02 \x01(\t\x12\x1b\n\x13last_included_index\x18\x03 \x01(\x04\x12\x1a\n\x12last_included_term\x18\x04 \x01(\x04\x12\r\n\x05state\x18\x05 \x01(\x0c\x12\x0f\n\x07members\x18\x06 \x03(\t"<\n\x1bRaftInstallSnapshotResponse\x12\x0c\n\x04term\x18\x01 \x01(\x04\x12\x0f\n\x07success\x18\x02 \x01(\x08"/\n\x11RaftChangeRequest\x12\n\n\x02op\x18\x01 \x01(\t\x12\x0e\n\x06server\x18\x02 \x01(\t"D\n\x12RaftChangeResponse\x12\r\n\x05error\x18\x01 \x01(\t\x12\x0f\n\x07members\x18\x02 \x03(\t\x12\x0e\n\x06leader\x18\x03 \x01(\t"\x13\n\x11RaftStatusRequest"\xa4\x01\n\x12RaftStatusResponse\x12\x0f\n\x07node_id\x18\x01 \x01(\t\x12\x0e\n\x06leader\x18\x02 \x01(\t\x12\x0c\n\x04term\x18\x03 \x01(\x04\x12\x0c\n\x04role\x18\x04 \x01(\t\x12\r\n\x05peers\x18\x05 \x03(\t\x12\x14\n\x0ccommit_index\x18\x06 \x01(\x04\x12\x15\n\rapplied_index\x18\x07 \x01(\x04\x12\x15\n\rmax_volume_id\x18\x08 \x01(\x04")\n\x14KeepConnectedRequest\x12\x11\n\tclient_id\x18\x01 \x01(\t"\xc5\x01\n\x14VolumeLocationUpdate\x12\x0b\n\x03url\x18\x01 \x01(\t\x12\x12\n\npublic_url\x18\x02 \x01(\t\x12\x11\n\tgrpc_port\x18\x03 \x01(\r\x12\x10\n\x08new_vids\x18\x04 \x03(\r\x12\x14\n\x0cdeleted_vids\x18\x05 \x03(\r\x12\x13\n\x0bnew_ec_vids\x18\x06 \x03(\r\x12\x17\n\x0fdeleted_ec_vids\x18\x07 \x03(\r\x12\x0e\n\x06leader\x18\x08 \x01(\t\x12\x13\n\x0bserver_gone\x18\t \x01(\x08"N\n\x0bLockRequest\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\r\n\x05owner\x18\x02 \x01(\t\x12\x13\n\x0bttl_seconds\x18\x03 \x01(\x01\x12\r\n\x05token\x18\x04 \x01(\t"\\\n\x0cLockResponse\x12\n\n\x02ok\x18\x01 \x01(\x08\x12\r\n\x05token\x18\x02 \x01(\t\x12\x0e\n\x06holder\x18\x03 \x01(\t\x12\x12\n\nexpires_ns\x18\x04 \x01(\x04\x12\r\n\x05error\x18\x05 \x01(\t",\n\rUnlockRequest\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\r\n\x05token\x18\x02 \x01(\t"+\n\x0eUnlockResponse\x12\n\n\x02ok\x18\x01 \x01(\x08\x12\r\n\x05error\x18\x02 \x01(\t":\n\x07LockRow\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\r\n\x05owner\x18\x02 \x01(\t\x12\x12\n\nexpires_ns\x18\x03 \x01(\x04"\x13\n\x11LockStatusRequest"0\n\x12LockStatusResponse\x12\x1a\n\x05locks\x18\x01 \x03(\x0b2\x0b.sw.LockRow"q\n\x0bTierRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x10\n\x08dest_url\x18\x03 \x01(\t\x12\x12\n\nkeep_local\x18\x04 \x01(\x08\x12\x15\n\rdelete_remote\x18\x05 \x01(\x08"2\n\x0cTierResponse\x12\r\n\x05error\x18\x01 \x01(\t\x12\x13\n\x0bmoved_bytes\x18\x02 \x01(\x04"V\n\x11VolumeTailRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x10\n\x08since_ns\x18\x02 \x01(\x04\x12\x1c\n\x14idle_timeout_seconds\x18\x03 \x01(\r"e\n\x0fVolumeTailChunk\x12\x15\n\rneedle_header\x18\x01 \x01(\x0c\x12\x13\n\x0bneedle_body\x18\x02 \x01(\x0c\x12\x15\n\ris_last_chunk\x18\x03 \x01(\x08\x12\x0f\n\x07version\x18\x04 \x01(\r"|\n\x19VolumeTailReceiverRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x10\n\x08since_ns\x18\x02 \x01(\x04\x12\x1c\n\x14idle_timeout_seconds\x18\x03 \x01(\r\x12\x1c\n\x14source_volume_server\x18\x04 \x01(\t"=\n\x1aVolumeTailReceiverResponse\x12\x10\n\x08received\x18\x01 \x01(\x04\x12\r\n\x05error\x18\x02 \x01(\t"C\n\x1cVolumeIncrementalCopyRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x10\n\x08since_ns\x18\x02 \x01(\x04"[\n\x1aVolumeIncrementalCopyChunk\x12\x14\n\x0cfile_content\x18\x01 \x01(\x0c\x12\x14\n\x0cstart_offset\x18\x02 \x01(\x04\x12\x11\n\thas_start\x18\x03 \x01(\x08",\n\x17VolumeFileStatusRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r"\xaa\x01\n\x18VolumeFileStatusResponse\x12\x10\n\x08dat_size\x18\x01 \x01(\x04\x12\x10\n\x08idx_size\x18\x02 \x01(\x04\x12\x1b\n\x13compaction_revision\x18\x03 \x01(\x04\x12\x0f\n\x07version\x18\x04 \x01(\r\x12\x19\n\x11last_append_at_ns\x18\x05 \x01(\x04\x12\x12\n\ncollection\x18\x06 \x01(\t\x12\r\n\x05error\x18\x07 \x01(\t"@\n\x16VolumeConfigureRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x13\n\x0breplication\x18\x02 \x01(\t":\n\x14VacuumControlRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x0f\n\x07disable\x18\x02 \x01(\x08b\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'cluster_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _VOLUMEINFOMSG._serialized_start=22
  _VOLUMEINFOMSG._serialized_end=244
  _ECSHARDINFOMSG._serialized_start=247
  _ECSHARDINFOMSG._serialized_end=399
  _HEARTBEAT._serialized_start=402
  _HEARTBEAT._serialized_end=846
  _HEARTBEATRESPONSE._serialized_start=848
  _HEARTBEATRESPONSE._serialized_end=910
  _ASSIGNREQUEST._serialized_start=913
  _ASSIGNREQUEST._serialized_end=1051
  _LOCATION._serialized_start=1053
  _LOCATION._serialized_end=1136
  _ASSIGNRESPONSE._serialized_start=1139
  _ASSIGNRESPONSE._serialized_end=1275
  _LOOKUPVOLUMEREQUEST._serialized_start=1277
  _LOOKUPVOLUMEREQUEST._serialized_end=1318
  _VOLUMELOCATIONS._serialized_start=1320
  _VOLUMELOCATIONS._serialized_end=1404
  _LOOKUPVOLUMERESPONSE._serialized_start=1406
  _LOOKUPVOLUMERESPONSE._serialized_end=1475
  _LOOKUPECVOLUMEREQUEST._serialized_start=1477
  _LOOKUPECVOLUMEREQUEST._serialized_end=1519
  _ECSHARDLOCATION._serialized_start=1521
  _ECSHARDLOCATION._serialized_end=1589
  _LOOKUPECVOLUMERESPONSE._serialized_start=1591
  _LOOKUPECVOLUMERESPONSE._serialized_end=1695
  _STATISTICSREQUEST._serialized_start=1697
  _STATISTICSREQUEST._serialized_end=1716
  _STATISTICSRESPONSE._serialized_start=1719
  _STATISTICSRESPONSE._serialized_end=1865
  _TOPOLOGYREQUEST._serialized_start=1867
  _TOPOLOGYREQUEST._serialized_end=1884
  _DATANODEINFO._serialized_start=1887
  _DATANODEINFO._serialized_end=2081
  _TOPOLOGYRESPONSE._serialized_start=2083
  _TOPOLOGYRESPONSE._serialized_end=2157
  _VOLUMEGROWREQUEST._serialized_start=2159
  _VOLUMEGROWREQUEST._serialized_end=2266
  _VOLUMEGROWRESPONSE._serialized_start=2268
  _VOLUMEGROWRESPONSE._serialized_end=2308
  _COLLECTIONLISTREQUEST._serialized_start=2310
  _COLLECTIONLISTREQUEST._serialized_end=2333
  _COLLECTIONLISTRESPONSE._serialized_start=2335
  _COLLECTIONLISTRESPONSE._serialized_end=2380
  _COLLECTIONDELETEREQUEST._serialized_start=2382
  _COLLECTIONDELETEREQUEST._serialized_end=2421
  _COLLECTIONDELETERESPONSE._serialized_start=2423
  _COLLECTIONDELETERESPONSE._serialized_end=2492
  _ALLOCATEVOLUMEREQUEST._serialized_start=2495
  _ALLOCATEVOLUMEREQUEST._serialized_end=2627
  _ALLOCATEVOLUMERESPONSE._serialized_start=2629
  _ALLOCATEVOLUMERESPONSE._serialized_end=2653
  _VOLUMECOMMANDREQUEST._serialized_start=2655
  _VOLUMECOMMANDREQUEST._serialized_end=2696
  _VOLUMECOMMANDRESPONSE._serialized_start=2698
  _VOLUMECOMMANDRESPONSE._serialized_end=2736
  _VACUUMREQUEST._serialized_start=2738
  _VACUUMREQUEST._serialized_end=2799
  _VACUUMRESPONSE._serialized_start=2801
  _VACUUMRESPONSE._serialized_end=2865
  _WRITENEEDLEREQUEST._serialized_start=2868
  _WRITENEEDLEREQUEST._serialized_end=3021
  _WRITENEEDLERESPONSE._serialized_start=3023
  _WRITENEEDLERESPONSE._serialized_end=3073
  _READNEEDLEREQUEST._serialized_start=3075
  _READNEEDLEREQUEST._serialized_end=3148
  _READNEEDLERESPONSE._serialized_start=3150
  _READNEEDLERESPONSE._serialized_end=3250
  _DELETENEEDLEREQUEST._serialized_start=3252
  _DELETENEEDLEREQUEST._serialized_end=3333
  _DELETENEEDLERESPONSE._serialized_start=3335
  _DELETENEEDLERESPONSE._serialized_end=3393
  _ECSHARDSGENERATEREQUEST._serialized_start=3396
  _ECSHARDSGENERATEREQUEST._serialized_end=3539
  _ECSHARDSGENERATERESPONSE._serialized_start=3541
  _ECSHARDSGENERATERESPONSE._serialized_end=3587
  _ECSHARDSREBUILDREQUEST._serialized_start=3589
  _ECSHARDSREBUILDREQUEST._serialized_end=3689
  _ECSHARDSREBUILDRESPONSE._serialized_start=3692
  _ECSHARDSREBUILDRESPONSE._serialized_end=3830
  _ECSHARDSCOPYREQUEST._serialized_start=3833
  _ECSHARDSCOPYREQUEST._serialized_end=4006
  _ECSHARDSCOPYRESPONSE._serialized_start=4008
  _ECSHARDSCOPYRESPONSE._serialized_end=4030
  _ECSHARDSDELETEREQUEST._serialized_start=4032
  _ECSHARDSDELETEREQUEST._serialized_end=4113
  _ECSHARDSDELETERESPONSE._serialized_start=4115
  _ECSHARDSDELETERESPONSE._serialized_end=4139
  _ECSHARDSMOUNTREQUEST._serialized_start=4141
  _ECSHARDSMOUNTREQUEST._serialized_end=4221
  _ECSHARDSMOUNTRESPONSE._serialized_start=4223
  _ECSHARDSMOUNTRESPONSE._serialized_end=4246
  _ECSHARDSUNMOUNTREQUEST._serialized_start=4248
  _ECSHARDSUNMOUNTREQUEST._serialized_end=4310
  _ECSHARDSUNMOUNTRESPONSE._serialized_start=4312
  _ECSHARDSUNMOUNTRESPONSE._serialized_end=4337
  _ECSHARDREADREQUEST._serialized_start=4339
  _ECSHARDREADREQUEST._serialized_end=4446
  _ECSHARDREADCHUNK._serialized_start=4448
  _ECSHARDREADCHUNK._serialized_end=4500
  _ECBLOBDELETEREQUEST._serialized_start=4502
  _ECBLOBDELETEREQUEST._serialized_end=4581
  _ECBLOBDELETERESPONSE._serialized_start=4583
  _ECBLOBDELETERESPONSE._serialized_end=4605
  _ECSHARDSTOVOLUMEREQUEST._serialized_start=4607
  _ECSHARDSTOVOLUMEREQUEST._serialized_end=4671
  _ECSHARDSTOVOLUMERESPONSE._serialized_start=4673
  _ECSHARDSTOVOLUMERESPONSE._serialized_end=4699
  _COPYFILEREQUEST._serialized_start=4701
  _COPYFILEREQUEST._serialized_end=4813
  _COPYFILECHUNK._serialized_start=4815
  _COPYFILECHUNK._serialized_end=4844
  _VOLUMESERVERSTATUSREQUEST._serialized_start=4846
  _VOLUMESERVERSTATUSREQUEST._serialized_end=4873
  _VOLUMESERVERSTATUSRESPONSE._serialized_start=4875
  _VOLUMESERVERSTATUSRESPONSE._serialized_end=4993
  _SCRUBREQUEST._serialized_start=4995
  _SCRUBREQUEST._serialized_end=5048
  _SCRUBRESPONSE._serialized_start=5051
  _SCRUBRESPONSE._serialized_end=5225
  _RAFTENTRY._serialized_start=5227
  _RAFTENTRY._serialized_end=5310
  _RAFTVOTEREQUEST._serialized_start=5312
  _RAFTVOTEREQUEST._serialized_end=5412
  _RAFTVOTERESPONSE._serialized_start=5414
  _RAFTVOTERESPONSE._serialized_end=5463
  _RAFTAPPENDREQUEST._serialized_start=5466
  _RAFTAPPENDREQUEST._serialized_end=5620
  _RAFTAPPENDRESPONSE._serialized_start=5622
  _RAFTAPPENDRESPONSE._serialized_end=5718
  _RAFTINSTALLSNAPSHOTREQUEST._serialized_start=5721
  _RAFTINSTALLSNAPSHOTREQUEST._serialized_end=5871
  _RAFTINSTALLSNAPSHOTRESPONSE._serialized_start=5873
  _RAFTINSTALLSNAPSHOTRESPONSE._serialized_end=5933
  _RAFTCHANGEREQUEST._serialized_start=5935
  _RAFTCHANGEREQUEST._serialized_end=5982
  _RAFTCHANGERESPONSE._serialized_start=5984
  _RAFTCHANGERESPONSE._serialized_end=6052
  _RAFTSTATUSREQUEST._serialized_start=6054
  _RAFTSTATUSREQUEST._serialized_end=6073
  _RAFTSTATUSRESPONSE._serialized_start=6076
  _RAFTSTATUSRESPONSE._serialized_end=6240
  _KEEPCONNECTEDREQUEST._serialized_start=6242
  _KEEPCONNECTEDREQUEST._serialized_end=6283
  _VOLUMELOCATIONUPDATE._serialized_start=6286
  _VOLUMELOCATIONUPDATE._serialized_end=6483
  _LOCKREQUEST._serialized_start=6485
  _LOCKREQUEST._serialized_end=6563
  _LOCKRESPONSE._serialized_start=6565
  _LOCKRESPONSE._serialized_end=6657
  _UNLOCKREQUEST._serialized_start=6659
  _UNLOCKREQUEST._serialized_end=6703
  _UNLOCKRESPONSE._serialized_start=6705
  _UNLOCKRESPONSE._serialized_end=6748
  _LOCKROW._serialized_start=6750
  _LOCKROW._serialized_end=6808
  _LOCKSTATUSREQUEST._serialized_start=6810
  _LOCKSTATUSREQUEST._serialized_end=6829
  _LOCKSTATUSRESPONSE._serialized_start=6831
  _LOCKSTATUSRESPONSE._serialized_end=6879
  _TIERREQUEST._serialized_start=6881
  _TIERREQUEST._serialized_end=6994
  _TIERRESPONSE._serialized_start=6996
  _TIERRESPONSE._serialized_end=7046
  _VOLUMETAILREQUEST._serialized_start=7048
  _VOLUMETAILREQUEST._serialized_end=7134
  _VOLUMETAILCHUNK._serialized_start=7136
  _VOLUMETAILCHUNK._serialized_end=7237
  _VOLUMETAILRECEIVERREQUEST._serialized_start=7239
  _VOLUMETAILRECEIVERREQUEST._serialized_end=7363
  _VOLUMETAILRECEIVERRESPONSE._serialized_start=7365
  _VOLUMETAILRECEIVERRESPONSE._serialized_end=7426
  _VOLUMEINCREMENTALCOPYREQUEST._serialized_start=7428
  _VOLUMEINCREMENTALCOPYREQUEST._serialized_end=7495
  _VOLUMEINCREMENTALCOPYCHUNK._serialized_start=7497
  _VOLUMEINCREMENTALCOPYCHUNK._serialized_end=7588
  _VOLUMEFILESTATUSREQUEST._serialized_start=7590
  _VOLUMEFILESTATUSREQUEST._serialized_end=7634
  _VOLUMEFILESTATUSRESPONSE._serialized_start=7637
  _VOLUMEFILESTATUSRESPONSE._serialized_end=7807
  _VOLUMECONFIGUREREQUEST._serialized_start=7809
  _VOLUMECONFIGUREREQUEST._serialized_end=7873
  _VACUUMCONTROLREQUEST._serialized_start=7875
  _VACUUMCONTROLREQUEST._serialized_end=7933
# @@protoc_insertion_point(module_scope)
