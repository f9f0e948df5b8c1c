# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: filer.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0b\x66iler.proto\x12\x07swfiler\"\xa2\x01\n\tFileChunk\x12\x0b\n\x03\x66id\x18\x01 \x01(\t\x12\x0e\n\x06offset\x18\x02 \x01(\x03\x12\x0c\n\x04size\x18\x03 \x01(\x04\x12\x16\n\x0emodified_ts_ns\x18\x04 \x01(\x03\x12\x0c\n\x04\x65tag\x18\x05 \x01(\t\x12\x12\n\ncipher_key\x18\x06 \x01(\x0c\x12\x15\n\ris_compressed\x18\x07 \x01(\x08\x12\x19\n\x11is_chunk_manifest\x18\x08 \x01(\x08\"7\n\x11\x46ileChunkManifest\x12\"\n\x06\x63hunks\x18\x01 \x03(\x0b\x32\x12.swfiler.FileChunk\"\xee\x01\n\x04\x41ttr\x12\r\n\x05mtime\x18\x01 \x01(\x03\x12\x0e\n\x06\x63rtime\x18\x02 \x01(\x03\x12\x11\n\tfile_mode\x18\x03 \x01(\r\x12\x0b\n\x03uid\x18\x04 \x01(\r\x12\x0b\n\x03gid\x18\x05 \x01(\r\x12\x0c\n\x04mime\x18\x06 \x01(\t\x12\x0f\n\x07ttl_sec\x18\x07 \x01(\x05\x12\x11\n\tuser_name\x18\x08 \x01(\t\x12\x13\n\x0bgroup_names\x18\t \x03(\t\x12\x16\n\x0esymlink_target\x18\n \x01(\t\x12\x0b\n\x03md5\x18\x0b \x01(\x0c\x12\x11\n\tfile_size\x18\x0c \x01(\x04\x12\x0c\n\x04rdev\x18\r \x01(\x03\x12\r\n\x05inode\x18\x0e \x01(\x04\"\xb5\x02\n\x05\x45ntry\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x14\n\x0cis_directory\x18\x02 \x01(\x08\x12\"\n\x06\x63hunks\x18\x03 \x03(\x0b\x32\x12.swfiler.FileChunk\x12!\n\nattributes\x18\x04 \x01(\x0b\x32\r.swfiler.Attr\x12.\n\x08\x65xtended\x18\x05 \x03(\x0b\x32\x1c.swfiler.Entry.ExtendedEntry\x12\x14\n\x0chard_link_id\x18\x06 \x01(\x0c\x12\x19\n\x11hard_link_counter\x18\x07 \x01(\x05\x12\x0f\n\x07\x63ontent\x18\x08 \x01(\x0c\x12\x1e\n\x16worm_enforced_at_ts_ns\x18\t \x01(\x03\x1a/\n\rExtendedEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x0c:\x02\x38\x01\"\xa8\x01\n\x11\x45ventNotification\x12!\n\told_entry\x18\x01 \x01(\x0b\x32\x0e.swfiler.Entry\x12!\n\tnew_entry\x18\x02 \x01(\x0b\x32\x0e.swfiler.Entry\x12\x15\n\rdelete_chunks\x18\x03 \x01(\x08\x12\x17\n\x0fnew_parent_path\x18\x04 \x01(\t\x12\x1d\n\x15is_from_other_cluster\x18\x05 \x01(\x08\"d\n\x15\x46ullEventNotification\x12\x11\n\tdirectory\x18\x01 \x01(\t\x12)\n\x05\x65vent\x18\x02 \x01(\x0b\x32\x1a.swfiler.EventNotification\x12\r\n\x05ts_ns\x18\x03 \x01(\x03\"5\n\x12LookupEntryRequest\x12\x11\n\tdirectory\x18\x01 \x01(\t\x12\x0c\n\x04name\x18\x02 \x01(\t\"C\n\x13LookupEntryResponse\x12\x1d\n\x05\x65ntry\x18\x01 \x01(\x0b\x32\x0e.swfiler.Entry\x12\r\n\x05\x65rror\x18\x02 \x01(\t\"Z\n\x12ListEntriesRequest\x12\x11\n\tdirectory\x18\x01 \x01(\t\x12\x12\n\nstart_from\x18\x02 \x01(\t\x12\r\n\x05limit\x18\x03 \x01(\r\x12\x0e\n\x06prefix\x18\x04 \x01(\t\"4\n\x13ListEntriesResponse\x12\x1d\n\x05\x65ntry\x18\x01 \x01(\x0b\x32\x0e.swfiler.Entry\"F\n\x12\x43reateEntryRequest\x12\x11\n\tdirectory\x18\x01 \x01(\t\x12\x1d\n\x05\x65ntry\x18\x02 \x01(\x0b\x32\x0e.swfiler.Entry\" \n\x0f\x46ilerOpResponse\x12\r\n\x05\x65rror\x18\x01 \x01(\t\"F\n\x12UpdateEntryRequest\x12\x11\n\tdirectory\x18\x01 \x01(\t\x12\x1d\n\x05\x65ntry\x18\x02 \x01(\x0b\x32\x0e.swfiler.Entry\"c\n\x12\x44\x65leteEntryRequest\x12\x11\n\tdirectory\x18\x01 \x01(\t\x12\x0c\n\x04name\x18\x02 \x01(\t\x12\x14\n\x0cis_recursive\x18\x03 \x01(\x08\x12\x16\n\x0eis_delete_data\x18\x04 \x01(\x08\"l\n\x18\x41tomicRenameEntryRequest\x12\x15\n\rold_directory\x18\x01 \x01(\t\x12\x10\n\x08old_name\x18\x02 \x01(\t\x12\x15\n\rnew_directory\x18\x03 \x01(\t\x12\x10\n\x08new_name\x18\x04 \x01(\t\"j\n\x18SubscribeMetadataRequest\x12\x13\n\x0b\x63lient_name\x18\x01 \x01(\t\x12\x13\n\x0bpath_prefix\x18\x02 \x01(\t\x12\x10\n\x08since_ns\x18\x03 \x01(\x03\x12\x12\n\nlocal_only\x18\x04 \x01(\x08\"E\n\x13\x41ssignVolumeRequest\x12\r\n\x05\x63ount\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x0b\n\x03ttl\x18\x03 \x01(\t\"L\n\x14\x41ssignVolumeResponse\x12\x0b\n\x03\x66id\x18\x01 \x01(\t\x12\x0b\n\x03url\x18\x02 \x01(\t\x12\x0b\n\x03jwt\x18\x03 \x01(\t\x12\r\n\x05\x65rror\x18\x04 \x01(\t\"5\n\x0fHardLinkRequest\x12\x10\n\x08src_path\x18\x01 \x01(\t\x12\x10\n\x08\x64st_path\x18\x02 \x01(\t\" \n\x11\x46ilerKvGetRequest\x12\x0b\n\x03key\x18\x01 \x01(\x0c\"2\n\x12\x46ilerKvGetResponse\x12\r\n\x05value\x18\x01 \x01(\x0c\x12\r\n\x05\x66ound\x18\x02 \x01(\x08\"/\n\x11\x46ilerKvPutRequest\x12\x0b\n\x03key\x18\x01 \x01(\x0c\x12\r\n\x05value\x18\x02 \x01(\x0c\"\x81\x01\n\x10LockRangeRequest\x12\x0c\n\x04path\x18\x01 \x01(\t\x12\r\n\x05owner\x18\x02 \x01(\t\x12\r\n\x05start\x18\x03 \x01(\x04\x12\x0b\n\x03\x65nd\x18\x04 \x01(\x04\x12\x11\n\texclusive\x18\x05 \x01(\x08\x12\x15\n\rlease_seconds\x18\x06 \x01(\x03\x12\n\n\x02op\x18\x07 \x01(\x05\"Z\n\x11LockRangeResponse\x12\x0f\n\x07granted\x18\x01 \x01(\x08\x12\x16\n\x0e\x63onflict_owner\x18\x02 \x01(\t\x12\r\n\x05\x63ount\x18\x03 \x01(\x05\x12\r\n\x05\x65rror\x18\x04 \x01(\t\"m\n\nDlmRequest\x12\n\n\x02op\x18\x01 \x01(\t\x12\x0c\n\x04name\x18\x02 \x01(\t\x12\r\n\x05owner\x18\x03 \x01(\t\x12\x13\n\x0bttl_seconds\x18\x04 \x01(\x01\x12\r\n\x05token\x18\x05 \x01(\t\x12\x12\n\nno_forward\x18\x06 \x01(\x08\"<\n\nDlmLockRow\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\r\n\x05owner\x18\x02 \x01(\t\x12\x11\n\tremaining\x18\x03 \x01(\x01\"\x90\x01\n\x0b\x44lmResponse\x12\n\n\x02ok\x18\x01 \x01(\x08\x12\r\n\x05token\x18\x02 \x01(\t\x12\x0e\n\x06holder\x18\x03 \x01(\t\x12\x11\n\tremaining\x18\x04 \x01(\x01\x12\x10\n\x08moved_to\x18\x05 \x01(\t\x12\r\n\x05\x65rror\x18\x06 \x01(\t\x12\"\n\x05locks\x18\x07 \x03(\x0b\x32\x13.swfiler.DlmLockRow\"%\n\x13LifecycleRunRequest\x12\x0e\n\x06\x62ucket\x18\x01 \x01(\t\"k\n\x14LifecycleRunResponse\x12\x0f\n\x07\x65xpired\x18\x01 \x01(\x04\x12\x1a\n\x12noncurrent_expired\x18\x02 \x01(\x04\x12\x17\n\x0f\x61\x62orted_uploads\x18\x03 \x01(\x04\x12\r\n\x05\x65rror\x18\x04 \x01(\tb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'filer_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _ENTRY_EXTENDEDENTRY._options = None
  _ENTRY_EXTENDEDENTRY._serialized_options = b'8\001'
  _FILECHUNK._serialized_start=25
  _FILECHUNK._serialized_end=187
  _FILECHUNKMANIFEST._serialized_start=189
  _FILECHUNKMANIFEST._serialized_end=244
  _ATTR._serialized_start=247
  _ATTR._serialized_end=485
  _ENTRY._serialized_start=488
  _ENTRY._serialized_end=797
  _ENTRY_EXTENDEDENTRY._serialized_start=750
  _ENTRY_EXTENDEDENTRY._serialized_end=797
  _EVENTNOTIFICATION._serialized_start=800
  _EVENTNOTIFICATION._serialized_end=968
  _FULLEVENTNOTIFICATION._serialized_start=970
  _FULLEVENTNOTIFICATION._serialized_end=1070
  _LOOKUPENTRYREQUEST._serialized_start=1072
  _LOOKUPENTRYREQUEST._serialized_end=1125
  _LOOKUPENTRYRESPONSE._serialized_start=1127
  _LOOKUPENTRYRESPONSE._serialized_end=1194
  _LISTENTRIESREQUEST._serialized_start=1196
  _LISTENTRIESREQUEST._serialized_end=1286
  _LISTENTRIESRESPONSE._serialized_start=1288
  _LISTENTRIESRESPONSE._serialized_end=1340
  _CREATEENTRYREQUEST._serialized_start=1342
  _CREATEENTRYREQUEST._serialized_end=1412
  _FILEROPRESPONSE._serialized_start=1414
  _FILEROPRESPONSE._serialized_end=1446
  _UPDATEENTRYREQUEST._serialized_start=1448
  _UPDATEENTRYREQUEST._serialized_end=1518
  _DELETEENTRYREQUEST._serialized_start=1520
  _DELETEENTRYREQUEST._serialized_end=1619
  _ATOMICRENAMEENTRYREQUEST._serialized_start=1621
  _ATOMICRENAMEENTRYREQUEST._serialized_end=1729
  _SUBSCRIBEMETADATAREQUEST._serialized_start=1731
  _SUBSCRIBEMETADATAREQUEST._serialized_end=1837
  _ASSIGNVOLUMEREQUEST._serialized_start=1839
  _ASSIGNVOLUMEREQUEST._serialized_end=1908
  _ASSIGNVOLUMERESPONSE._serialized_start=1910
  _ASSIGNVOLUMERESPONSE._serialized_end=1986
  _HARDLINKREQUEST._serialized_start=1988
  _HARDLINKREQUEST._serialized_end=2041
  _FILERKVGETREQUEST._serialized_start=2043
  _FILERKVGETREQUEST._serialized_end=2075
  _FILERKVGETRESPONSE._serialized_start=2077
  _FILERKVGETRESPONSE._serialized_end=2127
  _FILERKVPUTREQUEST._serialized_start=2129
  _FILERKVPUTREQUEST._serialized_end=2176
  _LOCKRANGEREQUEST._serialized_start=2179
  _LOCKRANGEREQUEST._serialized_end=2308
  _LOCKRANGERESPONSE._serialized_start=2310
  _LOCKRANGERESPONSE._serialized_end=2400
  _DLMREQUEST._serialized_start=2402
  _DLMREQUEST._serialized_end=2511
  _DLMLOCKROW._serialized_start=2513
  _DLMLOCKROW._serialized_end=2573
  _DLMRESPONSE._serialized_start=2576
  _DLMRESPONSE._serialized_end=2720
  _LIFECYCLERUNREQUEST._serialized_start=2722
  _LIFECYCLERUNREQUEST._serialized_end=2759
  _LIFECYCLERUNRESPONSE._serialized_start=2761
  _LIFECYCLERUNRESPONSE._serialized_end=2868
# @@protoc_insertion_point(module_scope)
