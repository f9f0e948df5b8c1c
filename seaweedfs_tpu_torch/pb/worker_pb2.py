# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: worker.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0cworker.proto\x12\x08swworker\"\x97\x01\n\rWorkerMessage\x12&\n\x08register\x18\x01 \x01(\x0b\x32\x12.swworker.RegisterH\x00\x12.\n\theartbeat\x18\x02 \x01(\x0b\x32\x19.swworker.WorkerHeartbeatH\x00\x12&\n\x06update\x18\x03 \x01(\x0b\x32\x14.swworker.TaskUpdateH\x00\x42\x06\n\x04\x62ody\"\x8b\x01\n\x08Register\x12\x11\n\tworker_id\x18\x01 \x01(\t\x12\x14\n\x0c\x63\x61pabilities\x18\x02 \x03(\t\x12\x16\n\x0emax_concurrent\x18\x03 \x01(\x05\x12\x0f\n\x07\x62\x61\x63kend\x18\x04 \x01(\t\x12-\n\x0b\x64\x65scriptors\x18\x05 \x03(\x0b\x32\x18.swworker.TaskDescriptor\"b\n\x0b\x43onfigField\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0c\n\x04type\x18\x02 \x01(\t\x12\x0f\n\x07\x64\x65\x66\x61ult\x18\x03 \x01(\t\x12\x0c\n\x04help\x18\x04 \x01(\t\x12\x0b\n\x03min\x18\x05 \x01(\x01\x12\x0b\n\x03max\x18\x06 \x01(\x01\"p\n\x0eTaskDescriptor\x12\x0c\n\x04kind\x18\x01 \x01(\t\x12\x14\n\x0c\x64isplay_name\x18\x02 \x01(\t\x12\x13\n\x0b\x64\x65scription\x18\x03 \x01(\t\x12%\n\x06\x66ields\x18\x04 \x03(\x0b\x32\x15.swworker.ConfigField\"\'\n\x0fWorkerHeartbeat\x12\x14\n\x0c\x61\x63tive_tasks\x18\x01 \x01(\x05\"]\n\nTaskUpdate\x12\x0f\n\x07task_id\x18\x01 \x01(\t\x12\r\n\x05state\x18\x02 \x01(\t\x12\x10\n\x08progress\x18\x03 \x01(\x02\x12\r\n\x05\x65rror\x18\x04 \x01(\t\x12\x0e\n\x06\x64\x65tail\x18\x05 \x01(\t\"c\n\rServerMessage\x12&\n\x06\x61ssign\x18\x01 \x01(\x0b\x32\x14.swworker.TaskAssignH\x00\x12\"\n\x03\x61\x63k\x18\x02 \x01(\x0b\x32\x13.swworker.ServerAckH\x00\x42\x06\n\x04\x62ody\"\xc4\x01\n\nTaskAssign\x12\x0f\n\x07task_id\x18\x01 \x01(\t\x12\x0c\n\x04kind\x18\x02 \x01(\t\x12\x11\n\tvolume_id\x18\x03 \x01(\r\x12\x12\n\ncollection\x18\x04 \x01(\t\x12\x0f\n\x07\x62\x61\x63kend\x18\x05 \x01(\t\x12\x30\n\x06params\x18\x06 \x03(\x0b\x32 .swworker.TaskAssign.ParamsEntry\x1a-\n\x0bParamsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"\x0b\n\tServerAck\"\x12\n\x10ListTasksRequest\"\x7f\n\x08TaskInfo\x12\x0f\n\x07task_id\x18\x01 \x01(\t\x12\x0c\n\x04kind\x18\x02 \x01(\t\x12\x11\n\tvolume_id\x18\x03 \x01(\r\x12\r\n\x05state\x18\x04 \x01(\t\x12\x11\n\tworker_id\x18\x05 \x01(\t\x12\x10\n\x08progress\x18\x06 \x01(\x02\x12\r\n\x05\x65rror\x18\x07 \x01(\t\"6\n\x11ListTasksResponse\x12!\n\x05tasks\x18\x01 \x03(\x0b\x32\x12.swworker.TaskInfo\"\xc1\x01\n\x11SubmitTaskRequest\x12\x0c\n\x04kind\x18\x01 \x01(\t\x12\x11\n\tvolume_id\x18\x02 \x01(\r\x12\x12\n\ncollection\x18\x03 \x01(\t\x12\x0f\n\x07\x62\x61\x63kend\x18\x04 \x01(\t\x12\x37\n\x06params\x18\x05 \x03(\x0b\x32\'.swworker.SubmitTaskRequest.ParamsEntry\x1a-\n\x0bParamsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"4\n\x12SubmitTaskResponse\x12\x0f\n\x07task_id\x18\x01 \x01(\t\x12\r\n\x05\x65rror\x18\x02 \x01(\t\"\x14\n\x12ListWorkersRequest\"\x9d\x01\n\nWorkerInfo\x12\x11\n\tworker_id\x18\x01 \x01(\t\x12\x14\n\x0c\x63\x61pabilities\x18\x02 \x03(\t\x12\x0f\n\x07\x62\x61\x63kend\x18\x03 \x01(\t\x12\x0e\n\x06\x61\x63tive\x18\x04 \x01(\x05\x12\x16\n\x0emax_concurrent\x18\x05 \x01(\x05\x12-\n\x0b\x64\x65scriptors\x18\x06 \x03(\x0b\x32\x18.swworker.TaskDescriptor\"<\n\x13ListWorkersResponse\x12%\n\x07workers\x18\x01 \x03(\x0b\x32\x14.swworker.WorkerInfo\"\xfb\x04\n\x11MaintenanceConfig\x12\x1d\n\x10\x65\x63_auto_fullness\x18\x01 \x01(\x01H\x00\x88\x01\x01\x12\x1d\n\x10\x65\x63_quiet_seconds\x18\x02 \x01(\x01H\x01\x88\x01\x01\x12\x1e\n\x11garbage_threshold\x18\x03 \x01(\x01H\x02\x88\x01\x01\x12$\n\x17vacuum_interval_seconds\x18\x04 \x01(\x01H\x03\x88\x01\x01\x12\x1b\n\x0e\x62\x61lance_spread\x18\x05 \x01(\x01H\x04\x88\x01\x01\x12\'\n\x1alifecycle_interval_seconds\x18\x06 \x01(\x01H\x05\x88\x01\x01\x12\x1c\n\x0flifecycle_filer\x18\x07 \x01(\tH\x06\x88\x01\x01\x12(\n\x1b\x65\x63_balance_interval_seconds\x18\x08 \x01(\x01H\x07\x88\x01\x01\x12&\n\x19\x65\x63_scrub_interval_seconds\x18\t \x01(\x01H\x08\x88\x01\x01\x12*\n\x1d\x65\x63_rebalance_interval_seconds\x18\n \x01(\x01H\t\x88\x01\x01\x42\x13\n\x11_ec_auto_fullnessB\x13\n\x11_ec_quiet_secondsB\x14\n\x12_garbage_thresholdB\x1a\n\x18_vacuum_interval_secondsB\x11\n\x0f_balance_spreadB\x1d\n\x1b_lifecycle_interval_secondsB\x12\n\x10_lifecycle_filerB\x1e\n\x1c_ec_balance_interval_secondsB\x1c\n\x1a_ec_scrub_interval_secondsB \n\x1e_ec_rebalance_interval_seconds\"\x1d\n\x1bGetMaintenanceConfigRequest\"-\n\x1cSetMaintenanceConfigResponse\x12\r\n\x05\x65rror\x18\x01 \x01(\tb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'worker_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _TASKASSIGN_PARAMSENTRY._options = None
  _TASKASSIGN_PARAMSENTRY._serialized_options = b'8\001'
  _SUBMITTASKREQUEST_PARAMSENTRY._options = None
  _SUBMITTASKREQUEST_PARAMSENTRY._serialized_options = b'8\001'
  _WORKERMESSAGE._serialized_start=27
  _WORKERMESSAGE._serialized_end=178
  _REGISTER._serialized_start=181
  _REGISTER._serialized_end=320
  _CONFIGFIELD._serialized_start=322
  _CONFIGFIELD._serialized_end=420
  _TASKDESCRIPTOR._serialized_start=422
  _TASKDESCRIPTOR._serialized_end=534
  _WORKERHEARTBEAT._serialized_start=536
  _WORKERHEARTBEAT._serialized_end=575
  _TASKUPDATE._serialized_start=577
  _TASKUPDATE._serialized_end=670
  _SERVERMESSAGE._serialized_start=672
  _SERVERMESSAGE._serialized_end=771
  _TASKASSIGN._serialized_start=774
  _TASKASSIGN._serialized_end=970
  _TASKASSIGN_PARAMSENTRY._serialized_start=925
  _TASKASSIGN_PARAMSENTRY._serialized_end=970
  _SERVERACK._serialized_start=972
  _SERVERACK._serialized_end=983
  _LISTTASKSREQUEST._serialized_start=985
  _LISTTASKSREQUEST._serialized_end=1003
  _TASKINFO._serialized_start=1005
  _TASKINFO._serialized_end=1132
  _LISTTASKSRESPONSE._serialized_start=1134
  _LISTTASKSRESPONSE._serialized_end=1188
  _SUBMITTASKREQUEST._serialized_start=1191
  _SUBMITTASKREQUEST._serialized_end=1384
  _SUBMITTASKREQUEST_PARAMSENTRY._serialized_start=925
  _SUBMITTASKREQUEST_PARAMSENTRY._serialized_end=970
  _SUBMITTASKRESPONSE._serialized_start=1386
  _SUBMITTASKRESPONSE._serialized_end=1438
  _LISTWORKERSREQUEST._serialized_start=1440
  _LISTWORKERSREQUEST._serialized_end=1460
  _WORKERINFO._serialized_start=1463
  _WORKERINFO._serialized_end=1620
  _LISTWORKERSRESPONSE._serialized_start=1622
  _LISTWORKERSRESPONSE._serialized_end=1682
  _MAINTENANCECONFIG._serialized_start=1685
  _MAINTENANCECONFIG._serialized_end=2320
  _GETMAINTENANCECONFIGREQUEST._serialized_start=2322
  _GETMAINTENANCECONFIGREQUEST._serialized_end=2351
  _SETMAINTENANCECONFIGRESPONSE._serialized_start=2353
  _SETMAINTENANCECONFIGRESPONSE._serialized_end=2398
# @@protoc_insertion_point(module_scope)
