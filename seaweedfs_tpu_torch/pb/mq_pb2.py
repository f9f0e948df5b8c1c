# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: mq.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x08mq.proto\x12\x04swmq"(\n\x05Topic\x12\x11\n\tnamespace\x18\x01 \x01(\t\x12\x0c\n\x04name\x18\x02 \x01(\t"s\n\x15ConfigureTopicRequest\x12\x1a\n\x05topic\x18\x01 \x01(\x0b2\x0b.swmq.Topic\x12\x17\n\x0fpartition_count\x18\x02 \x01(\x05\x12%\n\x0edurable_parity\x18\x03 \x01(\x05R\rdurableParity"\x18\n\x16ConfigureTopicResponse"\x13\n\x11ListTopicsRequest"@\n\tTopicInfo\x12\x1a\n\x05topic\x18\x01 \x01(\x0b2\x0b.swmq.Topic\x12\x17\n\x0fpartition_count\x18\x02 \x01(\x05"5\n\x12ListTopicsResponse\x12\x1f\n\x06topics\x18\x01 \x03(\x0b2\x0f.swmq.TopicInfo"8\n\x0bDataMessage\x12\x0b\n\x03key\x18\x01 \x01(\x0c\x12\r\n\x05value\x18\x02 \x01(\x0c\x12\r\n\x05ts_ns\x18\x03 \x01(\x03"c\n\x0ePublishRequest\x12\x1a\n\x05topic\x18\x01 \x01(\x0b2\x0b.swmq.Topic\x12\x11\n\tpartition\x18\x02 \x01(\x05\x12"\n\x07message\x18\x03 \x01(\x0b2\x11.swmq.DataMessage"C\n\x0fPublishResponse\x12\x0e\n\x06offset\x18\x01 \x01(\x03\x12\x11\n\tpartition\x18\x02 \x01(\x05\x12\r\n\x05error\x18\x03 \x01(\t"\x7f\n\x10SubscribeRequest\x12\x1a\n\x05topic\x18\x01 \x01(\x0b2\x0b.swmq.Topic\x12\x11\n\tpartition\x18\x02 \x01(\x05\x12\x14\n\x0cstart_offset\x18\x03 \x01(\x03\x12\x16\n\x0econsumer_group\x18\x04 \x01(\t\x12\x0e\n\x06follow\x18\x05 \x01(\x08"o\n\x0fSubscribeRecord\x12"\n\x07message\x18\x01 \x01(\x0b2\x11.swmq.DataMessage\x12\x0e\n\x06offset\x18\x02 \x01(\x03\x12\x11\n\tpartition\x18\x03 \x01(\x05\x12\x15\n\rend_of_stream\x18\x04 \x01(\x08"l\n\x13CommitOffsetRequest\x12\x1a\n\x05topic\x18\x01 \x01(\x0b2\x0b.swmq.Topic\x12\x11\n\tpartition\x18\x02 \x01(\x05\x12\x16\n\x0econsumer_group\x18\x03 \x01(\t\x12\x0e\n\x06offset\x18\x04 \x01(\x03"\x16\n\x14CommitOffsetResponse"[\n\x12FetchOffsetRequest\x12\x1a\n\x05topic\x18\x01 \x01(\x0b2\x0b.swmq.Topic\x12\x11\n\tpartition\x18\x02 \x01(\x05\x12\x16\n\x0econsumer_group\x18\x03 \x01(\t"%\n\x13FetchOffsetResponse\x12\x0e\n\x06offset\x18\x01 \x01(\x03"2\n\x14PartitionInfoRequest\x12\x1a\n\x05topic\x18\x01 \x01(\x0b2\x0b.swmq.Topic"P\n\rPartitionInfo\x12\x11\n\tpartition\x18\x01 \x01(\x05\x12\x17\n\x0fearliest_offset\x18\x02 \x01(\x03\x12\x13\n\x0bnext_offset\x18\x03 \x01(\x03"@\n\x15PartitionInfoResponse\x12\'\n\npartitions\x18\x01 \x03(\x0b2\x13.swmq.PartitionInfo"\x15\n\x13BrokerStatusRequest"b\n\x14BrokerStatusResponse\x12\x0f\n\x07address\x18\x01 \x01(\t\x12\r\n\x05peers\x18\x02 \x03(\t\x12\x16\n\x0euptime_seconds\x18\x03 \x01(\x03\x12\x12\n\nload_score\x18\x04 \x01(\x01"7\n\x19LookupTopicBrokersRequest\x12\x1a\n\x05topic\x18\x01 \x01(\x0b2\x0b.swmq.Topic"P\n\x19BrokerPartitionAssignment\x12\x11\n\tpartition\x18\x01 \x01(\x05\x12\x0e\n\x06leader\x18\x02 \x01(\t\x12\x10\n\x08follower\x18\x03 \x01(\t"a\n\x1aLookupTopicBrokersResponse\x124\n\x0bassignments\x18\x01 \x03(\x0b2\x1f.swmq.BrokerPartitionAssignment\x12\r\n\x05error\x18\x02 \x01(\t"\x91\x01\n\x13FollowAppendRequest\x12\x1a\n\x05topic\x18\x01 \x01(\x0b2\x0b.swmq.Topic\x12\x11\n\tpartition\x18\x02 \x01(\x05\x12\x0e\n\x06offset\x18\x03 \x01(\x03\x12"\n\x07message\x18\x04 \x01(\x0b2\x11.swmq.DataMessage\x12\x17\n\x0fpartition_count\x18\x05 \x01(\x05"%\n\x14FollowAppendResponse\x12\r\n\x05error\x18\x01 \x01(\t"H\n\x15RegisterSchemaRequest\x12\x1a\n\x05topic\x18\x01 \x01(\x0b2\x0b.swmq.Topic\x12\x13\n\x0bschema_json\x18\x02 \x01(\t"\'\n\x16RegisterSchemaResponse\x12\r\n\x05error\x18\x01 \x01(\t".\n\x10GetSchemaRequest\x12\x1a\n\x05topic\x18\x01 \x01(\x0b2\x0b.swmq.Topic"7\n\x11GetSchemaResponse\x12\x13\n\x0bschema_json\x18\x01 \x01(\t\x12\r\n\x05error\x18\x02 \x01(\t"/\n\x13CompactTopicRequest\x12\n\n\x02ns\x18\x01 \x01(\t\x12\x0c\n\x04name\x18\x02 \x01(\t"@\n\x14CompactTopicResponse\x12\x19\n\x11archived_segments\x18\x01 \x01(\x04\x12\r\n\x05error\x18\x02 \x01(\t"Z\n\x14TruncateTopicRequest\x12\n\n\x02ns\x18\x01 \x01(\t\x12\x0c\n\x04name\x18\x02 \x01(\t\x12\x11\n\tpartition\x18\x03 \x01(\x05\x12\x15\n\rbefore_offset\x18\x04 \x01(\x03"D\n\x15TruncateTopicResponse\x12\x1c\n\x14truncated_partitions\x18\x01 \x01(\x04\x12\r\n\x05error\x18\x02 \x01(\t".\n\x12DeleteTopicRequest\x12\n\n\x02ns\x18\x01 \x01(\t\x12\x0c\n\x04name\x18\x02 \x01(\t"$\n\x13DeleteTopicResponse\x12\r\n\x05error\x18\x01 \x01(\t"e\n\x18AgentStartPublishRequest\x12\n\n\x02ns\x18\x01 \x01(\t\x12\x0c\n\x04name\x18\x02 \x01(\t\x12\x17\n\x0fpartition_count\x18\x03 \x01(\x05\x12\x16\n\x0epublisher_name\x18\x04 \x01(\t">\n\x19AgentStartPublishResponse\x12\r\n\x05error\x18\x01 \x01(\t\x12\x12\n\nsession_id\x18\x02 \x01(\x03".\n\x18AgentClosePublishRequest\x12\x12\n\nsession_id\x18\x01 \x01(\x03"*\n\x19AgentClosePublishResponse\x12\r\n\x05error\x18\x01 \x01(\t"E\n\x13AgentPublishRequest\x12\x12\n\nsession_id\x18\x01 \x01(\x03\x12\x0b\n\x03key\x18\x02 \x01(\x0c\x12\r\n\x05value\x18\x03 \x01(\x0c"K\n\x14AgentPublishResponse\x12\x14\n\x0cack_sequence\x18\x01 \x01(\x03\x12\r\n\x05error\x18\x02 \x01(\t\x12\x0e\n\x06offset\x18\x03 \x01(\x03"\x7f\n\x12AgentSubscribeInit\x12\x16\n\x0econsumer_group\x18\x01 \x01(\t\x12\n\n\x02ns\x18\x02 \x01(\t\x12\x0c\n\x04name\x18\x03 \x01(\t\x12\x11\n\tpartition\x18\x04 \x01(\x05\x12\x14\n\x0cstart_offset\x18\x05 \x01(\x03\x12\x0e\n\x06follow\x18\x06 \x01(\x08"U\n\x15AgentSubscribeRequest\x12&\n\x04init\x18\x01 \x01(\x0b2\x18.swmq.AgentSubscribeInit\x12\x14\n\x0cack_sequence\x18\x02 \x01(\x03"|\n\x16AgentSubscribeResponse\x12\x0b\n\x03key\x18\x01 \x01(\x0c\x12\r\n\x05value\x18\x02 \x01(\x0c\x12\r\n\x05ts_ns\x18\x03 \x01(\x03\x12\r\n\x05error\x18\x04 \x01(\t\x12\x18\n\x10is_end_of_stream\x18\x05 \x01(\x08\x12\x0e\n\x06offset\x18\x06 \x01(\x03b\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'mq_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _TOPIC._serialized_start=18
  _TOPIC._serialized_end=58
  _CONFIGURETOPICREQUEST._serialized_start=60
  _CONFIGURETOPICREQUEST._serialized_end=136
  _CONFIGURETOPICRESPONSE._serialized_start=138
  _CONFIGURETOPICRESPONSE._serialized_end=162
  _LISTTOPICSREQUEST._serialized_start=164
  _LISTTOPICSREQUEST._serialized_end=183
  _TOPICINFO._serialized_start=185
  _TOPICINFO._serialized_end=249
  _LISTTOPICSRESPONSE._serialized_start=251
  _LISTTOPICSRESPONSE._serialized_end=304
  _DATAMESSAGE._serialized_start=306
  _DATAMESSAGE._serialized_end=362
  _PUBLISHREQUEST._serialized_start=364
  _PUBLISHREQUEST._serialized_end=463
  _PUBLISHRESPONSE._serialized_start=465
  _PUBLISHRESPONSE._serialized_end=532
  _SUBSCRIBEREQUEST._serialized_start=534
  _SUBSCRIBEREQUEST._serialized_end=661
  _SUBSCRIBERECORD._serialized_start=663
  _SUBSCRIBERECORD._serialized_end=774
  _COMMITOFFSETREQUEST._serialized_start=776
  _COMMITOFFSETREQUEST._serialized_end=884
  _COMMITOFFSETRESPONSE._serialized_start=886
  _COMMITOFFSETRESPONSE._serialized_end=908
  _FETCHOFFSETREQUEST._serialized_start=910
  _FETCHOFFSETREQUEST._serialized_end=1001
  _FETCHOFFSETRESPONSE._serialized_start=1003
  _FETCHOFFSETRESPONSE._serialized_end=1040
  _PARTITIONINFOREQUEST._serialized_start=1042
  _PARTITIONINFOREQUEST._serialized_end=1092
  _PARTITIONINFO._serialized_start=1094
  _PARTITIONINFO._serialized_end=1174
  _PARTITIONINFORESPONSE._serialized_start=1176
  _PARTITIONINFORESPONSE._serialized_end=1240
  _BROKERSTATUSREQUEST._serialized_start=1242
  _BROKERSTATUSREQUEST._serialized_end=1263
  _BROKERSTATUSRESPONSE._serialized_start=1265
  _BROKERSTATUSRESPONSE._serialized_end=1363
  _LOOKUPTOPICBROKERSREQUEST._serialized_start=1365
  _LOOKUPTOPICBROKERSREQUEST._serialized_end=1420
  _BROKERPARTITIONASSIGNMENT._serialized_start=1422
  _BROKERPARTITIONASSIGNMENT._serialized_end=1502
  _LOOKUPTOPICBROKERSRESPONSE._serialized_start=1504
  _LOOKUPTOPICBROKERSRESPONSE._serialized_end=1601
  _FOLLOWAPPENDREQUEST._serialized_start=1604
  _FOLLOWAPPENDREQUEST._serialized_end=1749
  _FOLLOWAPPENDRESPONSE._serialized_start=1751
  _FOLLOWAPPENDRESPONSE._serialized_end=1788
  _REGISTERSCHEMAREQUEST._serialized_start=1790
  _REGISTERSCHEMAREQUEST._serialized_end=1862
  _REGISTERSCHEMARESPONSE._serialized_start=1864
  _REGISTERSCHEMARESPONSE._serialized_end=1903
  _GETSCHEMAREQUEST._serialized_start=1905
  _GETSCHEMAREQUEST._serialized_end=1951
  _GETSCHEMARESPONSE._serialized_start=1953
  _GETSCHEMARESPONSE._serialized_end=2008
  _COMPACTTOPICREQUEST._serialized_start=2010
  _COMPACTTOPICREQUEST._serialized_end=2057
  _COMPACTTOPICRESPONSE._serialized_start=2059
  _COMPACTTOPICRESPONSE._serialized_end=2123
  _TRUNCATETOPICREQUEST._serialized_start=2125
  _TRUNCATETOPICREQUEST._serialized_end=2215
  _TRUNCATETOPICRESPONSE._serialized_start=2217
  _TRUNCATETOPICRESPONSE._serialized_end=2285
  _DELETETOPICREQUEST._serialized_start=2287
  _DELETETOPICREQUEST._serialized_end=2333
  _DELETETOPICRESPONSE._serialized_start=2335
  _DELETETOPICRESPONSE._serialized_end=2371
  _AGENTSTARTPUBLISHREQUEST._serialized_start=2373
  _AGENTSTARTPUBLISHREQUEST._serialized_end=2474
  _AGENTSTARTPUBLISHRESPONSE._serialized_start=2476
  _AGENTSTARTPUBLISHRESPONSE._serialized_end=2538
  _AGENTCLOSEPUBLISHREQUEST._serialized_start=2540
  _AGENTCLOSEPUBLISHREQUEST._serialized_end=2586
  _AGENTCLOSEPUBLISHRESPONSE._serialized_start=2588
  _AGENTCLOSEPUBLISHRESPONSE._serialized_end=2630
  _AGENTPUBLISHREQUEST._serialized_start=2632
  _AGENTPUBLISHREQUEST._serialized_end=2701
  _AGENTPUBLISHRESPONSE._serialized_start=2703
  _AGENTPUBLISHRESPONSE._serialized_end=2778
  _AGENTSUBSCRIBEINIT._serialized_start=2780
  _AGENTSUBSCRIBEINIT._serialized_end=2907
  _AGENTSUBSCRIBEREQUEST._serialized_start=2909
  _AGENTSUBSCRIBEREQUEST._serialized_end=2994
  _AGENTSUBSCRIBERESPONSE._serialized_start=2996
  _AGENTSUBSCRIBERESPONSE._serialized_end=3120
# @@protoc_insertion_point(module_scope)
