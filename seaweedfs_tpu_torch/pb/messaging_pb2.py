# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: messaging.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0fmessaging.proto\x12\x0cmessaging_pb\"\xb8\x03\n\x11SubscriberMessage\x12\x39\n\x04init\x18\x01 \x01(\x0b\x32+.messaging_pb.SubscriberMessage.InitMessage\x12\x37\n\x03\x61\x63k\x18\x02 \x01(\x0b\x32*.messaging_pb.SubscriberMessage.AckMessage\x12\x10\n\x08is_close\x18\x03 \x01(\x08\x1a\xfa\x01\n\x0bInitMessage\x12\x11\n\tnamespace\x18\x01 \x01(\t\x12\r\n\x05topic\x18\x02 \x01(\t\x12\x11\n\tpartition\x18\x03 \x01(\x05\x12P\n\rstartPosition\x18\x04 \x01(\x0e\x32\x39.messaging_pb.SubscriberMessage.InitMessage.StartPosition\x12\x13\n\x0btimestampNs\x18\x05 \x01(\x03\x12\x15\n\rsubscriber_id\x18\x06 \x01(\t\"8\n\rStartPosition\x12\n\n\x06LATEST\x10\x00\x12\x0c\n\x08\x45\x41RLIEST\x10\x01\x12\r\n\tTIMESTAMP\x10\x02\x1a \n\nAckMessage\x12\x12\n\nmessage_id\x18\x01 \x01(\x03\"\xb3\x01\n\x07Message\x12\x15\n\revent_time_ns\x18\x01 \x01(\x03\x12\x0b\n\x03key\x18\x02 \x01(\x0c\x12\r\n\x05value\x18\x03 \x01(\x0c\x12\x33\n\x07headers\x18\x04 \x03(\x0b\x32\".messaging_pb.Message.HeadersEntry\x12\x10\n\x08is_close\x18\x05 \x01(\x08\x1a.\n\x0cHeadersEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x0c:\x02\x38\x01\"4\n\rBrokerMessage\x12#\n\x04\x64\x61ta\x18\x01 \x01(\x0b\x32\x15.messaging_pb.Message\"\xb1\x01\n\x0ePublishRequest\x12\x36\n\x04init\x18\x01 \x01(\x0b\x32(.messaging_pb.PublishRequest.InitMessage\x12#\n\x04\x64\x61ta\x18\x02 \x01(\x0b\x32\x15.messaging_pb.Message\x1a\x42\n\x0bInitMessage\x12\x11\n\tnamespace\x18\x01 \x01(\t\x12\r\n\x05topic\x18\x02 \x01(\t\x12\x11\n\tpartition\x18\x03 \x01(\x05\"\xf3\x01\n\x0fPublishResponse\x12;\n\x06\x63onfig\x18\x01 \x01(\x0b\x32+.messaging_pb.PublishResponse.ConfigMessage\x12?\n\x08redirect\x18\x02 \x01(\x0b\x32-.messaging_pb.PublishResponse.RedirectMessage\x12\x11\n\tis_closed\x18\x03 \x01(\x08\x1a(\n\rConfigMessage\x12\x17\n\x0fpartition_count\x18\x01 \x01(\x05\x1a%\n\x0fRedirectMessage\x12\x12\n\nnew_broker\x18\x01 \x01(\t\"6\n\x12\x44\x65leteTopicRequest\x12\x11\n\tnamespace\x18\x01 \x01(\t\x12\r\n\x05topic\x18\x02 \x01(\t\"\x15\n\x13\x44\x65leteTopicResponse\"r\n\x15\x43onfigureTopicRequest\x12\x11\n\tnamespace\x18\x01 \x01(\t\x12\r\n\x05topic\x18\x02 \x01(\t\x12\x37\n\rconfiguration\x18\x03 \x01(\x0b\x32 .messaging_pb.TopicConfiguration\"\x18\n\x16\x43onfigureTopicResponse\"@\n\x1cGetTopicConfigurationRequest\x12\x11\n\tnamespace\x18\x01 \x01(\t\x12\r\n\x05topic\x18\x02 \x01(\t\"X\n\x1dGetTopicConfigurationResponse\x12\x37\n\rconfiguration\x18\x01 \x01(\x0b\x32 .messaging_pb.TopicConfiguration\"G\n\x11\x46indBrokerRequest\x12\x11\n\tnamespace\x18\x01 \x01(\t\x12\r\n\x05topic\x18\x02 \x01(\t\x12\x10\n\x08parition\x18\x03 \x01(\x05\"$\n\x12\x46indBrokerResponse\x12\x0e\n\x06\x62roker\x18\x01 \x01(\t\"\xf1\x01\n\x12TopicConfiguration\x12\x17\n\x0fpartition_count\x18\x01 \x01(\x05\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x13\n\x0breplication\x18\x03 \x01(\t\x12\x14\n\x0cis_transient\x18\x04 \x01(\x08\x12\x42\n\x0bpartitoning\x18\x05 \x01(\x0e\x32-.messaging_pb.TopicConfiguration.Partitioning\"?\n\x0cPartitioning\x12\x12\n\x0eNonNullKeyHash\x10\x00\x12\x0b\n\x07KeyHash\x10\x01\x12\x0e\n\nRoundRobin\x10\x02\x32\xad\x04\n\x10SeaweedMessaging\x12O\n\tSubscribe\x12\x1f.messaging_pb.SubscriberMessage\x1a\x1b.messaging_pb.BrokerMessage\"\x00(\x01\x30\x01\x12L\n\x07Publish\x12\x1c.messaging_pb.PublishRequest\x1a\x1d.messaging_pb.PublishResponse\"\x00(\x01\x30\x01\x12T\n\x0b\x44\x65leteTopic\x12 .messaging_pb.DeleteTopicRequest\x1a!.messaging_pb.DeleteTopicResponse\"\x00\x12]\n\x0e\x43onfigureTopic\x12#.messaging_pb.ConfigureTopicRequest\x1a$.messaging_pb.ConfigureTopicResponse\"\x00\x12r\n\x15GetTopicConfiguration\x12*.messaging_pb.GetTopicConfigurationRequest\x1a+.messaging_pb.GetTopicConfigurationResponse\"\x00\x12Q\n\nFindBroker\x12\x1f.messaging_pb.FindBrokerRequest\x1a .messaging_pb.FindBrokerResponse\"\x00\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'messaging_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _MESSAGE_HEADERSENTRY._options = None
  _MESSAGE_HEADERSENTRY._serialized_options = b'8\001'
  _SUBSCRIBERMESSAGE._serialized_start=34
  _SUBSCRIBERMESSAGE._serialized_end=474
  _SUBSCRIBERMESSAGE_INITMESSAGE._serialized_start=190
  _SUBSCRIBERMESSAGE_INITMESSAGE._serialized_end=440
  _SUBSCRIBERMESSAGE_INITMESSAGE_STARTPOSITION._serialized_start=384
  _SUBSCRIBERMESSAGE_INITMESSAGE_STARTPOSITION._serialized_end=440
  _SUBSCRIBERMESSAGE_ACKMESSAGE._serialized_start=442
  _SUBSCRIBERMESSAGE_ACKMESSAGE._serialized_end=474
  _MESSAGE._serialized_start=477
  _MESSAGE._serialized_end=656
  _MESSAGE_HEADERSENTRY._serialized_start=610
  _MESSAGE_HEADERSENTRY._serialized_end=656
  _BROKERMESSAGE._serialized_start=658
  _BROKERMESSAGE._serialized_end=710
  _PUBLISHREQUEST._serialized_start=713
  _PUBLISHREQUEST._serialized_end=890
  _PUBLISHREQUEST_INITMESSAGE._serialized_start=190
  _PUBLISHREQUEST_INITMESSAGE._serialized_end=256
  _PUBLISHRESPONSE._serialized_start=893
  _PUBLISHRESPONSE._serialized_end=1136
  _PUBLISHRESPONSE_CONFIGMESSAGE._serialized_start=1057
  _PUBLISHRESPONSE_CONFIGMESSAGE._serialized_end=1097
  _PUBLISHRESPONSE_REDIRECTMESSAGE._serialized_start=1099
  _PUBLISHRESPONSE_REDIRECTMESSAGE._serialized_end=1136
  _DELETETOPICREQUEST._serialized_start=1138
  _DELETETOPICREQUEST._serialized_end=1192
  _DELETETOPICRESPONSE._serialized_start=1194
  _DELETETOPICRESPONSE._serialized_end=1215
  _CONFIGURETOPICREQUEST._serialized_start=1217
  _CONFIGURETOPICREQUEST._serialized_end=1331
  _CONFIGURETOPICRESPONSE._serialized_start=1333
  _CONFIGURETOPICRESPONSE._serialized_end=1357
  _GETTOPICCONFIGURATIONREQUEST._serialized_start=1359
  _GETTOPICCONFIGURATIONREQUEST._serialized_end=1423
  _GETTOPICCONFIGURATIONRESPONSE._serialized_start=1425
  _GETTOPICCONFIGURATIONRESPONSE._serialized_end=1513
  _FINDBROKERREQUEST._serialized_start=1515
  _FINDBROKERREQUEST._serialized_end=1586
  _FINDBROKERRESPONSE._serialized_start=1588
  _FINDBROKERRESPONSE._serialized_end=1624
  _TOPICCONFIGURATION._serialized_start=1627
  _TOPICCONFIGURATION._serialized_end=1868
  _TOPICCONFIGURATION_PARTITIONING._serialized_start=1805
  _TOPICCONFIGURATION_PARTITIONING._serialized_end=1868
  _SEAWEEDMESSAGING._serialized_start=1871
  _SEAWEEDMESSAGING._serialized_end=2428
# @@protoc_insertion_point(module_scope)
