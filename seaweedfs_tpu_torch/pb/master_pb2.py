# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: master.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0cmaster.proto\x12\tmaster_pb\"\xd3\x04\n\tHeartbeat\x12\n\n\x02ip\x18\x01 \x01(\t\x12\x0c\n\x04port\x18\x02 \x01(\r\x12\x12\n\npublic_url\x18\x03 \x01(\t\x12\x18\n\x10max_volume_count\x18\x04 \x01(\r\x12\x14\n\x0cmax_file_key\x18\x05 \x01(\x04\x12\x13\n\x0b\x64\x61ta_center\x18\x06 \x01(\t\x12\x0c\n\x04rack\x18\x07 \x01(\t\x12\x12\n\nadmin_port\x18\x08 \x01(\r\x12\x34\n\x07volumes\x18\t \x03(\x0b\x32#.master_pb.VolumeInformationMessage\x12=\n\x0bnew_volumes\x18\n \x03(\x0b\x32(.master_pb.VolumeShortInformationMessage\x12\x41\n\x0f\x64\x65leted_volumes\x18\x0b \x03(\x0b\x32(.master_pb.VolumeShortInformationMessage\x12\x16\n\x0ehas_no_volumes\x18\x0c \x01(\x08\x12=\n\tec_shards\x18\x10 \x03(\x0b\x32*.master_pb.VolumeEcShardInformationMessage\x12\x41\n\rnew_ec_shards\x18\x11 \x03(\x0b\x32*.master_pb.VolumeEcShardInformationMessage\x12\x45\n\x11\x64\x65leted_ec_shards\x18\x12 \x03(\x0b\x32*.master_pb.VolumeEcShardInformationMessage\x12\x18\n\x10has_no_ec_shards\x18\x13 \x01(\x08\"\xae\x01\n\x11HeartbeatResponse\x12\x19\n\x11volume_size_limit\x18\x01 \x01(\x04\x12\x0e\n\x06leader\x18\x02 \x01(\t\x12\x17\n\x0fmetrics_address\x18\x03 \x01(\t\x12 \n\x18metrics_interval_seconds\x18\x04 \x01(\r\x12\x33\n\x10storage_backends\x18\x05 \x03(\x0b\x32\x19.master_pb.StorageBackend\"\xc9\x02\n\x18VolumeInformationMessage\x12\n\n\x02id\x18\x01 \x01(\r\x12\x0c\n\x04size\x18\x02 \x01(\x04\x12\x12\n\ncollection\x18\x03 \x01(\t\x12\x12\n\nfile_count\x18\x04 \x01(\x04\x12\x14\n\x0c\x64\x65lete_count\x18\x05 \x01(\x04\x12\x1a\n\x12\x64\x65leted_byte_count\x18\x06 \x01(\x04\x12\x11\n\tread_only\x18\x07 \x01(\x08\x12\x19\n\x11replica_placement\x18\x08 \x01(\r\x12\x0f\n\x07version\x18\t \x01(\r\x12\x0b\n\x03ttl\x18\n \x01(\r\x12\x18\n\x10\x63ompact_revision\x18\x0b \x01(\r\x12\x1a\n\x12modified_at_second\x18\x0c \x01(\x03\x12\x1b\n\x13remote_storage_name\x18\r \x01(\t\x12\x1a\n\x12remote_storage_key\x18\x0e \x01(\t\"x\n\x1dVolumeShortInformationMessage\x12\n\n\x02id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x03 \x01(\t\x12\x19\n\x11replica_placement\x18\x08 \x01(\r\x12\x0f\n\x07version\x18\t \x01(\r\x12\x0b\n\x03ttl\x18\n \x01(\r\"X\n\x1fVolumeEcShardInformationMessage\x12\n\n\x02id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x15\n\rec_index_bits\x18\x03 \x01(\r\"\x9c\x01\n\x0eStorageBackend\x12\x0c\n\x04type\x18\x01 \x01(\t\x12\n\n\x02id\x18\x02 \x01(\t\x12=\n\nproperties\x18\x03 \x03(\x0b\x32).master_pb.StorageBackend.PropertiesEntry\x1a\x31\n\x0fPropertiesEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"7\n\x14KeepConnectedRequest\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x11\n\tgrpc_port\x18\x02 \x01(\r\"i\n\x0eVolumeLocation\x12\x0b\n\x03url\x18\x01 \x01(\t\x12\x12\n\npublic_url\x18\x02 \x01(\t\x12\x10\n\x08new_vids\x18\x03 \x03(\r\x12\x14\n\x0c\x64\x65leted_vids\x18\x04 \x03(\r\x12\x0e\n\x06leader\x18\x05 \x01(\t\"=\n\x13LookupVolumeRequest\x12\x12\n\nvolume_ids\x18\x01 \x03(\t\x12\x12\n\ncollection\x18\x02 \x01(\t\"\xc3\x01\n\x14LookupVolumeResponse\x12M\n\x13volume_id_locations\x18\x01 \x03(\x0b\x32\x30.master_pb.LookupVolumeResponse.VolumeIdLocation\x1a\\\n\x10VolumeIdLocation\x12\x11\n\tvolume_id\x18\x01 \x01(\t\x12&\n\tlocations\x18\x02 \x03(\x0b\x32\x13.master_pb.Location\x12\r\n\x05\x65rror\x18\x03 \x01(\t\"+\n\x08Location\x12\x0b\n\x03url\x18\x01 \x01(\t\x12\x12\n\npublic_url\x18\x02 \x01(\t\"\xc9\x01\n\rAssignRequest\x12\r\n\x05\x63ount\x18\x01 \x01(\x04\x12\x13\n\x0breplication\x18\x02 \x01(\t\x12\x12\n\ncollection\x18\x03 \x01(\t\x12\x0b\n\x03ttl\x18\x04 \x01(\t\x12\x13\n\x0b\x64\x61ta_center\x18\x05 \x01(\t\x12\x0c\n\x04rack\x18\x06 \x01(\t\x12\x11\n\tdata_node\x18\x07 \x01(\t\x12\x1e\n\x16memory_map_max_size_mb\x18\x08 \x01(\r\x12\x1d\n\x15Writable_volume_count\x18\t \x01(\r\"j\n\x0e\x41ssignResponse\x12\x0b\n\x03\x66id\x18\x01 \x01(\t\x12\x0b\n\x03url\x18\x02 \x01(\t\x12\x12\n\npublic_url\x18\x03 \x01(\t\x12\r\n\x05\x63ount\x18\x04 \x01(\x04\x12\r\n\x05\x65rror\x18\x05 \x01(\t\x12\x0c\n\x04\x61uth\x18\x06 \x01(\t\"I\n\x11StatisticsRequest\x12\x13\n\x0breplication\x18\x01 \x01(\t\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x0b\n\x03ttl\x18\x03 \x01(\t\"\x85\x01\n\x12StatisticsResponse\x12\x13\n\x0breplication\x18\x01 \x01(\t\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x0b\n\x03ttl\x18\x03 \x01(\t\x12\x12\n\ntotal_size\x18\x04 \x01(\x04\x12\x11\n\tused_size\x18\x05 \x01(\x04\x12\x12\n\nfile_count\x18\x06 \x01(\x04\"\x1a\n\nCollection\x12\x0c\n\x04name\x18\x01 \x01(\t\"S\n\x15\x43ollectionListRequest\x12\x1e\n\x16include_normal_volumes\x18\x01 \x01(\x08\x12\x1a\n\x12include_ec_volumes\x18\x02 \x01(\x08\"D\n\x16\x43ollectionListResponse\x12*\n\x0b\x63ollections\x18\x01 \x03(\x0b\x32\x15.master_pb.Collection\"\'\n\x17\x43ollectionDeleteRequest\x12\x0c\n\x04name\x18\x01 \x01(\t\"\x1a\n\x18\x43ollectionDeleteResponse\"\x9e\x02\n\x0c\x44\x61taNodeInfo\x12\n\n\x02id\x18\x01 \x01(\t\x12\x14\n\x0cvolume_count\x18\x02 \x01(\x04\x12\x18\n\x10max_volume_count\x18\x03 \x01(\x04\x12\x19\n\x11\x66ree_volume_count\x18\x04 \x01(\x04\x12\x1b\n\x13\x61\x63tive_volume_count\x18\x05 \x01(\x04\x12\x39\n\x0cvolume_infos\x18\x06 \x03(\x0b\x32#.master_pb.VolumeInformationMessage\x12\x42\n\x0e\x65\x63_shard_infos\x18\x07 \x03(\x0b\x32*.master_pb.VolumeEcShardInformationMessage\x12\x1b\n\x13remote_volume_count\x18\x08 \x01(\x04\"\xcd\x01\n\x08RackInfo\x12\n\n\x02id\x18\x01 \x01(\t\x12\x14\n\x0cvolume_count\x18\x02 \x01(\x04\x12\x18\n\x10max_volume_count\x18\x03 \x01(\x04\x12\x19\n\x11\x66ree_volume_count\x18\x04 \x01(\x04\x12\x1b\n\x13\x61\x63tive_volume_count\x18\x05 \x01(\x04\x12\x30\n\x0f\x64\x61ta_node_infos\x18\x06 \x03(\x0b\x32\x17.master_pb.DataNodeInfo\x12\x1b\n\x13remote_volume_count\x18\x07 \x01(\x04\"\xca\x01\n\x0e\x44\x61taCenterInfo\x12\n\n\x02id\x18\x01 \x01(\t\x12\x14\n\x0cvolume_count\x18\x02 \x01(\x04\x12\x18\n\x10max_volume_count\x18\x03 \x01(\x04\x12\x19\n\x11\x66ree_volume_count\x18\x04 \x01(\x04\x12\x1b\n\x13\x61\x63tive_volume_count\x18\x05 \x01(\x04\x12\'\n\nrack_infos\x18\x06 \x03(\x0b\x32\x13.master_pb.RackInfo\x12\x1b\n\x13remote_volume_count\x18\x07 \x01(\x04\"\xd5\x01\n\x0cTopologyInfo\x12\n\n\x02id\x18\x01 \x01(\t\x12\x14\n\x0cvolume_count\x18\x02 \x01(\x04\x12\x18\n\x10max_volume_count\x18\x03 \x01(\x04\x12\x19\n\x11\x66ree_volume_count\x18\x04 \x01(\x04\x12\x1b\n\x13\x61\x63tive_volume_count\x18\x05 \x01(\x04\x12\x34\n\x11\x64\x61ta_center_infos\x18\x06 \x03(\x0b\x32\x19.master_pb.DataCenterInfo\x12\x1b\n\x13remote_volume_count\x18\x07 \x01(\x04\"\x13\n\x11VolumeListRequest\"b\n\x12VolumeListResponse\x12.\n\rtopology_info\x18\x01 \x01(\x0b\x32\x17.master_pb.TopologyInfo\x12\x1c\n\x14volume_size_limit_mb\x18\x02 \x01(\x04\"*\n\x15LookupEcVolumeRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\"\xcb\x01\n\x16LookupEcVolumeResponse\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12O\n\x12shard_id_locations\x18\x02 \x03(\x0b\x32\x33.master_pb.LookupEcVolumeResponse.EcShardIdLocation\x1aM\n\x11\x45\x63ShardIdLocation\x12\x10\n\x08shard_id\x18\x01 \x01(\r\x12&\n\tlocations\x18\x02 \x03(\x0b\x32\x13.master_pb.Location\"\x1f\n\x1dGetMasterConfigurationRequest\"\xbd\x01\n\x1eGetMasterConfigurationResponse\x12\x17\n\x0fmetrics_address\x18\x01 \x01(\t\x12 \n\x18metrics_interval_seconds\x18\x02 \x01(\r\x12\x33\n\x10storage_backends\x18\x03 \x03(\x0b\x32\x19.master_pb.StorageBackend\x12\x1b\n\x13\x64\x65\x66\x61ult_replication\x18\x04 \x01(\t\x12\x0e\n\x06leader\x18\x05 \x01(\t\"/\n\x18ListMasterClientsRequest\x12\x13\n\x0b\x63lient_type\x18\x01 \x01(\t\"3\n\x19ListMasterClientsResponse\x12\x16\n\x0egrpc_addresses\x18\x01 \x03(\t\"_\n\x16LeaseAdminTokenRequest\x12\x16\n\x0eprevious_token\x18\x01 \x01(\x03\x12\x1a\n\x12previous_lock_time\x18\x02 \x01(\x03\x12\x11\n\tlock_name\x18\x03 \x01(\t\"<\n\x17LeaseAdminTokenResponse\x12\r\n\x05token\x18\x01 \x01(\x03\x12\x12\n\nlock_ts_ns\x18\x02 \x01(\x03\"a\n\x18ReleaseAdminTokenRequest\x12\x16\n\x0eprevious_token\x18\x01 \x01(\x03\x12\x1a\n\x12previous_lock_time\x18\x02 \x01(\x03\x12\x11\n\tlock_name\x18\x03 \x01(\t\"\x1b\n\x19ReleaseAdminTokenResponse2\xf7\x08\n\x07Seaweed\x12I\n\rSendHeartbeat\x12\x14.master_pb.Heartbeat\x1a\x1c.master_pb.HeartbeatResponse\"\x00(\x01\x30\x01\x12Q\n\rKeepConnected\x12\x1f.master_pb.KeepConnectedRequest\x1a\x19.master_pb.VolumeLocation\"\x00(\x01\x30\x01\x12Q\n\x0cLookupVolume\x12\x1e.master_pb.LookupVolumeRequest\x1a\x1f.master_pb.LookupVolumeResponse\"\x00\x12?\n\x06\x41ssign\x12\x18.master_pb.AssignRequest\x1a\x19.master_pb.AssignResponse\"\x00\x12K\n\nStatistics\x12\x1c.master_pb.StatisticsRequest\x1a\x1d.master_pb.StatisticsResponse\"\x00\x12W\n\x0e\x43ollectionList\x12 .master_pb.CollectionListRequest\x1a!.master_pb.CollectionListResponse\"\x00\x12]\n\x10\x43ollectionDelete\x12\".master_pb.CollectionDeleteRequest\x1a#.master_pb.CollectionDeleteResponse\"\x00\x12K\n\nVolumeList\x12\x1c.master_pb.VolumeListRequest\x1a\x1d.master_pb.VolumeListResponse\"\x00\x12W\n\x0eLookupEcVolume\x12 .master_pb.LookupEcVolumeRequest\x1a!.master_pb.LookupEcVolumeResponse\"\x00\x12o\n\x16GetMasterConfiguration\x12(.master_pb.GetMasterConfigurationRequest\x1a).master_pb.GetMasterConfigurationResponse\"\x00\x12`\n\x11ListMasterClients\x12#.master_pb.ListMasterClientsRequest\x1a$.master_pb.ListMasterClientsResponse\"\x00\x12Z\n\x0fLeaseAdminToken\x12!.master_pb.LeaseAdminTokenRequest\x1a\".master_pb.LeaseAdminTokenResponse\"\x00\x12`\n\x11ReleaseAdminToken\x12#.master_pb.ReleaseAdminTokenRequest\x1a$.master_pb.ReleaseAdminTokenResponse\"\x00\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'master_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _STORAGEBACKEND_PROPERTIESENTRY._options = None
  _STORAGEBACKEND_PROPERTIESENTRY._serialized_options = b'8\001'
  _HEARTBEAT._serialized_start=28
  _HEARTBEAT._serialized_end=623
  _HEARTBEATRESPONSE._serialized_start=626
  _HEARTBEATRESPONSE._serialized_end=800
  _VOLUMEINFORMATIONMESSAGE._serialized_start=803
  _VOLUMEINFORMATIONMESSAGE._serialized_end=1132
  _VOLUMESHORTINFORMATIONMESSAGE._serialized_start=1134
  _VOLUMESHORTINFORMATIONMESSAGE._serialized_end=1254
  _VOLUMEECSHARDINFORMATIONMESSAGE._serialized_start=1256
  _VOLUMEECSHARDINFORMATIONMESSAGE._serialized_end=1344
  _STORAGEBACKEND._serialized_start=1347
  _STORAGEBACKEND._serialized_end=1503
  _STORAGEBACKEND_PROPERTIESENTRY._serialized_start=1454
  _STORAGEBACKEND_PROPERTIESENTRY._serialized_end=1503
  _KEEPCONNECTEDREQUEST._serialized_start=1505
  _KEEPCONNECTEDREQUEST._serialized_end=1560
  _VOLUMELOCATION._serialized_start=1562
  _VOLUMELOCATION._serialized_end=1667
  _LOOKUPVOLUMEREQUEST._serialized_start=1669
  _LOOKUPVOLUMEREQUEST._serialized_end=1730
  _LOOKUPVOLUMERESPONSE._serialized_start=1733
  _LOOKUPVOLUMERESPONSE._serialized_end=1928
  _LOOKUPVOLUMERESPONSE_VOLUMEIDLOCATION._serialized_start=1836
  _LOOKUPVOLUMERESPONSE_VOLUMEIDLOCATION._serialized_end=1928
  _LOCATION._serialized_start=1930
  _LOCATION._serialized_end=1973
  _ASSIGNREQUEST._serialized_start=1976
  _ASSIGNREQUEST._serialized_end=2177
  _ASSIGNRESPONSE._serialized_start=2179
  _ASSIGNRESPONSE._serialized_end=2285
  _STATISTICSREQUEST._serialized_start=2287
  _STATISTICSREQUEST._serialized_end=2360
  _STATISTICSRESPONSE._serialized_start=2363
  _STATISTICSRESPONSE._serialized_end=2496
  _COLLECTION._serialized_start=2498
  _COLLECTION._serialized_end=2524
  _COLLECTIONLISTREQUEST._serialized_start=2526
  _COLLECTIONLISTREQUEST._serialized_end=2609
  _COLLECTIONLISTRESPONSE._serialized_start=2611
  _COLLECTIONLISTRESPONSE._serialized_end=2679
  _COLLECTIONDELETEREQUEST._serialized_start=2681
  _COLLECTIONDELETEREQUEST._serialized_end=2720
  _COLLECTIONDELETERESPONSE._serialized_start=2722
  _COLLECTIONDELETERESPONSE._serialized_end=2748
  _DATANODEINFO._serialized_start=2751
  _DATANODEINFO._serialized_end=3037
  _RACKINFO._serialized_start=3040
  _RACKINFO._serialized_end=3245
  _DATACENTERINFO._serialized_start=3248
  _DATACENTERINFO._serialized_end=3450
  _TOPOLOGYINFO._serialized_start=3453
  _TOPOLOGYINFO._serialized_end=3666
  _VOLUMELISTREQUEST._serialized_start=3668
  _VOLUMELISTREQUEST._serialized_end=3687
  _VOLUMELISTRESPONSE._serialized_start=3689
  _VOLUMELISTRESPONSE._serialized_end=3787
  _LOOKUPECVOLUMEREQUEST._serialized_start=3789
  _LOOKUPECVOLUMEREQUEST._serialized_end=3831
  _LOOKUPECVOLUMERESPONSE._serialized_start=3834
  _LOOKUPECVOLUMERESPONSE._serialized_end=4037
  _LOOKUPECVOLUMERESPONSE_ECSHARDIDLOCATION._serialized_start=3960
  _LOOKUPECVOLUMERESPONSE_ECSHARDIDLOCATION._serialized_end=4037
  _GETMASTERCONFIGURATIONREQUEST._serialized_start=4039
  _GETMASTERCONFIGURATIONREQUEST._serialized_end=4070
  _GETMASTERCONFIGURATIONRESPONSE._serialized_start=4073
  _GETMASTERCONFIGURATIONRESPONSE._serialized_end=4262
  _LISTMASTERCLIENTSREQUEST._serialized_start=4264
  _LISTMASTERCLIENTSREQUEST._serialized_end=4311
  _LISTMASTERCLIENTSRESPONSE._serialized_start=4313
  _LISTMASTERCLIENTSRESPONSE._serialized_end=4364
  _LEASEADMINTOKENREQUEST._serialized_start=4366
  _LEASEADMINTOKENREQUEST._serialized_end=4461
  _LEASEADMINTOKENRESPONSE._serialized_start=4463
  _LEASEADMINTOKENRESPONSE._serialized_end=4523
  _RELEASEADMINTOKENREQUEST._serialized_start=4525
  _RELEASEADMINTOKENREQUEST._serialized_end=4622
  _RELEASEADMINTOKENRESPONSE._serialized_start=4624
  _RELEASEADMINTOKENRESPONSE._serialized_end=4651
  _SEAWEED._serialized_start=4654
  _SEAWEED._serialized_end=5797
# @@protoc_insertion_point(module_scope)
