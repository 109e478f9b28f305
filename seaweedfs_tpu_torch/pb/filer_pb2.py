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




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0b\x66iler.proto\x12\x08\x66iler_pb\">\n\x1bLookupDirectoryEntryRequest\x12\x11\n\tdirectory\x18\x01 \x01(\t\x12\x0c\n\x04name\x18\x02 \x01(\t\">\n\x1cLookupDirectoryEntryResponse\x12\x1e\n\x05\x65ntry\x18\x01 \x01(\x0b\x32\x0f.filer_pb.Entry\"}\n\x12ListEntriesRequest\x12\x11\n\tdirectory\x18\x01 \x01(\t\x12\x0e\n\x06prefix\x18\x02 \x01(\t\x12\x19\n\x11startFromFileName\x18\x03 \x01(\t\x12\x1a\n\x12inclusiveStartFrom\x18\x04 \x01(\x08\x12\r\n\x05limit\x18\x05 \x01(\r\"5\n\x13ListEntriesResponse\x12\x1e\n\x05\x65ntry\x18\x01 \x01(\x0b\x32\x0f.filer_pb.Entry\"\x91\x02\n\x05\x45ntry\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x14\n\x0cis_directory\x18\x02 \x01(\x08\x12#\n\x06\x63hunks\x18\x03 \x03(\x0b\x32\x13.filer_pb.FileChunk\x12,\n\nattributes\x18\x04 \x01(\x0b\x32\x18.filer_pb.FuseAttributes\x12/\n\x08\x65xtended\x18\x05 \x03(\x0b\x32\x1d.filer_pb.Entry.ExtendedEntry\x12\x14\n\x0chard_link_id\x18\x07 \x01(\x0c\x12\x19\n\x11hard_link_counter\x18\x08 \x01(\x05\x1a/\n\rExtendedEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x0c:\x02\x38\x01\"\xbe\x01\n\x11\x45ventNotification\x12\"\n\told_entry\x18\x01 \x01(\x0b\x32\x0f.filer_pb.Entry\x12\"\n\tnew_entry\x18\x02 \x01(\x0b\x32\x0f.filer_pb.Entry\x12\x15\n\rdelete_chunks\x18\x03 \x01(\x08\x12\x17\n\x0fnew_parent_path\x18\x04 \x01(\t\x12\x1d\n\x15is_from_other_cluster\x18\x05 \x01(\x08\x12\x12\n\nsignatures\x18\x06 \x03(\x05\"\xfb\x01\n\tFileChunk\x12\x0f\n\x07\x66ile_id\x18\x01 \x01(\t\x12\x0e\n\x06offset\x18\x02 \x01(\x03\x12\x0c\n\x04size\x18\x03 \x01(\x04\x12\r\n\x05mtime\x18\x04 \x01(\x03\x12\r\n\x05\x65_tag\x18\x05 \x01(\t\x12\x16\n\x0esource_file_id\x18\x06 \x01(\t\x12\x1d\n\x03\x66id\x18\x07 \x01(\x0b\x32\x10.filer_pb.FileId\x12$\n\nsource_fid\x18\x08 \x01(\x0b\x32\x10.filer_pb.FileId\x12\x12\n\ncipher_key\x18\t \x01(\x0c\x12\x15\n\ris_compressed\x18\n \x01(\x08\x12\x19\n\x11is_chunk_manifest\x18\x0b \x01(\x08\"=\n\x06\x46ileId\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x10\n\x08\x66ile_key\x18\x02 \x01(\x04\x12\x0e\n\x06\x63ookie\x18\x03 \x01(\x07\"\x83\x02\n\x0e\x46useAttributes\x12\x11\n\tfile_size\x18\x01 \x01(\x04\x12\r\n\x05mtime\x18\x02 \x01(\x03\x12\x11\n\tfile_mode\x18\x03 \x01(\r\x12\x0b\n\x03uid\x18\x04 \x01(\r\x12\x0b\n\x03gid\x18\x05 \x01(\r\x12\x0e\n\x06\x63rtime\x18\x06 \x01(\x03\x12\x0c\n\x04mime\x18\x07 \x01(\t\x12\x13\n\x0breplication\x18\x08 \x01(\t\x12\x12\n\ncollection\x18\t \x01(\t\x12\x0f\n\x07ttl_sec\x18\n \x01(\x05\x12\x11\n\tuser_name\x18\x0b \x01(\t\x12\x12\n\ngroup_name\x18\x0c \x03(\t\x12\x16\n\x0esymlink_target\x18\r \x01(\t\x12\x0b\n\x03md5\x18\x0e \x01(\x0c\"\x8a\x01\n\x12\x43reateEntryRequest\x12\x11\n\tdirectory\x18\x01 \x01(\t\x12\x1e\n\x05\x65ntry\x18\x02 \x01(\x0b\x32\x0f.filer_pb.Entry\x12\x0e\n\x06o_excl\x18\x03 \x01(\x08\x12\x1d\n\x15is_from_other_cluster\x18\x04 \x01(\x08\x12\x12\n\nsignatures\x18\x05 \x03(\x05\"$\n\x13\x43reateEntryResponse\x12\r\n\x05\x65rror\x18\x01 \x01(\t\"z\n\x12UpdateEntryRequest\x12\x11\n\tdirectory\x18\x01 \x01(\t\x12\x1e\n\x05\x65ntry\x18\x02 \x01(\x0b\x32\x0f.filer_pb.Entry\x12\x1d\n\x15is_from_other_cluster\x18\x03 \x01(\x08\x12\x12\n\nsignatures\x18\x04 \x03(\x05\"\x15\n\x13UpdateEntryResponse\"b\n\x14\x41ppendToEntryRequest\x12\x11\n\tdirectory\x18\x01 \x01(\t\x12\x12\n\nentry_name\x18\x02 \x01(\t\x12#\n\x06\x63hunks\x18\x03 \x03(\x0b\x32\x13.filer_pb.FileChunk\"\x17\n\x15\x41ppendToEntryResponse\"\xb6\x01\n\x12\x44\x65leteEntryRequest\x12\x11\n\tdirectory\x18\x01 \x01(\t\x12\x0c\n\x04name\x18\x02 \x01(\t\x12\x16\n\x0eis_delete_data\x18\x04 \x01(\x08\x12\x14\n\x0cis_recursive\x18\x05 \x01(\x08\x12\x1e\n\x16ignore_recursive_error\x18\x06 \x01(\x08\x12\x1d\n\x15is_from_other_cluster\x18\x07 \x01(\x08\x12\x12\n\nsignatures\x18\x08 \x03(\x05\"$\n\x13\x44\x65leteEntryResponse\x12\r\n\x05\x65rror\x18\x01 \x01(\t\"l\n\x18\x41tomicRenameEntryRequest\x12\x15\n\rold_directory\x18\x01 \x01(\t\x12\x10\n\x08old_name\x18\x02 \x01(\t\x12\x15\n\rnew_directory\x18\x03 \x01(\t\x12\x10\n\x08new_name\x18\x04 \x01(\t\"\x1b\n\x19\x41tomicRenameEntryResponse\"\x96\x01\n\x13\x41ssignVolumeRequest\x12\r\n\x05\x63ount\x18\x01 \x01(\x05\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x13\n\x0breplication\x18\x03 \x01(\t\x12\x0f\n\x07ttl_sec\x18\x04 \x01(\x05\x12\x13\n\x0b\x64\x61ta_center\x18\x05 \x01(\t\x12\x13\n\x0bparent_path\x18\x06 \x01(\t\x12\x0c\n\x04rack\x18\x07 \x01(\t\"\x9d\x01\n\x14\x41ssignVolumeResponse\x12\x0f\n\x07\x66ile_id\x18\x01 \x01(\t\x12\x0b\n\x03url\x18\x02 \x01(\t\x12\x12\n\npublic_url\x18\x03 \x01(\t\x12\r\n\x05\x63ount\x18\x04 \x01(\x05\x12\x0c\n\x04\x61uth\x18\x05 \x01(\t\x12\x12\n\ncollection\x18\x06 \x01(\t\x12\x13\n\x0breplication\x18\x07 \x01(\t\x12\r\n\x05\x65rror\x18\x08 \x01(\t\")\n\x13LookupVolumeRequest\x12\x12\n\nvolume_ids\x18\x01 \x03(\t\"2\n\tLocations\x12%\n\tlocations\x18\x01 \x03(\x0b\x32\x12.filer_pb.Location\"+\n\x08Location\x12\x0b\n\x03url\x18\x01 \x01(\t\x12\x12\n\npublic_url\x18\x02 \x01(\t\"\xa9\x01\n\x14LookupVolumeResponse\x12G\n\rlocations_map\x18\x01 \x03(\x0b\x32\x30.filer_pb.LookupVolumeResponse.LocationsMapEntry\x1aH\n\x11LocationsMapEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\"\n\x05value\x18\x02 \x01(\x0b\x32\x13.filer_pb.Locations:\x02\x38\x01\"\x1a\n\nCollection\x12\x0c\n\x04name\x18\x01 \x01(\t\"S\n\x15\x43ollectionListRequest\x12\x1e\n\x16include_normal_volumes\x18\x01 \x01(\x08\x12\x1a\n\x12include_ec_volumes\x18\x02 \x01(\x08\"C\n\x16\x43ollectionListResponse\x12)\n\x0b\x63ollections\x18\x01 \x03(\x0b\x32\x14.filer_pb.Collection\"-\n\x17\x44\x65leteCollectionRequest\x12\x12\n\ncollection\x18\x01 \x01(\t\"\x1a\n\x18\x44\x65leteCollectionResponse\"I\n\x11StatisticsRequest\x12\x13\n\x0breplication\x18\x01 \x01(\t\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x0b\n\x03ttl\x18\x03 \x01(\t\"\x85\x01\n\x12StatisticsResponse\x12\x13\n\x0breplication\x18\x01 \x01(\t\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x0b\n\x03ttl\x18\x03 \x01(\t\x12\x12\n\ntotal_size\x18\x04 \x01(\x04\x12\x11\n\tused_size\x18\x05 \x01(\x04\x12\x12\n\nfile_count\x18\x06 \x01(\x04\"\x1e\n\x1cGetFilerConfigurationRequest\"\xd8\x01\n\x1dGetFilerConfigurationResponse\x12\x0f\n\x07masters\x18\x01 \x03(\t\x12\x13\n\x0breplication\x18\x02 \x01(\t\x12\x12\n\ncollection\x18\x03 \x01(\t\x12\x0e\n\x06max_mb\x18\x04 \x01(\r\x12\x13\n\x0b\x64ir_buckets\x18\x05 \x01(\t\x12\x0e\n\x06\x63ipher\x18\x07 \x01(\x08\x12\x11\n\tsignature\x18\x08 \x01(\x05\x12\x17\n\x0fmetrics_address\x18\t \x01(\t\x12\x1c\n\x14metrics_interval_sec\x18\n \x01(\x05\"i\n\x18SubscribeMetadataRequest\x12\x13\n\x0b\x63lient_name\x18\x01 \x01(\t\x12\x13\n\x0bpath_prefix\x18\x02 \x01(\t\x12\x10\n\x08since_ns\x18\x03 \x01(\x03\x12\x11\n\tsignature\x18\x04 \x01(\x05\"v\n\x19SubscribeMetadataResponse\x12\x11\n\tdirectory\x18\x01 \x01(\t\x12\x37\n\x12\x65vent_notification\x18\x02 \x01(\x0b\x32\x1b.filer_pb.EventNotification\x12\r\n\x05ts_ns\x18\x03 \x01(\x03\"J\n\x14KeepConnectedRequest\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x11\n\tgrpc_port\x18\x02 \x01(\r\x12\x11\n\tresources\x18\x03 \x03(\t\"\x17\n\x15KeepConnectedResponse\"\'\n\x13LocateBrokerRequest\x12\x10\n\x08resource\x18\x01 \x01(\t\"\x9d\x01\n\x14LocateBrokerResponse\x12\r\n\x05\x66ound\x18\x01 \x01(\x08\x12:\n\tresources\x18\x02 \x03(\x0b\x32\'.filer_pb.LocateBrokerResponse.Resource\x1a:\n\x08Resource\x12\x16\n\x0egrpc_addresses\x18\x01 \x01(\t\x12\x16\n\x0eresource_count\x18\x02 \x01(\x05\"\x1b\n\x0cKvGetRequest\x12\x0b\n\x03key\x18\x01 \x01(\x0c\"-\n\rKvGetResponse\x12\r\n\x05value\x18\x01 \x01(\x0c\x12\r\n\x05\x65rror\x18\x02 \x01(\t\"*\n\x0cKvPutRequest\x12\x0b\n\x03key\x18\x01 \x01(\x0c\x12\r\n\x05value\x18\x02 \x01(\x0c\"\x1e\n\rKvPutResponse\x12\r\n\x05\x65rror\x18\x01 \x01(\t2\xdc\x0c\n\x0cSeaweedFiler\x12g\n\x14LookupDirectoryEntry\x12%.filer_pb.LookupDirectoryEntryRequest\x1a&.filer_pb.LookupDirectoryEntryResponse\"\x00\x12N\n\x0bListEntries\x12\x1c.filer_pb.ListEntriesRequest\x1a\x1d.filer_pb.ListEntriesResponse\"\x00\x30\x01\x12L\n\x0b\x43reateEntry\x12\x1c.filer_pb.CreateEntryRequest\x1a\x1d.filer_pb.CreateEntryResponse\"\x00\x12L\n\x0bUpdateEntry\x12\x1c.filer_pb.UpdateEntryRequest\x1a\x1d.filer_pb.UpdateEntryResponse\"\x00\x12R\n\rAppendToEntry\x12\x1e.filer_pb.AppendToEntryRequest\x1a\x1f.filer_pb.AppendToEntryResponse\"\x00\x12L\n\x0b\x44\x65leteEntry\x12\x1c.filer_pb.DeleteEntryRequest\x1a\x1d.filer_pb.DeleteEntryResponse\"\x00\x12^\n\x11\x41tomicRenameEntry\x12\".filer_pb.AtomicRenameEntryRequest\x1a#.filer_pb.AtomicRenameEntryResponse\"\x00\x12O\n\x0c\x41ssignVolume\x12\x1d.filer_pb.AssignVolumeRequest\x1a\x1e.filer_pb.AssignVolumeResponse\"\x00\x12O\n\x0cLookupVolume\x12\x1d.filer_pb.LookupVolumeRequest\x1a\x1e.filer_pb.LookupVolumeResponse\"\x00\x12U\n\x0e\x43ollectionList\x12\x1f.filer_pb.CollectionListRequest\x1a .filer_pb.CollectionListResponse\"\x00\x12[\n\x10\x44\x65leteCollection\x12!.filer_pb.DeleteCollectionRequest\x1a\".filer_pb.DeleteCollectionResponse\"\x00\x12I\n\nStatistics\x12\x1b.filer_pb.StatisticsRequest\x1a\x1c.filer_pb.StatisticsResponse\"\x00\x12j\n\x15GetFilerConfiguration\x12&.filer_pb.GetFilerConfigurationRequest\x1a\'.filer_pb.GetFilerConfigurationResponse\"\x00\x12`\n\x11SubscribeMetadata\x12\".filer_pb.SubscribeMetadataRequest\x1a#.filer_pb.SubscribeMetadataResponse\"\x00\x30\x01\x12\x65\n\x16SubscribeLocalMetadata\x12\".filer_pb.SubscribeMetadataRequest\x1a#.filer_pb.SubscribeMetadataResponse\"\x00\x30\x01\x12V\n\rKeepConnected\x12\x1e.filer_pb.KeepConnectedRequest\x1a\x1f.filer_pb.KeepConnectedResponse\"\x00(\x01\x30\x01\x12O\n\x0cLocateBroker\x12\x1d.filer_pb.LocateBrokerRequest\x1a\x1e.filer_pb.LocateBrokerResponse\"\x00\x12:\n\x05KvGet\x12\x16.filer_pb.KvGetRequest\x1a\x17.filer_pb.KvGetResponse\"\x00\x12:\n\x05KvPut\x12\x16.filer_pb.KvPutRequest\x1a\x17.filer_pb.KvPutResponse\"\x00\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'filer_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _ENTRY_EXTENDEDENTRY._options = None
  _ENTRY_EXTENDEDENTRY._serialized_options = b'8\001'
  _LOOKUPVOLUMERESPONSE_LOCATIONSMAPENTRY._options = None
  _LOOKUPVOLUMERESPONSE_LOCATIONSMAPENTRY._serialized_options = b'8\001'
  _LOOKUPDIRECTORYENTRYREQUEST._serialized_start=25
  _LOOKUPDIRECTORYENTRYREQUEST._serialized_end=87
  _LOOKUPDIRECTORYENTRYRESPONSE._serialized_start=89
  _LOOKUPDIRECTORYENTRYRESPONSE._serialized_end=151
  _LISTENTRIESREQUEST._serialized_start=153
  _LISTENTRIESREQUEST._serialized_end=278
  _LISTENTRIESRESPONSE._serialized_start=280
  _LISTENTRIESRESPONSE._serialized_end=333
  _ENTRY._serialized_start=336
  _ENTRY._serialized_end=609
  _ENTRY_EXTENDEDENTRY._serialized_start=562
  _ENTRY_EXTENDEDENTRY._serialized_end=609
  _EVENTNOTIFICATION._serialized_start=612
  _EVENTNOTIFICATION._serialized_end=802
  _FILECHUNK._serialized_start=805
  _FILECHUNK._serialized_end=1056
  _FILEID._serialized_start=1058
  _FILEID._serialized_end=1119
  _FUSEATTRIBUTES._serialized_start=1122
  _FUSEATTRIBUTES._serialized_end=1381
  _CREATEENTRYREQUEST._serialized_start=1384
  _CREATEENTRYREQUEST._serialized_end=1522
  _CREATEENTRYRESPONSE._serialized_start=1524
  _CREATEENTRYRESPONSE._serialized_end=1560
  _UPDATEENTRYREQUEST._serialized_start=1562
  _UPDATEENTRYREQUEST._serialized_end=1684
  _UPDATEENTRYRESPONSE._serialized_start=1686
  _UPDATEENTRYRESPONSE._serialized_end=1707
  _APPENDTOENTRYREQUEST._serialized_start=1709
  _APPENDTOENTRYREQUEST._serialized_end=1807
  _APPENDTOENTRYRESPONSE._serialized_start=1809
  _APPENDTOENTRYRESPONSE._serialized_end=1832
  _DELETEENTRYREQUEST._serialized_start=1835
  _DELETEENTRYREQUEST._serialized_end=2017
  _DELETEENTRYRESPONSE._serialized_start=2019
  _DELETEENTRYRESPONSE._serialized_end=2055
  _ATOMICRENAMEENTRYREQUEST._serialized_start=2057
  _ATOMICRENAMEENTRYREQUEST._serialized_end=2165
  _ATOMICRENAMEENTRYRESPONSE._serialized_start=2167
  _ATOMICRENAMEENTRYRESPONSE._serialized_end=2194
  _ASSIGNVOLUMEREQUEST._serialized_start=2197
  _ASSIGNVOLUMEREQUEST._serialized_end=2347
  _ASSIGNVOLUMERESPONSE._serialized_start=2350
  _ASSIGNVOLUMERESPONSE._serialized_end=2507
  _LOOKUPVOLUMEREQUEST._serialized_start=2509
  _LOOKUPVOLUMEREQUEST._serialized_end=2550
  _LOCATIONS._serialized_start=2552
  _LOCATIONS._serialized_end=2602
  _LOCATION._serialized_start=2604
  _LOCATION._serialized_end=2647
  _LOOKUPVOLUMERESPONSE._serialized_start=2650
  _LOOKUPVOLUMERESPONSE._serialized_end=2819
  _LOOKUPVOLUMERESPONSE_LOCATIONSMAPENTRY._serialized_start=2747
  _LOOKUPVOLUMERESPONSE_LOCATIONSMAPENTRY._serialized_end=2819
  _COLLECTION._serialized_start=2821
  _COLLECTION._serialized_end=2847
  _COLLECTIONLISTREQUEST._serialized_start=2849
  _COLLECTIONLISTREQUEST._serialized_end=2932
  _COLLECTIONLISTRESPONSE._serialized_start=2934
  _COLLECTIONLISTRESPONSE._serialized_end=3001
  _DELETECOLLECTIONREQUEST._serialized_start=3003
  _DELETECOLLECTIONREQUEST._serialized_end=3048
  _DELETECOLLECTIONRESPONSE._serialized_start=3050
  _DELETECOLLECTIONRESPONSE._serialized_end=3076
  _STATISTICSREQUEST._serialized_start=3078
  _STATISTICSREQUEST._serialized_end=3151
  _STATISTICSRESPONSE._serialized_start=3154
  _STATISTICSRESPONSE._serialized_end=3287
  _GETFILERCONFIGURATIONREQUEST._serialized_start=3289
  _GETFILERCONFIGURATIONREQUEST._serialized_end=3319
  _GETFILERCONFIGURATIONRESPONSE._serialized_start=3322
  _GETFILERCONFIGURATIONRESPONSE._serialized_end=3538
  _SUBSCRIBEMETADATAREQUEST._serialized_start=3540
  _SUBSCRIBEMETADATAREQUEST._serialized_end=3645
  _SUBSCRIBEMETADATARESPONSE._serialized_start=3647
  _SUBSCRIBEMETADATARESPONSE._serialized_end=3765
  _KEEPCONNECTEDREQUEST._serialized_start=3767
  _KEEPCONNECTEDREQUEST._serialized_end=3841
  _KEEPCONNECTEDRESPONSE._serialized_start=3843
  _KEEPCONNECTEDRESPONSE._serialized_end=3866
  _LOCATEBROKERREQUEST._serialized_start=3868
  _LOCATEBROKERREQUEST._serialized_end=3907
  _LOCATEBROKERRESPONSE._serialized_start=3910
  _LOCATEBROKERRESPONSE._serialized_end=4067
  _LOCATEBROKERRESPONSE_RESOURCE._serialized_start=4009
  _LOCATEBROKERRESPONSE_RESOURCE._serialized_end=4067
  _KVGETREQUEST._serialized_start=4069
  _KVGETREQUEST._serialized_end=4096
  _KVGETRESPONSE._serialized_start=4098
  _KVGETRESPONSE._serialized_end=4143
  _KVPUTREQUEST._serialized_start=4145
  _KVPUTREQUEST._serialized_end=4187
  _KVPUTRESPONSE._serialized_start=4189
  _KVPUTRESPONSE._serialized_end=4219
  _SEAWEEDFILER._serialized_start=4222
  _SEAWEEDFILER._serialized_end=5850
# @@protoc_insertion_point(module_scope)
