# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: volume_server.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x13volume_server.proto\x12\x10volume_server_pb\"A\n\x12\x42\x61tchDeleteRequest\x12\x10\n\x08\x66ile_ids\x18\x01 \x03(\t\x12\x19\n\x11skip_cookie_check\x18\x02 \x01(\x08\"F\n\x13\x42\x61tchDeleteResponse\x12/\n\x07results\x18\x01 \x03(\x0b\x32\x1e.volume_server_pb.DeleteResult\"]\n\x0c\x44\x65leteResult\x12\x0f\n\x07\x66ile_id\x18\x01 \x01(\t\x12\x0e\n\x06status\x18\x02 \x01(\x05\x12\r\n\x05\x65rror\x18\x03 \x01(\t\x12\x0c\n\x04size\x18\x04 \x01(\r\x12\x0f\n\x07version\x18\x05 \x01(\r\"-\n\x18VacuumVolumeCheckRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\"2\n\x19VacuumVolumeCheckResponse\x12\x15\n\rgarbage_ratio\x18\x01 \x01(\x01\"D\n\x1aVacuumVolumeCompactRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x13\n\x0bpreallocate\x18\x02 \x01(\x03\"\x1d\n\x1bVacuumVolumeCompactResponse\".\n\x19VacuumVolumeCommitRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\"2\n\x1aVacuumVolumeCommitResponse\x12\x14\n\x0cis_read_only\x18\x01 \x01(\x08\"/\n\x1aVacuumVolumeCleanupRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\"\x1d\n\x1bVacuumVolumeCleanupResponse\"-\n\x17\x44\x65leteCollectionRequest\x12\x12\n\ncollection\x18\x01 \x01(\t\"\x1a\n\x18\x44\x65leteCollectionResponse\"\x95\x01\n\x15\x41llocateVolumeRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x13\n\x0bpreallocate\x18\x03 \x01(\x03\x12\x13\n\x0breplication\x18\x04 \x01(\t\x12\x0b\n\x03ttl\x18\x05 \x01(\t\x12\x1e\n\x16memory_map_max_size_mb\x18\x06 \x01(\r\"\x18\n\x16\x41llocateVolumeResponse\",\n\x17VolumeSyncStatusRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\"\xa9\x01\n\x18VolumeSyncStatusResponse\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x13\n\x0breplication\x18\x04 \x01(\t\x12\x0b\n\x03ttl\x18\x05 \x01(\t\x12\x13\n\x0btail_offset\x18\x06 \x01(\x04\x12\x18\n\x10\x63ompact_revision\x18\x07 \x01(\r\x12\x15\n\ridx_file_size\x18\x08 \x01(\x04\"C\n\x1cVolumeIncrementalCopyRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x10\n\x08since_ns\x18\x02 \x01(\x04\"5\n\x1dVolumeIncrementalCopyResponse\x12\x14\n\x0c\x66ile_content\x18\x01 \x01(\x0c\"\'\n\x12VolumeMountRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\"\x15\n\x13VolumeMountResponse\")\n\x14VolumeUnmountRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\"\x17\n\x15VolumeUnmountResponse\"(\n\x13VolumeDeleteRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\"\x16\n\x14VolumeDeleteResponse\".\n\x19VolumeMarkReadonlyRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\"\x1c\n\x1aVolumeMarkReadonlyResponse\".\n\x19VolumeMarkWritableRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\"\x1c\n\x1aVolumeMarkWritableResponse\"@\n\x16VolumeConfigureRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x13\n\x0breplication\x18\x02 \x01(\t\"(\n\x17VolumeConfigureResponse\x12\r\n\x05\x65rror\x18\x01 \x01(\t\"(\n\x13VolumeStatusRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\",\n\x14VolumeStatusResponse\x12\x14\n\x0cis_read_only\x18\x01 \x01(\x08\"v\n\x11VolumeCopyRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x13\n\x0breplication\x18\x03 \x01(\t\x12\x0b\n\x03ttl\x18\x04 \x01(\t\x12\x18\n\x10source_data_node\x18\x05 \x01(\t\"/\n\x12VolumeCopyResponse\x12\x19\n\x11last_append_at_ns\x18\x01 \x01(\x04\"\xb3\x01\n\x0f\x43opyFileRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x0b\n\x03\x65xt\x18\x02 \x01(\t\x12\x1b\n\x13\x63ompaction_revision\x18\x03 \x01(\r\x12\x13\n\x0bstop_offset\x18\x04 \x01(\x04\x12\x12\n\ncollection\x18\x05 \x01(\t\x12\x14\n\x0cis_ec_volume\x18\x06 \x01(\x08\x12$\n\x1cignore_source_file_not_found\x18\x07 \x01(\x08\"(\n\x10\x43opyFileResponse\x12\x14\n\x0c\x66ile_content\x18\x01 \x01(\x0c\"\\\n\x17VolumeTailSenderRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x10\n\x08since_ns\x18\x02 \x01(\x04\x12\x1c\n\x14idle_timeout_seconds\x18\x03 \x01(\r\"]\n\x18VolumeTailSenderResponse\x12\x15\n\rneedle_header\x18\x01 \x01(\x0c\x12\x13\n\x0bneedle_body\x18\x02 \x01(\x0c\x12\x15\n\ris_last_chunk\x18\x03 \x01(\x08\"|\n\x19VolumeTailReceiverRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x10\n\x08since_ns\x18\x02 \x01(\x04\x12\x1c\n\x14idle_timeout_seconds\x18\x03 \x01(\r\x12\x1c\n\x14source_volume_server\x18\x04 \x01(\t\"\x1c\n\x1aVolumeTailReceiverResponse\"F\n\x1dVolumeEcShardsGenerateRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\" \n\x1eVolumeEcShardsGenerateResponse\"E\n\x1cVolumeEcShardsRebuildRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\":\n\x1dVolumeEcShardsRebuildResponse\x12\x19\n\x11rebuilt_shard_ids\x18\x01 \x03(\r\"\xb4\x01\n\x19VolumeEcShardsCopyRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x11\n\tshard_ids\x18\x03 \x03(\r\x12\x15\n\rcopy_ecx_file\x18\x04 \x01(\x08\x12\x18\n\x10source_data_node\x18\x05 \x01(\t\x12\x15\n\rcopy_ecj_file\x18\x06 \x01(\x08\x12\x15\n\rcopy_vif_file\x18\x07 \x01(\x08\"\x1c\n\x1aVolumeEcShardsCopyResponse\"W\n\x1bVolumeEcShardsDeleteRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x11\n\tshard_ids\x18\x03 \x03(\r\"\x1e\n\x1cVolumeEcShardsDeleteResponse\"V\n\x1aVolumeEcShardsMountRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x11\n\tshard_ids\x18\x03 \x03(\r\"\x1d\n\x1bVolumeEcShardsMountResponse\"D\n\x1cVolumeEcShardsUnmountRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x11\n\tshard_ids\x18\x03 \x03(\r\"\x1f\n\x1dVolumeEcShardsUnmountResponse\"o\n\x18VolumeEcShardReadRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x10\n\x08shard_id\x18\x02 \x01(\r\x12\x0e\n\x06offset\x18\x03 \x01(\x03\x12\x0c\n\x04size\x18\x04 \x01(\x03\x12\x10\n\x08\x66ile_key\x18\x05 \x01(\x04\"=\n\x19VolumeEcShardReadResponse\x12\x0c\n\x04\x64\x61ta\x18\x01 \x01(\x0c\x12\x12\n\nis_deleted\x18\x02 \x01(\x08\"e\n\x19VolumeEcBlobDeleteRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x10\n\x08\x66ile_key\x18\x03 \x01(\x04\x12\x0f\n\x07version\x18\x04 \x01(\r\"\x1c\n\x1aVolumeEcBlobDeleteResponse\"F\n\x1dVolumeEcShardsToVolumeRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\" \n\x1eVolumeEcShardsToVolumeResponse\"0\n\x1bReadVolumeFileStatusRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\"\xec\x01\n\x1cReadVolumeFileStatusResponse\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\"\n\x1aidx_file_timestamp_seconds\x18\x02 \x01(\x04\x12\x15\n\ridx_file_size\x18\x03 \x01(\x04\x12\"\n\x1a\x64\x61t_file_timestamp_seconds\x18\x04 \x01(\x04\x12\x15\n\rdat_file_size\x18\x05 \x01(\x04\x12\x12\n\nfile_count\x18\x06 \x01(\x04\x12\x1b\n\x13\x63ompaction_revision\x18\x07 \x01(\r\x12\x12\n\ncollection\x18\x08 \x01(\t\"n\n\nDiskStatus\x12\x0b\n\x03\x64ir\x18\x01 \x01(\t\x12\x0b\n\x03\x61ll\x18\x02 \x01(\x04\x12\x0c\n\x04used\x18\x03 \x01(\x04\x12\x0c\n\x04\x66ree\x18\x04 \x01(\x04\x12\x14\n\x0cpercent_free\x18\x05 \x01(\x02\x12\x14\n\x0cpercent_used\x18\x06 \x01(\x02\"s\n\tMemStatus\x12\x12\n\ngoroutines\x18\x01 \x01(\x05\x12\x0b\n\x03\x61ll\x18\x02 \x01(\x04\x12\x0c\n\x04used\x18\x03 \x01(\x04\x12\x0c\n\x04\x66ree\x18\x04 \x01(\x04\x12\x0c\n\x04self\x18\x05 \x01(\x04\x12\x0c\n\x04heap\x18\x06 \x01(\x04\x12\r\n\x05stack\x18\x07 \x01(\x04\"\x88\x01\n VolumeTierMoveDatToRemoteRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12 \n\x18\x64\x65stination_backend_name\x18\x03 \x01(\t\x12\x1b\n\x13keep_local_dat_file\x18\x04 \x01(\x08\"S\n!VolumeTierMoveDatToRemoteResponse\x12\x11\n\tprocessed\x18\x01 \x01(\x03\x12\x1b\n\x13processedPercentage\x18\x02 \x01(\x02\"i\n\"VolumeTierMoveDatFromRemoteRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x1c\n\x14keep_remote_dat_file\x18\x03 \x01(\x08\"U\n#VolumeTierMoveDatFromRemoteResponse\x12\x11\n\tprocessed\x18\x01 \x01(\x03\x12\x1b\n\x13processedPercentage\x18\x02 \x01(\x02\"\x1b\n\x19VolumeServerStatusRequest\"\x85\x01\n\x1aVolumeServerStatusResponse\x12\x33\n\rdisk_statuses\x18\x01 \x03(\x0b\x32\x1c.volume_server_pb.DiskStatus\x12\x32\n\rmemory_status\x18\x02 \x01(\x0b\x32\x1b.volume_server_pb.MemStatus\"\x1a\n\x18VolumeServerLeaveRequest\"\x1b\n\x19VolumeServerLeaveResponse\"A\n\x19VolumeNeedleStatusRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x11\n\tneedle_id\x18\x02 \x01(\x04\"~\n\x1aVolumeNeedleStatusResponse\x12\x11\n\tneedle_id\x18\x01 \x01(\x04\x12\x0e\n\x06\x63ookie\x18\x02 \x01(\r\x12\x0c\n\x04size\x18\x03 \x01(\r\x12\x15\n\rlast_modified\x18\x04 \x01(\x04\x12\x0b\n\x03\x63rc\x18\x05 \x01(\r\x12\x0b\n\x03ttl\x18\x06 \x01(\t\"\xe2\t\n\x0cQueryRequest\x12\x12\n\nselections\x18\x01 \x03(\t\x12\x15\n\rfrom_file_ids\x18\x02 \x03(\t\x12\x35\n\x06\x66ilter\x18\x03 \x01(\x0b\x32%.volume_server_pb.QueryRequest.Filter\x12N\n\x13input_serialization\x18\x04 \x01(\x0b\x32\x31.volume_server_pb.QueryRequest.InputSerialization\x12P\n\x14output_serialization\x18\x05 \x01(\x0b\x32\x32.volume_server_pb.QueryRequest.OutputSerialization\x1a\x37\n\x06\x46ilter\x12\r\n\x05\x66ield\x18\x01 \x01(\t\x12\x0f\n\x07operand\x18\x02 \x01(\t\x12\r\n\x05value\x18\x03 \x01(\t\x1a\x9d\x04\n\x12InputSerialization\x12\x18\n\x10\x63ompression_type\x18\x01 \x01(\t\x12M\n\tcsv_input\x18\x02 \x01(\x0b\x32:.volume_server_pb.QueryRequest.InputSerialization.CSVInput\x12O\n\njson_input\x18\x03 \x01(\x0b\x32;.volume_server_pb.QueryRequest.InputSerialization.JSONInput\x12U\n\rparquet_input\x18\x04 \x01(\x0b\x32>.volume_server_pb.QueryRequest.InputSerialization.ParquetInput\x1a\xca\x01\n\x08\x43SVInput\x12\x18\n\x10\x66ile_header_info\x18\x01 \x01(\t\x12\x18\n\x10record_delimiter\x18\x02 \x01(\t\x12\x17\n\x0f\x66ield_delimiter\x18\x03 \x01(\t\x12\x18\n\x10quote_charactoer\x18\x04 \x01(\t\x12\x1e\n\x16quote_escape_character\x18\x05 \x01(\t\x12\x10\n\x08\x63omments\x18\x06 \x01(\t\x12%\n\x1d\x61llow_quoted_record_delimiter\x18\x07 \x01(\x08\x1a\x19\n\tJSONInput\x12\x0c\n\x04type\x18\x01 \x01(\t\x1a\x0e\n\x0cParquetInput\x1a\xf4\x02\n\x13OutputSerialization\x12P\n\ncsv_output\x18\x02 \x01(\x0b\x32<.volume_server_pb.QueryRequest.OutputSerialization.CSVOutput\x12R\n\x0bjson_output\x18\x03 \x01(\x0b\x32=.volume_server_pb.QueryRequest.OutputSerialization.JSONOutput\x1a\x8e\x01\n\tCSVOutput\x12\x14\n\x0cquote_fields\x18\x01 \x01(\t\x12\x18\n\x10record_delimiter\x18\x02 \x01(\t\x12\x17\n\x0f\x66ield_delimiter\x18\x03 \x01(\t\x12\x18\n\x10quote_charactoer\x18\x04 \x01(\t\x12\x1e\n\x16quote_escape_character\x18\x05 \x01(\t\x1a&\n\nJSONOutput\x12\x18\n\x10record_delimiter\x18\x01 \x01(\t\" \n\rQueriedStripe\x12\x0f\n\x07records\x18\x01 \x01(\x0c\x32\xd8\x1f\n\x0cVolumeServer\x12\\\n\x0b\x42\x61tchDelete\x12$.volume_server_pb.BatchDeleteRequest\x1a%.volume_server_pb.BatchDeleteResponse\"\x00\x12n\n\x11VacuumVolumeCheck\x12*.volume_server_pb.VacuumVolumeCheckRequest\x1a+.volume_server_pb.VacuumVolumeCheckResponse\"\x00\x12t\n\x13VacuumVolumeCompact\x12,.volume_server_pb.VacuumVolumeCompactRequest\x1a-.volume_server_pb.VacuumVolumeCompactResponse\"\x00\x12q\n\x12VacuumVolumeCommit\x12+.volume_server_pb.VacuumVolumeCommitRequest\x1a,.volume_server_pb.VacuumVolumeCommitResponse\"\x00\x12t\n\x13VacuumVolumeCleanup\x12,.volume_server_pb.VacuumVolumeCleanupRequest\x1a-.volume_server_pb.VacuumVolumeCleanupResponse\"\x00\x12k\n\x10\x44\x65leteCollection\x12).volume_server_pb.DeleteCollectionRequest\x1a*.volume_server_pb.DeleteCollectionResponse\"\x00\x12\x65\n\x0e\x41llocateVolume\x12\'.volume_server_pb.AllocateVolumeRequest\x1a(.volume_server_pb.AllocateVolumeResponse\"\x00\x12k\n\x10VolumeSyncStatus\x12).volume_server_pb.VolumeSyncStatusRequest\x1a*.volume_server_pb.VolumeSyncStatusResponse\"\x00\x12|\n\x15VolumeIncrementalCopy\x12..volume_server_pb.VolumeIncrementalCopyRequest\x1a/.volume_server_pb.VolumeIncrementalCopyResponse\"\x00\x30\x01\x12\\\n\x0bVolumeMount\x12$.volume_server_pb.VolumeMountRequest\x1a%.volume_server_pb.VolumeMountResponse\"\x00\x12\x62\n\rVolumeUnmount\x12&.volume_server_pb.VolumeUnmountRequest\x1a\'.volume_server_pb.VolumeUnmountResponse\"\x00\x12_\n\x0cVolumeDelete\x12%.volume_server_pb.VolumeDeleteRequest\x1a&.volume_server_pb.VolumeDeleteResponse\"\x00\x12q\n\x12VolumeMarkReadonly\x12+.volume_server_pb.VolumeMarkReadonlyRequest\x1a,.volume_server_pb.VolumeMarkReadonlyResponse\"\x00\x12q\n\x12VolumeMarkWritable\x12+.volume_server_pb.VolumeMarkWritableRequest\x1a,.volume_server_pb.VolumeMarkWritableResponse\"\x00\x12h\n\x0fVolumeConfigure\x12(.volume_server_pb.VolumeConfigureRequest\x1a).volume_server_pb.VolumeConfigureResponse\"\x00\x12_\n\x0cVolumeStatus\x12%.volume_server_pb.VolumeStatusRequest\x1a&.volume_server_pb.VolumeStatusResponse\"\x00\x12Y\n\nVolumeCopy\x12#.volume_server_pb.VolumeCopyRequest\x1a$.volume_server_pb.VolumeCopyResponse\"\x00\x12w\n\x14ReadVolumeFileStatus\x12-.volume_server_pb.ReadVolumeFileStatusRequest\x1a..volume_server_pb.ReadVolumeFileStatusResponse\"\x00\x12U\n\x08\x43opyFile\x12!.volume_server_pb.CopyFileRequest\x1a\".volume_server_pb.CopyFileResponse\"\x00\x30\x01\x12m\n\x10VolumeTailSender\x12).volume_server_pb.VolumeTailSenderRequest\x1a*.volume_server_pb.VolumeTailSenderResponse\"\x00\x30\x01\x12q\n\x12VolumeTailReceiver\x12+.volume_server_pb.VolumeTailReceiverRequest\x1a,.volume_server_pb.VolumeTailReceiverResponse\"\x00\x12}\n\x16VolumeEcShardsGenerate\x12/.volume_server_pb.VolumeEcShardsGenerateRequest\x1a\x30.volume_server_pb.VolumeEcShardsGenerateResponse\"\x00\x12z\n\x15VolumeEcShardsRebuild\x12..volume_server_pb.VolumeEcShardsRebuildRequest\x1a/.volume_server_pb.VolumeEcShardsRebuildResponse\"\x00\x12q\n\x12VolumeEcShardsCopy\x12+.volume_server_pb.VolumeEcShardsCopyRequest\x1a,.volume_server_pb.VolumeEcShardsCopyResponse\"\x00\x12w\n\x14VolumeEcShardsDelete\x12-.volume_server_pb.VolumeEcShardsDeleteRequest\x1a..volume_server_pb.VolumeEcShardsDeleteResponse\"\x00\x12t\n\x13VolumeEcShardsMount\x12,.volume_server_pb.VolumeEcShardsMountRequest\x1a-.volume_server_pb.VolumeEcShardsMountResponse\"\x00\x12z\n\x15VolumeEcShardsUnmount\x12..volume_server_pb.VolumeEcShardsUnmountRequest\x1a/.volume_server_pb.VolumeEcShardsUnmountResponse\"\x00\x12p\n\x11VolumeEcShardRead\x12*.volume_server_pb.VolumeEcShardReadRequest\x1a+.volume_server_pb.VolumeEcShardReadResponse\"\x00\x30\x01\x12q\n\x12VolumeEcBlobDelete\x12+.volume_server_pb.VolumeEcBlobDeleteRequest\x1a,.volume_server_pb.VolumeEcBlobDeleteResponse\"\x00\x12}\n\x16VolumeEcShardsToVolume\x12/.volume_server_pb.VolumeEcShardsToVolumeRequest\x1a\x30.volume_server_pb.VolumeEcShardsToVolumeResponse\"\x00\x12\x88\x01\n\x19VolumeTierMoveDatToRemote\x12\x32.volume_server_pb.VolumeTierMoveDatToRemoteRequest\x1a\x33.volume_server_pb.VolumeTierMoveDatToRemoteResponse\"\x00\x30\x01\x12\x8e\x01\n\x1bVolumeTierMoveDatFromRemote\x12\x34.volume_server_pb.VolumeTierMoveDatFromRemoteRequest\x1a\x35.volume_server_pb.VolumeTierMoveDatFromRemoteResponse\"\x00\x30\x01\x12L\n\x05Query\x12\x1e.volume_server_pb.QueryRequest\x1a\x1f.volume_server_pb.QueriedStripe\"\x00\x30\x01\x12q\n\x12VolumeServerStatus\x12+.volume_server_pb.VolumeServerStatusRequest\x1a,.volume_server_pb.VolumeServerStatusResponse\"\x00\x12n\n\x11VolumeServerLeave\x12*.volume_server_pb.VolumeServerLeaveRequest\x1a+.volume_server_pb.VolumeServerLeaveResponse\"\x00\x12q\n\x12VolumeNeedleStatus\x12+.volume_server_pb.VolumeNeedleStatusRequest\x1a,.volume_server_pb.VolumeNeedleStatusResponse\"\x00\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'volume_server_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _BATCHDELETEREQUEST._serialized_start=41
  _BATCHDELETEREQUEST._serialized_end=106
  _BATCHDELETERESPONSE._serialized_start=108
  _BATCHDELETERESPONSE._serialized_end=178
  _DELETERESULT._serialized_start=180
  _DELETERESULT._serialized_end=273
  _VACUUMVOLUMECHECKREQUEST._serialized_start=275
  _VACUUMVOLUMECHECKREQUEST._serialized_end=320
  _VACUUMVOLUMECHECKRESPONSE._serialized_start=322
  _VACUUMVOLUMECHECKRESPONSE._serialized_end=372
  _VACUUMVOLUMECOMPACTREQUEST._serialized_start=374
  _VACUUMVOLUMECOMPACTREQUEST._serialized_end=442
  _VACUUMVOLUMECOMPACTRESPONSE._serialized_start=444
  _VACUUMVOLUMECOMPACTRESPONSE._serialized_end=473
  _VACUUMVOLUMECOMMITREQUEST._serialized_start=475
  _VACUUMVOLUMECOMMITREQUEST._serialized_end=521
  _VACUUMVOLUMECOMMITRESPONSE._serialized_start=523
  _VACUUMVOLUMECOMMITRESPONSE._serialized_end=573
  _VACUUMVOLUMECLEANUPREQUEST._serialized_start=575
  _VACUUMVOLUMECLEANUPREQUEST._serialized_end=622
  _VACUUMVOLUMECLEANUPRESPONSE._serialized_start=624
  _VACUUMVOLUMECLEANUPRESPONSE._serialized_end=653
  _DELETECOLLECTIONREQUEST._serialized_start=655
  _DELETECOLLECTIONREQUEST._serialized_end=700
  _DELETECOLLECTIONRESPONSE._serialized_start=702
  _DELETECOLLECTIONRESPONSE._serialized_end=728
  _ALLOCATEVOLUMEREQUEST._serialized_start=731
  _ALLOCATEVOLUMEREQUEST._serialized_end=880
  _ALLOCATEVOLUMERESPONSE._serialized_start=882
  _ALLOCATEVOLUMERESPONSE._serialized_end=906
  _VOLUMESYNCSTATUSREQUEST._serialized_start=908
  _VOLUMESYNCSTATUSREQUEST._serialized_end=952
  _VOLUMESYNCSTATUSRESPONSE._serialized_start=955
  _VOLUMESYNCSTATUSRESPONSE._serialized_end=1124
  _VOLUMEINCREMENTALCOPYREQUEST._serialized_start=1126
  _VOLUMEINCREMENTALCOPYREQUEST._serialized_end=1193
  _VOLUMEINCREMENTALCOPYRESPONSE._serialized_start=1195
  _VOLUMEINCREMENTALCOPYRESPONSE._serialized_end=1248
  _VOLUMEMOUNTREQUEST._serialized_start=1250
  _VOLUMEMOUNTREQUEST._serialized_end=1289
  _VOLUMEMOUNTRESPONSE._serialized_start=1291
  _VOLUMEMOUNTRESPONSE._serialized_end=1312
  _VOLUMEUNMOUNTREQUEST._serialized_start=1314
  _VOLUMEUNMOUNTREQUEST._serialized_end=1355
  _VOLUMEUNMOUNTRESPONSE._serialized_start=1357
  _VOLUMEUNMOUNTRESPONSE._serialized_end=1380
  _VOLUMEDELETEREQUEST._serialized_start=1382
  _VOLUMEDELETEREQUEST._serialized_end=1422
  _VOLUMEDELETERESPONSE._serialized_start=1424
  _VOLUMEDELETERESPONSE._serialized_end=1446
  _VOLUMEMARKREADONLYREQUEST._serialized_start=1448
  _VOLUMEMARKREADONLYREQUEST._serialized_end=1494
  _VOLUMEMARKREADONLYRESPONSE._serialized_start=1496
  _VOLUMEMARKREADONLYRESPONSE._serialized_end=1524
  _VOLUMEMARKWRITABLEREQUEST._serialized_start=1526
  _VOLUMEMARKWRITABLEREQUEST._serialized_end=1572
  _VOLUMEMARKWRITABLERESPONSE._serialized_start=1574
  _VOLUMEMARKWRITABLERESPONSE._serialized_end=1602
  _VOLUMECONFIGUREREQUEST._serialized_start=1604
  _VOLUMECONFIGUREREQUEST._serialized_end=1668
  _VOLUMECONFIGURERESPONSE._serialized_start=1670
  _VOLUMECONFIGURERESPONSE._serialized_end=1710
  _VOLUMESTATUSREQUEST._serialized_start=1712
  _VOLUMESTATUSREQUEST._serialized_end=1752
  _VOLUMESTATUSRESPONSE._serialized_start=1754
  _VOLUMESTATUSRESPONSE._serialized_end=1798
  _VOLUMECOPYREQUEST._serialized_start=1800
  _VOLUMECOPYREQUEST._serialized_end=1918
  _VOLUMECOPYRESPONSE._serialized_start=1920
  _VOLUMECOPYRESPONSE._serialized_end=1967
  _COPYFILEREQUEST._serialized_start=1970
  _COPYFILEREQUEST._serialized_end=2149
  _COPYFILERESPONSE._serialized_start=2151
  _COPYFILERESPONSE._serialized_end=2191
  _VOLUMETAILSENDERREQUEST._serialized_start=2193
  _VOLUMETAILSENDERREQUEST._serialized_end=2285
  _VOLUMETAILSENDERRESPONSE._serialized_start=2287
  _VOLUMETAILSENDERRESPONSE._serialized_end=2380
  _VOLUMETAILRECEIVERREQUEST._serialized_start=2382
  _VOLUMETAILRECEIVERREQUEST._serialized_end=2506
  _VOLUMETAILRECEIVERRESPONSE._serialized_start=2508
  _VOLUMETAILRECEIVERRESPONSE._serialized_end=2536
  _VOLUMEECSHARDSGENERATEREQUEST._serialized_start=2538
  _VOLUMEECSHARDSGENERATEREQUEST._serialized_end=2608
  _VOLUMEECSHARDSGENERATERESPONSE._serialized_start=2610
  _VOLUMEECSHARDSGENERATERESPONSE._serialized_end=2642
  _VOLUMEECSHARDSREBUILDREQUEST._serialized_start=2644
  _VOLUMEECSHARDSREBUILDREQUEST._serialized_end=2713
  _VOLUMEECSHARDSREBUILDRESPONSE._serialized_start=2715
  _VOLUMEECSHARDSREBUILDRESPONSE._serialized_end=2773
  _VOLUMEECSHARDSCOPYREQUEST._serialized_start=2776
  _VOLUMEECSHARDSCOPYREQUEST._serialized_end=2956
  _VOLUMEECSHARDSCOPYRESPONSE._serialized_start=2958
  _VOLUMEECSHARDSCOPYRESPONSE._serialized_end=2986
  _VOLUMEECSHARDSDELETEREQUEST._serialized_start=2988
  _VOLUMEECSHARDSDELETEREQUEST._serialized_end=3075
  _VOLUMEECSHARDSDELETERESPONSE._serialized_start=3077
  _VOLUMEECSHARDSDELETERESPONSE._serialized_end=3107
  _VOLUMEECSHARDSMOUNTREQUEST._serialized_start=3109
  _VOLUMEECSHARDSMOUNTREQUEST._serialized_end=3195
  _VOLUMEECSHARDSMOUNTRESPONSE._serialized_start=3197
  _VOLUMEECSHARDSMOUNTRESPONSE._serialized_end=3226
  _VOLUMEECSHARDSUNMOUNTREQUEST._serialized_start=3228
  _VOLUMEECSHARDSUNMOUNTREQUEST._serialized_end=3296
  _VOLUMEECSHARDSUNMOUNTRESPONSE._serialized_start=3298
  _VOLUMEECSHARDSUNMOUNTRESPONSE._serialized_end=3329
  _VOLUMEECSHARDREADREQUEST._serialized_start=3331
  _VOLUMEECSHARDREADREQUEST._serialized_end=3442
  _VOLUMEECSHARDREADRESPONSE._serialized_start=3444
  _VOLUMEECSHARDREADRESPONSE._serialized_end=3505
  _VOLUMEECBLOBDELETEREQUEST._serialized_start=3507
  _VOLUMEECBLOBDELETEREQUEST._serialized_end=3608
  _VOLUMEECBLOBDELETERESPONSE._serialized_start=3610
  _VOLUMEECBLOBDELETERESPONSE._serialized_end=3638
  _VOLUMEECSHARDSTOVOLUMEREQUEST._serialized_start=3640
  _VOLUMEECSHARDSTOVOLUMEREQUEST._serialized_end=3710
  _VOLUMEECSHARDSTOVOLUMERESPONSE._serialized_start=3712
  _VOLUMEECSHARDSTOVOLUMERESPONSE._serialized_end=3744
  _READVOLUMEFILESTATUSREQUEST._serialized_start=3746
  _READVOLUMEFILESTATUSREQUEST._serialized_end=3794
  _READVOLUMEFILESTATUSRESPONSE._serialized_start=3797
  _READVOLUMEFILESTATUSRESPONSE._serialized_end=4033
  _DISKSTATUS._serialized_start=4035
  _DISKSTATUS._serialized_end=4145
  _MEMSTATUS._serialized_start=4147
  _MEMSTATUS._serialized_end=4262
  _VOLUMETIERMOVEDATTOREMOTEREQUEST._serialized_start=4265
  _VOLUMETIERMOVEDATTOREMOTEREQUEST._serialized_end=4401
  _VOLUMETIERMOVEDATTOREMOTERESPONSE._serialized_start=4403
  _VOLUMETIERMOVEDATTOREMOTERESPONSE._serialized_end=4486
  _VOLUMETIERMOVEDATFROMREMOTEREQUEST._serialized_start=4488
  _VOLUMETIERMOVEDATFROMREMOTEREQUEST._serialized_end=4593
  _VOLUMETIERMOVEDATFROMREMOTERESPONSE._serialized_start=4595
  _VOLUMETIERMOVEDATFROMREMOTERESPONSE._serialized_end=4680
  _VOLUMESERVERSTATUSREQUEST._serialized_start=4682
  _VOLUMESERVERSTATUSREQUEST._serialized_end=4709
  _VOLUMESERVERSTATUSRESPONSE._serialized_start=4712
  _VOLUMESERVERSTATUSRESPONSE._serialized_end=4845
  _VOLUMESERVERLEAVEREQUEST._serialized_start=4847
  _VOLUMESERVERLEAVEREQUEST._serialized_end=4873
  _VOLUMESERVERLEAVERESPONSE._serialized_start=4875
  _VOLUMESERVERLEAVERESPONSE._serialized_end=4902
  _VOLUMENEEDLESTATUSREQUEST._serialized_start=4904
  _VOLUMENEEDLESTATUSREQUEST._serialized_end=4969
  _VOLUMENEEDLESTATUSRESPONSE._serialized_start=4971
  _VOLUMENEEDLESTATUSRESPONSE._serialized_end=5097
  _QUERYREQUEST._serialized_start=5100
  _QUERYREQUEST._serialized_end=6350
  _QUERYREQUEST_FILTER._serialized_start=5376
  _QUERYREQUEST_FILTER._serialized_end=5431
  _QUERYREQUEST_INPUTSERIALIZATION._serialized_start=5434
  _QUERYREQUEST_INPUTSERIALIZATION._serialized_end=5975
  _QUERYREQUEST_INPUTSERIALIZATION_CSVINPUT._serialized_start=5730
  _QUERYREQUEST_INPUTSERIALIZATION_CSVINPUT._serialized_end=5932
  _QUERYREQUEST_INPUTSERIALIZATION_JSONINPUT._serialized_start=5934
  _QUERYREQUEST_INPUTSERIALIZATION_JSONINPUT._serialized_end=5959
  _QUERYREQUEST_INPUTSERIALIZATION_PARQUETINPUT._serialized_start=5961
  _QUERYREQUEST_INPUTSERIALIZATION_PARQUETINPUT._serialized_end=5975
  _QUERYREQUEST_OUTPUTSERIALIZATION._serialized_start=5978
  _QUERYREQUEST_OUTPUTSERIALIZATION._serialized_end=6350
  _QUERYREQUEST_OUTPUTSERIALIZATION_CSVOUTPUT._serialized_start=6168
  _QUERYREQUEST_OUTPUTSERIALIZATION_CSVOUTPUT._serialized_end=6310
  _QUERYREQUEST_OUTPUTSERIALIZATION_JSONOUTPUT._serialized_start=6312
  _QUERYREQUEST_OUTPUTSERIALIZATION_JSONOUTPUT._serialized_end=6350
  _QUERIEDSTRIPE._serialized_start=6352
  _QUERIEDSTRIPE._serialized_end=6384
  _VOLUMESERVER._serialized_start=6387
  _VOLUMESERVER._serialized_end=10443
# @@protoc_insertion_point(module_scope)
