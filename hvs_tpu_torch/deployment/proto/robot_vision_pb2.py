# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: robot_vision.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x12robot_vision.proto\x12\x07hvs_tpu\"p\n\tDetection\x12\n\n\x02x1\x18\x01 \x01(\x02\x12\n\n\x02y1\x18\x02 \x01(\x02\x12\n\n\x02x2\x18\x03 \x01(\x02\x12\n\n\x02y2\x18\x04 \x01(\x02\x12\r\n\x05score\x18\x05 \x01(\x02\x12\x10\n\x08\x63lass_id\x18\x06 \x01(\x05\x12\x12\n\nclass_name\x18\x07 \x01(\t\"K\n\rDetectRequest\x12\r\n\x05image\x18\x01 \x01(\x0c\x12\x12\n\nrequest_id\x18\x02 \x01(\t\x12\x17\n\x0fscore_threshold\x18\x03 \x01(\x02\"\x9a\x01\n\x0e\x44\x65tectResponse\x12&\n\ndetections\x18\x01 \x03(\x0b\x32\x12.hvs_tpu.Detection\x12\x12\n\nrequest_id\x18\x02 \x01(\t\x12\x12\n\nlatency_ms\x18\x03 \x01(\x02\x12\x14\n\x0cimage_height\x18\x04 \x01(\x05\x12\x13\n\x0bimage_width\x18\x05 \x01(\x05\x12\r\n\x05\x65rror\x18\x06 \x01(\t\"\x85\x01\n\x0e\x43ommandRequest\x12\x0f\n\x07\x63ommand\x18\x01 \x01(\t\x12\x33\n\x06params\x18\x02 \x03(\x0b\x32#.hvs_tpu.CommandRequest.ParamsEntry\x1a-\n\x0bParamsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"\x92\x01\n\x0f\x43ommandResponse\x12\x0f\n\x07success\x18\x01 \x01(\x08\x12\x0f\n\x07message\x18\x02 \x01(\t\x12\x30\n\x04\x64\x61ta\x18\x03 \x03(\x0b\x32\".hvs_tpu.CommandResponse.DataEntry\x1a+\n\tDataEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\x32\xa6\x02\n\x12RobotVisionService\x12?\n\x0c\x44\x65tectSingle\x12\x16.hvs_tpu.DetectRequest\x1a\x17.hvs_tpu.DetectResponse\x12\x42\n\x0b\x44\x65tectBatch\x12\x16.hvs_tpu.DetectRequest\x1a\x17.hvs_tpu.DetectResponse(\x01\x30\x01\x12G\n\x10StreamDetections\x12\x16.hvs_tpu.DetectRequest\x1a\x17.hvs_tpu.DetectResponse(\x01\x30\x01\x12\x42\n\rHandleCommand\x12\x17.hvs_tpu.CommandRequest\x1a\x18.hvs_tpu.CommandResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'robot_vision_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _COMMANDREQUEST_PARAMSENTRY._options = None
  _COMMANDREQUEST_PARAMSENTRY._serialized_options = b'8\001'
  _COMMANDRESPONSE_DATAENTRY._options = None
  _COMMANDRESPONSE_DATAENTRY._serialized_options = b'8\001'
  _DETECTION._serialized_start=31
  _DETECTION._serialized_end=143
  _DETECTREQUEST._serialized_start=145
  _DETECTREQUEST._serialized_end=220
  _DETECTRESPONSE._serialized_start=223
  _DETECTRESPONSE._serialized_end=377
  _COMMANDREQUEST._serialized_start=380
  _COMMANDREQUEST._serialized_end=513
  _COMMANDREQUEST_PARAMSENTRY._serialized_start=468
  _COMMANDREQUEST_PARAMSENTRY._serialized_end=513
  _COMMANDRESPONSE._serialized_start=516
  _COMMANDRESPONSE._serialized_end=662
  _COMMANDRESPONSE_DATAENTRY._serialized_start=619
  _COMMANDRESPONSE_DATAENTRY._serialized_end=662
  _ROBOTVISIONSERVICE._serialized_start=665
  _ROBOTVISIONSERVICE._serialized_end=959
# @@protoc_insertion_point(module_scope)
