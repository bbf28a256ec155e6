# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: msf_loam_tpu_torch/proto/msg.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\"msf_loam_tpu_torch/proto/msg.proto\x12\x12msf_loam_tpu_torch\"+\n\x08Vector3d\x12\t\n\x01x\x18\x01 \x01(\x01\x12\t\n\x01y\x18\x02 \x01(\x01\x12\t\n\x01z\x18\x03 \x01(\x01\"9\n\x0bQuaterniond\x12\t\n\x01x\x18\x01 \x01(\x01\x12\t\n\x01y\x18\x02 \x01(\x01\x12\t\n\x01z\x18\x03 \x01(\x01\x12\t\n\x01w\x18\x04 \x01(\x01\"o\n\x07Rigid3d\x12\x31\n\x0btranslation\x18\x01 \x01(\x0b\x32\x1c.msf_loam_tpu_torch.Vector3d\x12\x31\n\x08rotation\x18\x02 \x01(\x0b\x32\x1f.msf_loam_tpu_torch.Quaterniond\"\x8f\x01\n\x07ImuData\x12\x11\n\ttimestamp\x18\x01 \x01(\x04\x12\x39\n\x13linear_acceleration\x18\x02 \x01(\x0b\x32\x1c.msf_loam_tpu_torch.Vector3d\x12\x36\n\x10\x61ngular_velocity\x18\x03 \x01(\x0b\x32\x1c.msf_loam_tpu_torch.Vector3d\"L\n\x0cOdometryData\x12\x11\n\ttimestamp\x18\x01 \x01(\x04\x12)\n\x04pose\x18\x02 \x01(\x0b\x32\x1b.msf_loam_tpu_torch.Rigid3d\"n\n\x06PbData\x12.\n\timu_datas\x18\x01 \x03(\x0b\x32\x1b.msf_loam_tpu_torch.ImuData\x12\x34\n\nodom_datas\x18\x02 \x03(\x0b\x32 .msf_loam_tpu_torch.OdometryDatab\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'msf_loam_tpu_torch.proto.msg_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _VECTOR3D._serialized_start=58
  _VECTOR3D._serialized_end=101
  _QUATERNIOND._serialized_start=103
  _QUATERNIOND._serialized_end=160
  _RIGID3D._serialized_start=162
  _RIGID3D._serialized_end=273
  _IMUDATA._serialized_start=276
  _IMUDATA._serialized_end=419
  _ODOMETRYDATA._serialized_start=421
  _ODOMETRYDATA._serialized_end=497
  _PBDATA._serialized_start=499
  _PBDATA._serialized_end=609
# @@protoc_insertion_point(module_scope)
