# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: msf_loam_tpu_torch/proto/config.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from msf_loam_tpu_torch.proto import msg_pb2 as msf__loam__tpu__torch_dot_proto_dot_msg__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n%msf_loam_tpu_torch/proto/config.proto\x12\x12msf_loam_tpu_torch\x1a\"msf_loam_tpu_torch/proto/msg.proto\"\xb5\x01\n\x16ImuintrinsicParameters\x12\x1f\n\x17gyroscope_noise_density\x18\x01 \x01(\x01\x12#\n\x1b\x61\x63\x63\x65lerometer_noise_density\x18\x02 \x01(\x01\x12\x1d\n\x15gyroscope_random_walk\x18\x03 \x01(\x01\x12!\n\x19\x61\x63\x63\x65lerometer_random_walk\x18\x04 \x01(\x01\x12\x13\n\x0bupdate_rate\x18\x05 \x01(\x01\"\xf5\x01\n\rMsfLoamConfig\x12\x43\n\x1elidar2imu_extrinsic_parameters\x18\x01 \x01(\x0b\x32\x1b.msf_loam_tpu_torch.Rigid3d\x12L\n\x18imu_intrinsic_parameters\x18\x02 \x01(\x0b\x32*.msf_loam_tpu_torch.ImuintrinsicParameters\x12\x34\n\x0egravity_vector\x18\x03 \x01(\x0b\x32\x1c.msf_loam_tpu_torch.Vector3d\x12\x1b\n\x13save_pointcloud_map\x18\x04 \x01(\x08\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'msf_loam_tpu_torch.proto.config_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _IMUINTRINSICPARAMETERS._serialized_start=98
  _IMUINTRINSICPARAMETERS._serialized_end=279
  _MSFLOAMCONFIG._serialized_start=282
  _MSFLOAMCONFIG._serialized_end=527
# @@protoc_insertion_point(module_scope)
