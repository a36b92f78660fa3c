# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: ligero_proof.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from . import ligero_common_pb2 as ligero__common__pb2
from google.protobuf import timestamp_pb2 as google_dot_protobuf_dot_timestamp__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x12ligero_proof.proto\x12\tligero.v1\x1a\x13ligero_common.proto\x1a\x1fgoogle/protobuf/timestamp.proto\" \n\x0e\x46ixedU32Vector\x12\x0e\n\x06values\x18\x01 \x03(\x07\"\xb6\x02\n\rProofMetadata\x12\x16\n\x0eprover_version\x18\x01 \x01(\t\x12\x1c\n\x14proof_schema_version\x18\x02 \x01(\r\x12/\n\nproof_type\x18\x03 \x01(\x0e\x32\x1b.ligero.common.v1.ProofType\x12\x32\n\x0cprogram_hash\x18\x04 \x01(\x0b\x32\x1c.ligero.common.v1.HashDigest\x12\x30\n\x0cgenerated_at\x18\x05 \x01(\x0b\x32\x1a.google.protobuf.Timestamp\x12\x14\n\x0cpacking_size\x18\x06 \x01(\r\x12\x15\n\rcodeword_size\x18\x07 \x01(\r\x12\x13\n\x0bsample_size\x18\x08 \x01(\r\x12\x16\n\x0esecurity_level\x18\t \x01(\r\"\x93\x02\n\x0bLigeroProof\x12\x39\n\x0bmerkle_tree\x18\x01 \x01(\x0b\x32$.ligero.common.v1.MerkleDecommitment\x12/\n\x0c\x65ncoded_code\x18\x02 \x01(\x0b\x32\x19.ligero.v1.FixedU32Vector\x12\x31\n\x0e\x65ncoded_linear\x18\x03 \x01(\x0b\x32\x19.ligero.v1.FixedU32Vector\x12\x34\n\x11\x65ncoded_quadratic\x18\x04 \x01(\x0b\x32\x19.ligero.v1.FixedU32Vector\x12/\n\x0csampled_data\x18\x05 \x01(\x0b\x32\x19.ligero.v1.FixedU32Vector\"|\n\x13LigeroProofEnvelope\x12*\n\x08metadata\x18\x01 \x01(\x0b\x32\x18.ligero.v1.ProofMetadata\x12.\n\x0cligero_proof\x18\x02 \x01(\x0b\x32\x16.ligero.v1.LigeroProofH\x00\x42\t\n\x07payloadb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'ligero_proof_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _FIXEDU32VECTOR._serialized_start=87
  _FIXEDU32VECTOR._serialized_end=119
  _PROOFMETADATA._serialized_start=122
  _PROOFMETADATA._serialized_end=432
  _LIGEROPROOF._serialized_start=435
  _LIGEROPROOF._serialized_end=710
  _LIGEROPROOFENVELOPE._serialized_start=712
  _LIGEROPROOFENVELOPE._serialized_end=836
# @@protoc_insertion_point(module_scope)
