# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: ligero_common.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x13ligero_common.proto\x12\x10ligero.common.v1\"\x1b\n\nHashDigest\x12\r\n\x05value\x18\x01 \x01(\x0c\"\xc0\x01\n\x12MerkleDecommitment\x12\x32\n\talgorithm\x18\x01 \x01(\x0e\x32\x1f.ligero.common.v1.HashAlgorithm\x12*\n\x04root\x18\x02 \x01(\x0b\x32\x1c.ligero.common.v1.HashDigest\x12\x34\n\x0esibling_hashes\x18\x03 \x03(\x0b\x32\x1c.ligero.common.v1.HashDigest\x12\x14\n\x0cleaf_indices\x18\x04 \x03(\r*J\n\rHashAlgorithm\x12\x1e\n\x1aHASH_ALGORITHM_UNSPECIFIED\x10\x00\x12\x19\n\x15HASH_ALGORITHM_SHA256\x10\x01*Z\n\tProofType\x12\x1a\n\x16PROOF_TYPE_UNSPECIFIED\x10\x00\x12\x16\n\x12PROOF_TYPE_CLASSIC\x10\x01\x12\x19\n\x15PROOF_TYPE_PREPROCESS\x10\x02\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'ligero_common_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _HASHALGORITHM._serialized_start=265
  _HASHALGORITHM._serialized_end=339
  _PROOFTYPE._serialized_start=341
  _PROOFTYPE._serialized_end=431
  _HASHDIGEST._serialized_start=41
  _HASHDIGEST._serialized_end=68
  _MERKLEDECOMMITMENT._serialized_start=71
  _MERKLEDECOMMITMENT._serialized_end=263
# @@protoc_insertion_point(module_scope)
