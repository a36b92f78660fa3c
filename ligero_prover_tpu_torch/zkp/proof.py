"""Proof (de)serialization: gzip'd protobuf LigeroProofEnvelope.

Wire format and canonical sibling ordering match the reference
(``zkp/proof_serializer.hpp``, ``proto/ligero_proof.proto``): siblings are
serialized bottom-up, left-to-right per level, and their tree positions are
recomputed identically on both sides so the proof stores only digests.
"""

from __future__ import annotations

import gzip
import os
import time

import numpy as np

from ..proto import ligero_common_pb2 as common_pb
from ..proto import ligero_proof_pb2 as proof_pb
from .merkle import sibling_positions
from .. import __version__ as _version
from ..params import SAMPLE_SIZE, SECURITY_LEVEL, PROOF_SCHEMA_VERSION


def _bit_ceil(x: int) -> int:
    return 1 if x <= 1 else 1 << (x - 1).bit_length()


class ProofData:
    def __init__(self, merkle_root: bytes, code: np.ndarray,
                 linear: np.ndarray, quad: np.ndarray,
                 leaf_indices: list[int], siblings: dict[int, bytes],
                 samplings: np.ndarray, metadata=None):
        self.merkle_root = merkle_root
        self.encoded_code_limbs = code       # flat u32
        self.encoded_linear_limbs = linear
        self.encoded_quad_limbs = quad
        self.leaf_indices = leaf_indices
        self.siblings = siblings             # tree position -> digest
        self.host_samplings = samplings      # flat u32
        self.metadata = metadata


def serialize_proof(root: bytes, code: np.ndarray, linear: np.ndarray,
                    quad: np.ndarray, leaf_indices: list[int],
                    siblings: dict[int, bytes], samplings: np.ndarray,
                    *, program_hash: bytes, k: int, n: int,
                    timestamp: int | None = None) -> bytes:
    env = proof_pb.LigeroProofEnvelope()
    md = env.metadata
    md.prover_version = _version
    md.proof_schema_version = PROOF_SCHEMA_VERSION
    md.proof_type = common_pb.PROOF_TYPE_CLASSIC
    md.program_hash.value = program_hash
    if timestamp is None:
        timestamp = int(os.environ.get("LIGERO_PROOF_TIMESTAMP",
                                       int(time.time())))
    md.generated_at.seconds = timestamp
    md.packing_size = k
    md.codeword_size = n
    md.sample_size = SAMPLE_SIZE
    md.security_level = SECURITY_LEVEL

    proof = env.ligero_proof
    mt = proof.merkle_tree
    mt.algorithm = common_pb.HASH_ALGORITHM_SHA256
    mt.root.value = root
    for idx in leaf_indices:
        mt.leaf_indices.append(idx)
    total_count = _bit_ceil(n) * 2 - 1
    for pos in sibling_positions(leaf_indices, total_count):
        h = mt.sibling_hashes.add()
        h.value = siblings[pos]

    _load_packed(proof.encoded_code, code)
    _load_packed(proof.encoded_linear, linear)
    _load_packed(proof.encoded_quadratic, quad)
    _load_packed(proof.sampled_data, samplings)

    # mtime=0: the reference's boost gzip stream embeds no timestamp either;
    # proof bytes must be a pure function of the transcript for the parity
    # harness (SURVEY §4) to byte-compare them.
    return gzip.compress(env.SerializeToString(), compresslevel=6, mtime=0)


def deserialize_proof(blob: bytes) -> ProofData:
    raw = gzip.decompress(blob)
    env = proof_pb.LigeroProofEnvelope()
    if not env.ParseFromString(raw):
        pass  # ParseFromString raises on failure in python impl
    if not env.HasField("ligero_proof"):
        raise ValueError("proof envelope has no LigeroProof payload")
    md = env.metadata
    n = md.codeword_size
    if n == 0:
        raise ValueError("proof metadata missing codeword_size")
    total_count = _bit_ceil(n) * 2 - 1

    proof = env.ligero_proof
    mt = proof.merkle_tree
    root = mt.root.value
    if len(root) != 32:
        raise ValueError("invalid root digest size")
    leaf_indices = list(mt.leaf_indices)
    positions = sibling_positions(leaf_indices, total_count)
    if len(positions) != len(mt.sibling_hashes):
        raise ValueError(
            f"sibling hash count mismatch: expected {len(positions)}, "
            f"got {len(mt.sibling_hashes)}")
    siblings = {}
    for pos, h in zip(positions, mt.sibling_hashes):
        if len(h.value) != 32:
            raise ValueError("invalid sibling digest size")
        siblings[pos] = h.value

    return ProofData(
        root,
        _read_packed(proof.encoded_code),
        _read_packed(proof.encoded_linear),
        _read_packed(proof.encoded_quadratic),
        leaf_indices, siblings,
        _read_packed(proof.sampled_data),
        metadata=md)


# -- The port's own codec of the bulk vectors ----------------------------
#
# A ``FixedU32Vector`` is one packed field 1: the byte 0x0a, the varint
# byte length, then little-endian u32s.  The four bulk vectors cross
# between numpy and protobuf as those bytes, one buffer copy each way,
# and not as one Python int per element; protobuf still parses the
# proof and writes its wire bytes.


def _varint(n: int) -> bytes:
    out = bytearray()
    while n > 0x7F:
        out.append(n & 0x7F | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _load_packed(vec, x) -> None:
    """Fills the empty ``FixedU32Vector`` `vec` with the values of
    ``np.asarray(x, np.uint32).reshape(-1)``."""
    a = np.ascontiguousarray(np.asarray(x, np.uint32).reshape(-1), "<u4")
    if a.size == 0:
        vec.values.extend([])   # sets `vec`, empty, as the reference does
        return
    vec.MergeFromString(b"\x0a" + _varint(a.nbytes) + a.tobytes())


def _read_packed(vec) -> np.ndarray:
    """`vec`'s values as a 1-D, owned uint32 array.  With its unknown
    fields dropped, `vec` serializes to nothing or to its one packed
    field 1, which ends in the values."""
    vec.DiscardUnknownFields()
    raw = vec.SerializeToString()
    if not raw:
        return np.zeros(0, np.uint32)
    return np.frombuffer(raw, "<u4",
                         offset=len(raw) - 4 * len(vec.values)
                         ).astype(np.uint32)
