"""Fiat-Shamir transcript: instance hash and stage seeds.

Byte layout matches the reference drivers exactly:

* instance hash: fold SHA256(prev_digest || arg_bytes) over *public* args,
  starting from a zero digest (``webgpu_prover.cpp:161-168``).  Arg 0 is
  always the program name string "Ligero\\0".
* stage-1 seed: SHA256(b"LigetronStage1\\0" || root || instance_hash) — the
  14-char string literal is absorbed with its NUL terminator, as the C++
  char-array overload does (``zkp/hash.hpp:59-63``).
* stage-2 seed: SHA256(b"LigetronStage2\\0" || root || code || linear ||
  quad) with each codeword as little-endian u32 limbs
  (``webgpu_prover.cpp:337-341``).
"""

from __future__ import annotations

import hashlib

import numpy as np

ZERO_DIGEST = bytes(32)


def instance_hash(args: list[bytes], private_indices: set[int]) -> bytes:
    acc = ZERO_DIGEST
    for i, arg in enumerate(args):
        if i in private_indices:
            continue
        acc = hashlib.sha256(acc + arg).digest()
    return acc


def stage1_seed(root: bytes, inst_hash: bytes) -> bytes:
    return hashlib.sha256(b"LigetronStage1\x00" + root + inst_hash).digest()


def stage2_seed(root: bytes, code_limbs: np.ndarray, linear_limbs: np.ndarray,
                quad_limbs: np.ndarray) -> bytes:
    h = hashlib.sha256()
    h.update(b"LigetronStage2\x00")
    h.update(root)
    h.update(np.ascontiguousarray(code_limbs, dtype="<u4").tobytes())
    h.update(np.ascontiguousarray(linear_limbs, dtype="<u4").tobytes())
    h.update(np.ascontiguousarray(quad_limbs, dtype="<u4").tobytes())
    return h.digest()
