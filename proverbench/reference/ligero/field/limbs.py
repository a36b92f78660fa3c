"""Limb packing helpers: Python ints <-> little-endian u32 limb arrays.

The device ABI for one BN254-Fr element is 8 little-endian uint32 limbs
(32 bytes), matching ``include/ligetron/webgpu/device_bignum.hpp:32-36`` and
the ``mpz_import/export(order=-1, size=4)`` convention used throughout the
reference (``zkp/finite_field_gmp.hpp:183-197``).
"""

from __future__ import annotations

import numpy as np

NUM_U32 = 8
MASK32 = 0xFFFFFFFF


def int_to_limbs(x: int) -> np.ndarray:
    """One element -> (8,) uint32 little-endian."""
    return np.frombuffer(x.to_bytes(32, "little"), dtype="<u4").copy()


def limbs_to_int(limbs) -> int:
    return int.from_bytes(np.asarray(limbs, dtype="<u4").tobytes(), "little")


def ints_to_limbs(xs, out: np.ndarray | None = None) -> np.ndarray:
    """Vector of ints -> (N, 8) uint32."""
    n = len(xs)
    if out is None:
        out = np.empty((n, NUM_U32), dtype=np.uint32)
    buf = b"".join(x.to_bytes(32, "little") for x in xs)
    out[:] = np.frombuffer(buf, dtype="<u4").reshape(n, NUM_U32)
    return out


def limbs_to_ints(arr: np.ndarray) -> list[int]:
    arr = np.ascontiguousarray(np.asarray(arr, dtype="<u4"))
    flat = arr.reshape(-1, NUM_U32).tobytes()
    return [int.from_bytes(flat[i * 32:(i + 1) * 32], "little")
            for i in range(len(flat) // 32)]


def limbs_to_bytes_be_stream(arr: np.ndarray) -> bytes:
    """SHA-256 absorb byte order: for each LE u32 limb, its 4 bytes big-endian
    (``shader/sha256.wgsl:152-176``)."""
    arr = np.asarray(arr, dtype=np.uint32).reshape(-1, NUM_U32)
    return arr.astype(">u4").tobytes()
