"""Deterministic randomness engines, bit-compatible with the reference.

Three generators drive the protocol (``util/csprng.hpp``, ``zkp/random.hpp``):

* :class:`MpzRandomEngine` — AES-256-CTR keystream over a zeroed 16 KiB
  buffer, consumed as little-endian u64 limbs.  A request that does not fit
  in the remaining buffer triggers a refill that *discards* the tail
  (``csprng.hpp:95-97``) — replicated exactly, since every discarded limb
  shifts all subsequent encoding randomness.
* :class:`HashRandomEngine` — SHA-256 counter-mode byte generator used for
  Fiat-Shamir index sampling.  Quirks preserved from ``random.hpp:129-138``:
  the first block hashes only the counter (the seed is absorbed *after* the
  first flush), and digest bytes are consumed back-to-front.
* :func:`sha256_digest` — transcript hashing helper.
"""

from __future__ import annotations

import hashlib
import struct

from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes

BUFFER_BYTES = 16384
BUFFER_U64 = BUFFER_BYTES // 8
_ZEROS = bytes(BUFFER_BYTES)


class MpzRandomEngine:
    """AES-256-CTR big-integer source (``util/csprng.hpp:28-110``)."""

    def __init__(self, key: bytes | None = None, iv: bytes | None = None):
        self._enc = None
        self._buf = b""
        self._offset_u64 = BUFFER_U64
        if key is not None:
            self.init(key, iv if iv is not None else bytes(16))

    def init(self, key: bytes, iv: bytes):
        assert len(key) == 32 and len(iv) == 16
        self._enc = Cipher(algorithms.AES(key), modes.CTR(iv)).encryptor()
        self._fill()

    def _fill(self):
        if self._enc is None:
            raise RuntimeError("MpzRandomEngine not initialized")
        self._buf = self._enc.update(_ZEROS)
        self._offset_u64 = 0

    def draw_int(self, num_bytes: int) -> int:
        if num_bytes == 0 or num_bytes % 8 != 0:
            raise ValueError("num_bytes must be a nonzero multiple of 8")
        if num_bytes > BUFFER_BYTES:
            raise ValueError("request exceeds buffer capacity")
        num_u64 = num_bytes // 8
        if self._offset_u64 + num_u64 > BUFFER_U64:
            self._fill()  # discards buffer tail, as the reference does
        start = self._offset_u64 * 8
        chunk = self._buf[start:start + num_bytes]
        self._offset_u64 += num_u64
        return int.from_bytes(chunk, "little")


class HashRandomEngine:
    """SHA-256 counter-mode byte engine (``zkp/random.hpp:87-146``).

    Block 0 is SHA256(le64(0)); block i>=1 is SHA256(seed || le64(i)).
    Bytes are read from digest[31] down to digest[0].
    result_type is uint8: min()=0, max()=255.
    """

    MIN = 0
    MAX = 255

    def __init__(self, seed: bytes):
        assert len(seed) == 32
        self._seed = seed
        self._state = 0
        self._buffer = b""
        self._offset = -1
        self._pending_seed = b""  # what has been absorbed into the next hash

    def next_byte(self) -> int:
        if self._offset < 0:
            h = hashlib.sha256()
            h.update(self._pending_seed)
            h.update(struct.pack("<Q", self._state))
            self._state += 1
            self._buffer = h.digest()
            self._pending_seed = self._seed  # hash_ << seed_ after each flush
            self._offset = 31
        b = self._buffer[self._offset]
        self._offset -= 1
        return b

    __call__ = next_byte


def sha256_digest(*chunks: bytes) -> bytes:
    h = hashlib.sha256()
    for c in chunks:
        h.update(c)
    return h.digest()


# -- The port's block draws ----------------------------------------------


def draw_ints(engine: MpzRandomEngine, num_bytes: int,
              count: int) -> list[int]:
    """What `count` calls of ``engine.draw_int(num_bytes)`` return, drawn
    as one block: the same ints in the same order, and the same refills (a
    draw that does not fit discards the buffer's tail)."""
    if num_bytes == 0 or num_bytes % 8 != 0:
        raise ValueError("num_bytes must be a nonzero multiple of 8")
    if num_bytes > BUFFER_BYTES:
        raise ValueError("request exceeds buffer capacity")
    num_u64 = num_bytes // 8
    out: list[int] = []
    while count:
        if engine._offset_u64 + num_u64 > BUFFER_U64:
            engine._fill()
        start = engine._offset_u64 * 8
        take = min(count, (BUFFER_BYTES - start) // num_bytes)
        buf = engine._buf
        out += [int.from_bytes(buf[i:i + num_bytes], "little")
                for i in range(start, start + take * num_bytes, num_bytes)]
        engine._offset_u64 += take * num_u64
        count -= take
    return out
