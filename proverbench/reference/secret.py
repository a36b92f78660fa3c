"""The plain reference for guests with secret arguments, and the plain
SHA-256 that states a guest's digest.

``SecretGuest`` is ``prover.Guest`` run with the configuration's private
argument indices: the frozen front end marks those arguments' bytes secret
(``args_get``), so the guest takes the interpreter's witness path.
``prover.prove`` and ``prover.verify`` take it as they take a ``Guest``.
"""

from __future__ import annotations

import hashlib

from .ligero.vm.run import run_program
from .prover import Guest

_M = 0xFFFFFFFF


class SecretGuest(Guest):
    """A WAT guest, its arguments and the indices of the secret ones."""

    def __init__(self, wat: str, args: list[bytes], private: set[int]):
        super().__init__(wat, args)
        self.private = set(private)

    def run(self, ctx):
        run_program(self.module, ctx, self.args, self.private)
        ctx.finalize()


def _rotr(x: int, n: int) -> int:
    return ((x >> n) | (x << (32 - n))) & _M


def _frac_bits(p: int, e: int) -> int:
    """The first 32 bits of the fractional part of p ** (1/e)."""
    x = p << (32 * e)
    r = int(round(x ** (1.0 / e)))
    while r ** e > x:
        r -= 1
    while (r + 1) ** e <= x:
        r += 1
    return r & _M


# FIPS 180-4 4.2.2 and 5.3.3: from the first 64 and the first 8 primes
_PRIMES = [p for p in range(2, 312) if all(p % d for d in range(2, p))]
K = [_frac_bits(p, 3) for p in _PRIMES[:64]]
H0 = [_frac_bits(p, 2) for p in _PRIMES[:8]]


def sha256(message: bytes, rounds: int = 64) -> bytes:
    """FIPS 180-4 SHA-256 with `rounds` rounds a block (the schedule as far
    as the rounds read it); at 64 it is held against ``hashlib``."""
    data = message + b"\x80" + bytes((55 - len(message)) % 64) \
        + (8 * len(message)).to_bytes(8, "big")
    h = list(H0)
    for off in range(0, len(data), 64):
        w = list(int.from_bytes(data[off + i:off + i + 4], "big")
                 for i in range(0, 64, 4))
        for t in range(16, max(16, rounds)):
            x, y = w[t - 15], w[t - 2]
            w.append((w[t - 16] + w[t - 7]
                      + (_rotr(x, 7) ^ _rotr(x, 18) ^ (x >> 3))
                      + (_rotr(y, 17) ^ _rotr(y, 19) ^ (y >> 10))) & _M)
        v = list(h)
        for t in range(rounds):
            a, b, c, d, e, f, g, hh = v
            t1 = (hh + (_rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25))
                  + ((e & f) ^ (~e & _M & g)) + K[t] + w[t]) & _M
            t2 = ((_rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22))
                  + ((a & b) ^ (a & c) ^ (b & c))) & _M
            v = [(t1 + t2) & _M, a, b, c, (d + t1) & _M, e, f, g]
        h = [(x + y) & _M for x, y in zip(h, v)]
    out = b"".join(x.to_bytes(4, "big") for x in h)
    if rounds == 64 and out != hashlib.sha256(message).digest():
        raise AssertionError("the plain SHA-256 disagrees with hashlib")
    return out
