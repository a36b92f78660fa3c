"""Stack value model for the WASM VM.

Mirrors ``include/stack_value.hpp``: a stack slot is a public numeric (with
an i32/i64/f32/f64 tag), a secret witness handle, a decomposed bit vector,
or a function reference.  Coercions between the three value forms follow
``nonbatch_context.hpp:249-316``.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..zkp.backend import Managed, DecomposedBits

MASK32 = 0xFFFFFFFF
MASK64 = 0xFFFFFFFFFFFFFFFF

I32, I64, F32, F64 = "i32", "i64", "f32", "f64"


class WasmTrap(Exception):
    pass


class ExitProgram(Exception):
    def __init__(self, code: int):
        self.code = code


@dataclass
class Num:
    """Public numeric. `v` is the unsigned raw value for ints, float for
    f32/f64."""

    t: str
    v: object

    def as_u32(self) -> int:
        if self.t in (F32, F64):
            raise WasmTrap("float used as integer")
        return int(self.v) & MASK32

    def as_u64(self) -> int:
        if self.t in (F32, F64):
            raise WasmTrap("float used as integer")
        return int(self.v) & MASK64

    def as_s32(self) -> int:
        u = self.as_u32()
        return u - (1 << 32) if u >= (1 << 31) else u

    def as_s64(self) -> int:
        u = self.as_u64()
        return u - (1 << 64) if u >= (1 << 63) else u

    def as_f32(self) -> float:
        return float(self.v)

    def as_f64(self) -> float:
        return float(self.v)


@dataclass
class Ref:
    addr: int | None = None


def u32(v: int) -> Num:
    return Num(I32, v & MASK32)


def u64(v: int) -> Num:
    return Num(I64, v & MASK64)


def f32(v: float) -> Num:
    import numpy as np
    return Num(F32, float(np.float32(v)))


def f64(v: float) -> Num:
    return Num(F64, float(v))


def is_public(v) -> bool:
    return isinstance(v, (Num, Ref))


def num_bits_of(t: str) -> int:
    return 32 if t == I32 else 64
