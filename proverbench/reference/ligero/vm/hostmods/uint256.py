"""`uint256` host module — oracle helpers for the SDK's 256-bit bigint
layer (reference ``include/host_modules/uint256.hpp``).

A guest ``uint256`` is a struct of 4 `bn254fr` handles, one per 64-bit
little-endian limb (``uint256.hpp:18-23,37-44``).  All functions here set
limb *values* only; verification constraints are emitted guest-side by the
SDK (``uint256.hpp`` header comment / SURVEY §2.3).
"""

from __future__ import annotations

from ..values import WasmTrap

NLIMBS = 4
LIMB_BITS = 64
LIMB_MASK = (1 << LIMB_BITS) - 1


class Uint256Module:
    name = "uint256"

    def __init__(self, ctx):
        self.ctx = ctx

    def call(self, func: str):
        handler = getattr(self, func, None)
        if handler is None:
            raise WasmTrap(f"uint256.{func} not implemented")
        handler()

    # -- handle plumbing ----------------------------------------------------

    @property
    def _fr(self):
        return self.ctx.host_modules["bn254fr"]

    def _load_limbs(self, addr: int):
        """4 bn254fr handles at addr+0,8,16,24 (``uint256.hpp:37-44``)."""
        return [self._fr._load(addr + i * 8) for i in range(NLIMBS)]

    def _compose(self, limbs) -> int:
        v = 0
        for i in range(NLIMBS):
            v |= limbs[i].value << (LIMB_BITS * i)
        return v

    def _decompose(self, limbs, v: int):
        for i in range(NLIMBS):
            limbs[i].value = (v >> (LIMB_BITS * i)) & LIMB_MASK

    def _pop_u32(self) -> int:
        return self.ctx.make_numeric(self.ctx.pop()).as_u32()

    # -- setters ------------------------------------------------------------

    def _set_bytes(self, order: str):
        size = self._pop_u32()
        data_addr = self._pop_u32()
        limbs = self._load_limbs(self._pop_u32())
        raw = self.ctx.memory.load_bytes(data_addr, size)
        self._decompose(limbs, int.from_bytes(raw, order))

    def uint256_set_bytes_little(self):
        self._set_bytes("little")

    def uint256_set_bytes_big(self):
        self._set_bytes("big")

    def uint256_set_str(self):
        base = self._pop_u32()
        str_addr = self._pop_u32()
        limbs = self._load_limbs(self._pop_u32())
        mem = self.ctx.memory
        try:
            end = mem.data.index(0, str_addr, len(mem.data))
        except ValueError:
            raise WasmTrap("uint256_set_str: unterminated string")
        try:
            s = bytes(mem.data[str_addr:end]).decode()
        except UnicodeDecodeError:
            raise WasmTrap("bad conversion")
        try:
            if base == 0:
                v = int(s, 0)
            elif base == 16 and s.startswith(("0x", "0X")):
                v = int(s, 16)
            else:
                v = int(s, base)
        except ValueError:
            raise WasmTrap("bad conversion")
        self._decompose(limbs, v)

    def uint256_print(self):
        limbs = self._load_limbs(self._pop_u32())
        print(f"@uint256_print: val={self._compose(limbs):x}")

    # -- oracles ------------------------------------------------------------

    def uint512_idiv_normalized(self):
        """512/256 → (320-bit q, 256-bit r) division oracle
        (``uint256.hpp:153-210``); q_high is a single bn254fr handle."""
        b = self._load_limbs(self._pop_u32())
        a_high = self._load_limbs(self._pop_u32())
        a_low = self._load_limbs(self._pop_u32())
        r = self._load_limbs(self._pop_u32())
        q_high = self._fr._load(self._pop_u32())
        q_low = self._load_limbs(self._pop_u32())

        a = (self._compose(a_high) << (NLIMBS * LIMB_BITS)) \
            | self._compose(a_low)
        b_val = self._compose(b)
        if b_val == 0:
            raise WasmTrap("uint512_idiv_normalized: division by zero")
        q, rem = divmod(a, b_val)
        self._decompose(q_low, q)
        q_high.value = (q >> (NLIMBS * LIMB_BITS)) & LIMB_MASK
        self._decompose(r, rem)

    def uint256_invmod(self):
        m = self._load_limbs(self._pop_u32())
        a = self._load_limbs(self._pop_u32())
        out = self._load_limbs(self._pop_u32())
        # Non-invertible a (or m == 0) leaves the output 0 and lets the
        # guest-side constraints fail, matching the reference's tolerance
        # (mpz_invert leaves the result undefined, ``uint256.hpp:227``).
        try:
            inv = pow(self._compose(a), -1, self._compose(m))
        except ValueError:
            inv = 0
        self._decompose(out, inv)

    def finalize(self):
        pass
