"""`bn254fr` host module: guest-visible BN254-Fr field element handles
(``include/host_modules/bn254fr.hpp``).

A guest ``bn254fr_t`` stores a 64-bit handle; the host maps handles to
:class:`~ligero_prover_tpu_torch.zkp.witness.LazyWitness` instances.  Handles are
allocated as non-witness instances; operations that *constrain* an element
promote it to witness status, after which its release commits it into the
streaming rows.  Compute ops (addmod & co) set values only; the matching
``assert_*`` family emits constraints; the bigint helpers provide oracles
plus the polynomial-identity multiplication check.
"""

from __future__ import annotations

import sys

from ...field import bn254 as F
from ..values import Num, WasmTrap, u32, u64


class Bn254frModule:
    name = "bn254fr"

    def __init__(self, ctx):
        self.ctx = ctx
        self._handles = {}
        self._next = 1

    def call(self, func: str):
        handler = getattr(self, func, None)
        if handler is None:
            raise WasmTrap(f"bn254fr.{func} not implemented")
        handler()

    # -- handle plumbing ---------------------------------------------------

    def _load(self, addr: int):
        hid = int.from_bytes(self.ctx.memory.load_bytes(addr, 8), "little")
        if hid == 0:
            return None
        wit = self._handles.get(hid)
        if wit is None:
            raise WasmTrap(f"bn254fr: invalid handle {hid}")
        return wit

    def _store(self, addr: int, wit):
        if wit is None:
            hid = 0
        else:
            hid = self._next
            self._next += 1
            self._handles[hid] = wit
        self.ctx.memory.store_bytes(addr, hid.to_bytes(8, "little"))
        self.ctx.memory.unmark(addr, addr + 8)

    def _pop_u32(self) -> int:
        return self.ctx.make_numeric(self.ctx.pop()).as_u32()

    @property
    def _m(self):
        return self.ctx.backend.manager

    @property
    def _b(self):
        return self.ctx.backend

    # -- memory management -------------------------------------------------

    def bn254fr_alloc(self):
        addr = self._pop_u32()
        wit = self._m.acquire_witness(0)
        wit.is_witness = False  # instance until constrained
        self._store(addr, wit)

    def bn254fr_free(self):
        addr = self._pop_u32()
        hid = int.from_bytes(self.ctx.memory.load_bytes(addr, 8), "little")
        wit = self._handles.pop(hid, None)
        if wit is not None:
            if wit.is_witness:
                self._m.commit_release_witness(wit)
            else:
                self._m.live_witnesses -= 1
        self.ctx.memory.store_bytes(addr, bytes(8))

    # -- setters / getters -------------------------------------------------

    def bn254fr_set_u32(self):
        ui = self._pop_u32()
        wit = self._load(self._pop_u32())
        wit.value = ui

    def bn254fr_set_u64(self):
        v = self.ctx.make_numeric(self.ctx.pop()).as_u64()
        wit = self._load(self._pop_u32())
        wit.value = v

    def bn254fr_set_bytes(self):
        order = self._pop_u32()
        order = order - (1 << 32) if order >= (1 << 31) else order
        size = self._pop_u32()
        data_addr = self._pop_u32()
        wit = self._load(self._pop_u32())
        raw = self.ctx.memory.load_bytes(data_addr, size)
        wit.value = int.from_bytes(raw, "little" if order == -1 else "big")

    def bn254fr_set_str(self):
        base = self._pop_u32()
        str_addr = self._pop_u32()
        wit = self._load(self._pop_u32())
        mem = self.ctx.memory
        end = mem.data.index(0, str_addr)
        s = bytes(mem.data[str_addr:end]).decode()
        try:
            if base == 0:
                wit.value = int(s, 0)
            elif base == 16 and s.startswith(("0x", "0X")):
                wit.value = int(s, 16)
            else:
                wit.value = int(s, base)
        except ValueError:
            raise WasmTrap("bad conversion")

    def bn254fr_get_u64(self):
        wit = self._load(self._pop_u32())
        self.ctx.push(u64(wit.value & 0xFFFFFFFFFFFFFFFF))

    def bn254fr_to_bytes(self):
        order = self._pop_u32()
        order = order - (1 << 32) if order >= (1 << 31) else order
        size = self._pop_u32()
        wit = self._load(self._pop_u32())
        data_addr = self._pop_u32()
        required = (wit.value.bit_length() + 7) // 8
        if size > 32 or size < required:
            raise WasmTrap("invalid size for bn254fr_to_bytes")
        raw = wit.value.to_bytes(size, "little" if order == -1 else "big")
        self.ctx.memory.store_bytes(data_addr, raw)

    def bn254fr_copy(self):
        src = self._load(self._pop_u32())
        dest = self._load(self._pop_u32())
        dest.value = src.value

    def bn254fr_print(self):
        base = self._pop_u32()
        wit = self._load(self._pop_u32())
        if base == 10:
            print(f"@bn254fr_print: val={wit.value}")
        elif base == 16:
            print(f"@bn254fr_print: val={wit.value:#x}")
        else:
            raise WasmTrap("bad conversion")

    # -- constraint assertions --------------------------------------------

    def bn254fr_assert_equal(self):
        y = self._load(self._pop_u32())
        x = self._load(self._pop_u32())
        x.is_witness = True
        y.is_witness = True
        self._m.constrain_equal(x, y)

    def _assert_equal_pub(self, as_bits: int):
        sy = self.ctx.pop()
        x = self._load(self._pop_u32())
        x.is_witness = True
        if isinstance(sy, Num):
            v = sy.as_u32() if as_bits == 32 else sy.as_u64()
            self._m.constrain_constant(x, v)
        else:
            y = self.ctx.make_witness(sy)
            self._m.constrain_equal(x, y.wit)
            del y

    def bn254fr_assert_equal_u32(self):
        self._assert_equal_pub(32)

    def bn254fr_assert_equal_u64(self):
        self._assert_equal_pub(64)

    def bn254fr_assert_equal_bytes(self):
        order = self._pop_u32()
        order = order - (1 << 32) if order >= (1 << 31) else order
        size = self._pop_u32()
        bytes_addr = self._pop_u32()
        x = self._load(self._pop_u32())
        x.is_witness = True
        mem = self.ctx.memory

        secret = mem.contains_secret(bytes_addr, bytes_addr + 1)
        for i in range(size):
            if mem.contains_secret(bytes_addr + i, bytes_addr + i + 1) \
                    != secret:
                raise WasmTrap("bad bytes equal constraint")

        if secret:
            byts = [None] * size
            for i in range(size):
                bv = mem.load_bytes(bytes_addr + i, 1)[0]
                idx = i if order == -1 else size - i - 1
                byts[idx] = self.ctx.make_witness(u32(bv))
            s = self._b.acquire_witness()
            exp = 1
            for i in range(size):
                s = self._b.eval(s + byts[i] * exp)
                exp <<= 8
            self._m.constrain_equal(x, s.wit)
            # reverse-order release (bn254fr.hpp:160-165)
            while byts:
                byts.pop()
            del s
        else:
            raw = mem.load_bytes(bytes_addr, size)
            y = int.from_bytes(raw, "little" if order == -1 else "big")
            if y >= F.MODULUS:
                raise WasmTrap("bad bytes equal constraint")
            self._m.constrain_constant(x, y)

    def bn254fr_assert_add(self):
        y = self._load(self._pop_u32())
        x = self._load(self._pop_u32())
        out = self._load(self._pop_u32())
        x.is_witness = y.is_witness = out.is_witness = True
        self._m.constrain_linear(out, x, y)

    def bn254fr_assert_mul(self):
        y = self._load(self._pop_u32())
        x = self._load(self._pop_u32())
        out = self._load(self._pop_u32())
        x.is_witness = y.is_witness = out.is_witness = True
        self._m.constrain_quadratic(out, x, y)

    def bn254fr_assert_mulc(self):
        y = self._load(self._pop_u32())
        x = self._load(self._pop_u32())
        out = self._load(self._pop_u32())
        x.is_witness = y.is_witness = out.is_witness = True
        self._m.constrain_quadratic_constant(out, x, y.value)

    # -- checked bit (de)composition --------------------------------------

    def bn254fr_to_bits_checked(self):
        bitcount = self._pop_u32()
        x = self._load(self._pop_u32())
        arr_addr = self._pop_u32()
        x.is_witness = True
        rand = self._m.generate_linear_random()
        self._m.witness_sub_random(x, rand)
        for i in range(bitcount):
            bit = self._load(arr_addr + i * 8)
            bit.value = (x.value >> i) & 1
            bit.is_witness = True
            self._b.constrain_bit(bit)
            self._m.witness_add_random(bit, (rand << i) % F.MODULUS)

    def bn254fr_from_bits_checked(self):
        bitcount = self._pop_u32()
        arr_addr = self._pop_u32()
        x = self._load(self._pop_u32())
        x.is_witness = True
        rand = self._m.generate_linear_random()
        self._m.witness_sub_random(x, rand)
        for i in range(bitcount):
            bit = self._load(arr_addr + i * 8)
            bit.is_witness = True
            x.value += bit.value << i
            self._m.witness_add_random(bit, (rand << i) % F.MODULUS)

    # -- arithmetic (values only; constraints via assert_*) ---------------

    def _binop(self, fn):
        y = self._load(self._pop_u32())
        x = self._load(self._pop_u32())
        out = self._load(self._pop_u32())
        out.value = fn(x.value, y.value)

    def bn254fr_addmod(self):
        self._binop(F.addmod)

    def bn254fr_submod(self):
        self._binop(F.submod)

    def bn254fr_mulmod(self):
        self._binop(F.mulmod)

    def bn254fr_divmod(self):
        self._binop(F.divmod_)

    def bn254fr_powmod(self):
        self._binop(lambda x, y: pow(x, y, F.MODULUS))

    def bn254fr_idiv(self):
        self._binop(lambda x, y: x // y)

    def bn254fr_irem(self):
        self._binop(lambda x, y: x % y)

    def bn254fr_invmod(self):
        x = self._load(self._pop_u32())
        out = self._load(self._pop_u32())
        out.value = F.invmod(x.value)

    def bn254fr_negmod(self):
        x = self._load(self._pop_u32())
        out = self._load(self._pop_u32())
        out.value = F.negate(x.value)

    # -- comparison / logic -----------------------------------------------

    def _cmp(self, fn):
        y = self._load(self._pop_u32())
        x = self._load(self._pop_u32())
        self.ctx.push(u32(int(fn(x.value, y.value))))

    def bn254fr_eq(self):
        self._cmp(lambda a, b: a == b)

    def bn254fr_lt(self):
        self._cmp(lambda a, b: a < b)

    def bn254fr_lte(self):
        self._cmp(lambda a, b: a <= b)

    def bn254fr_gt(self):
        self._cmp(lambda a, b: a > b)

    def bn254fr_gte(self):
        self._cmp(lambda a, b: a >= b)

    def bn254fr_land(self):
        self._cmp(lambda a, b: bool(a) and bool(b))

    def bn254fr_lor(self):
        self._cmp(lambda a, b: bool(a) or bool(b))

    def bn254fr_eqz(self):
        x = self._load(self._pop_u32())
        self.ctx.push(u32(int(x.value == 0)))

    # -- bitwise / shifts --------------------------------------------------

    def bn254fr_band(self):
        self._binop(lambda a, b: a & b)

    def bn254fr_bor(self):
        self._binop(lambda a, b: a | b)

    def bn254fr_bxor(self):
        self._binop(lambda a, b: a ^ b)

    def bn254fr_bnot(self):
        x = self._load(self._pop_u32())
        out = self._load(self._pop_u32())
        out.value = ~x.value  # GMP two's-complement semantics (may be <0)

    def bn254fr_shlmod(self):
        y = self._load(self._pop_u32())
        x = self._load(self._pop_u32())
        out = self._load(self._pop_u32())
        out.value = self._shl(x.value, y.value)

    def bn254fr_shrmod(self):
        y = self._load(self._pop_u32())
        x = self._load(self._pop_u32())
        out = self._load(self._pop_u32())
        out.value = self._shr(x.value, y.value)

    def _shl(self, x: int, k: int) -> int:
        if k < 0:
            return x
        if k < F.MODULUS_MIDDLE:
            return (x << k) % F.MODULUS
        return self._shr(x, F.MODULUS - k)

    def _shr(self, x: int, k: int) -> int:
        if k < 0:
            return x
        if k < F.MODULUS_MIDDLE:
            return x >> k
        return self._shl(x, F.MODULUS - k)

    def bn254fr_to_bits(self):
        bitcount = self._pop_u32()
        x = self._load(self._pop_u32())
        arr_addr = self._pop_u32()
        for i in range(bitcount):
            bit = self._load(arr_addr + i * 8)
            bit.value = (x.value >> i) & 1

    def bn254fr_from_bits(self):
        bitcount = self._pop_u32()
        arr_addr = self._pop_u32()
        x = self._load(self._pop_u32())
        for i in range(bitcount):
            bit = self._load(arr_addr + i * 8)
            x.value |= bit.value << i

    # -- bigint helpers ----------------------------------------------------

    def _compose(self, addr: int, count: int, bits: int) -> int:
        s = 0
        for i in range(count):
            s += self._load(addr + i * 8).value << (bits * i)
        return s

    def _compose_signed(self, addr: int, count: int, bits: int) -> int:
        s = 0
        for i in range(count):
            v = self._load(addr + i * 8).value
            if v < F.MODULUS_MIDDLE:
                s += v << (bits * i)
            else:
                s -= (F.MODULUS - v) << (bits * i)
        return s

    def _decompose(self, addr: int, count: int, x: int, bits: int):
        mask = (1 << bits) - 1
        cur = x
        for i in range(count):
            self._load(addr + i * 8).value = cur & mask \
                if cur >= 0 else cur % (1 << bits)
            cur >>= bits

    def bn254fr_bigint_mul(self):
        bits = self._pop_u32()
        b_count = self._pop_u32()
        a_count = self._pop_u32()
        b_addr = self._pop_u32()
        a_addr = self._pop_u32()
        out_addr = self._pop_u32()
        a = self._compose(a_addr, a_count, bits)
        b = self._compose(b_addr, b_count, bits)
        self._decompose(out_addr, a_count + b_count, a * b, bits)

    def bn254fr_bigint_idiv(self):
        bits = self._pop_u32()
        b_count = self._pop_u32()
        a_count = self._pop_u32()
        b_addr = self._pop_u32()
        a_addr = self._pop_u32()
        r_addr = self._pop_u32()
        q_addr = self._pop_u32()
        a = self._compose(a_addr, a_count, bits)
        b = self._compose(b_addr, b_count, bits)
        self._decompose(q_addr, a_count, a // b, bits)
        self._decompose(r_addr, b_count, a % b, bits)

    def bn254fr_bigint_invmod(self):
        bits = self._pop_u32()
        m_count = self._pop_u32()
        a_count = self._pop_u32()
        m_addr = self._pop_u32()
        a_addr = self._pop_u32()
        out_addr = self._pop_u32()
        a = self._compose_signed(a_addr, a_count, bits)
        m = self._compose_signed(m_addr, m_count, bits)
        self._decompose(out_addr, m_count, pow(a, -1, m), bits)

    def bn254fr_bigint_mul_checked_no_carry(self):
        b_count = self._pop_u32()
        a_count = self._pop_u32()
        b_addr = self._pop_u32()
        a_addr = self._pop_u32()
        c_addr = self._pop_u32()
        # c[i+j] += a[i] * b[j]
        for i in range(a_count):
            for j in range(b_count):
                a_i = self._load(a_addr + i * 8)
                b_j = self._load(b_addr + j * 8)
                c_ij = self._load(c_addr + (i + j) * 8)
                c_ij.value = F.addmod(c_ij.value,
                                      F.mulmod(a_i.value, b_j.value))
        self._assert_poly_mul(c_addr, a_addr, b_addr, a_count, b_count)

    def _calc_poly_val(self, addr: int, x: int, count: int):
        """Horner-free polynomial evaluation with constraints
        (bn254fr.hpp:1189-1227)."""
        b = self._b
        m = self._m
        s = b.acquire_witness()
        a0 = self._load(addr)
        s.wit.value = a0.value
        a0.is_witness = True
        m.constrain_equal(s.wit, a0)
        x_i = x
        for i in range(1, count):
            a_i = self._load(addr + i * 8)
            xm = b.acquire_witness(F.mulmod(a_i.value, x_i))
            a_i.is_witness = True
            m.constrain_quadratic_constant(xm.wit, a_i, x_i)
            st = b.acquire_witness(F.addmod(s.val, xm.val))
            m.constrain_linear(st.wit, s.wit, xm.wit)
            s = st
            del xm
            x_i = F.mulmod(x_i, x)
        return s

    def _assert_poly_mul(self, c_addr, a_addr, b_addr, a_count, b_count):
        c_count = a_count + b_count - 1
        for i in range(c_count + 1):
            a_val = self._calc_poly_val(a_addr, i, a_count)
            b_val = self._calc_poly_val(b_addr, i, b_count)
            c_val = self._calc_poly_val(c_addr, i, c_count)
            self._m.constrain_quadratic(c_val.wit, a_val.wit, b_val.wit)
            del a_val, b_val, c_val

    def bn254fr_bigint_convert_to_proper_representation_signed(self):
        bits = self._pop_u32()
        in_count = self._pop_u32()
        out_count = self._pop_u32()
        in_addr = self._pop_u32()
        out_addr = self._pop_u32()
        val = self._compose_signed(in_addr, in_count, bits)
        self._decompose(out_addr, out_count, val, bits)

    def bn254fr_bigint_convert_to_proper_representation_unsigned(self):
        bits = self._pop_u32()
        in_count = self._pop_u32()
        out_count = self._pop_u32()
        in_addr = self._pop_u32()
        out_addr = self._pop_u32()
        val = self._compose(in_addr, in_count, bits)
        self._decompose(out_addr, out_count, val, bits)

    def bn254fr_bigint_convert_to_proper_representation(self):
        bits = self._pop_u32()
        count = self._pop_u32()
        in_addr = self._pop_u32()
        out_addr = self._pop_u32()
        mask = (1 << bits) - 1
        splits = []
        for i in range(count):
            v = self._load(in_addr + i * 8).value
            splits.append((v & mask, (v >> bits) & mask,
                           (v >> (2 * bits)) & mask))
        carry = [0] * count
        out0 = self._load(out_addr)
        out0.value = splits[0][0]
        if count == 1:
            self._load(out_addr + 8).value = splits[0][1]
            return
        tmp = splits[0][1] + splits[1][0]
        self._load(out_addr + 8).value = tmp & mask
        carry[1] = (tmp >> bits) & mask
        if count == 2:
            self._load(out_addr + 16).value = \
                splits[1][1] + splits[0][2] + carry[1]
            return
        for i in range(2, count):
            tmp = splits[i][0] + splits[i - 1][1] + splits[i - 2][2] \
                + carry[i - 1]
            self._load(out_addr + i * 8).value = tmp & mask
            carry[i] = (tmp >> bits) & mask
        self._load(out_addr + count * 8).value = \
            splits[count - 1][1] + splits[count - 2][2] + carry[count - 1]

    def bn254fr_bigint_convert_to_overflow_representation(self):
        overflow_bits = self._pop_u32()
        bits = self._pop_u32()
        in_count = self._pop_u32()
        out_count = self._pop_u32()
        in_addr = self._pop_u32()
        out_addr = self._pop_u32()
        val = self._compose(in_addr, in_count, bits)
        omask = (1 << overflow_bits) - 1
        cur = val
        for i in range(out_count):
            x_i = cur & omask
            self._load(out_addr + i * 8).value = x_i
            cur = (cur - x_i) >> bits

    def bn254fr_bigint_print(self):
        bits = self._pop_u32()
        limbs = self._pop_u32()
        addr = self._pop_u32()
        val = self._compose_signed(addr, limbs, bits)
        print(f"@bn254fr_bigint_print {val:#x}")

    def finalize(self):
        pass
