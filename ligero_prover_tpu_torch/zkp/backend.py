"""Constraint backend: expression DSL, randomness calculus, bit gadgets.

Re-implements the semantics of ``include/zkp/backend/core.hpp``: evaluating
an arithmetic expression over witnesses simultaneously computes the value
and threads the linear-test randomness so that, over all committed rows,
sum(witness_i * randomness_i) + constant_sum == 0.  The per-op randomness
rules (documented at ``core.hpp:320-646``) are reproduced case by case:

  z = x + y :  z -= r;  x += r;  y += r
  z = x + K :  z -= r;  x += r;  constsum += K*r
  z = x - y :  z -= r;  x += r;  y -= r          (sign threads inward)
  z = K - x :  z -= r;  x -= r;  constsum += K*r
  z = x * K :  z -= r;  x += K*r
  z = ~x    :  z -= r;  x -= r;  constsum += r   (z = 1 - x over bits)
  z = x * y / x & y :  new quadratic slot (x, y, z); nested use adds +r to z

Witness lifetime is managed by :class:`Managed` handles whose release
(CPython refcount hitting zero, exactly like the reference's shared_ptr
deleter at ``core.hpp:283-291``) commits the witness into the streaming
row builder.  ``DecomposedBits`` enforces reverse-order release, matching
``core.hpp:95-147``.
"""

from __future__ import annotations

from ..field import bn254 as F
from .witness import (WitnessManager, LazyWitness,
                      generate_randoms)
from ..utils.timer import count

SIGN = "sign"
UNSIGN = "unsign"


class Managed:
    """Shared handle: commit-on-last-release (cf. managed_witness)."""

    __slots__ = ("wit", "_backend", "__weakref__")

    def __init__(self, backend: "Backend", wit: LazyWitness):
        self._backend = backend
        self.wit = wit

    @property
    def val(self) -> int:
        return self.wit.value

    def set_val(self, v: int):
        self.wit.value = v % F.MODULUS if v >= F.MODULUS or v < 0 else v

    def as_u32(self) -> int:
        return self.wit.value & 0xFFFFFFFF

    def as_u64(self) -> int:
        return self.wit.value & 0xFFFFFFFFFFFFFFFF

    def __del__(self):
        b = self._backend
        if b is not None:
            b.manager.commit_release_witness(self.wit)

    # -- expression sugar --
    def __add__(self, other):
        return EAdd(self, _wrap(other))

    def __radd__(self, other):
        return EAdd(self, _wrap(other))

    def __sub__(self, other):
        return ESub(self, _wrap(other))

    def __rsub__(self, other):
        return ESub(_wrap(other), self)

    def __mul__(self, other):
        return EMul(self, _wrap(other))

    def __rmul__(self, other):
        return EMul(self, _wrap(other))

    def __and__(self, other):
        return EAnd(self, other)

    def __invert__(self):
        return ENot(self)

    # leaf eval protocol (managed_witness::eval, core.hpp:80-90)
    def eval_to_witness(self, backend):
        return self

    def eval_value(self, backend, rand: int) -> int:
        backend.manager.witness_add_random(self.wit, rand)
        return self.wit.value


class EConst:
    __slots__ = ("k",)

    def __init__(self, k: int):
        self.k = k

    def eval_to_witness(self, backend):
        w = backend.manager.acquire_witness(self.k % F.MODULUS)
        backend.manager.constrain_constant(w)
        return backend.make_managed(w)


def _wrap(x):
    return EConst(x) if isinstance(x, int) else x


class _Expr:
    __slots__ = ("a", "b")

    def __init__(self, a, b=None):
        self.a = a
        self.b = b

    def __add__(self, other):
        return EAdd(self, _wrap(other))

    def __sub__(self, other):
        return ESub(self, _wrap(other))

    def __mul__(self, other):
        return EMul(self, _wrap(other))

    def __and__(self, other):
        return EAnd(self, other)

    def __invert__(self):
        return ENot(self)

    def eval_to_witness(self, backend):
        """Top-level: allocate z, draw r, z -= r, evaluate with (out, r)."""
        m = backend.manager
        wit = m.acquire_witness()
        r = m.generate_linear_random()
        m.witness_sub_random(wit, r)
        wit.value = self.eval_value(backend, r)
        return backend.make_managed(wit)


class EAdd(_Expr):
    def eval_value(self, backend, rand):
        m = backend.manager
        if isinstance(self.b, EConst):
            x = self.a.eval_value(backend, rand)
            k = self.b.k % F.MODULUS
            if m.policy.enable_linear_check:
                m.constsum_add(F.mulmod(k, rand))
            return F.addmod(x, k)
        x = self.a.eval_value(backend, rand)
        y = self.b.eval_value(backend, rand)
        return F.addmod(x, y)


class ESub(_Expr):
    def eval_value(self, backend, rand):
        m = backend.manager
        if isinstance(self.b, EConst) and not isinstance(self.a, EConst):
            x = self.a.eval_value(backend, rand)
            k = self.b.k % F.MODULUS
            if m.policy.enable_linear_check:
                m.constsum_sub(F.mulmod(k, rand))
            return F.submod(x, k)
        if isinstance(self.a, EConst):
            x = self.b.eval_value(backend, F.negate(rand))
            k = self.a.k % F.MODULUS
            if m.policy.enable_linear_check:
                m.constsum_add(F.mulmod(k, rand))
            return F.submod(k, x)
        x = self.a.eval_value(backend, rand)
        y = self.b.eval_value(backend, F.negate(rand))
        return F.submod(x, y)


class EMul(_Expr):
    def eval_to_witness(self, backend):
        if isinstance(self.b, EConst):
            return _Expr.eval_to_witness(self, backend)
        # full quadratic gate (core.hpp:538-549)
        m = backend.manager
        x = self.a.eval_to_witness(backend)
        y = self.b.eval_to_witness(backend)
        z = m.acquire_witness(F.mulmod(x.val, y.val))
        m.constrain_quadratic(z, x.wit, y.wit)
        return backend.make_managed(z)

    def eval_value(self, backend, rand):
        m = backend.manager
        if isinstance(self.b, EConst):
            k = self.b.k % F.MODULUS
            kr = F.mulmod(k, rand) if m.policy.enable_linear_check else 0
            x = self.a.eval_value(backend, kr)
            return F.mulmod(x, k)
        z = self.eval_to_witness(backend)
        out = z.val
        if m.policy.enable_linear_check:
            m.witness_add_random(z.wit, rand)
        return out


class ENot(_Expr):
    def eval_value(self, backend, rand):
        m = backend.manager
        x = self.a.eval_value(backend, F.negate(rand))
        assert x in (0, 1)
        if m.policy.enable_linear_check:
            m.constsum_add(rand)
        return 1 - x


class EAnd(_Expr):
    def eval_to_witness(self, backend):
        m = backend.manager
        x = self.a.eval_to_witness(backend)
        y = self.b.eval_to_witness(backend)
        assert x.val in (0, 1) and y.val in (0, 1)
        z = m.acquire_witness(x.val & y.val)
        m.constrain_quadratic(z, x.wit, y.wit)
        return backend.make_managed(z)

    def eval_value(self, backend, rand):
        m = backend.manager
        z = self.eval_to_witness(backend)
        out = z.val
        if m.policy.enable_linear_check:
            m.witness_add_random(z.wit, rand)
        return out


class DecomposedBits:
    """Bit vector of managed witnesses, LSB first; releases back-to-front
    (``core.hpp:95-147``)."""

    __slots__ = ("bits",)

    def __init__(self, bits: list[Managed]):
        self.bits = bits

    def __len__(self):
        return len(self.bits)

    def __getitem__(self, i) -> Managed:
        return self.bits[i]

    def __del__(self):
        while self.bits:
            self.bits.pop()

    def drop_lsb(self, n: int):
        for i in range(n - 1, -1, -1):
            self.bits[i] = None
        del self.bits[:n]

    def drop_msb(self, n: int):
        for _ in range(n):
            self.bits.pop()

    def push_msb(self, w: Managed, n: int):
        self.bits.extend([w] * n)

    def push_lsb(self, w: Managed, n: int):
        self.bits[:0] = [w] * n


class Backend:
    """ligetron_backend equivalent (``core.hpp:277-857``)."""

    def __init__(self, packing_size: int, padded_size: int, policy):
        self.manager = WitnessManager(packing_size, padded_size, policy)

    # -- plumbing ---------------------------------------------------------

    def make_managed(self, wit: LazyWitness) -> Managed:
        return Managed(self, wit)

    def acquire_witness(self, value: int = 0) -> Managed:
        return self.make_managed(self.manager.acquire_witness(value))

    def eval(self, expr) -> Managed:
        if isinstance(expr, int):
            expr = EConst(expr)
        return expr.eval_to_witness(self)

    def duplicate(self, w: Managed) -> Managed:
        cloned = self.manager.acquire_witness(w.val)
        self.manager.constrain_equal(w.wit, cloned)
        return self.make_managed(cloned)

    def assert_const(self, w: Managed, value: int):
        self.manager.constrain_constant(w.wit, value)

    def assert_equal(self, x: Managed, y: Managed):
        self.manager.constrain_equal(x.wit, y.wit)

    def finalize(self):
        self.manager.finalize()

    # -- gadgets (core.hpp:694-848) --------------------------------------

    def idivide_qr(self, x: Managed, y: Managed):
        """Oracle division: q, r with q*y + r == x (constrained)."""
        q = self.acquire_witness(x.val // y.val if y.val else 0)
        r = self.acquire_witness(x.val % y.val if y.val else 0)
        tmp = self.eval(q * y + r)
        self.manager.constrain_equal(tmp.wit, x.wit)
        del tmp
        return q, r

    def constrain_bit(self, wit: LazyWitness, r1: int | None = None,
                      r2: int | None = None):
        """b * b = b via two clones (``witness_manager.hpp:429-440``): two
        clones of b, constrained equal to it with the linear randoms r1 and
        r2 (drawn here if not given), take offsets 0 and 1 of a new slot
        and are released into it; b takes offset 2."""
        assert wit.value in (0, 1)
        m = self.manager
        if r1 is None:
            r1 = m.generate_linear_random()
            r2 = m.generate_linear_random()
        slot = m.acquire_slot()
        m.clone_into(slot, 0, wit, r1)
        m.clone_into(slot, 1, wit, r2)
        m.join_or_clone(slot, 2, wit)

    def bit_decompose(self, x: Managed, from_bits: int) -> DecomposedBits:
        """x as `from_bits` checked bits, LSB first: draws r_d, x -= r_d,
        then per bit i acquires b with b += r_d * 2^i and constrains it
        (``constrain_bit`` with the next two draws).  The bit's slot
        commits when its handle is released.  The 1 + 2 * from_bits linear
        randoms are drawn as one block."""
        m = self.manager
        n = 1 + 2 * from_bits
        if m.policy.enable_linear_check:
            rs = generate_randoms(m.linear_random_engine, n)
        else:
            rs = [0] * n
        rd = rs[0]
        m.witness_sub_random(x.wit, rd)
        xv = x.val
        acquire = m.acquire_witness
        constrain = self.constrain_bit
        P = F.MODULUS
        bits = []
        for i in range(from_bits):
            b = acquire((xv >> i) & 1, (rd << i) % P)
            constrain(b, rs[2 * i + 1], rs[2 * i + 2])
            bits.append(Managed(self, b))
        count("gadget.bits", from_bits)
        return DecomposedBits(bits)

    def bit_decompose_constant(self, k: int, from_bits: int) -> DecomposedBits:
        m = self.manager
        bits = []
        for i in range(from_bits):
            wit = m.acquire_witness((k >> i) & 1)
            m.constrain_constant(wit)
            bits.append(self.make_managed(wit))
        return DecomposedBits(bits)

    def bit_compose(self, bits: DecomposedBits) -> Managed:
        """The witness s = sum(bit_i * 2^i): draws r, bit_i += r * 2^i,
        and s -= r (r is 0 where the linear check is off)."""
        m = self.manager
        P = F.MODULUS
        r = m.generate_linear_random()
        total = 0
        for i, b in enumerate(bits.bits):
            w = b.wit
            total += w.value << i
            w.random = (w.random + (r << i)) % P
        count("gadget.bits", len(bits.bits))
        return Managed(self, m.acquire_witness(total % P, P - r if r else 0))

    @staticmethod
    def bit_compose_constant(bits: DecomposedBits) -> int:
        total = 0
        for i in range(len(bits)):
            total += bits[i].val << i
        return total

    def bitwise(self, kind: str, xs: list, ys: list) -> list:
        """Per-bit `kind` of the bits `xs` and `ys` (Managed, LSB first):
        "and" is x & y, "or" x + y - (x & y), "xor" x + y - (x & y) * 2,
        "xnor" ~(x + y - (x & y) * 2).

        Per bit, except for "and": acquires the result w, draws r, w -= r,
        and adds the top-level randomness to the operands (or, xor: x += r,
        y += r; xnor: x -= r, y -= r, constant_sum += r).  Then x & y as
        ``constrain_quadratic`` makes it: acquires z = x & y, and x, y and z
        join a new slot in turn, an operand already in a slot by a clone
        that draws its own random.  "and" returns z's handle.  The others
        give z the product's randomness (or: -r; xor: -2r; xnor: +2r) and
        release it, which commits the slot if both operands were cloned,
        before w's handle is made.  With the linear check off every r is 0,
        so the updates change nothing."""
        m = self.manager
        lin = m.policy.enable_linear_check
        engine = m.linear_random_engine
        draw = F.generate_random
        acquire = m.acquire_witness
        acquire_slot = m.acquire_slot
        join = m.join_or_clone
        release = m.commit_release_witness
        P = F.MODULUS
        out = []
        for xm, ym in zip(xs, ys):
            xw = xm.wit
            yw = ym.wit
            xv = xw.value
            yv = yw.value
            assert (xv | yv) >> 1 == 0
            zr = 0
            if kind == "xnor":
                r = draw(engine) if lin else 0
                w = acquire(1 - (xv ^ yv), P - r if r else 0)
                xw.random = (xw.random - r) % P
                yw.random = (yw.random - r) % P
                m.constant_sum = (m.constant_sum + r) % P
                zr = 2 * r % P
            elif kind != "and":
                r = draw(engine) if lin else 0
                w = acquire(xv | yv if kind == "or" else xv ^ yv,
                            P - r if r else 0)
                xw.random = (xw.random + r) % P
                yw.random = (yw.random + r) % P
                zr = (-r if kind == "or" else -2 * r) % P
            z = acquire(xv & yv, zr)
            slot = acquire_slot()
            join(slot, 0, xw)
            join(slot, 1, yw)
            join(slot, 2, z)
            if kind == "and":
                out.append(Managed(self, z))
            else:
                release(z)
                out.append(Managed(self, w))
        count("gadget.bits", len(out))
        return out

    def bitwise_xor(self, x: Managed, y: Managed) -> Managed:
        return self.bitwise("xor", [x], [y])[0]

    def bitwise_xnor(self, x: Managed, y: Managed) -> Managed:
        return self.bitwise("xnor", [x], [y])[0]

    def bitwise_eqz(self, x: DecomposedBits) -> Managed:
        eqz = self.eval(~x[0])
        for i in range(1, len(x)):
            eqz = self.eval(eqz & ~x[i])
        return eqz

    def bitwise_eq(self, x: DecomposedBits, y: DecomposedBits) -> Managed:
        assert len(x) == len(y)
        eq = self.bitwise_xnor(x[0], y[0])
        for i in range(1, len(x)):
            eq = self.eval(eq & self.bitwise_xnor(x[i], y[i]))
        return eq

    def bitwise_gt(self, x: DecomposedBits, y: DecomposedBits, sign: str):
        """Returns (gt, eq) bits; `sign` is SIGN or UNSIGN
        (``core.hpp:823-848``)."""
        assert len(x) == len(y)
        msb = len(x) - 1
        if sign == SIGN:
            gt = self.eval(~x[msb] & y[msb])
        else:
            gt = self.eval(x[msb] & ~y[msb])
        eq = self.bitwise_xnor(x[msb], y[msb])
        for i in range(msb - 1, -1, -1):
            neq = self.bitwise_xnor(x[i], y[i])
            gt = self.eval(gt + (eq & x[i] & ~y[i]))
            eq = self.eval(eq & neq)
        return gt, eq
