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
from .witness import WitnessManager, LazyWitness

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
        m.constrain_quadratic(z, x.wit, y.wit, m.commit_release_witness)
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
        m.constrain_quadratic(z, x.wit, y.wit, m.commit_release_witness)
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

    def constrain_bit(self, wit: LazyWitness):
        """b * b = b via two clones (``witness_manager.hpp:429-440``)."""
        assert wit.value in (0, 1)
        w1 = self.manager.acquire_witness(wit.value)
        self.manager.constrain_equal(wit, w1)
        w2 = self.manager.acquire_witness(wit.value)
        self.manager.constrain_equal(wit, w2)
        self.manager.constrain_quadratic(
            wit, w1, w2, self.manager.commit_release_witness)
        self.manager.commit_release_witness(w1)
        self.manager.commit_release_witness(w2)

    def bit_decompose(self, x: Managed, from_bits: int) -> DecomposedBits:
        m = self.manager
        decompose_rand = m.generate_linear_random()
        m.witness_sub_random(x.wit, decompose_rand)
        bits = []
        for i in range(from_bits):
            bit = (x.val >> i) & 1
            wit = m.acquire_witness(bit)
            self.constrain_bit(wit)
            m.witness_add_random(wit, (decompose_rand << i) % F.MODULUS)
            bits.append(self.make_managed(wit))
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
        m = self.manager
        s = m.acquire_witness()
        rand = m.generate_linear_random()
        m.witness_sub_random(s, rand)
        total = 0
        for i in range(len(bits)):
            total += bits[i].val << i
            m.witness_add_random(bits[i].wit, (rand << i) % F.MODULUS)
        s.value = total % F.MODULUS if total >= F.MODULUS else total
        return self.make_managed(s)

    @staticmethod
    def bit_compose_constant(bits: DecomposedBits) -> int:
        total = 0
        for i in range(len(bits)):
            total += bits[i].val << i
        return total

    def bitwise_xor(self, x: Managed, y: Managed) -> Managed:
        return self.eval(x + y - (x & y) * 2)

    def bitwise_xnor(self, x: Managed, y: Managed) -> Managed:
        return self.eval(~(x + y - (x & y) * 2))

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
