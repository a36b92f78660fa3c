"""Streaming witness manager: rows, encoding padding, masks, constraints.

Faithful re-implementation of the reference's streaming row builder
(``include/zkp/backend/witness_manager.hpp``) and lazy-witness commit
protocol (``include/zkp/backend/lazy_witness.hpp``):

* A witness is (value, linear-test randomness, optional quadratic slot).
* On release it routes to the linear row, or — once all three slot members
  are released — to the three quadratic rows (a, b, c) with a*b = c.
* When a row holds l entries it is zero-padded to l (final partial row),
  padded from l to k with fresh *encoding randomness*, and flushed to the
  stage context.  Randomness rows are zero-padded alongside.
* ``finalize`` flushes partial rows then emits the three zero-knowledge
  mask rows (code: [rand^l, 0^(k-l)]; linear/quadratic: 2k-long
  [0, rand, 0, rand, ...] patterns whose 2k-point decode vanishes on the
  first l slots; the linear mask's odd entries sum to zero)
  (``witness_manager.hpp:271-321``).

Per-stage behaviour (which checks run, whether encoding padding is random)
is injected via a RandomPolicy, mirroring ``nonbatch_context.hpp:39-65``.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..field import bn254 as F
from .csprng import MpzRandomEngine, draw_ints
from ..utils.timer import count


@dataclass(frozen=True)
class RandomPolicy:
    pad_encoding_random: bool
    enable_code_check: bool
    enable_linear_check: bool
    enable_quadratic_check: bool


STAGE1_POLICY = RandomPolicy(True, False, False, False)
STAGE2_POLICY = RandomPolicy(True, True, True, True)
STAGE3_POLICY = RandomPolicy(True, False, False, False)
VERIFIER_POLICY = RandomPolicy(False, True, True, True)


class QuadraticSlot:
    __slots__ = ("witnesses", "ready")

    def __init__(self):
        self.witnesses = [None, None, None]
        self.ready = [False, False, False]


class LazyWitness:
    """Value + randomness + optional quadratic-slot membership."""

    __slots__ = ("value", "random", "slot", "slot_offset", "is_witness")

    def __init__(self):
        self.value = 0
        self.random = 0
        self.slot: QuadraticSlot | None = None
        self.slot_offset = -1
        self.is_witness = False

    def set_slot(self, slot: QuadraticSlot, offset: int):
        self.slot = slot
        self.slot_offset = offset


class WitnessManager:
    def __init__(self, row_size: int, padded_row_size: int,
                 policy: RandomPolicy):
        self.l = row_size
        self.k = padded_row_size
        self.policy = policy

        self.encoding_random_engine = MpzRandomEngine()
        self.code_random_engine = MpzRandomEngine()
        self.linear_random_engine = MpzRandomEngine()
        self.quadratic_random_engine = MpzRandomEngine()

        self.linear_callback = None
        self.quadratic_callback = None
        self.mask_callback = None

        self.constant_sum = 0
        self.linear_val: list[int] = []
        self.linear_random: list[int] = []
        self.quadratic_val = [[], [], []]
        self.quadratic_random = [[], [], []]

        self.linear_counter = 0
        self.quadratic_counter = 0
        self.live_witnesses = 0
        # recycle pools (``util/recycle_pool.hpp:1-95``): a secret i32.add
        # allocates ~35 LazyWitness objects x3 program executions; reusing
        # released ones keeps the front-end off the allocator
        self._wit_pool: list[LazyWitness] = []
        self._slot_pool: list[QuadraticSlot] = []

    # -- acquisition ------------------------------------------------------

    def acquire_witness(self, value: int = 0,
                        random: int = 0) -> LazyWitness:
        if self._wit_pool:
            w = self._wit_pool.pop()
            w.slot = None
            w.slot_offset = -1
        else:
            w = LazyWitness()
        w.is_witness = True
        w.value = value
        w.random = random
        self.live_witnesses += 1
        return w

    def acquire_slot(self) -> QuadraticSlot:
        if self._slot_pool:
            s = self._slot_pool.pop()
            s.witnesses[0] = s.witnesses[1] = s.witnesses[2] = None
            s.ready[0] = s.ready[1] = s.ready[2] = False
            return s
        return QuadraticSlot()

    # -- commit / release -------------------------------------------------

    def commit_release_witness(self, wit: LazyWitness):
        if not wit.is_witness:
            return
        slot = wit.slot
        if slot is not None:
            ready = slot.ready
            ready[wit.slot_offset] = True
            if ready[0] and ready[1] and ready[2]:
                self._commit_quadratic(slot)
            return
        self._commit_linear(wit)

    def _commit_linear(self, wit: LazyWitness):
        if len(self.linear_val) >= self.l:
            self.process_reset_linear_row()
        self.linear_val.append(wit.value)
        if self.policy.enable_linear_check:
            self.linear_random.append(wit.random)
        self.live_witnesses -= 1
        wit.is_witness = False
        self._wit_pool.append(wit)

    def _commit_quadratic(self, slot: QuadraticSlot):
        qv = self.quadratic_val
        if len(qv[0]) >= self.l:
            self.process_reset_quadratic_rows()
            qv = self.quadratic_val
        a, b, c = slot.witnesses
        qv[0].append(a.value)
        qv[1].append(b.value)
        qv[2].append(c.value)
        if self.policy.enable_linear_check:
            qr = self.quadratic_random
            qr[0].append(a.random)
            qr[1].append(b.random)
            qr[2].append(c.random)
        self.live_witnesses -= 3
        a.is_witness = b.is_witness = c.is_witness = False
        self._wit_pool += (a, b, c)
        self._slot_pool.append(slot)

    # -- row flushing -----------------------------------------------------

    def _pad_encoding_random(self, vec: list[int], count: int):
        if self.policy.pad_encoding_random:
            for _ in range(count):
                vec.append(F.generate_random(self.encoding_random_engine))
        else:
            vec.extend([0] * count)

    def process_reset_linear_row(self):
        if not self.linear_val:
            return
        data_size = len(self.linear_val)
        self.linear_counter += data_size
        count("witness.elements", data_size)
        self.linear_val.extend([0] * (self.l - data_size))
        self._pad_encoding_random(self.linear_val, self.k - self.l)
        if self.policy.enable_linear_check:
            self.linear_random.extend(
                [0] * (self.k - len(self.linear_random)))
        self.linear_callback(self.linear_val, self.linear_random)
        self.linear_val = []
        self.linear_random = []

    def process_reset_quadratic_rows(self):
        if not self.quadratic_val[0]:
            return
        data_size = len(self.quadratic_val[0])
        self.quadratic_counter += data_size
        count("witness.elements", 3 * data_size)
        for i in range(3):
            self.quadratic_val[i].extend([0] * (self.l - data_size))
            self._pad_encoding_random(self.quadratic_val[i], self.k - self.l)
            if self.policy.enable_linear_check:
                self.quadratic_random[i].extend(
                    [0] * (self.k - len(self.quadratic_random[i])))
        self.quadratic_callback(self.quadratic_val, self.quadratic_random)
        self.quadratic_val = [[], [], []]
        self.quadratic_random = [[], [], []]

    def process_masks(self):
        """ZK masks, exactly as ``witness_manager.hpp:271-321``."""
        # Code mask: l randoms then k-l zeros (k long).
        code: list[int] = []
        self._pad_encoding_random(code, self.l)
        code.extend([0] * (self.k - self.l))

        # Linear mask (2k long): [0, r]*(l-1), then [0, -sum(odd)], then
        # 2(k-l) randoms.  Odd entries over [0, 2l) sum to zero.
        linear: list[int] = []
        for _ in range(self.l - 1):
            linear.append(0)
            self._pad_encoding_random(linear, 1)
        s = 0
        for i in range(2 * (self.l - 1)):
            if i & 1:
                s = F.addmod(s, linear[i])
        s = F.negate(s)
        linear.append(0)
        linear.append(s)
        self._pad_encoding_random(linear, 2 * (self.k - self.l))

        # Quadratic mask (2k long): [0, r]*l then 2(k-l) randoms.
        quad: list[int] = []
        for _ in range(self.l):
            quad.append(0)
            self._pad_encoding_random(quad, 1)
        self._pad_encoding_random(quad, 2 * (self.k - self.l))

        self.mask_callback(code, linear, quad)

    # -- randomness calculus helpers -------------------------------------

    def generate_code_random(self) -> int:
        if self.policy.enable_code_check:
            return F.generate_random(self.code_random_engine)
        return 0

    def generate_linear_random(self) -> int:
        if self.policy.enable_linear_check:
            return F.generate_random(self.linear_random_engine)
        return 0

    def generate_quadratic_random(self) -> int:
        if self.policy.enable_quadratic_check:
            return F.generate_random(self.quadratic_random_engine)
        return 0

    def witness_add_random(self, wit: LazyWitness, r: int):
        if self.policy.enable_linear_check:
            wit.random = F.addmod(wit.random, r)

    def witness_sub_random(self, wit: LazyWitness, r: int):
        if self.policy.enable_linear_check:
            wit.random = F.submod(wit.random, r)

    def constsum_add(self, r: int):
        if self.policy.enable_linear_check:
            self.constant_sum = F.addmod(self.constant_sum, r)

    def constsum_sub(self, r: int):
        if self.policy.enable_linear_check:
            self.constant_sum = F.submod(self.constant_sum, r)

    # -- constraint primitives (``witness_manager.hpp:396-495``) ----------

    def constrain_constant(self, wit: LazyWitness, value: int | None = None):
        v = wit.value if value is None else value
        r = self.generate_linear_random()
        self.witness_add_random(wit, r)
        self.constsum_sub(F.mulmod(v % F.MODULUS, r))

    def constrain_equal(self, a: LazyWitness, b: LazyWitness):
        # value equality is *claimed* here; a lie makes the linear test
        # unsatisfiable (debug-only assert in the reference)
        r = self.generate_linear_random()
        self.witness_add_random(a, r)
        self.witness_sub_random(b, r)

    def constrain_linear(self, c: LazyWitness, a: LazyWitness, b: LazyWitness,
                         r: int | None = None):
        if r is None:
            r = self.generate_linear_random()
        self.witness_add_random(a, r)
        self.witness_add_random(b, r)
        self.witness_sub_random(c, r)

    def constrain_quadratic_constant(self, c: LazyWitness, a: LazyWitness,
                                     k: int):
        r = self.generate_linear_random()
        self.witness_add_random(c, r)
        self.witness_sub_random(a, F.mulmod(r, k % F.MODULUS))

    def constrain_quadratic(self, c, a, b):
        """Bind (a, b, c) into one quadratic slot with a*b = c.

        Members already in a slot are cloned (with an equality constraint)
        first, as ``witness_manager.hpp:477-495``.
        """
        slot = self.acquire_slot()
        self.join_or_clone(slot, 0, a)
        self.join_or_clone(slot, 1, b)
        self.join_or_clone(slot, 2, c)

    def join_or_clone(self, slot: QuadraticSlot, offset: int,
                      w: LazyWitness):
        """`w` takes `offset` in `slot`, or, if it is in a slot already, a
        clone of it does (``clone_into``, with a fresh linear random)."""
        if w.slot is None:
            w.slot = slot
            w.slot_offset = offset
            slot.witnesses[offset] = w
        elif self.policy.enable_linear_check:
            self.clone_into(slot, offset, w,
                            F.generate_random(self.linear_random_engine))
        else:
            self.clone_into(slot, offset, w, 0)

    def clone_into(self, slot: QuadraticSlot, offset: int, w: LazyWitness,
                   r: int):
        """A clone of `w`, constrained equal to it with the linear random
        `r` (w += r, clone -= r; `r` is 0 where the linear check is off),
        takes `offset` in `slot` and is released into it."""
        P = F.MODULUS
        w.random = (w.random + r) % P
        tmp = self.acquire_witness(w.value, P - r if r else 0)
        tmp.slot = slot
        tmp.slot_offset = offset
        slot.witnesses[offset] = tmp
        ready = slot.ready
        ready[offset] = True
        if ready[0] and ready[1] and ready[2]:
            self._commit_quadratic(slot)

    # -- finalize ---------------------------------------------------------

    def finalize(self):
        self.process_reset_linear_row()
        self.process_reset_quadratic_rows()
        self.process_masks()
        assert self.live_witnesses == 0, \
            f"{self.live_witnesses} witnesses leaked (not released)"


# -- The port's block draws ----------------------------------------------


def generate_randoms(engine: MpzRandomEngine, count: int) -> list[int]:
    """What `count` calls of ``bn254.generate_random(engine)`` return,
    drawn as one block (``csprng.draw_ints``)."""
    P = F.MODULUS
    out = [v >> 2 for v in draw_ints(engine, F.NUM_BYTES, count)]
    return [v - P if v >= P else v for v in out]
