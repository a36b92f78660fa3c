"""WASM interpreter with dual public/secret semantics.

Python re-design of ``include/interpreter.hpp`` + ``interpreter_impl.hpp``:
every integer opcode has a concrete fast path when all operands are public,
and a witness path that builds BN254-Fr constraints otherwise.  The ZK
encodings follow the reference exactly (file:line cited per handler):

  add       : field-add, 33/65-bit decompose, drop carry   (impl:265-298)
  sub       : add 2^N first, decompose, drop carry         (impl:300-349)
  mul       : decompose the 64/128-bit product             (impl:351-393)
  div/rem   : oracle quotient + range check + r < y        (impl:395-595)
  and/or/xor: bitwise over decomposed bits                 (impl:597-704)
  shifts    : bit-vector manipulation (public shift count) (impl:706-887)
  clz/ctz/popcnt: bit scans                                (impl:155-263)
  compares  : bitwise_eq / bitwise_gt                      (impl:889-1162)
  select    : is_zero*f + ~is_zero*t                       (impl:118-140)
  loads     : secret-interval check -> witness             (impl:2204-2298)
  stores    : mark/unmark secret bytes                     (impl:2300-2389)

Floats are public-only, as in the reference (impl:1314-1851).
"""

from __future__ import annotations

import math
import struct

import numpy as np

from .values import (Num, Ref, WasmTrap, ExitProgram, I32, I64, F32, F64,
                     MASK32, MASK64, u32, u64, f32, f64)
from .module import Store, ModuleInstance, Function, instantiate
from ..zkp.backend import Managed, DecomposedBits, SIGN, UNSIGN
from ..utils.timer import span


def _sdiv(a: int, b: int) -> int:
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


def _fdiv(a: float, b: float) -> float:
    """IEEE 754 division on Python floats (spec exec/numerics fdiv).

    Python raises ZeroDivisionError for b == +-0; WASM requires
    nan for 0/0 and nan operands, and a correctly-signed infinity
    otherwise."""
    if b != 0 or math.isnan(b):
        return a / b
    if math.isnan(a) or a == 0:
        return float("nan")
    sign = math.copysign(1.0, a) * math.copysign(1.0, b)
    return math.copysign(float("inf"), sign)


def _fmin(a: float, b: float) -> float:
    """WASM fmin: NaN-propagating, min(-0, +0) = -0 (spec fmin)."""
    if math.isnan(a) or math.isnan(b):
        return float("nan")
    if a == b == 0:  # distinguish signed zeros, which compare equal
        return a if math.copysign(1.0, a) < 0 else b
    return min(a, b)


def _fmax(a: float, b: float) -> float:
    """WASM fmax: NaN-propagating, max(-0, +0) = +0 (spec fmax)."""
    if math.isnan(a) or math.isnan(b):
        return float("nan")
    if a == b == 0:
        return a if math.copysign(1.0, a) > 0 else b
    return max(a, b)


def _srem(a: int, b: int) -> int:
    r = abs(a) % abs(b)
    return -r if a < 0 else r


class Frame:
    __slots__ = ("locals", "module", "arity", "stack_height")

    def __init__(self, locals_, module, arity, stack_height):
        self.locals = locals_
        self.module = module
        self.arity = arity
        self.stack_height = stack_height


class _Branch(Exception):
    """Internal: branch to relative label depth."""

    def __init__(self, depth):
        self.depth = depth


class _Return(Exception):
    pass


class VMContext:
    """Execution context: shared stack + frames + store, delegating row
    building to a ZK stage context's backend."""

    def __init__(self, zkctx):
        self.zk = zkctx
        self.backend = zkctx.backend
        self.stack: list = []
        self.frames: list[Frame] = []
        self.store: Store | None = None
        self.assert_failures = 0
        self.module: ModuleInstance | None = None
        self.host_modules: dict[str, object] = {}

    # -- stack ------------------------------------------------------------

    def push(self, v):
        if isinstance(v, int):
            raise TypeError("raw int on stack")
        self.stack.append(v)

    def pop(self):
        return self.stack.pop()

    def peek(self):
        return self.stack[-1]

    # -- memory -----------------------------------------------------------

    @property
    def memory(self):
        return self.store.memories[self.module.memaddrs[0]]

    # -- coercions (nonbatch_context.hpp:249-316) -------------------------

    def make_numeric(self, v) -> Num:
        if isinstance(v, Num):
            return v
        if isinstance(v, Managed):
            return Num(I64, v.as_u64())
        if isinstance(v, DecomposedBits):
            return Num(I64, self.backend.bit_compose_constant(v) & MASK64)
        raise WasmTrap(f"cannot coerce {type(v)} to numeric")

    def make_witness(self, v) -> Managed:
        if isinstance(v, Num):
            if v.t == I32:
                return self.backend.acquire_witness(v.as_u32())
            if v.t == I64:
                return self.backend.acquire_witness(v.as_u64())
            raise WasmTrap("cannot witness a float")
        if isinstance(v, Managed):
            return v
        if isinstance(v, DecomposedBits):
            return self.backend.bit_compose(v)
        raise WasmTrap(f"cannot coerce {type(v)} to witness")

    def make_decomposed(self, v, bits: int) -> DecomposedBits:
        if isinstance(v, Num):
            return self.backend.bit_decompose_constant(v.as_u64(), bits)
        if isinstance(v, Managed):
            return self.backend.bit_decompose(v, bits)
        if isinstance(v, DecomposedBits):
            return v
        raise WasmTrap(f"cannot decompose {type(v)}")

    def duplicate_value(self, v):
        if isinstance(v, Num):
            return Num(v.t, v.v)
        if isinstance(v, Ref):
            return Ref(v.addr)
        if isinstance(v, Managed):
            return self.backend.duplicate(v)
        if isinstance(v, DecomposedBits):
            return self.backend.bit_compose(v)
        raise WasmTrap("cannot duplicate value")


class Interpreter:
    def __init__(self, ctx: VMContext, count_ops: bool = False):
        self.ctx = ctx
        # opcode-frequency counters (``interpreter_impl.hpp:54-103``):
        # opt-in (LIGERO_OPCOUNT=1 via vm/run.py) — None keeps the
        # dispatch loop branchless-cheap.
        self.op_counts: dict[str, int] | None = {} if count_ops else None

    def report_op_counts(self, top: int = 20) -> list[tuple[str, int]]:
        if not self.op_counts:
            return []
        return sorted(self.op_counts.items(), key=lambda kv: -kv[1])[:top]

    # ==================== function invocation ====================

    def call_function(self, funcaddr: int):
        ctx = self.ctx
        fn: Function = ctx.store.functions[funcaddr]
        if fn.imported is not None:
            mod_name, field = fn.imported
            mod = ctx.host_modules.get(mod_name)
            if mod is None:
                raise WasmTrap(f"unknown host module {mod_name}")
            with span("vm.hostcall"):
                mod.call(field)
            return
        nparams = len(fn.type.params)
        args = [ctx.pop() for _ in range(nparams)][::-1]
        locals_ = args
        for t in fn.locals:
            if t in (I32, I64):
                locals_.append(Num(t, 0))
            else:
                locals_.append(Num(t, 0.0))
        frame = Frame(locals_, ctx.module, len(fn.type.results),
                      len(ctx.stack))
        ctx.frames.append(frame)
        try:
            self._run_body(fn.body)
        except _Return:
            pass
        # keep top arity results, drop the rest above the frame base
        results = [ctx.pop() for _ in range(frame.arity)][::-1]
        del ctx.stack[frame.stack_height:]
        ctx.stack.extend(results)
        ctx.frames.pop()
        del locals_

    def _run_body(self, code):
        ctx = self.ctx
        stack = ctx.stack
        # control stack entries: (kind, start_pc, end_pc, arity, height)
        ctrl: list[tuple] = []
        pc = 0
        dispatch = self.dispatch
        counts = self.op_counts
        while True:
            instr = code[pc]
            op = instr[0]
            if counts is not None:
                counts[op] = counts.get(op, 0) + 1
            if op == "end_function":
                return
            if op == "block":
                ctrl.append(("block", pc, instr[2], instr[1], len(stack)))
                pc += 1
                continue
            if op == "loop":
                ctrl.append(("loop", pc, instr[2], instr[1], len(stack)))
                pc += 1
                continue
            if op == "if":
                cond = ctx.make_numeric(ctx.pop()).as_u32()
                ctrl.append(("block", pc, instr[2], instr[1], len(stack)))
                pc = pc + 1 if cond else instr[3]
                continue
            if op == "end_block":
                ctrl.pop()
                pc += 1
                continue
            if op == "jump":
                pc = instr[1]
                continue
            if op == "br":
                pc = self._do_branch(ctrl, instr[1])
                continue
            if op == "br_if":
                cond = ctx.make_numeric(ctx.pop()).as_u32()
                if cond:
                    pc = self._do_branch(ctrl, instr[1])
                else:
                    pc += 1
                continue
            if op == "br_table":
                i = ctx.make_numeric(ctx.pop()).as_u32()
                depths, default = instr[1], instr[2]
                d = depths[i] if i < len(depths) else default
                pc = self._do_branch(ctrl, d)
                continue
            if op == "return":
                raise _Return()
            if op == "call":
                self.call_function(ctx.frames[-1].module.funcaddrs[instr[1]])
                pc += 1
                continue
            if op == "call_indirect":
                ti = ctx.make_numeric(ctx.pop()).as_u32()
                tab = ctx.store.tables[
                    ctx.frames[-1].module.tableaddrs[instr[1]]]
                if ti >= len(tab.elems):
                    raise WasmTrap("call_indirect: index out of range")
                ref = tab.elems[ti]
                if ref.addr is None:
                    raise WasmTrap("call_indirect: null reference")
                self.call_function(ref.addr)
                pc += 1
                continue
            handler = dispatch.get(op)
            if handler is None:
                raise WasmTrap(f"unhandled opcode {op}")
            handler(self, instr)
            pc += 1

    def _do_branch(self, ctrl, depth) -> int:
        ctx = self.ctx
        entry = ctrl[-1 - depth]
        kind, start_pc, end_pc, arity, height = entry
        if kind == "loop":
            # loops have no result values carried on back-edges (MVP blocks)
            del ctx.stack[height:]
            del ctrl[len(ctrl) - depth:]   # keep the loop's own entry
            return start_pc + 1
        vals = [ctx.pop() for _ in range(arity)][::-1]
        del ctx.stack[height:]
        ctx.stack.extend(vals)
        del ctrl[len(ctrl) - 1 - depth:]
        return end_pc + 1  # entries removed; skip the end_block marker

    # ==================== numeric helpers ====================

    def _binop_pub(self, instr, fn32, fn64):
        ctx = self.ctx
        sy = ctx.pop()
        sx = ctx.pop()
        if isinstance(sx, Num) and isinstance(sy, Num):
            if sx.t == I32:
                ctx.push(u32(fn32(sx, sy)))
            else:
                ctx.push(u64(fn64(sx, sy)))
            return None
        return sx, sy

    # ==================== integer opcodes ====================

    def op_const(self, instr):
        op = instr[0]
        t = op.split(".")[0]
        if t == I32:
            self.ctx.push(u32(instr[1]))
        elif t == I64:
            self.ctx.push(u64(instr[1]))
        elif t == F32:
            self.ctx.push(f32(instr[1]))
        else:
            self.ctx.push(f64(instr[1]))

    def op_add(self, instr):
        ctx = self.ctx
        b = self.ctx.backend
        nb = 32 if instr[0].startswith("i32") else 64
        r = self._binop_pub(instr,
                            lambda x, y: x.as_u32() + y.as_u32(),
                            lambda x, y: x.as_u64() + y.as_u64())
        if r is None:
            return
        sx, sy = r
        x = ctx.make_witness(sx)
        y = ctx.make_witness(sy)
        overflowed = b.eval(x + y)
        bits = b.bit_decompose(overflowed, nb + 1)
        bits.drop_msb(1)
        del x, y, overflowed
        ctx.push(bits)

    def op_sub(self, instr):
        ctx = self.ctx
        b = ctx.backend
        nb = 32 if instr[0].startswith("i32") else 64
        r = self._binop_pub(instr,
                            lambda x, y: x.as_u32() - y.as_u32(),
                            lambda x, y: x.as_u64() - y.as_u64())
        if r is None:
            return
        sx, sy = r
        x = ctx.make_witness(sx)
        y = ctx.make_witness(sy)
        overflowed = b.eval((1 << nb) - y + x)
        bits = b.bit_decompose(overflowed, nb + 1)
        bits.drop_msb(1)
        del x, y, overflowed
        ctx.push(bits)

    def op_mul(self, instr):
        ctx = self.ctx
        b = ctx.backend
        nb = 32 if instr[0].startswith("i32") else 64
        r = self._binop_pub(instr,
                            lambda x, y: x.as_u32() * y.as_u32(),
                            lambda x, y: x.as_u64() * y.as_u64())
        if r is None:
            return
        sx, sy = r
        x = ctx.make_witness(sx)
        y = ctx.make_witness(sy)
        overflow = b.eval(x * y)
        bits = b.bit_decompose(overflow, 2 * nb)
        bits.drop_msb(nb)
        del x, y, overflow
        ctx.push(bits)

    def _divrem_public(self, sx, sy, nb, sign, want_rem):
        if sy.as_u64() == 0:
            raise WasmTrap("integer divide by zero")
        if sign:
            a = sx.as_s32() if nb == 32 else sx.as_s64()
            c = sy.as_s32() if nb == 32 else sy.as_s64()
            if not want_rem and a == -(1 << (nb - 1)) and c == -1:
                raise WasmTrap("integer overflow")
            v = _srem(a, c) if want_rem else _sdiv(a, c)
        else:
            a = sx.as_u32() if nb == 32 else sx.as_u64()
            c = sy.as_u32() if nb == 32 else sy.as_u64()
            v = a % c if want_rem else a // c
        return u32(v) if nb == 32 else u64(v)

    def _divrem_witness(self, sx, sy, nb, sign, want_rem):
        """impl:395-595."""
        ctx = self.ctx
        b = ctx.backend
        msb = nb - 1
        x = ctx.make_witness(sx)
        y = ctx.make_witness(sy)
        if y.val == 0:
            raise WasmTrap("integer divide by zero")
        if sign:
            bx = b.bit_decompose(x, nb)
            by = b.bit_decompose(y, nb)
            pow_ = 1 << nb
            abs_x = b.eval(bx[msb] * (pow_ - x) + ~bx[msb] * x)
            abs_y = b.eval(by[msb] * (pow_ - y) + ~by[msb] * y)
            q, r_ = b.idivide_qr(abs_x, abs_y)
            _range_q = b.bit_decompose(q, nb)
            del _range_q
            abs_y_bit = b.bit_decompose(abs_y, nb)
            br_ = b.bit_decompose(r_, nb)
            gt, eq = b.bitwise_gt(abs_y_bit, br_, SIGN)
            b.assert_const(gt, 1)
            b.assert_const(eq, 0)
            del gt, eq, abs_y_bit, br_
            if not want_rem:
                neg = b.bitwise_xor(bx[msb], by[msb])
                ovf_q = b.eval((pow_) - q)
                bneg_q = b.bit_decompose(ovf_q, nb + 1)
                bneg_q.drop_msb(1)
                neg_q = b.bit_compose(bneg_q)
                res = b.eval(neg * neg_q + ~neg * q)
                del neg, ovf_q, bneg_q, neg_q, q, r_, abs_x, abs_y, bx, by
                del x, y
                return res
            ovf_r = b.eval((pow_) - r_)
            bneg_r = b.bit_decompose(ovf_r, nb + 1)
            bneg_r.drop_msb(1)
            neg_r = b.bit_compose(bneg_r)
            res = b.eval(bx[msb] * neg_r + ~bx[msb] * r_)
            del ovf_r, bneg_r, neg_r, q, r_, abs_x, abs_y, bx, by, x, y
            return res
        q, r_ = b.idivide_qr(x, y)
        _range_q = b.bit_decompose(q, nb)
        del _range_q
        by = b.bit_decompose(y, nb)
        br_ = b.bit_decompose(r_, nb)
        gt, eq = b.bitwise_gt(by, br_, UNSIGN)
        b.assert_const(gt, 1)
        b.assert_const(eq, 0)
        del gt, eq, by, br_, x, y
        return r_ if want_rem else q

    def op_divrem(self, instr):
        ctx = self.ctx
        op = instr[0]
        nb = 32 if op.startswith("i32") else 64
        sign = op.endswith("_s")
        want_rem = ".rem" in op
        sy = ctx.pop()
        sx = ctx.pop()
        if isinstance(sx, Num) and isinstance(sy, Num):
            ctx.push(self._divrem_public(sx, sy, nb, sign, want_rem))
            return
        ctx.push(self._divrem_witness(sx, sy, nb, sign, want_rem))

    def op_bitwise(self, instr):
        ctx = self.ctx
        b = ctx.backend
        op = instr[0]
        nb = 32 if op.startswith("i32") else 64
        kind = op.split(".")[1]
        pub = {"and": lambda x, y: x & y, "or": lambda x, y: x | y,
               "xor": lambda x, y: x ^ y}[kind]
        r = self._binop_pub(instr,
                            lambda x, y: pub(x.as_u32(), y.as_u32()),
                            lambda x, y: pub(x.as_u64(), y.as_u64()))
        if r is None:
            return
        sx, sy = r
        x = ctx.make_decomposed(sx, nb)
        y = ctx.make_decomposed(sy, nb)
        out = []
        for i in range(nb):
            if kind == "and":
                out.append(b.eval(x[i] & y[i]))
            elif kind == "or":
                out.append(b.eval(x[i] + y[i] - (x[i] & y[i])))
            else:
                out.append(b.bitwise_xor(x[i], y[i]))
        del x, y
        ctx.push(DecomposedBits(out))

    def op_shift(self, instr):
        ctx = self.ctx
        b = ctx.backend
        op = instr[0]
        nb = 32 if op.startswith("i32") else 64
        kind = op.split(".")[1]
        shift = ctx.pop()
        sx = ctx.pop()
        n = ctx.make_numeric(shift).as_u32() % nb
        if isinstance(sx, Num):
            xv = sx.as_u32() if nb == 32 else sx.as_u64()
            mask = MASK32 if nb == 32 else MASK64
            if kind == "shl":
                v = (xv << n) & mask
            elif kind == "shr_u":
                v = xv >> n
            elif kind == "shr_s":
                s = xv - (1 << nb) if xv >= (1 << (nb - 1)) else xv
                v = (s >> n) & mask
            elif kind == "rotl":
                v = ((xv << n) | (xv >> (nb - n))) & mask if n else xv
            else:  # rotr
                v = ((xv >> n) | (xv << (nb - n))) & mask if n else xv
            ctx.push(u32(v) if nb == 32 else u64(v))
            return
        x = ctx.make_decomposed(sx, nb)
        if kind == "shl":
            zero = b.eval(0)
            x.push_lsb(zero, n)
            x.drop_msb(n)
            del zero
            ctx.push(x)
        elif kind == "shr_u":
            zero = b.eval(0)
            x.drop_lsb(n)
            x.push_msb(zero, n)
            del zero
            ctx.push(x)
        elif kind == "shr_s":
            pad = b.duplicate(x[nb - 1])
            x.drop_lsb(n)
            x.push_msb(pad, n)
            del pad
            ctx.push(x)
        elif kind == "rotl":
            out = [x[nb - n + i] for i in range(n)] + \
                  [x[i - n] for i in range(n, nb)]
            x.bits = []  # transfer ownership without re-release
            ctx.push(DecomposedBits(out))
        else:  # rotr
            out = [x[i] for i in range(n, nb)] + [x[i] for i in range(n)]
            x.bits = []
            ctx.push(DecomposedBits(out))

    def op_unary_bits(self, instr):
        """clz/ctz/popcnt (impl:155-263)."""
        ctx = self.ctx
        b = ctx.backend
        op = instr[0]
        nb = 32 if op.startswith("i32") else 64
        kind = op.split(".")[1]
        sx = ctx.pop()
        if isinstance(sx, Num):
            xv = sx.as_u32() if nb == 32 else sx.as_u64()
            if kind == "clz":
                v = nb - xv.bit_length()
            elif kind == "ctz":
                v = nb if xv == 0 else (xv & -xv).bit_length() - 1
            else:
                v = bin(xv).count("1")
            ctx.push(u32(v) if nb == 32 else u64(v))
            return
        bits = ctx.make_decomposed(sx, nb)
        if kind == "popcnt":
            acc = b.eval(0)
            for i in range(nb):
                acc = b.eval(acc + bits[i])
        elif kind == "clz":
            acc = b.eval(~bits[nb - 1])
            cont = b.duplicate(acc)
            for i in range(nb - 2, -1, -1):
                cont = b.eval(cont & ~bits[i])
                acc = b.eval(acc + cont)
            del cont
        else:  # ctz
            acc = b.eval(~bits[0])
            cont = b.duplicate(acc)
            for i in range(1, nb):
                cont = b.eval(cont & ~bits[i])
                acc = b.eval(acc + cont)
            del cont
        del bits
        ctx.push(acc)

    def op_eqz(self, instr):
        ctx = self.ctx
        b = ctx.backend
        nb = 32 if instr[0].startswith("i32") else 64
        sx = ctx.pop()
        if isinstance(sx, Num):
            v = (sx.as_u32() if nb == 32 else sx.as_u64()) == 0
            ctx.push(u32(int(v)) if nb == 32 else u64(int(v)))
            return
        x = ctx.make_decomposed(sx, nb)
        acc = b.eval(~x[0])
        for i in range(1, nb):
            acc = b.eval(acc & ~x[i])
        del x
        ctx.push(acc)

    def op_compare(self, instr):
        ctx = self.ctx
        b = ctx.backend
        op = instr[0]
        nb = 32 if op.startswith("i32") else 64
        kind = op.split(".")[1]
        sy = ctx.pop()
        sx = ctx.pop()
        if isinstance(sx, Num) and isinstance(sy, Num):
            if kind.endswith("_s"):
                a = sx.as_s32() if nb == 32 else sx.as_s64()
                c = sy.as_s32() if nb == 32 else sy.as_s64()
            else:
                a = sx.as_u32() if nb == 32 else sx.as_u64()
                c = sy.as_u32() if nb == 32 else sy.as_u64()
            base = kind.split("_")[0]
            v = {"eq": a == c, "ne": a != c, "lt": a < c, "gt": a > c,
                 "le": a <= c, "ge": a >= c}[base]
            ctx.push(u32(int(v)) if nb == 32 else u64(int(v)))
            return
        sign = SIGN if kind.endswith("_s") else UNSIGN
        base = kind.split("_")[0]
        x = ctx.make_decomposed(sx, nb)
        y = ctx.make_decomposed(sy, nb)
        if base == "eq":
            res = b.bitwise_eq(x, y)
        elif base == "ne":
            res = b.eval(~b.bitwise_eq(x, y))
        elif base == "lt":
            gt, eq = b.bitwise_gt(x, y, sign)
            res = b.eval(~(gt + eq))
            del gt, eq
        elif base == "gt":
            gt, eq = b.bitwise_gt(x, y, sign)
            res = gt
            del eq
        elif base == "le":
            gt, eq = b.bitwise_gt(x, y, sign)
            res = b.eval(~gt)
            del gt, eq
        else:  # ge
            gt, eq = b.bitwise_gt(x, y, sign)
            res = b.eval(gt + eq)
            del gt, eq
        del x, y
        ctx.push(res)

    def op_extend(self, instr):
        """extend8_s/16_s/32_s, i64.extend_i32_s/u, i32.wrap_i64
        (impl:1164-1310)."""
        ctx = self.ctx
        b = ctx.backend
        op = instr[0]
        nb = 32 if op.startswith("i32") else 64
        sx = ctx.pop()
        if op == "i32.wrap_i64":
            if isinstance(sx, Num):
                ctx.push(u32(sx.as_u64()))
                return
            bits = ctx.make_decomposed(sx, 64)
            bits.drop_msb(32)
            ctx.push(bits)
            return
        if op in ("i64.extend_i32_s", "i64.extend_i32_u"):
            sign = op.endswith("_s")
            if isinstance(sx, Num):
                v = sx.as_s32() if sign else sx.as_u32()
                ctx.push(u64(v))
                return
            bits = ctx.make_decomposed(sx, 32)
            if sign:
                for _ in range(32):
                    bits.bits.append(b.duplicate(bits[31]))
            else:
                zero = b.eval(0)
                bits.push_msb(zero, 32)
                del zero
            ctx.push(bits)
            return
        width = int(op.split("extend")[1].split("_")[0])  # 8, 16, 32
        if isinstance(sx, Num):
            v = sx.as_u64() & ((1 << width) - 1)
            if v >= (1 << (width - 1)):
                v -= 1 << width
            ctx.push(u32(v) if nb == 32 else u64(v))
            return
        bits = ctx.make_decomposed(sx, nb)
        bits.drop_msb(nb - width)
        for _ in range(width, nb):
            bits.bits.append(b.duplicate(bits[width - 1]))
        ctx.push(bits)

    # ==================== parametric / variable ====================

    def op_drop(self, instr):
        self.ctx.pop()

    def op_select(self, instr):
        ctx = self.ctx
        b = ctx.backend
        sc = ctx.pop()
        if isinstance(sc, Num):
            f_ = ctx.pop()
            t_ = ctx.pop()
            ctx.push(t_ if sc.as_u32() else f_)
            return
        c = ctx.make_decomposed(sc, 32)
        f_ = ctx.make_witness(ctx.pop())
        t_ = ctx.make_witness(ctx.pop())
        is_zero = b.bitwise_eqz(c)
        v = b.eval(is_zero * f_ + ~is_zero * t_)
        del c, f_, t_, is_zero
        ctx.push(v)

    def op_local_get(self, instr):
        ctx = self.ctx
        v = ctx.frames[-1].locals[instr[1]]
        if isinstance(v, DecomposedBits):
            v = DecomposedBits(list(v.bits))
        ctx.push(v)

    def op_local_set(self, instr):
        ctx = self.ctx
        ctx.frames[-1].locals[instr[1]] = ctx.pop()

    def op_local_tee(self, instr):
        ctx = self.ctx
        v = ctx.peek()
        if isinstance(v, DecomposedBits):
            v = DecomposedBits(list(v.bits))
        ctx.frames[-1].locals[instr[1]] = v

    def op_global_get(self, instr):
        ctx = self.ctx
        g = ctx.store.globals[ctx.frames[-1].module.globaladdrs[instr[1]]]
        ctx.push(Num(g.val.t, g.val.v))

    def op_global_set(self, instr):
        ctx = self.ctx
        g = ctx.store.globals[ctx.frames[-1].module.globaladdrs[instr[1]]]
        v = ctx.pop()
        if not isinstance(v, Num):
            raise WasmTrap("global.set of non-public value")
        g.val = v

    # ==================== memory ====================

    _LOAD_SPEC = {
        "i32.load": (4, False, I32), "i64.load": (8, False, I64),
        "f32.load": (4, False, F32), "f64.load": (8, False, F64),
        "i32.load8_s": (1, True, I32), "i32.load8_u": (1, False, I32),
        "i32.load16_s": (2, True, I32), "i32.load16_u": (2, False, I32),
        "i64.load8_s": (1, True, I64), "i64.load8_u": (1, False, I64),
        "i64.load16_s": (2, True, I64), "i64.load16_u": (2, False, I64),
        "i64.load32_s": (4, True, I64), "i64.load32_u": (4, False, I64),
    }

    def op_load(self, instr):
        ctx = self.ctx
        op, offset = instr[0], instr[1]
        size, sign, out_t = self._LOAD_SPEC[op]
        mem = ctx.memory
        i = ctx.make_numeric(ctx.pop()).as_u32()
        ea = i + offset
        raw = mem.load_bytes(ea, size)
        if out_t == F32:
            ctx.push(Num(F32, struct.unpack("<f", raw)[0]))
            return
        if out_t == F64:
            ctx.push(Num(F64, struct.unpack("<d", raw)[0]))
            return
        v = int.from_bytes(raw, "little", signed=sign)
        result = u32(v) if out_t == I32 else u64(v)
        if mem.contains_secret(ea, ea + size):
            ctx.push(ctx.make_witness(result))
        else:
            ctx.push(result)

    _STORE_SPEC = {
        "i32.store": (4, I32), "i64.store": (8, I64),
        "f32.store": (4, F32), "f64.store": (8, F64),
        "i32.store8": (1, I32), "i32.store16": (2, I32),
        "i64.store8": (1, I64), "i64.store16": (2, I64),
        "i64.store32": (4, I64),
    }

    def op_store(self, instr):
        ctx = self.ctx
        op, offset = instr[0], instr[1]
        size, t = self._STORE_SPEC[op]
        mem = ctx.memory
        val = ctx.pop()
        addr = ctx.pop()
        ea = ctx.make_numeric(addr).as_u32() + offset
        if ea + size > len(mem.data):
            raise WasmTrap("Invalid memory address")
        if isinstance(val, Num):
            mem.unmark(ea, ea + size)
        else:
            mem.mark_secret(ea, ea + size)
        if t == F32:
            raw = struct.pack("<f", ctx.make_numeric(val).as_f32())
        elif t == F64:
            raw = struct.pack("<d", ctx.make_numeric(val).as_f64())
        else:
            num = ctx.make_numeric(val)
            v = num.as_u32() if t == I32 else num.as_u64()
            raw = (v & ((1 << (8 * size)) - 1)).to_bytes(size, "little")
        mem.store_bytes(ea, raw)

    def op_memory_size(self, instr):
        self.ctx.push(u32(self.ctx.memory.num_pages))

    def op_memory_grow(self, instr):
        n = self.ctx.make_numeric(self.ctx.pop()).as_u32()
        self.ctx.push(u32(self.ctx.memory.grow(n)))

    def op_memory_fill(self, instr):
        ctx = self.ctx
        mem = ctx.memory
        n = ctx.make_numeric(ctx.pop()).as_u32()
        val = ctx.make_numeric(ctx.pop()).as_u32() & 0xFF
        d = ctx.make_numeric(ctx.pop()).as_u32()
        if d + n > len(mem.data):
            raise WasmTrap("memory_fill: Invalid address")
        mem.data[d:d + n] = bytes([val]) * n
        mem.unmark(d, d + n)

    def op_memory_copy(self, instr):
        ctx = self.ctx
        mem = ctx.memory
        count = ctx.make_numeric(ctx.pop()).as_u32()
        src = ctx.make_numeric(ctx.pop()).as_u32()
        dst = ctx.make_numeric(ctx.pop()).as_u32()
        mem.memcpy_secrets(dst, src, count)

    def op_memory_init(self, instr):
        ctx = self.ctx
        mem = ctx.memory
        data = ctx.store.datas[ctx.frames[-1].module.dataaddrs[instr[1]]]
        n = ctx.make_numeric(ctx.pop()).as_u32()
        s = ctx.make_numeric(ctx.pop()).as_u32()
        d = ctx.make_numeric(ctx.pop()).as_u32()
        if s + n > len(data) or d + n > len(mem.data):
            raise WasmTrap("memory_init: Invalid address")
        mem.data[d:d + n] = data[s:s + n]
        mem.unmark(d, d + n)

    def op_data_drop(self, instr):
        ctx = self.ctx
        ctx.store.datas[ctx.frames[-1].module.dataaddrs[instr[1]]] = b""

    # ==================== refs / tables ====================

    def op_ref_null(self, instr):
        self.ctx.push(Ref(None))

    def op_ref_is_null(self, instr):
        v = self.ctx.pop()
        self.ctx.push(u32(int(v.addr is None)))

    def op_ref_func(self, instr):
        ctx = self.ctx
        ctx.push(Ref(ctx.frames[-1].module.funcaddrs[instr[1]]))

    def op_table_get(self, instr):
        ctx = self.ctx
        tab = ctx.store.tables[ctx.frames[-1].module.tableaddrs[instr[1]]]
        i = ctx.make_numeric(ctx.pop()).as_u32()
        if i >= len(tab.elems):
            raise WasmTrap("table_get: index out of range")
        ctx.push(tab.elems[i])

    def op_table_set(self, instr):
        ctx = self.ctx
        tab = ctx.store.tables[ctx.frames[-1].module.tableaddrs[instr[1]]]
        val = ctx.pop()
        i = ctx.make_numeric(ctx.pop()).as_u32()
        if i >= len(tab.elems):
            raise WasmTrap("table_set: index out of range")
        tab.elems[i] = val

    def op_table_size(self, instr):
        ctx = self.ctx
        tab = ctx.store.tables[ctx.frames[-1].module.tableaddrs[instr[1]]]
        ctx.push(u32(len(tab.elems)))

    def op_table_grow(self, instr):
        ctx = self.ctx
        tab = ctx.store.tables[ctx.frames[-1].module.tableaddrs[instr[1]]]
        sz = len(tab.elems)
        n = ctx.make_numeric(ctx.pop()).as_u32()
        val = ctx.pop()
        tab.elems.extend([val] * n)
        ctx.push(u32(sz))

    def op_table_fill(self, instr):
        ctx = self.ctx
        tab = ctx.store.tables[ctx.frames[-1].module.tableaddrs[instr[1]]]
        n = ctx.make_numeric(ctx.pop()).as_u32()
        val = ctx.pop()
        i = ctx.make_numeric(ctx.pop()).as_u32()
        if i + n > len(tab.elems):
            raise WasmTrap("table_fill: index out of bound")
        for j in range(n):
            tab.elems[i + j] = val

    # ==================== floats (public only, impl:1314-1851) ==========

    def _fbin(self, instr, fn):
        ctx = self.ctx
        y = ctx.make_numeric(ctx.pop())
        x = ctx.make_numeric(ctx.pop())
        t = instr[0].split(".")[0]
        v = fn(x.as_f64(), y.as_f64())
        if math.isnan(v):
            v = float("nan")  # canonical quiet NaN (deterministic profile)
        ctx.push(f32(v) if t == F32 else f64(v))

    def _fcmp(self, instr, fn):
        ctx = self.ctx
        y = ctx.make_numeric(ctx.pop())
        x = ctx.make_numeric(ctx.pop())
        ctx.push(u32(int(fn(x.as_f64(), y.as_f64()))))

    def _funary(self, instr, fn):
        ctx = self.ctx
        x = ctx.make_numeric(ctx.pop())
        t = instr[0].split(".")[0]
        v = fn(x.as_f64())
        if math.isnan(v):
            v = float("nan")
        ctx.push(f32(v) if t == F32 else f64(v))

    def op_float(self, instr):
        op = instr[0]
        kind = op.split(".")[1]
        if kind == "add":
            self._fbin(instr, lambda a, b: a + b)
        elif kind == "sub":
            self._fbin(instr, lambda a, b: a - b)
        elif kind == "mul":
            self._fbin(instr, lambda a, b: a * b)
        elif kind == "div":
            self._fbin(instr, _fdiv)
        elif kind == "min":
            self._fbin(instr, _fmin)
        elif kind == "max":
            self._fbin(instr, _fmax)
        elif kind == "copysign":
            self._fbin(instr, lambda a, b: math.copysign(a, b))
        elif kind == "eq":
            self._fcmp(instr, lambda a, b: a == b)
        elif kind == "ne":
            self._fcmp(instr, lambda a, b: a != b)
        elif kind == "lt":
            self._fcmp(instr, lambda a, b: a < b)
        elif kind == "gt":
            self._fcmp(instr, lambda a, b: a > b)
        elif kind == "le":
            self._fcmp(instr, lambda a, b: a <= b)
        elif kind == "ge":
            self._fcmp(instr, lambda a, b: a >= b)
        elif kind == "abs":
            self._funary(instr, abs)
        elif kind == "neg":
            self._funary(instr, lambda a: -a)
        elif kind == "ceil":
            self._funary(instr, lambda a: float(np.ceil(a)))
        elif kind == "floor":
            self._funary(instr, lambda a: float(np.floor(a)))
        elif kind == "trunc":
            self._funary(instr, lambda a: float(np.trunc(a)))
        elif kind == "nearest":
            self._funary(instr, lambda a: float(np.rint(a)))
        elif kind == "sqrt":
            self._funary(instr, lambda a: math.sqrt(a) if a >= 0
                         else float("nan"))
        else:
            raise WasmTrap(f"unhandled float op {op}")

    def op_convert(self, instr):
        ctx = self.ctx
        op = instr[0]
        dst, kind = op.split(".")
        x = ctx.make_numeric(ctx.pop())
        if kind.startswith("convert_"):
            src_sign = kind.endswith("_s")
            src64 = "i64" in kind
            v = (x.as_s64() if src64 else x.as_s32()) if src_sign else \
                (x.as_u64() if src64 else x.as_u32())
            ctx.push(f32(float(v)) if dst == F32 else f64(float(v)))
        elif kind == "demote_f64":
            ctx.push(f32(x.as_f64()))
        elif kind == "promote_f32":
            ctx.push(f64(x.as_f32()))
        elif kind.startswith("trunc_sat_") or kind.startswith("trunc_f"):
            sat = "sat" in kind
            signed = kind.endswith("_s")
            bits = 32 if dst == I32 else 64
            v = x.as_f64()
            lo = -(1 << (bits - 1)) if signed else 0
            hi = (1 << (bits - 1)) - 1 if signed else (1 << bits) - 1
            if math.isnan(v):
                if not sat:
                    raise WasmTrap("invalid conversion to integer")
                r = 0
            else:
                t = math.trunc(v)
                if t < lo or t > hi:
                    if not sat:
                        raise WasmTrap("integer overflow")
                    r = lo if t < lo else hi
                else:
                    r = int(t)
            ctx.push(u32(r) if dst == I32 else u64(r))
        elif kind == "reinterpret_f32":
            ctx.push(u32(struct.unpack("<I", struct.pack(
                "<f", x.as_f32()))[0]))
        elif kind == "reinterpret_f64":
            ctx.push(u64(struct.unpack("<Q", struct.pack(
                "<d", x.as_f64()))[0]))
        elif kind == "reinterpret_i32":
            ctx.push(Num(F32, struct.unpack("<f", struct.pack(
                "<I", x.as_u32()))[0]))
        elif kind == "reinterpret_i64":
            ctx.push(Num(F64, struct.unpack("<d", struct.pack(
                "<Q", x.as_u64()))[0]))
        else:
            raise WasmTrap(f"unhandled conversion {op}")

    def op_nop(self, instr):
        pass

    def op_unreachable(self, instr):
        raise WasmTrap("Unreachable")

    # ==================== dispatch table ====================

    dispatch: dict = {}


def _build_dispatch():
    d = {}
    for t in ("i32", "i64"):
        d[f"{t}.const"] = Interpreter.op_const
        d[f"{t}.add"] = Interpreter.op_add
        d[f"{t}.sub"] = Interpreter.op_sub
        d[f"{t}.mul"] = Interpreter.op_mul
        for o in ("div_s", "div_u", "rem_s", "rem_u"):
            d[f"{t}.{o}"] = Interpreter.op_divrem
        for o in ("and", "or", "xor"):
            d[f"{t}.{o}"] = Interpreter.op_bitwise
        for o in ("shl", "shr_s", "shr_u", "rotl", "rotr"):
            d[f"{t}.{o}"] = Interpreter.op_shift
        for o in ("clz", "ctz", "popcnt"):
            d[f"{t}.{o}"] = Interpreter.op_unary_bits
        d[f"{t}.eqz"] = Interpreter.op_eqz
        for o in ("eq", "ne", "lt_s", "lt_u", "gt_s", "gt_u",
                  "le_s", "le_u", "ge_s", "ge_u"):
            d[f"{t}.{o}"] = Interpreter.op_compare
        d[f"{t}.extend8_s"] = Interpreter.op_extend
        d[f"{t}.extend16_s"] = Interpreter.op_extend
    d["i64.extend32_s"] = Interpreter.op_extend
    d["i64.extend_i32_s"] = Interpreter.op_extend
    d["i64.extend_i32_u"] = Interpreter.op_extend
    d["i32.wrap_i64"] = Interpreter.op_extend
    for t in ("f32", "f64"):
        d[f"{t}.const"] = Interpreter.op_const
        for o in ("add", "sub", "mul", "div", "min", "max", "copysign",
                  "eq", "ne", "lt", "gt", "le", "ge", "abs", "neg", "ceil",
                  "floor", "trunc", "nearest", "sqrt"):
            d[f"{t}.{o}"] = Interpreter.op_float
        for o in ("convert_i32_s", "convert_i32_u", "convert_i64_s",
                  "convert_i64_u"):
            d[f"{t}.{o}"] = Interpreter.op_convert
    d["f32.demote_f64"] = Interpreter.op_convert
    d["f64.promote_f32"] = Interpreter.op_convert
    for dst in ("i32", "i64"):
        for src in ("f32", "f64"):
            for s in ("s", "u"):
                d[f"{dst}.trunc_{src}_{s}"] = Interpreter.op_convert
                d[f"{dst}.trunc_sat_{src}_{s}"] = Interpreter.op_convert
    d["i32.reinterpret_f32"] = Interpreter.op_convert
    d["i64.reinterpret_f64"] = Interpreter.op_convert
    d["f32.reinterpret_i32"] = Interpreter.op_convert
    d["f64.reinterpret_i64"] = Interpreter.op_convert
    for op in Interpreter._LOAD_SPEC:
        d[op] = Interpreter.op_load
    for op in Interpreter._STORE_SPEC:
        d[op] = Interpreter.op_store
    d.update({
        "nop": Interpreter.op_nop,
        "unreachable": Interpreter.op_unreachable,
        "drop": Interpreter.op_drop,
        "select": Interpreter.op_select,
        "local.get": Interpreter.op_local_get,
        "local.set": Interpreter.op_local_set,
        "local.tee": Interpreter.op_local_tee,
        "global.get": Interpreter.op_global_get,
        "global.set": Interpreter.op_global_set,
        "memory.size": Interpreter.op_memory_size,
        "memory.grow": Interpreter.op_memory_grow,
        "memory.fill": Interpreter.op_memory_fill,
        "memory.copy": Interpreter.op_memory_copy,
        "memory.init": Interpreter.op_memory_init,
        "data.drop": Interpreter.op_data_drop,
        "ref.null": Interpreter.op_ref_null,
        "ref.is_null": Interpreter.op_ref_is_null,
        "ref.func": Interpreter.op_ref_func,
        "table.get": Interpreter.op_table_get,
        "table.set": Interpreter.op_table_set,
        "table.size": Interpreter.op_table_size,
        "table.grow": Interpreter.op_table_grow,
        "table.fill": Interpreter.op_table_fill,
    })
    return d


Interpreter.dispatch = _build_dispatch()
