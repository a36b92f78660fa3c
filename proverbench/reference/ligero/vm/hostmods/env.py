"""`env` host module: assertions, witness casts, private constants
(``include/host_modules/env.hpp``)."""

from __future__ import annotations

import sys

from ..values import Num, WasmTrap, u32


class EnvModule:
    name = "env"

    def __init__(self, ctx):
        self.ctx = ctx

    def call(self, func: str):
        handler = getattr(self, func, None)
        if handler is None:
            raise WasmTrap(f"env.{func} not implemented")
        handler()

    def assert_zero(self):
        ctx = self.ctx
        wit = ctx.make_witness(ctx.pop())
        ctx.backend.assert_const(wit, 0)

    def assert_one(self):
        ctx = self.ctx
        wit = ctx.make_witness(ctx.pop())
        ctx.backend.assert_const(wit, 1)

    def assert_equal(self):
        ctx = self.ctx
        sy = ctx.pop()
        sx = ctx.pop()
        wx = ctx.make_witness(sx)
        wy = ctx.make_witness(sy)
        if wx.val != wy.val:
            print(f"Assertion failed: {wx.val} != {wy.val}", file=sys.stderr)
            ctx.assert_failures += 1
        ctx.backend.assert_equal(wx, wy)

    def assert_constant(self):
        ctx = self.ctx
        wit = ctx.make_witness(ctx.pop())
        ctx.backend.assert_const(wit, wit.val)

    def witness_cast_u32(self):
        ctx = self.ctx
        ctx.push(ctx.make_witness(ctx.pop()))

    witness_cast_u64 = witness_cast_u32

    def assert_is_concrete(self):
        v = self.ctx.pop()
        if not isinstance(v, Num):
            raise WasmTrap("assert_is_concrete: value is a witness")

    def i32_private_const(self):
        ctx = self.ctx
        v = ctx.make_numeric(ctx.pop()).as_u32()
        x = ctx.backend.acquire_witness(v)
        # 32-bit range check via decomposition (env.hpp:166-176)
        ctx.push(ctx.backend.bit_decompose(x, 32))

    def i64_private_const(self):
        ctx = self.ctx
        v = ctx.make_numeric(ctx.pop()).as_u64()
        x = ctx.backend.acquire_witness(v)
        ctx.push(ctx.backend.bit_decompose(x, 64))

    def print_str(self):
        ctx = self.ctx
        ln = ctx.make_numeric(ctx.pop()).as_u32()
        ptr = ctx.make_numeric(ctx.pop()).as_u32()
        data = ctx.memory.load_bytes(ptr, ln)
        sys.stdout.write(data.decode("utf-8", "replace"))

    def dump_memory(self):
        ctx = self.ctx
        ln = ctx.make_numeric(ctx.pop()).as_u32()
        ptr = ctx.make_numeric(ctx.pop()).as_u32()
        print("@dump:", ctx.memory.load_bytes(ptr, ln).hex().upper())

    def file_size_get(self):
        import os
        ctx = self.ctx
        name_ptr = ctx.make_numeric(ctx.pop()).as_u64()
        path = self._read_cstr(name_ptr)
        ctx.push(u32(os.path.getsize(path)))

    def file_get(self):
        import os
        ctx = self.ctx
        name_ptr = ctx.make_numeric(ctx.pop()).as_u64()
        buf_ptr = ctx.make_numeric(ctx.pop()).as_u64()
        path = self._read_cstr(name_ptr)
        data = open(path, "rb").read()
        ctx.memory.store_bytes(buf_ptr, data)
        ctx.push(u32(len(data)))

    def _read_cstr(self, ptr: int) -> str:
        mem = self.ctx.memory
        end = mem.data.index(0, ptr)
        return bytes(mem.data[ptr:end]).decode()

    def finalize(self):
        pass
