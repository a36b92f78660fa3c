"""`wasi_snapshot_preview1` host module
(``include/host_modules/wasi_preview1.hpp``).

``args_get`` copies program arguments into guest memory and marks the bytes
of private-index args secret — this is how secret inputs enter the guest.
"""

from __future__ import annotations

import os
import sys

from ..values import Num, WasmTrap, ExitProgram, u32


class _MT19937:
    """Raw MT19937 matching ``std::mt19937`` (init_genrand seeding) so
    ``random_get`` reproduces the reference byte stream exactly
    (``wasi_preview1.hpp:198-210``: default-constructed engine, seed 5489;
    libstdc++ ``uniform_int_distribution(0,255)`` with urngrange
    2^32 - 1 computes scaling = (2^32-1)//256 = 16777215, rejects draws
    >= 256*16777215 = 4294967040, and returns draw // scaling — the
    rejection fires roughly once per ~16.8M draws, so a plain
    top-8-bits shortcut diverges from the reference byte stream)."""

    def __init__(self, seed: int = 5489):
        mt = [seed & 0xFFFFFFFF]
        for i in range(1, 624):
            mt.append((1812433253 * (mt[-1] ^ (mt[-1] >> 30)) + i)
                      & 0xFFFFFFFF)
        self.mt = mt
        self.idx = 624

    def _generate(self):
        mt = self.mt
        for i in range(624):
            y = (mt[i] & 0x80000000) | (mt[(i + 1) % 624] & 0x7FFFFFFF)
            v = mt[(i + 397) % 624] ^ (y >> 1)
            if y & 1:
                v ^= 0x9908B0DF
            mt[i] = v
        self.idx = 0

    def next_u32(self) -> int:
        if self.idx >= 624:
            self._generate()
        y = self.mt[self.idx]
        self.idx += 1
        y ^= y >> 11
        y ^= (y << 7) & 0x9D2C5680
        y ^= (y << 15) & 0xEFC60000
        y ^= y >> 18
        return y

    _UID_SCALING = (2**32 - 1) // 256          # 16777215
    _UID_PAST = 256 * _UID_SCALING             # 4294967040

    def next_byte(self) -> int:
        d = self.next_u32()
        while d >= self._UID_PAST:
            d = self.next_u32()
        return d // self._UID_SCALING


class WasiModule:
    name = "wasi_snapshot_preview1"

    def __init__(self, ctx, args: list[bytes], private_indices: set[int]):
        self.ctx = ctx
        self.args = args
        self.private_indices = private_indices
        self._rand = _MT19937()

    def call(self, func: str):
        handler = getattr(self, func, None)
        if handler is None:
            raise WasmTrap(f"wasi.{func} not implemented")
        handler()

    def args_sizes_get(self):
        ctx = self.ctx
        size_ptr = ctx.make_numeric(ctx.pop()).as_u32()
        count_ptr = ctx.make_numeric(ctx.pop()).as_u32()
        ctx.memory.store_bytes(count_ptr,
                               len(self.args).to_bytes(4, "little"))
        total = sum(len(a) for a in self.args)
        ctx.memory.store_bytes(size_ptr, total.to_bytes(4, "little"))
        ctx.push(u32(0))

    def args_get(self):
        ctx = self.ctx
        mem = ctx.memory
        argv_buffer = ctx.make_numeric(ctx.pop()).as_u32()
        argv = ctx.make_numeric(ctx.pop()).as_u32()
        for i, arg in enumerate(self.args):
            mem.store_bytes(argv, argv_buffer.to_bytes(4, "little"))
            argv += 4
            mem.store_bytes(argv_buffer, arg)
            if i in self.private_indices:
                mem.mark_secret(argv_buffer, argv_buffer + len(arg))
            argv_buffer += len(arg)
        ctx.push(u32(0))

    def environ_sizes_get(self):
        ctx = self.ctx
        size_ptr = ctx.make_numeric(ctx.pop()).as_u32()
        count_ptr = ctx.make_numeric(ctx.pop()).as_u32()
        ctx.memory.store_bytes(count_ptr, (0).to_bytes(4, "little"))
        ctx.memory.store_bytes(size_ptr, (0).to_bytes(4, "little"))
        ctx.push(u32(0))

    def environ_get(self):
        ctx = self.ctx
        ctx.pop()
        ctx.pop()
        ctx.push(u32(0))

    def fd_write(self):
        ctx = self.ctx
        mem = ctx.memory
        nwritten_ptr = ctx.make_numeric(ctx.pop()).as_u32()
        iovs_len = ctx.make_numeric(ctx.pop()).as_u32()
        iovs = ctx.make_numeric(ctx.pop()).as_u32()
        fd = ctx.make_numeric(ctx.pop()).as_u32()
        total = 0
        out = sys.stdout if fd == 1 else sys.stderr
        for i in range(iovs_len):
            base = int.from_bytes(mem.load_bytes(iovs + 8 * i, 4), "little")
            ln = int.from_bytes(mem.load_bytes(iovs + 8 * i + 4, 4), "little")
            out.write(mem.load_bytes(base, ln).decode("utf-8", "replace"))
            total += ln
        mem.store_bytes(nwritten_ptr, total.to_bytes(4, "little"))
        ctx.push(u32(0))

    def fd_read(self):
        ctx = self.ctx
        mem = ctx.memory
        nread_ptr = ctx.make_numeric(ctx.pop()).as_u32()
        iovs_len = ctx.make_numeric(ctx.pop()).as_u32()
        iovs = ctx.make_numeric(ctx.pop()).as_u32()
        fd = ctx.make_numeric(ctx.pop()).as_u32()
        total = 0
        for i in range(iovs_len):
            base = int.from_bytes(mem.load_bytes(iovs + 8 * i, 4), "little")
            ln = int.from_bytes(mem.load_bytes(iovs + 8 * i + 4, 4), "little")
            data = os.read(fd, ln) if ln else b""
            mem.store_bytes(base, data)
            total += len(data)
            if len(data) < ln:
                break
        mem.store_bytes(nread_ptr, total.to_bytes(4, "little"))
        ctx.push(u32(0))

    def fd_close(self):
        self.ctx.pop()
        self.ctx.push(u32(0))

    def fd_seek(self):
        ctx = self.ctx
        for _ in range(4):
            ctx.pop()
        ctx.push(u32(0))

    def fd_fdstat_get(self):
        ctx = self.ctx
        stat_ptr = ctx.make_numeric(ctx.pop()).as_u32()
        ctx.make_numeric(ctx.pop())
        ctx.memory.store_bytes(stat_ptr, bytes(24))
        ctx.push(u32(0))

    def random_get(self):
        ctx = self.ctx
        ln = ctx.make_numeric(ctx.pop()).as_u32()
        ptr = ctx.make_numeric(ctx.pop()).as_u32()
        data = bytes(self._rand.next_byte() for _ in range(ln))
        ctx.memory.store_bytes(ptr, data)
        ctx.push(u32(0))

    def proc_exit(self):
        code = self.ctx.make_numeric(self.ctx.pop()).as_u32()
        raise ExitProgram(code)

    # ---- wasi-libc bring-up stubs ------------------------------------
    # The reference comments these out of its lookup table
    # (``wasi_preview1.hpp:216-229``) so importing guests trap there;
    # here they are implemented far enough for real wasi-libc guests to
    # start deterministically (a prover must be a pure function of its
    # inputs, so the clock is fixed and no filesystem is exposed).

    _EBADF, _ENOSYS = 8, 52

    def clock_time_get(self):
        ctx = self.ctx
        time_ptr = ctx.make_numeric(ctx.pop()).as_u32()
        ctx.make_numeric(ctx.pop())          # precision (i64)
        ctx.make_numeric(ctx.pop())          # clock id
        ctx.memory.store_bytes(time_ptr, (0).to_bytes(8, "little"))
        ctx.push(u32(0))

    def fd_prestat_get(self):
        ctx = self.ctx
        ctx.pop()                             # prestat ptr
        ctx.pop()                             # fd
        ctx.push(u32(self._EBADF))            # no preopens: ends libc scan

    def fd_prestat_dir_name(self):
        ctx = self.ctx
        for _ in range(3):
            ctx.pop()
        ctx.push(u32(self._EBADF))

    def path_open(self):
        ctx = self.ctx
        for _ in range(9):
            ctx.pop()
        ctx.push(u32(self._ENOSYS))

    def fd_readdir(self):
        ctx = self.ctx
        for _ in range(5):
            ctx.pop()
        ctx.push(u32(self._EBADF))

    def fd_filestat_get(self):
        ctx = self.ctx
        for _ in range(2):
            ctx.pop()
        ctx.push(u32(self._EBADF))

    def path_filestat_get(self):
        ctx = self.ctx
        for _ in range(5):
            ctx.pop()
        ctx.push(u32(self._ENOSYS))

    def finalize(self):
        pass
