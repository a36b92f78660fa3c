"""`vbn254fr` host module — SIMD/batch field rows, device-resident
(``include/host_modules/vbn254fr.hpp``).

A guest handle names one of 512 row-slots of k BN254-Fr elements.  The
reference keeps the arena in one big WebGPU buffer and launches an
``Eltwise*`` kernel per op; here the arena is one (512, k, 8) int32 tensor
on the executor's device, updated in place by each guest op, so slots never
round-trip to the host.  Committed rows enter the same batched stage
pipelines as witness rows via the stage context's
``on_batch_{init,bit,equal,quadratic}`` hooks
(``nonbatch_context.hpp:497-553, 782-847, 996-1048, 1306-1350``):

* ``init``  — a freshly-set row: tail [l, k) gets fresh encoding
  randomness, row is committed.
* ``bit``   — commits the row plus a quadratic bit check x∘x = x.
* ``equal`` — commits both rows plus a quadratic-test term r*(x - y).
* ``quadratic`` — commits (x, y, z) plus the check r*(x∘y - z).

Rows handed to the hooks are copies, never views of the arena: the
contexts queue them until a flush, and the arena changes meanwhile.

Pure linear ops (addmod & co) compute values only, exactly like the
reference — the SDK's circuits route soundness through the hooks above.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from ...field import bn254 as F
from ...field.limbs import ints_to_limbs
from ...ops import fieldops as fo
from ..values import WasmTrap, u32, u64

MAX_VARIABLES = 512
NLIMB = 8


class Arena:
    """The (512, k, 8) slot tensor and the guest ops on it.  The linear ops
    (``add``, ``sub`` and the constant forms) write their result into the
    output slot in place (``out=``; on CUDA one KA launch, which reads both
    operands of an element before it writes it, so the output slot may be
    an input slot) and pass a constant by value, from the host, as the
    reference's one in-place update of a donated buffer does
    (``ligero_prover_tpu/vm/hostmods/vbn254fr.py:75-82, 94-107``).  The
    products (``mul``, ``div``, ``mul_const``, ``mont_mul_const``) compute
    a new tensor and copy it into the slot."""

    def __init__(self, k: int, device):
        self.device = device
        self.rows = torch.zeros((MAX_VARIABLES, k, NLIMB), dtype=torch.int32,
                                device=device)

    def const(self, limbs: np.ndarray) -> torch.Tensor:
        return fo.to_torch(limbs, self.device)

    def get(self, xi: int) -> torch.Tensor:
        return self.rows[xi].clone()

    def put(self, oi: int, value: torch.Tensor) -> torch.Tensor:
        self.rows[oi].copy_(value)
        return value

    def set_row(self, oi: int, row: np.ndarray):
        self.put(oi, self.const(row))

    def clear_row(self, oi: int):
        self.rows[oi].zero_()

    def copy(self, xi: int, oi: int) -> torch.Tensor:
        return self.put(oi, self.get(xi))

    def add(self, xi, yi, oi):
        fo.addmod(self.rows[xi], self.rows[yi], out=self.rows[oi])

    def sub(self, xi, yi, oi):
        fo.submod(self.rows[xi], self.rows[yi], out=self.rows[oi])

    def mul(self, xi, yi, oi):
        rx, ry = self.get(xi), self.get(yi)
        return rx, ry, self.put(oi, fo.mulmod(rx, ry))

    def div(self, xi, yi, oi):
        rx, ry = self.get(xi), self.get(yi)
        out = self.put(oi, fo.mulmod(rx, fo.invmod(ry)))
        return out, ry, rx

    # the constant stays on the host (fo.to_torch's default device): KA
    # takes one host element by value
    def add_const(self, xi, oi, c):
        fo.addmod(self.rows[xi], fo.to_torch(c), out=self.rows[oi])

    def sub_const(self, xi, oi, c):
        fo.submod(self.rows[xi], fo.to_torch(c), out=self.rows[oi])

    def const_sub(self, xi, oi, c):
        fo.submod(fo.to_torch(c), self.rows[xi], out=self.rows[oi])

    def mul_const(self, xi, oi, c):
        self.put(oi, fo.mulmod(self.rows[xi], self.const(c)))

    def mont_mul_const(self, xi, oi, c):
        # x * c * 2^-256 mod p: the guest passes c premultiplied by R
        # (``engine.cpp`` EltwiseMontMultMod semantics).
        self.put(oi, fo.mont_mul(self.rows[xi], self.const(c)))

    def bit_decompose(self, xi: int, slots: np.ndarray) -> torch.Tensor:
        x = self.rows[xi].to(torch.int64) & fo.MASK32            # (k, 8)
        shifts = torch.arange(32, device=self.device)
        bits = ((x[:, :, None] >> shifts) & 1).reshape(x.shape[0], -1)
        rows = torch.zeros((F.NUM_BITS,) + tuple(x.shape),
                           dtype=torch.int32, device=self.device)
        rows[:, :, 0] = bits[:, :F.NUM_BITS].T
        self.rows[fo.upload(torch.from_numpy(slots.astype(np.int64)),
                            self.device)] = rows
        return rows


class VBn254frModule:
    name = "vbn254fr"

    def __init__(self, ctx):
        self.ctx = ctx
        self.zk = ctx.zk
        self.l = self.zk.l
        self.k = self.zk.k
        self.arena = None                    # lazy (vbn254fr.hpp:47-52)
        self.free_list: deque[int] = deque()

    def call(self, func: str):
        handler = getattr(self, func, None)
        if handler is None:
            raise WasmTrap(f"vbn254fr.{func} not implemented")
        handler()

    def finalize(self):
        pass

    # -- plumbing ----------------------------------------------------------

    def _init_arena(self):
        executor = getattr(self.zk, "executor", None)
        device = executor.device if executor is not None else "cpu"
        self.arena = Arena(self.k, device)
        self.free_list = deque(range(MAX_VARIABLES))

    def _allocate(self) -> int:
        if self.arena is None:
            self._init_arena()
        if not self.free_list:
            raise WasmTrap(
                f"vbn254fr: bad alloc, 0/{MAX_VARIABLES} free slots")
        return self.free_list.popleft()

    def _pop_u32(self) -> int:
        return self.ctx.make_numeric(self.ctx.pop()).as_u32()

    def _pop_u64(self) -> int:
        return self.ctx.make_numeric(self.ctx.pop()).as_u64()

    def _load(self, addr: int) -> int:
        slot = int.from_bytes(self.ctx.memory.load_bytes(addr, 4), "little")
        if self.arena is None or slot >= MAX_VARIABLES:
            raise WasmTrap(f"vbn254fr: invalid handle {slot}")
        return slot

    def _store(self, addr: int, slot: int):
        self.ctx.memory.store_bytes(addr, slot.to_bytes(4, "little"))
        # handles are public metadata (vbn254fr.hpp:103-109)
        self.ctx.memory.unmark(addr, addr + 4)

    def _wants_rows(self) -> bool:
        return getattr(self.zk, "wants_batch_rows", True)

    def _rows_np(self, *rows):
        """Rows handed to the batch hooks STAY DEVICE-RESIDENT: the stage
        contexts stack them straight into the next pipeline batch, so no
        device->host->device round trip happens per row (measured: the
        per-row readback dominated end-to-end prove wall-clock)."""
        if not self._wants_rows():
            return [None] * len(rows)
        return list(rows)

    def _make_row(self, values: list[int]) -> np.ndarray:
        """Build a full k-wide limb row: values, zeros to l, encoding
        randomness tail [l, k) (``nonbatch_context.hpp:497-505``)."""
        if len(values) > self.l:
            raise WasmTrap("vbn254fr: too many elements for a batch row")
        row = np.zeros((self.k, NLIMB), np.uint32)
        ints_to_limbs([v % F.MODULUS for v in values], row[:len(values)])
        tail = self.zk.batch_encoding_tail()
        if tail is not None:
            ints_to_limbs(tail, row[self.l:self.l + len(tail)])
        return row

    def _set_and_init(self, slot: int, values: list[int]):
        row = self._make_row(values)
        self.arena.set_row(slot, row)
        self.zk.on_batch_init(row)

    # -- alloc / free ------------------------------------------------------

    def vbn254fr_get_size(self):
        self.ctx.push(u64(self.l))

    def vbn254fr_alloc(self):
        fp_addr = self._pop_u32()
        self._store(fp_addr, self._allocate())

    def vbn254fr_free(self):
        fp_addr = self._pop_u32()
        slot = self._load(fp_addr)
        self.arena.clear_row(slot)
        self.free_list.append(slot)
        self._store(fp_addr, 0)

    # -- setters -----------------------------------------------------------

    def vbn254fr_set_ui(self):
        length = self._pop_u64()
        ui_ptr = self._pop_u32()
        fp_addr = self._pop_u32()
        raw = self.ctx.memory.load_bytes(ui_ptr, 4 * length)
        vals = list(np.frombuffer(raw, np.uint32).astype(object))
        self._set_and_init(self._load(fp_addr), vals)

    def vbn254fr_set_ui_scalar(self):
        ui = self._pop_u32()
        fp_addr = self._pop_u32()
        self._set_and_init(self._load(fp_addr), [ui] * self.l)

    def _read_cstr(self, addr: int) -> str:
        mem = self.ctx.memory
        end = mem.data.index(0, addr)
        return bytes(mem.data[addr:end]).decode()

    def _parse_int(self, s: str, base: int) -> int:
        if base == 0:
            return int(s, 0)
        if base == 16 and s.startswith(("0x", "0X")):
            return int(s, 16)
        return int(s, base)

    def vbn254fr_set_str(self):
        base = self._pop_u32()
        length = self._pop_u64()
        str_ptr_ptr = self._pop_u32()
        fp_addr = self._pop_u32()
        err = 0
        vals = []
        for i in range(length):
            p = int.from_bytes(
                self.ctx.memory.load_bytes(str_ptr_ptr + 4 * i, 4), "little")
            try:
                vals.append(self._parse_int(self._read_cstr(p), base))
            except ValueError:
                err = 0xFFFFFFFF
                vals.append(0)
        self._set_and_init(self._load(fp_addr), vals)
        self.ctx.push(u32(err))

    def vbn254fr_set_str_scalar(self):
        base = self._pop_u32()
        str_addr = self._pop_u32()
        fp_addr = self._pop_u32()
        err = 0
        try:
            v = self._parse_int(self._read_cstr(str_addr), base)
        except ValueError:
            err, v = 0xFFFFFFFF, 0
        self._set_and_init(self._load(fp_addr), [v] * self.l)
        self.ctx.push(u32(err))

    def vbn254fr_set_bytes(self):
        count = self._pop_u64()
        length = self._pop_u64()
        bytes_ptr = self._pop_u32()
        fp_addr = self._pop_u32()
        vals = []
        for i in range(count):
            raw = self.ctx.memory.load_bytes(bytes_ptr + length * i, length)
            vals.append(int.from_bytes(raw, "big"))
        self._set_and_init(self._load(fp_addr), vals)

    def vbn254fr_set_bytes_scalar(self):
        length = self._pop_u64()
        bytes_ptr = self._pop_u32()
        fp_addr = self._pop_u32()
        v = int.from_bytes(self.ctx.memory.load_bytes(bytes_ptr, length),
                           "big")
        self._set_and_init(self._load(fp_addr), [v] * self.l)

    def vbn254fr_constant_set_str(self):
        base = self._pop_u32()
        str_addr = self._pop_u32()
        out_addr = self._pop_u32()
        err = 0
        try:
            v = self._parse_int(self._read_cstr(str_addr), base)
        except ValueError:
            err, v = 0xFFFFFFFF, 0
        self.ctx.memory.store_bytes(
            out_addr, (v % (1 << 256)).to_bytes(32, "little"))
        self.ctx.push(u32(err))

    # -- copy / print ------------------------------------------------------

    def vbn254fr_copy(self):
        in_addr = self._pop_u32()
        out_addr = self._pop_u32()
        xi = self._load(in_addr)
        oi = self._load(out_addr)
        rx = self.arena.copy(xi, oi)
        rout, rin = self._rows_np(rx, rx)
        self.zk.on_batch_equal(rout, rin)

    def vbn254fr_print(self):
        base = self._pop_u32()
        addr = self._pop_u32()
        xi = self._load(addr)
        from ...field.limbs import limbs_to_ints
        head = limbs_to_ints(fo.to_numpy(self.arena.get(xi))[:3])
        if base == 16:
            txt = " ".join(hex(v) for v in head)
        elif base == 10:
            txt = " ".join(str(v) for v in head)
        else:
            raise WasmTrap("bad conversion")
        print(f"@print [handle={xi}] vec: {txt} ...")

    # -- arithmetic --------------------------------------------------------

    def _pop3_slots(self):
        y_addr = self._pop_u32()
        x_addr = self._pop_u32()
        out_addr = self._pop_u32()
        return self._load(x_addr), self._load(y_addr), self._load(out_addr)

    def _pop_const_slots(self):
        """(out, x, k_ptr) arg order: constant is 8 little-endian u32 limbs
        in guest memory (``vbn254fr.hpp:369-384``)."""
        k_addr = self._pop_u32()
        x_addr = self._pop_u32()
        out_addr = self._pop_u32()
        c = int.from_bytes(self.ctx.memory.load_bytes(k_addr, 32), "little")
        climbs = ints_to_limbs([c % F.MODULUS])[0]
        return self._load(x_addr), self._load(out_addr), climbs

    def vbn254fr_addmod(self):
        xi, yi, oi = self._pop3_slots()
        self.arena.add(xi, yi, oi)

    def vbn254fr_submod(self):
        xi, yi, oi = self._pop3_slots()
        self.arena.sub(xi, yi, oi)

    def vbn254fr_addmod_constant(self):
        xi, oi, c = self._pop_const_slots()
        self.arena.add_const(xi, oi, c)

    def vbn254fr_submod_constant(self):
        xi, oi, c = self._pop_const_slots()
        self.arena.sub_const(xi, oi, c)

    def vbn254fr_constant_submod(self):
        # (out, k_ptr, x): k - x elementwise
        x_addr = self._pop_u32()
        k_addr = self._pop_u32()
        out_addr = self._pop_u32()
        c = int.from_bytes(self.ctx.memory.load_bytes(k_addr, 32), "little")
        climbs = ints_to_limbs([c % F.MODULUS])[0]
        self.arena.const_sub(self._load(x_addr), self._load(out_addr),
                             climbs)

    def vbn254fr_mulmod_constant(self):
        xi, oi, c = self._pop_const_slots()
        self.arena.mul_const(xi, oi, c)

    def vbn254fr_mont_mul_constant(self):
        k_addr = self._pop_u32()
        x_addr = self._pop_u32()
        out_addr = self._pop_u32()
        c = int.from_bytes(self.ctx.memory.load_bytes(k_addr, 32), "little")
        climbs = ints_to_limbs([c % (1 << 256)])[0]
        self.arena.mont_mul_const(self._load(x_addr), self._load(out_addr),
                                  climbs)

    def vbn254fr_mulmod(self):
        xi, yi, oi = self._pop3_slots()
        rx, ry, out = self.arena.mul(xi, yi, oi)
        nx, ny, nz = self._rows_np(rx, ry, out)
        self.zk.on_batch_quadratic(nx, ny, nz)

    def vbn254fr_divmod(self):
        xi, yi, oi = self._pop3_slots()
        out, ry, rx = self.arena.div(xi, yi, oi)
        nx, ny, nz = self._rows_np(out, ry, rx)
        self.zk.on_batch_quadratic(nx, ny, nz)   # out * y = x

    def vbn254fr_assert_equal(self):
        y_addr = self._pop_u32()
        x_addr = self._pop_u32()
        rx = self.arena.get(self._load(x_addr))
        ry = self.arena.get(self._load(y_addr))
        nx, ny = self._rows_np(rx, ry)
        self.zk.on_batch_equal(nx, ny)

    def vbn254fr_bit_decompose(self):
        x_addr = self._pop_u32()
        out_arr_base = self._pop_u32()
        xi = self._load(x_addr)
        raw = self.ctx.memory.load_bytes(out_arr_base, 4 * F.NUM_BITS)
        slots = np.frombuffer(raw, np.uint32).astype(np.int32)
        if (slots >= MAX_VARIABLES).any():
            raise WasmTrap("vbn254fr: invalid handle in bit_decompose")
        rows = self.arena.bit_decompose(xi, slots)
        wants = self._wants_rows()
        for i in range(F.NUM_BITS):
            self.zk.on_batch_bit(rows[i] if wants else None)
