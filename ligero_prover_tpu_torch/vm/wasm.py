"""WASM binary (.wasm) front-end.

Spec-driven decoder for the binary format (MVP + sign-extension ops,
non-trapping float conversions, bulk memory, reference types subset),
producing the same Module IR as the WAT front-end.  This is the path for
SDK-compiled guest programs (the reference parses them via wabt,
``src/webgpu_prover.cpp:198-209``).
"""

from __future__ import annotations

import struct

from .module import Module, Function, FuncType, Global, Limits
from .values import WasmTrap

_VALTYPE = {0x7F: "i32", 0x7E: "i64", 0x7D: "f32", 0x7C: "f64",
            0x70: "funcref", 0x6F: "externref", 0x7B: "v128"}


class Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def u8(self) -> int:
        b = self.data[self.pos]
        self.pos += 1
        return b

    def bytes(self, n: int) -> bytes:
        b = self.data[self.pos:self.pos + n]
        if len(b) != n:
            raise WasmTrap("unexpected end of wasm binary")
        self.pos += n
        return b

    def u32(self) -> int:
        """LEB128 unsigned."""
        result = 0
        shift = 0
        while True:
            b = self.u8()
            result |= (b & 0x7F) << shift
            if not (b & 0x80):
                return result
            shift += 7

    def s32(self) -> int:
        return self._sleb(32)

    def s64(self) -> int:
        return self._sleb(64)

    def _sleb(self, bits: int) -> int:
        result = 0
        shift = 0
        while True:
            b = self.u8()
            result |= (b & 0x7F) << shift
            shift += 7
            if not (b & 0x80):
                if b & 0x40 and shift < bits + 7:
                    result |= -(1 << shift)
                return result

    def f32(self) -> float:
        return struct.unpack("<f", self.bytes(4))[0]

    def f64(self) -> float:
        return struct.unpack("<d", self.bytes(8))[0]

    def name(self) -> str:
        n = self.u32()
        return self.bytes(n).decode("utf-8")

    def valtype(self) -> str:
        return _VALTYPE[self.u8()]

    def limits(self) -> Limits:
        flag = self.u8()
        mn = self.u32()
        mx = self.u32() if flag & 1 else None
        return Limits(mn, mx)

    def eof(self) -> bool:
        return self.pos >= len(self.data)


# opcode -> (mnemonic, immediate-kind)
# immediate kinds: none, block, idx, idx2, memarg, i32, i64, f32, f64,
#                  brtable, select_t, memidx
_OPS = {
    0x00: ("unreachable", "none"), 0x01: ("nop", "none"),
    0x0F: ("return", "none"), 0x1A: ("drop", "none"),
    0x1B: ("select", "none"), 0x1C: ("select", "select_t"),
    0xD0: ("ref.null", "heaptype"), 0xD1: ("ref.is_null", "none"),
    0xD2: ("ref.func", "idx"),
    0x20: ("local.get", "idx"), 0x21: ("local.set", "idx"),
    0x22: ("local.tee", "idx"), 0x23: ("global.get", "idx"),
    0x24: ("global.set", "idx"),
    0x25: ("table.get", "idx"), 0x26: ("table.set", "idx"),
    0x41: ("i32.const", "i32"), 0x42: ("i64.const", "i64"),
    0x43: ("f32.const", "f32"), 0x44: ("f64.const", "f64"),
    0x3F: ("memory.size", "memidx"), 0x40: ("memory.grow", "memidx"),
}

_MEM_OPS = {
    0x28: "i32.load", 0x29: "i64.load", 0x2A: "f32.load", 0x2B: "f64.load",
    0x2C: "i32.load8_s", 0x2D: "i32.load8_u", 0x2E: "i32.load16_s",
    0x2F: "i32.load16_u", 0x30: "i64.load8_s", 0x31: "i64.load8_u",
    0x32: "i64.load16_s", 0x33: "i64.load16_u", 0x34: "i64.load32_s",
    0x35: "i64.load32_u", 0x36: "i32.store", 0x37: "i64.store",
    0x38: "f32.store", 0x39: "f64.store", 0x3A: "i32.store8",
    0x3B: "i32.store16", 0x3C: "i64.store8", 0x3D: "i64.store16",
    0x3E: "i64.store32",
}

_PLAIN_OPS = {
    0x45: "i32.eqz", 0x46: "i32.eq", 0x47: "i32.ne", 0x48: "i32.lt_s",
    0x49: "i32.lt_u", 0x4A: "i32.gt_s", 0x4B: "i32.gt_u", 0x4C: "i32.le_s",
    0x4D: "i32.le_u", 0x4E: "i32.ge_s", 0x4F: "i32.ge_u",
    0x50: "i64.eqz", 0x51: "i64.eq", 0x52: "i64.ne", 0x53: "i64.lt_s",
    0x54: "i64.lt_u", 0x55: "i64.gt_s", 0x56: "i64.gt_u", 0x57: "i64.le_s",
    0x58: "i64.le_u", 0x59: "i64.ge_s", 0x5A: "i64.ge_u",
    0x5B: "f32.eq", 0x5C: "f32.ne", 0x5D: "f32.lt", 0x5E: "f32.gt",
    0x5F: "f32.le", 0x60: "f32.ge",
    0x61: "f64.eq", 0x62: "f64.ne", 0x63: "f64.lt", 0x64: "f64.gt",
    0x65: "f64.le", 0x66: "f64.ge",
    0x67: "i32.clz", 0x68: "i32.ctz", 0x69: "i32.popcnt", 0x6A: "i32.add",
    0x6B: "i32.sub", 0x6C: "i32.mul", 0x6D: "i32.div_s", 0x6E: "i32.div_u",
    0x6F: "i32.rem_s", 0x70: "i32.rem_u", 0x71: "i32.and", 0x72: "i32.or",
    0x73: "i32.xor", 0x74: "i32.shl", 0x75: "i32.shr_s", 0x76: "i32.shr_u",
    0x77: "i32.rotl", 0x78: "i32.rotr",
    0x79: "i64.clz", 0x7A: "i64.ctz", 0x7B: "i64.popcnt", 0x7C: "i64.add",
    0x7D: "i64.sub", 0x7E: "i64.mul", 0x7F: "i64.div_s", 0x80: "i64.div_u",
    0x81: "i64.rem_s", 0x82: "i64.rem_u", 0x83: "i64.and", 0x84: "i64.or",
    0x85: "i64.xor", 0x86: "i64.shl", 0x87: "i64.shr_s", 0x88: "i64.shr_u",
    0x89: "i64.rotl", 0x8A: "i64.rotr",
    0x8B: "f32.abs", 0x8C: "f32.neg", 0x8D: "f32.ceil", 0x8E: "f32.floor",
    0x8F: "f32.trunc", 0x90: "f32.nearest", 0x91: "f32.sqrt",
    0x92: "f32.add", 0x93: "f32.sub", 0x94: "f32.mul", 0x95: "f32.div",
    0x96: "f32.min", 0x97: "f32.max", 0x98: "f32.copysign",
    0x99: "f64.abs", 0x9A: "f64.neg", 0x9B: "f64.ceil", 0x9C: "f64.floor",
    0x9D: "f64.trunc", 0x9E: "f64.nearest", 0x9F: "f64.sqrt",
    0xA0: "f64.add", 0xA1: "f64.sub", 0xA2: "f64.mul", 0xA3: "f64.div",
    0xA4: "f64.min", 0xA5: "f64.max", 0xA6: "f64.copysign",
    0xA7: "i32.wrap_i64", 0xA8: "i32.trunc_f32_s", 0xA9: "i32.trunc_f32_u",
    0xAA: "i32.trunc_f64_s", 0xAB: "i32.trunc_f64_u",
    0xAC: "i64.extend_i32_s", 0xAD: "i64.extend_i32_u",
    0xAE: "i64.trunc_f32_s", 0xAF: "i64.trunc_f32_u",
    0xB0: "i64.trunc_f64_s", 0xB1: "i64.trunc_f64_u",
    0xB2: "f32.convert_i32_s", 0xB3: "f32.convert_i32_u",
    0xB4: "f32.convert_i64_s", 0xB5: "f32.convert_i64_u",
    0xB6: "f32.demote_f64",
    0xB7: "f64.convert_i32_s", 0xB8: "f64.convert_i32_u",
    0xB9: "f64.convert_i64_s", 0xBA: "f64.convert_i64_u",
    0xBB: "f64.promote_f32",
    0xBC: "i32.reinterpret_f32", 0xBD: "i64.reinterpret_f64",
    0xBE: "f32.reinterpret_i32", 0xBF: "f64.reinterpret_i64",
    0xC0: "i32.extend8_s", 0xC1: "i32.extend16_s", 0xC2: "i64.extend8_s",
    0xC3: "i64.extend16_s", 0xC4: "i64.extend32_s",
}

_FC_OPS = {  # 0xFC prefix
    0: "i32.trunc_sat_f32_s", 1: "i32.trunc_sat_f32_u",
    2: "i32.trunc_sat_f64_s", 3: "i32.trunc_sat_f64_u",
    4: "i64.trunc_sat_f32_s", 5: "i64.trunc_sat_f32_u",
    6: "i64.trunc_sat_f64_s", 7: "i64.trunc_sat_f64_u",
    8: "memory.init", 9: "data.drop", 10: "memory.copy", 11: "memory.fill",
    12: "table.init", 13: "elem.drop", 14: "table.copy", 15: "table.grow",
    16: "table.size", 17: "table.fill",
}


class WasmParser:
    def __init__(self, data: bytes):
        self.r = Reader(data)
        self.module = Module()
        self._func_type_idxs: list[int] = []
        self._num_imported_funcs = 0

    def parse(self) -> Module:
        r = self.r
        if r.bytes(4) != b"\x00asm":
            raise WasmTrap("not a wasm binary")
        if struct.unpack("<I", r.bytes(4))[0] != 1:
            raise WasmTrap("unsupported wasm version")
        while not r.eof():
            sec_id = r.u8()
            size = r.u32()
            end = r.pos + size
            handler = getattr(self, f"_sec_{sec_id}", None)
            if handler is not None:
                handler(end)
            r.pos = end
        return self.module

    # -- sections ----------------------------------------------------------

    def _sec_1(self, end):  # types
        r = self.r
        for _ in range(r.u32()):
            if r.u8() != 0x60:
                raise WasmTrap("expected functype")
            params = [r.valtype() for _ in range(r.u32())]
            results = [r.valtype() for _ in range(r.u32())]
            self.module.types.append(FuncType(params, results))

    def _sec_2(self, end):  # imports
        r = self.r
        for _ in range(r.u32()):
            mod = r.name()
            field = r.name()
            kind = r.u8()
            if kind == 0:
                ti = r.u32()
                ft = self.module.types[ti]
                self.module.funcs.append(Function(
                    FuncType(list(ft.params), list(ft.results)),
                    imported=(mod, field)))
                self._func_type_idxs.append(ti)
                self._num_imported_funcs += 1
            elif kind == 1:
                r.u8()  # reftype
                self.module.tables.append(("funcref", r.limits()))
            elif kind == 2:
                self.module.memories.append(r.limits())
            elif kind == 3:
                r.u8()
                r.u8()
                raise WasmTrap("imported globals not supported")
            else:
                raise WasmTrap(f"unknown import kind {kind}")

    def _sec_3(self, end):  # function decls
        r = self.r
        for _ in range(r.u32()):
            ti = r.u32()
            ft = self.module.types[ti]
            self.module.funcs.append(Function(
                FuncType(list(ft.params), list(ft.results))))
            self._func_type_idxs.append(ti)

    def _sec_4(self, end):  # tables
        r = self.r
        for _ in range(r.u32()):
            r.u8()  # reftype
            self.module.tables.append(("funcref", r.limits()))

    def _sec_5(self, end):  # memories
        r = self.r
        for _ in range(r.u32()):
            self.module.memories.append(r.limits())

    def _sec_6(self, end):  # globals
        r = self.r
        for _ in range(r.u32()):
            t = r.valtype()
            mutable = bool(r.u8())
            init = self._const_expr()
            self.module.globals.append(Global(t, mutable, init))

    def _sec_7(self, end):  # exports
        r = self.r
        for _ in range(r.u32()):
            name = r.name()
            kind = r.u8()
            idx = r.u32()
            if kind == 0:
                self.module.exports[name] = ("func", idx)

    def _sec_8(self, end):  # start
        self.module.start = self.r.u32()

    def _sec_9(self, end):  # elems
        r = self.r
        for _ in range(r.u32()):
            flags = r.u32()
            if flags == 0:
                offset = self._const_expr()
                idxs = [r.u32() for _ in range(r.u32())]
                self.module.elems.append((0, offset, idxs, "active"))
            elif flags == 1:
                r.u8()  # elemkind
                idxs = [r.u32() for _ in range(r.u32())]
                self.module.elems.append((0, ("i32.const", 0), idxs,
                                          "passive"))
            elif flags == 2:
                ti = r.u32()
                offset = self._const_expr()
                r.u8()
                idxs = [r.u32() for _ in range(r.u32())]
                self.module.elems.append((ti, offset, idxs, "active"))
            elif flags == 3:
                r.u8()
                idxs = [r.u32() for _ in range(r.u32())]
                self.module.elems.append((0, ("i32.const", 0), idxs,
                                          "declarative"))
            else:
                # expression-style element segments (flags 4-7)
                if flags in (4, 6):
                    offset = self._const_expr()
                else:
                    offset = ("i32.const", 0)
                if flags in (5, 6, 7):
                    r.valtype()
                if flags == 6:
                    ti = r.u32()
                idxs = []
                for _ in range(r.u32()):
                    idxs.append(self._elem_expr())
                mode = "active" if flags in (4, 6) else "passive"
                self.module.elems.append((0, offset, idxs, mode))

    def _elem_expr(self):
        r = self.r
        op = r.u8()
        if op == 0xD2:  # ref.func
            idx = r.u32()
        elif op == 0xD0:  # ref.null
            r.u8()
            idx = None
        else:
            raise WasmTrap("unsupported elem expr")
        if r.u8() != 0x0B:
            raise WasmTrap("unterminated elem expr")
        return idx

    def _sec_10(self, end):  # code
        r = self.r
        count = r.u32()
        body_funcs = [f for f in self.module.funcs if f.imported is None]
        if count != len(body_funcs):
            raise WasmTrap("code section count mismatch")
        for fn in body_funcs:
            size = r.u32()
            body_end = r.pos + size
            local_types = []
            for _ in range(r.u32()):
                n = r.u32()
                t = r.valtype()
                local_types.extend([t] * n)
            fn.locals = local_types
            fn.body = self._decode_body(body_end)
            r.pos = body_end

    def _sec_11(self, end):  # data
        r = self.r
        for _ in range(r.u32()):
            flags = r.u32()
            if flags == 0:
                offset = self._const_expr()
                data = r.bytes(r.u32())
                self.module.datas.append((0, offset, data, "active"))
            elif flags == 1:
                data = r.bytes(r.u32())
                self.module.datas.append((0, ("i32.const", 0), data,
                                          "passive"))
            elif flags == 2:
                mi = r.u32()
                offset = self._const_expr()
                data = r.bytes(r.u32())
                self.module.datas.append((mi, offset, data, "active"))
            else:
                raise WasmTrap(f"unknown data flags {flags}")

    # -- expressions -------------------------------------------------------

    def _const_expr(self):
        r = self.r
        op = r.u8()
        if op == 0x41:
            v = ("i32.const", r.s32())
        elif op == 0x42:
            v = ("i64.const", r.s64())
        elif op == 0x43:
            v = ("f32.const", r.f32())
        elif op == 0x44:
            v = ("f64.const", r.f64())
        elif op == 0x23:
            v = ("global.get", r.u32())
        else:
            raise WasmTrap(f"unsupported const expr opcode {op:#x}")
        if r.u8() != 0x0B:
            raise WasmTrap("unterminated const expr")
        return v

    def _blocktype(self) -> int:
        """Returns result arity (params unsupported beyond type-indexed)."""
        r = self.r
        b = self.r.data[r.pos]
        if b == 0x40:
            r.pos += 1
            return 0
        if b in _VALTYPE:
            r.pos += 1
            return 1
        ti = r.s32()  # type index (signed LEB)
        ft = self.module.types[ti]
        if ft.params:
            raise WasmTrap("block params not supported")
        return len(ft.results)

    def _decode_body(self, body_end: int) -> list:
        """Decode + lower to the flat instruction format (pre-resolved
        branch targets), mirroring the WAT lowering."""
        r = self.r
        code: list = []
        # control stack: (kind, header_pc, [jump_pc for if/else])
        ctrl: list[list] = []
        while r.pos < body_end:
            op = r.u8()
            if op == 0x02 or op == 0x03:  # block / loop
                arity = self._blocktype()
                ctrl.append(["block" if op == 0x02 else "loop",
                             len(code), arity, None])
                code.append(None)
            elif op == 0x04:  # if
                arity = self._blocktype()
                ctrl.append(["if", len(code), arity, None])
                code.append(None)
            elif op == 0x05:  # else
                entry = ctrl[-1]
                jmp = len(code)
                code.append(None)  # jump over else
                entry.append(jmp)
                entry[3] = len(code)  # else_pc
            elif op == 0x0B:  # end
                if not ctrl:
                    break  # function end
                kind, hdr, arity, else_pc, *rest = ctrl.pop()
                end = len(code)
                code.append(("end_block",))
                if kind == "if":
                    if rest:  # had else: patch jump-over
                        code[rest[0]] = ("jump", end)
                    code[hdr] = ("if", arity, end,
                                 else_pc if else_pc is not None else end)
                else:
                    code[hdr] = (kind, arity, end)
            elif op == 0x0C:
                code.append(("br", r.u32()))
            elif op == 0x0D:
                code.append(("br_if", r.u32()))
            elif op == 0x0E:
                depths = [r.u32() for _ in range(r.u32())]
                default = r.u32()
                code.append(("br_table", depths, default))
            elif op == 0x10:
                code.append(("call", r.u32()))
            elif op == 0x11:
                ti = r.u32()
                tbl = r.u32()
                ft = self.module.types[ti]
                code.append(("call_indirect", tbl,
                             FuncType(list(ft.params), list(ft.results))))
            elif op in _MEM_OPS:
                r.u32()  # align
                offset = r.u32()
                code.append((_MEM_OPS[op], offset))
            elif op in _PLAIN_OPS:
                code.append((_PLAIN_OPS[op],))
            elif op in _OPS:
                name, ik = _OPS[op]
                if ik == "none":
                    code.append((name,))
                elif ik == "idx":
                    code.append((name, r.u32()))
                elif ik == "i32":
                    code.append((name, r.s32()))
                elif ik == "i64":
                    code.append((name, r.s64()))
                elif ik == "f32":
                    code.append((name, r.f32()))
                elif ik == "f64":
                    code.append((name, r.f64()))
                elif ik == "memidx":
                    r.u32()
                    code.append((name, 0))
                elif ik == "select_t":
                    for _ in range(r.u32()):
                        r.u8()
                    code.append(("select",))
                elif ik == "heaptype":
                    r.u8()
                    code.append((name,))
            elif op == 0xFC:
                sub = r.u32()
                name = _FC_OPS.get(sub)
                if name is None:
                    raise WasmTrap(f"unsupported 0xFC op {sub}")
                if name in ("memory.init",):
                    di = r.u32()
                    r.u8()  # mem idx
                    code.append((name, di))
                elif name == "data.drop":
                    code.append((name, r.u32()))
                elif name == "memory.copy":
                    r.u8()
                    r.u8()
                    code.append((name, 0, 0))
                elif name == "memory.fill":
                    r.u8()
                    code.append((name, 0))
                elif name.startswith("table.") or name == "elem.drop":
                    if name in ("table.init",):
                        ei = r.u32()
                        r.u32()
                        code.append((name, ei))
                    elif name == "table.copy":
                        r.u32()
                        r.u32()
                        code.append((name, 0))
                    else:
                        code.append((name, r.u32()))
                else:  # trunc_sat family
                    code.append((name,))
            else:
                raise WasmTrap(f"unknown opcode {op:#x}")
        code.append(("end_function",))
        return code


def parse_wasm(data: bytes) -> Module:
    return WasmParser(data).parse()
