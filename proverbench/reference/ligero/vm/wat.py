"""WAT (WebAssembly text) front-end.

Parses the s-expression text format into the :class:`~.module.Module` IR,
unfolding folded instruction forms and lowering structured control flow to
flat instructions with pre-resolved branch targets.  Covers the language
used by the conformance suite (``tests/*.wat`` in the reference) plus
general MVP WASM: imports, funcs, memory, data, globals, tables, elems,
exports, block/loop/if control, and the full numeric instruction set.
"""

from __future__ import annotations

import re
import struct

from .module import Module, Function, FuncType, Global, Limits
from .values import WasmTrap

_TOKEN_RE = re.compile(r'"(?:\\.|[^"\\])*"|[()]|[^\s()";]+')


def tokenize(src: str) -> list[str]:
    # strip comments
    out = []
    i = 0
    n = len(src)
    while i < n:
        c = src[i]
        if c == ";" and i + 1 < n and src[i + 1] == ";":
            j = src.find("\n", i)
            i = n if j < 0 else j + 1
        elif c == "(" and i + 1 < n and src[i + 1] == ";":
            depth = 1
            i += 2
            while i < n and depth:
                if src.startswith("(;", i):
                    depth += 1
                    i += 2
                elif src.startswith(";)", i):
                    depth -= 1
                    i += 2
                else:
                    i += 1
        elif c == '"':
            j = i + 1
            while j < n:
                if src[j] == "\\":
                    j += 2
                elif src[j] == '"':
                    break
                else:
                    j += 1
            out.append(src[i:j + 1])
            i = j + 1
        elif c in "()":
            out.append(c)
            i += 1
        elif c.isspace():
            i += 1
        else:
            m = _TOKEN_RE.match(src, i)
            if not m:
                raise WasmTrap(f"tokenize error at {i}")
            out.append(m.group(0))
            i = m.end()
    return out


def parse_sexpr(tokens: list[str]):
    pos = 0

    def parse():
        nonlocal pos
        tok = tokens[pos]
        if tok == "(":
            pos += 1
            items = []
            while tokens[pos] != ")":
                items.append(parse())
            pos += 1
            return items
        pos += 1
        return tok

    result = parse()
    if pos != len(tokens):
        raise WasmTrap("trailing tokens")
    return result


def _unescape(s: str) -> bytes:
    assert s[0] == '"' and s[-1] == '"'
    body = s[1:-1]
    out = bytearray()
    i = 0
    while i < len(body):
        c = body[i]
        if c == "\\":
            nxt = body[i + 1]
            if nxt in "nrt\\'\"":
                out.append({"n": 10, "r": 13, "t": 9, "\\": 92,
                            "'": 39, '"': 34}[nxt])
                i += 2
            else:
                out.append(int(body[i + 1:i + 3], 16))
                i += 3
        else:
            out.extend(c.encode("utf-8"))
            i += 1
    return bytes(out)


def parse_int(tok: str) -> int:
    tok = tok.replace("_", "")
    neg = tok.startswith("-")
    if neg:
        tok = tok[1:]
    elif tok.startswith("+"):
        tok = tok[1:]
    v = int(tok, 16) if tok.lower().startswith("0x") else int(tok, 10)
    return -v if neg else v


def parse_float(tok: str, bits: int) -> float:
    import numpy as np
    t = tok.replace("_", "")
    neg = t.startswith("-")
    if neg:
        t = t[1:]
    elif t.startswith("+"):
        t = t[1:]
    if t.startswith("nan"):
        v = float("nan")
    elif t == "inf":
        v = float("inf")
    elif t.lower().startswith("0x"):
        # hex float
        v = float.fromhex(t.lower())
    else:
        v = float(t)
    if neg:
        v = -v
    return float(np.float32(v)) if bits == 32 else v


_NUM_TYPES = {"i32", "i64", "f32", "f64"}

# Instructions taking no immediates (dispatched by name at run time)
_SIMPLE_RE = re.compile(
    r"^(i32|i64|f32|f64)\.(add|sub|mul|div|div_s|div_u|rem_s|rem_u|and|or|"
    r"xor|shl|shr_s|shr_u|rotl|rotr|clz|ctz|popcnt|eqz|eq|ne|lt|lt_s|lt_u|"
    r"gt|gt_s|gt_u|le|le_s|le_u|ge|ge_s|ge_u|abs|neg|ceil|floor|trunc|"
    r"nearest|sqrt|min|max|copysign|extend8_s|extend16_s|extend32_s|"
    r"wrap_i64|extend_i32_s|extend_i32_u|trunc_f32_s|trunc_f32_u|"
    r"trunc_f64_s|trunc_f64_u|trunc_sat_f32_s|trunc_sat_f32_u|"
    r"trunc_sat_f64_s|trunc_sat_f64_u|convert_i32_s|convert_i32_u|"
    r"convert_i64_s|convert_i64_u|demote_f64|promote_f32|reinterpret_i32|"
    r"reinterpret_i64|reinterpret_f32|reinterpret_f64)$")

_MEM_RE = re.compile(
    r"^(i32|i64|f32|f64)\.(load|store)(8|16|32)?(_s|_u)?$")


class _FuncContext:
    def __init__(self):
        self.local_names: dict[str, int] = {}
        self.label_stack: list[str | None] = []


class WatParser:
    def __init__(self):
        self.module = Module()
        self.func_names: dict[str, int] = {}
        self.global_names: dict[str, int] = {}
        self.type_names: dict[str, int] = {}
        self.table_names: dict[str, int] = {}
        self.mem_names: dict[str, int] = {}
        self.data_names: dict[str, int] = {}
        self._data_count = 0
        self._pending_funcs: list[tuple] = []

    # -- top level ---------------------------------------------------------

    def parse(self, src: str) -> Module:
        sexp = parse_sexpr(tokenize(src))
        if not (isinstance(sexp, list) and sexp and sexp[0] == "module"):
            raise WasmTrap("expected (module ...)")
        fields = sexp[1:]

        # pass 1: collect names/indices in order (imports first for funcs)
        for f in fields:
            kind = f[0] if isinstance(f, list) else None
            if kind == "import":
                self._declare_import(f)
            elif kind == "func":
                self._declare_func(f)
            elif kind == "type":
                self._declare_type(f)
            elif kind == "memory":
                self._declare_memory(f)
            elif kind == "global":
                self._declare_global(f)
            elif kind == "table":
                self._declare_table(f)
            elif kind == "data":
                if isinstance(f[1], str) and f[1].startswith("$"):
                    self.data_names[f[1]] = self._data_count
                self._data_count += 1

        # pass 2: bodies and remaining fields
        for f in fields:
            kind = f[0] if isinstance(f, list) else None
            if kind == "export":
                self._parse_export(f)
            elif kind == "data":
                self._parse_data(f)
            elif kind == "elem":
                self._parse_elem(f)
            elif kind == "start":
                self.module.start = self._func_idx(f[1])

        for func, body_fields, ctx in self._pending_funcs:
            func.body = self._lower_body(body_fields, func, ctx)

        return self.module

    # -- declarations ------------------------------------------------------

    def _parse_functype(self, items) -> FuncType:
        """items: sequence of (param ...) / (result ...) / (type $t)."""
        params, results = [], []
        for it in items:
            if isinstance(it, list) and it[0] == "param":
                toks = it[1:]
                if toks and isinstance(toks[0], str) and toks[0].startswith("$"):
                    params.append((toks[0], toks[1]))
                else:
                    params.extend((None, t) for t in toks)
            elif isinstance(it, list) and it[0] == "result":
                results.extend(it[1:])
            elif isinstance(it, list) and it[0] == "type":
                idx = self._type_idx(it[1])
                ft = self.module.types[idx]
                return FuncType(list(ft.params), list(ft.results))
        return FuncType([p[1] if isinstance(p, tuple) else p for p in params],
                        results)

    def _declare_type(self, f):
        i = 1
        if isinstance(f[i], str) and f[i].startswith("$"):
            self.type_names[f[i]] = len(self.module.types)
            i += 1
        ft = f[i]
        assert ft[0] == "func"
        self.module.types.append(self._parse_functype(ft[1:]))

    def _declare_import(self, f):
        mod_name = _unescape(f[1]).decode()
        field_name = _unescape(f[2]).decode()
        desc = f[3]
        if desc[0] == "func":
            i = 1
            name = None
            if i < len(desc) and isinstance(desc[i], str) and desc[i].startswith("$"):
                name = desc[i]
                i += 1
            ft = self._parse_functype(desc[i:])
            if name:
                self.func_names[name] = len(self.module.funcs)
            self.module.funcs.append(
                Function(ft, imported=(mod_name, field_name)))
        elif desc[0] == "memory":
            self._declare_memory(desc)
        elif desc[0] == "global":
            # imported globals unsupported for now
            raise WasmTrap("imported globals not supported")

    def _declare_func(self, f):
        i = 1
        name = None
        if i < len(f) and isinstance(f[i], str) and f[i].startswith("$"):
            name = f[i]
            i += 1
        # inline export
        export_names = []
        while i < len(f) and isinstance(f[i], list) and f[i][0] == "export":
            export_names.append(_unescape(f[i][1]).decode())
            i += 1
        # signature
        sig_items = []
        while i < len(f) and isinstance(f[i], list) and \
                f[i][0] in ("param", "result", "type"):
            sig_items.append(f[i])
            i += 1
        ft = self._parse_functype(sig_items)

        ctx = _FuncContext()
        pi = 0
        for it in sig_items:
            if it[0] == "param":
                toks = it[1:]
                if toks and isinstance(toks[0], str) and toks[0].startswith("$"):
                    ctx.local_names[toks[0]] = pi
                    pi += 1
                else:
                    pi += len(toks)
        # locals
        local_types = []
        li = pi
        while i < len(f) and isinstance(f[i], list) and f[i][0] == "local":
            toks = f[i][1:]
            if toks and isinstance(toks[0], str) and toks[0].startswith("$"):
                ctx.local_names[toks[0]] = li
                local_types.append(toks[1])
                li += 1
            else:
                local_types.extend(toks)
                li += len(toks)
            i += 1

        func = Function(ft, local_types)
        idx = len(self.module.funcs)
        if name:
            self.func_names[name] = idx
        self.module.funcs.append(func)
        for en in export_names:
            self.module.exports[en] = ("func", idx)
        self._pending_funcs.append((func, f[i:], ctx))

    def _declare_memory(self, f):
        i = 1
        if isinstance(f[i], str) and f[i].startswith("$"):
            self.mem_names[f[i]] = len(self.module.memories)
            i += 1
        mn = parse_int(f[i])
        mx = parse_int(f[i + 1]) if i + 1 < len(f) and isinstance(f[i + 1], str) \
            and not f[i + 1].startswith("$") else None
        self.module.memories.append(Limits(mn, mx))

    def _declare_global(self, f):
        i = 1
        name = None
        if isinstance(f[i], str) and f[i].startswith("$"):
            name = f[i]
            i += 1
        t = f[i]
        mutable = False
        if isinstance(t, list) and t[0] == "mut":
            mutable = True
            t = t[1]
        i += 1
        init = self._const_expr(f[i])
        if name:
            self.global_names[name] = len(self.module.globals)
        self.module.globals.append(Global(t, mutable, init))

    def _declare_table(self, f):
        i = 1
        if isinstance(f[i], str) and f[i].startswith("$"):
            self.table_names[f[i]] = len(self.module.tables)
            i += 1
        mn = parse_int(f[i])
        i += 1
        mx = None
        if i < len(f) and isinstance(f[i], str) and f[i] not in (
                "funcref", "externref"):
            mx = parse_int(f[i])
            i += 1
        elem_type = f[i] if i < len(f) else "funcref"
        self.module.tables.append((elem_type, Limits(mn, mx)))

    def _const_expr(self, e):
        op = e[0]
        if op.endswith(".const"):
            t = op.split(".")[0]
            if t in ("i32", "i64"):
                return (op, parse_int(e[1]))
            return (op, parse_float(e[1], 32 if t == "f32" else 64))
        if op == "global.get":
            return (op, self._global_idx(e[1]))
        raise WasmTrap(f"unsupported const expr {op}")

    def _parse_export(self, f):
        name = _unescape(f[1]).decode()
        desc = f[2]
        if desc[0] == "func":
            self.module.exports[name] = ("func", self._func_idx(desc[1]))

    def _parse_data(self, f):
        i = 1
        mem_idx = 0
        if isinstance(f[i], str) and f[i].startswith("$"):
            i += 1  # segment name
        if isinstance(f[i], list) and f[i][0] == "memory":
            mem_idx = parse_int(f[i][1])
            i += 1
        offset_expr = None
        if isinstance(f[i], list) and f[i][0] != "data":
            e = f[i]
            if e[0] == "offset":
                e = e[1]
            offset_expr = self._const_expr(e)
            i += 1
        data = b"".join(_unescape(s) for s in f[i:])
        mode = "active" if offset_expr is not None else "passive"
        if offset_expr is None:
            offset_expr = ("i32.const", 0)
        self.module.datas.append((mem_idx, offset_expr, data, mode))

    def _parse_elem(self, f):
        i = 1
        table_idx = 0
        if isinstance(f[i], str) and f[i].startswith("$"):
            table_idx = self.table_names[f[i]]
            i += 1
        elif isinstance(f[i], list) and f[i][0] == "table":
            table_idx = parse_int(f[i][1])
            i += 1
        offset_expr = None
        if isinstance(f[i], list) and f[i][0] in ("offset", "i32.const",
                                                  "global.get"):
            e = f[i]
            if e[0] == "offset":
                e = e[1]
            offset_expr = self._const_expr(e)
            i += 1
        if i < len(f) and f[i] in ("func", "funcref"):
            i += 1
        idxs = []
        for tok in f[i:]:
            if isinstance(tok, list) and tok[0] == "item":
                tok = tok[1][1]  # (item (ref.func $f))
            idxs.append(self._func_idx(tok))
        mode = "active" if offset_expr is not None else "passive"
        if offset_expr is None:
            offset_expr = ("i32.const", 0)
        self.module.elems.append((table_idx, offset_expr, idxs, mode))

    # -- index helpers -----------------------------------------------------

    def _func_idx(self, tok) -> int:
        return self.func_names[tok] if tok.startswith("$") else parse_int(tok)

    def _global_idx(self, tok) -> int:
        return self.global_names[tok] if tok.startswith("$") else parse_int(tok)

    def _type_idx(self, tok) -> int:
        return self.type_names[tok] if tok.startswith("$") else parse_int(tok)

    # -- instruction lowering ----------------------------------------------

    def _lower_body(self, body_fields, func, ctx: _FuncContext) -> list:
        code: list = []
        self._emit_seq(body_fields, code, ctx)
        code.append(("end_function",))
        return code

    def _emit_seq(self, items, code, ctx):
        i = 0
        while i < len(items):
            it = items[i]
            if isinstance(it, list):
                self._emit_folded(it, code, ctx)
                i += 1
            else:
                i = self._emit_plain(items, i, code, ctx)

    def _emit_folded(self, sexp, code, ctx):
        op = sexp[0]
        if op in ("block", "loop"):
            i, label = 1, None
            if i < len(sexp) and isinstance(sexp[i], str) and \
                    sexp[i].startswith("$"):
                label = sexp[i]
                i += 1
            results = []
            while i < len(sexp) and isinstance(sexp[i], list) and \
                    sexp[i][0] in ("result", "param", "type"):
                if sexp[i][0] == "result":
                    results.extend(sexp[i][1:])
                i += 1
            hdr = len(code)
            code.append(None)  # placeholder
            ctx.label_stack.append(label)
            self._emit_seq(sexp[i:], code, ctx)
            ctx.label_stack.pop()
            end = len(code)
            code.append(("end_block",))
            code[hdr] = (op, len(results), end)
        elif op == "if":
            i, label = 1, None
            if i < len(sexp) and isinstance(sexp[i], str) and \
                    sexp[i].startswith("$"):
                label = sexp[i]
                i += 1
            results = []
            while i < len(sexp) and isinstance(sexp[i], list) and \
                    sexp[i][0] == "result":
                results.extend(sexp[i][1:])
                i += 1
            # folded if: condition exprs until (then ...)
            then_i = None
            for j in range(i, len(sexp)):
                if isinstance(sexp[j], list) and sexp[j][0] == "then":
                    then_i = j
                    break
            if then_i is None:
                raise WasmTrap("folded if without then")
            for j in range(i, then_i):
                self._emit_folded(sexp[j], code, ctx)
            hdr = len(code)
            code.append(None)
            ctx.label_stack.append(label)
            self._emit_seq(sexp[then_i][1:], code, ctx)
            else_pc = None
            if then_i + 1 < len(sexp):
                els = sexp[then_i + 1]
                assert isinstance(els, list) and els[0] == "else"
                jmp = len(code)
                code.append(None)  # jump-over-else placeholder
                else_pc = len(code)
                self._emit_seq(els[1:], code, ctx)
                code[jmp] = ("jump", len(code))
            ctx.label_stack.pop()
            end = len(code)
            code.append(("end_block",))
            code[hdr] = ("if", len(results), end,
                         else_pc if else_pc is not None else end)
        else:
            # folded plain op: operands first, then the op itself
            opnds, imms = self._split_operands(sexp, ctx)
            for o in opnds:
                self._emit_folded(o, code, ctx)
            code.append(imms)

    def _split_operands(self, sexp, ctx):
        """For a folded plain instruction, separate immediates from nested
        operand expressions and return (operands, lowered_instr)."""
        op = sexp[0]
        rest = sexp[1:]
        imm_count = 0
        instr = None
        if op.endswith(".const"):
            t = op.split(".")[0]
            if t in ("i32", "i64"):
                instr = (op, parse_int(rest[0]))
            else:
                instr = (op, parse_float(rest[0], 32 if t == "f32" else 64))
            imm_count = 1
        elif _MEM_RE.match(op):
            offset = 0
            align = None
            while imm_count < len(rest) and isinstance(rest[imm_count], str) \
                    and "=" in rest[imm_count]:
                kstr, vstr = rest[imm_count].split("=")
                if kstr == "offset":
                    offset = parse_int(vstr)
                imm_count += 1
            instr = (op, offset)
        elif op in ("call",):
            instr = (op, self._func_idx(rest[0]))
            imm_count = 1
        elif op == "call_indirect":
            ti = 0
            table_idx = 0
            if imm_count < len(rest) and isinstance(rest[imm_count], str) and \
                    not isinstance(rest[imm_count], list):
                tok = rest[imm_count]
                if tok.startswith("$") and tok in self.table_names:
                    table_idx = self.table_names[tok]
                    imm_count += 1
            sig_items = []
            while imm_count < len(rest) and isinstance(rest[imm_count], list) \
                    and rest[imm_count][0] in ("type", "param", "result"):
                sig_items.append(rest[imm_count])
                imm_count += 1
            ft = self._parse_functype(sig_items)
            instr = (op, table_idx, ft)
        elif op in ("local.get", "local.set", "local.tee"):
            tok = rest[0]
            idx = ctx.local_names[tok] if tok.startswith("$") else parse_int(tok)
            instr = (op, idx)
            imm_count = 1
        elif op in ("global.get", "global.set"):
            instr = (op, self._global_idx(rest[0]))
            imm_count = 1
        elif op in ("br", "br_if"):
            instr = (op, self._label_depth(rest[0], ctx))
            imm_count = 1
        elif op == "br_table":
            depths = []
            while imm_count < len(rest) and isinstance(rest[imm_count], str) \
                    and not isinstance(rest[imm_count], list):
                tok = rest[imm_count]
                if tok.startswith("$") or tok.lstrip("-").isdigit():
                    depths.append(self._label_depth(tok, ctx))
                    imm_count += 1
                else:
                    break
            instr = (op, depths[:-1], depths[-1])
        elif op in ("memory.size", "memory.grow", "memory.fill"):
            instr = (op, 0)
        elif op == "memory.copy":
            instr = (op, 0, 0)
        elif op in ("memory.init", "data.drop"):
            tok = rest[0]
            idx = self.data_names[tok] if tok.startswith("$") else parse_int(tok)
            instr = (op, idx)
            imm_count = 1
        elif op == "ref.func":
            instr = (op, self._func_idx(rest[0]))
            imm_count = 1
        elif op == "ref.null":
            instr = (op,)
            imm_count = 1  # heap type tok
        elif op.startswith("table."):
            idx = 0
            if rest and isinstance(rest[0], str) and not isinstance(rest[0], list):
                tok = rest[0]
                if tok.startswith("$"):
                    idx = self.table_names.get(tok, 0)
                    imm_count = 1
                elif tok.isdigit():
                    idx = parse_int(tok)
                    imm_count = 1
            instr = (op, idx)
        elif op == "select":
            # ignore optional (result t)
            while imm_count < len(rest) and isinstance(rest[imm_count], list) \
                    and rest[imm_count][0] == "result":
                imm_count += 1
            instr = (op,)
        else:
            instr = (op,)
        operands = [r for r in rest[imm_count:] if isinstance(r, list)]
        return operands, instr

    def _label_depth(self, tok, ctx) -> int:
        if tok.startswith("$"):
            for d, name in enumerate(reversed(ctx.label_stack)):
                if name == tok:
                    return d
            raise WasmTrap(f"unknown label {tok}")
        return parse_int(tok)

    def _emit_plain(self, items, i, code, ctx) -> int:
        """Handle flat (non-folded) instruction streams with block/end."""
        op = items[i]
        if op in ("block", "loop", "if"):
            # flat structured: scan until matching end/else
            label = None
            j = i + 1
            if j < len(items) and isinstance(items[j], str) and \
                    items[j].startswith("$"):
                label = items[j]
                j += 1
            results = []
            while j < len(items) and isinstance(items[j], list) and \
                    items[j][0] == "result":
                results.extend(items[j][1:])
                j += 1
            # find matching else/end at depth 0
            depth = 0
            else_at = None
            k = j
            while k < len(items):
                t = items[k]
                if isinstance(t, str):
                    if t in ("block", "loop", "if"):
                        depth += 1
                    elif t == "end":
                        if depth == 0:
                            break
                        depth -= 1
                    elif t == "else" and depth == 0:
                        else_at = k
                k += 1
            if k >= len(items):
                raise WasmTrap("unterminated block")
            hdr = len(code)
            code.append(None)
            ctx.label_stack.append(label)
            if op == "if" and else_at is not None:
                self._emit_seq(items[j:else_at], code, ctx)
                jmp = len(code)
                code.append(None)
                else_pc = len(code)
                self._emit_seq(items[else_at + 1:k], code, ctx)
                code[jmp] = ("jump", len(code))
            else:
                self._emit_seq(items[j:k], code, ctx)
                else_pc = None
            ctx.label_stack.pop()
            end = len(code)
            code.append(("end_block",))
            if op == "if":
                code[hdr] = ("if", len(results), end,
                             else_pc if else_pc is not None else end)
            else:
                code[hdr] = (op, len(results), end)
            return k + 1
        # plain op possibly with immediates — collect tokens until the next
        # list or recognized op boundary, reusing _split_operands on a
        # synthetic s-expr of this op plus following atom tokens
        j = i + 1
        imms = []
        while j < len(items) and isinstance(items[j], str) and \
                self._is_immediate_tok(op, items[j], len(imms)):
            imms.append(items[j])
            j += 1
        _, instr = self._split_operands([op] + imms, ctx)
        code.append(instr)
        return j

    @staticmethod
    def _is_immediate_tok(op, tok, count) -> bool:
        if op.endswith(".const"):
            return count < 1
        if op in ("call", "local.get", "local.set", "local.tee",
                  "global.get", "global.set", "br", "br_if", "ref.func",
                  "memory.init", "data.drop"):
            return count < 1
        if op == "br_table":
            return tok.startswith("$") or tok.lstrip("-").isdigit()
        if _MEM_RE.match(op):
            return "=" in tok
        if op.startswith("table."):
            return count < 1 and (tok.startswith("$") or tok.isdigit())
        return False


def parse_wat(src: str) -> Module:
    return WatParser().parse(src)
