"""Module IR, store, and instantiation.

The runtime model mirrors ``include/runtime.hpp``: a store of function /
table / memory / global / element / data instances; linear memory carries a
set of secret byte intervals (``runtime.hpp:106-177``) so loads of tainted
bytes produce witnesses; memories are over-allocated with heap+stack pages
(``runtime.hpp:333-342``).  The instruction encoding is our own flat list
with pre-resolved branch targets — the analogue of the reference's
transpiler lowering (``transpiler.hpp:530-775``), designed for a Python
dispatch loop instead of C++ structured instructions.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .values import Num, Ref, WasmTrap, I32, I64, F32, F64

PAGE_SIZE = 65536


@dataclass
class FuncType:
    params: list[str]
    results: list[str]


@dataclass
class Function:
    type: FuncType
    locals: list[str] = field(default_factory=list)
    body: list = field(default_factory=list)        # lowered instructions
    imported: tuple[str, str] | None = None         # (module, name)


@dataclass
class Limits:
    min: int
    max: int | None = None


@dataclass
class Global:
    type: str
    mutable: bool
    init: object  # Num


class MemoryInstance:
    """Linear memory with secret-interval tracking.

    Intervals are stored as a sorted list of disjoint [start, end) pairs —
    the Python analogue of boost::icl::interval_set.
    """

    def __init__(self, limits: Limits):
        self.limits = limits
        # 16MB heap + 8MB stack padding, as the reference allocates
        pages = max(limits.min, 256) + 128
        self.data = bytearray(pages * PAGE_SIZE)
        self._secret: list[tuple[int, int]] = []

    # -- secret intervals -------------------------------------------------

    def mark_secret(self, begin: int, end: int):
        if end <= begin:
            return
        self._insert(begin, end)

    def unmark(self, begin: int, end: int):
        if end <= begin:
            return
        out = []
        for s, e in self._secret:
            if e <= begin or s >= end:
                out.append((s, e))
            else:
                if s < begin:
                    out.append((s, begin))
                if e > end:
                    out.append((end, e))
        self._secret = out

    def contains_secret(self, begin: int, end: int) -> bool:
        for s, e in self._secret:
            if s < end and begin < e:
                return True
        return False

    def memcpy_secrets(self, dst: int, src: int, count: int):
        """Move bytes and their secret tags (``runtime.hpp:136-172``)."""
        if src + count > len(self.data) or dst + count > len(self.data):
            raise WasmTrap("memcpy_secrets: out of range")
        off = dst - src
        moved = []
        for s, e in self._secret:
            s2, e2 = max(s, src), min(e, src + count)
            if s2 < e2:
                moved.append((s2 + off, e2 + off))
        self.unmark(dst, dst + count)
        for s, e in moved:
            self.mark_secret(max(s, dst), min(e, dst + count))
        self.data[dst:dst + count] = self.data[src:src + count]

    def _insert(self, begin: int, end: int):
        out = []
        for s, e in self._secret:
            if e < begin or s > end:
                out.append((s, e))
            else:
                begin, end = min(begin, s), max(end, e)
        out.append((begin, end))
        out.sort()
        self._secret = out

    # -- accessors --------------------------------------------------------

    def load_bytes(self, addr: int, n: int) -> bytes:
        if addr + n > len(self.data):
            raise WasmTrap("Invalid memory address")
        return bytes(self.data[addr:addr + n])

    def store_bytes(self, addr: int, b: bytes):
        if addr + len(b) > len(self.data):
            raise WasmTrap("Invalid memory address")
        self.data[addr:addr + len(b)] = b

    @property
    def num_pages(self) -> int:
        return len(self.data) // PAGE_SIZE

    def grow(self, n: int) -> int:
        sz = self.num_pages
        new = sz + n
        if new > 65536 or (self.limits.max is not None and new > self.limits.max):
            return 0xFFFFFFFF
        self.data.extend(bytes(n * PAGE_SIZE))
        return sz


@dataclass
class TableInstance:
    elem_type: str
    elems: list[Ref]
    limits: Limits


@dataclass
class GlobalInstance:
    type: str
    val: Num


@dataclass
class Module:
    """Parsed module (shared by the WAT and binary front-ends)."""

    types: list[FuncType] = field(default_factory=list)
    funcs: list[Function] = field(default_factory=list)
    tables: list[tuple[str, Limits]] = field(default_factory=list)
    memories: list[Limits] = field(default_factory=list)
    globals: list[Global] = field(default_factory=list)
    exports: dict[str, tuple[str, int]] = field(default_factory=dict)
    elems: list[tuple] = field(default_factory=list)   # (table_idx, offset_expr, func_idxs, mode)
    datas: list[tuple] = field(default_factory=list)   # (mem_idx, offset_expr, bytes, mode)
    start: int | None = None


class Store:
    def __init__(self):
        self.functions: list[Function] = []
        self.tables: list[TableInstance] = []
        self.memories: list[MemoryInstance] = []
        self.globals: list[GlobalInstance] = []
        self.elements: list[list[Ref]] = []
        self.datas: list[bytes] = []


@dataclass
class ModuleInstance:
    module: Module
    funcaddrs: list[int] = field(default_factory=list)
    tableaddrs: list[int] = field(default_factory=list)
    memaddrs: list[int] = field(default_factory=list)
    globaladdrs: list[int] = field(default_factory=list)
    elemaddrs: list[int] = field(default_factory=list)
    dataaddrs: list[int] = field(default_factory=list)
    exports: dict[str, int] = field(default_factory=dict)  # name -> funcaddr


def _eval_const_expr(expr, store: Store, inst: ModuleInstance) -> Num:
    """Init expressions: a single const or global.get."""
    op = expr[0]
    if op == "i32.const":
        return Num(I32, expr[1] & 0xFFFFFFFF)
    if op == "i64.const":
        return Num(I64, expr[1] & 0xFFFFFFFFFFFFFFFF)
    if op == "f32.const":
        return Num(F32, expr[1])
    if op == "f64.const":
        return Num(F64, expr[1])
    if op == "global.get":
        return store.globals[inst.globaladdrs[expr[1]]].val
    raise WasmTrap(f"unsupported init expr {op}")


def instantiate(store: Store, module: Module) -> ModuleInstance:
    """Allocate instances and run init segments (``runtime.hpp:344-602``)."""
    inst = ModuleInstance(module)

    for f in module.funcs:
        inst.funcaddrs.append(len(store.functions))
        store.functions.append(f)

    for elem_type, limits in module.tables:
        inst.tableaddrs.append(len(store.tables))
        store.tables.append(TableInstance(
            elem_type, [Ref(None) for _ in range(limits.min)], limits))

    for limits in module.memories:
        inst.memaddrs.append(len(store.memories))
        store.memories.append(MemoryInstance(limits))
    if not module.memories:
        # Programs without an explicit memory still get one (host modules
        # need linear memory for args)
        inst.memaddrs.append(len(store.memories))
        store.memories.append(MemoryInstance(Limits(2)))

    for g in module.globals:
        inst.globaladdrs.append(len(store.globals))
        store.globals.append(GlobalInstance(
            g.type, _eval_const_expr(g.init, store, inst)))

    for table_idx, offset_expr, func_idxs, mode in module.elems:
        refs = [Ref(inst.funcaddrs[i] if i is not None else None)
                for i in func_idxs]
        inst.elemaddrs.append(len(store.elements))
        store.elements.append(refs)
        if mode == "active":
            off = _eval_const_expr(offset_expr, store, inst).as_u32()
            tab = store.tables[inst.tableaddrs[table_idx]]
            if off + len(refs) > len(tab.elems):
                raise WasmTrap("elem segment out of range")
            tab.elems[off:off + len(refs)] = refs

    for mem_idx, offset_expr, data_bytes, mode in module.datas:
        inst.dataaddrs.append(len(store.datas))
        store.datas.append(bytes(data_bytes))
        if mode == "active":
            off = _eval_const_expr(offset_expr, store, inst).as_u32()
            mem = store.memories[inst.memaddrs[mem_idx]]
            mem.store_bytes(off, bytes(data_bytes))

    for name, (kind, idx) in module.exports.items():
        if kind == "func":
            inst.exports[name] = inst.funcaddrs[idx]

    return inst
