"""Program driver: instantiate + host modules + `_start` + finalize
(``include/invoke.hpp:35-98``)."""

from __future__ import annotations

from .module import Store, instantiate, Module
from .interpreter import VMContext, Interpreter
from .values import ExitProgram, WasmTrap
from .hostmods.env import EnvModule
from .hostmods.wasi import WasiModule


def run_program(module: Module, zkctx, args: list[bytes],
                private_indices: set[int], strict: bool = False):
    """Execute the module's `_start` against a ZK stage context, then
    finalize (flush partial rows + ZK masks)."""
    import os
    ctx = VMContext(zkctx)
    store = Store()
    ctx.store = store
    interp = Interpreter(ctx,
                         count_ops=os.environ.get("LIGERO_OPCOUNT") == "1")
    inst = instantiate(store, module)
    ctx.module = inst

    ctx.host_modules["env"] = EnvModule(ctx)
    ctx.host_modules["wasi_snapshot_preview1"] = WasiModule(
        ctx, args, private_indices)
    from .hostmods.bn254fr import Bn254frModule
    from .hostmods.vbn254fr import VBn254frModule
    from .hostmods.uint256 import Uint256Module
    from .hostmods.ecc import EccModule
    ctx.host_modules["bn254fr"] = Bn254frModule(ctx)
    ctx.host_modules["vbn254fr"] = VBn254frModule(ctx)
    ctx.host_modules["uint256"] = Uint256Module(ctx)
    ctx.host_modules["ecc"] = EccModule(ctx)

    if "_start" not in inst.exports:
        raise WasmTrap("module has no _start export")

    try:
        interp.call_function(inst.exports["_start"])
    except ExitProgram as e:
        if e.code != 0:
            print(f"Exit with code {e.code}")

    # Drop any leftover stack values so their witnesses commit before
    # finalize (the reference pops its dummy frame here).
    ctx.stack.clear()
    for m in ctx.host_modules.values():
        m.finalize()
    zkctx.finalize()
    if interp.op_counts is not None:
        print("opcode frequencies (top 20):")
        for op, cnt in interp.report_op_counts():
            print(f"  {op:<24s} {cnt}")
    if strict and ctx.assert_failures:
        raise WasmTrap(f"{ctx.assert_failures} assertion failures")


def make_wat_program(path_or_src: str, args: list[bytes],
                     private_indices: set[int], strict: bool = False):
    """Returns a `program(zkctx)` callable for the prover/verifier drivers."""
    from .wat import parse_wat
    import os
    if os.path.exists(path_or_src):
        src = open(path_or_src).read()
    else:
        src = path_or_src
    module = parse_wat(src)

    def program(zkctx):
        run_program(module, zkctx, args, private_indices, strict=strict)

    return program
