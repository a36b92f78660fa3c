"""Traffic mode `prove`: each call proves the cell's guest through the
port's public entry, ``ligero_prover_tpu_torch.prover.prove``, on the
planar butterfly path (the CUDA default; the int8 engine stays off), from
its own encoding seed, and keeps the proof in memory.

The check: the window's last proof and a sample of the others, drawn from
the seed, are proved again by the benchmark's plain reference from the
same guest and encoding seed, and the bytes that differ are counted (an
exact comparison).  A
proof whose own self-check fails (``ProveResult.ok``) counts as a failed
call."""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import harness

STAGES = ("stage1", "stage2", "stage3")


@dataclass
class State:
    ctx: harness.Context
    program: object
    guest: tuple
    proofs: dict = field(default_factory=dict)


def setup(ctx: harness.Context) -> State:
    from ligero_prover_tpu_torch.vm.run import make_wat_program
    src, args = ctx.guest()
    return State(ctx, make_wat_program(src, args, set()), (src, args))


def call(state: State, index: int, warmup: bool = False) -> dict:
    from ligero_prover_tpu_torch.params import RowGeometry
    from ligero_prover_tpu_torch.prover import prove
    from ligero_prover_tpu_torch.utils.timer import get_timer
    ctx = state.ctx
    seed = ctx.encoding_seed(index)
    before = [get_timer(s) for s in STAGES]
    t0 = time.perf_counter()
    res = prove(state.program, geometry=RowGeometry(ctx.k),
                encoding_seed=seed, device=ctx.device,
                batch_rows=ctx.batch_rows)
    harness.synchronize(ctx.device)
    wall = time.perf_counter() - t0
    if not warmup:
        state.proofs[index] = (seed, res.proof)
    return {"wall": wall, "rows": res.num_rows, "ok": res.ok,
            "stages": {s: get_timer(s) - b for s, b in zip(STAGES, before)}}


def checked(state: State, records: list) -> list[int]:
    """The indices of the window's proofs that the check proves again: the
    last, and `checked_proofs` of the others drawn from the seed."""
    m = int(state.ctx.cell.workload.get("checked_proofs", 1))
    last = len(records) - 1
    rng = state.ctx.rng("check")
    return sorted(rng.sample(range(last), min(m, last)) + [last])


def reference_proofs(state: State, indices, **kw) -> list:
    from reference import prover as ref
    guest = ref.Guest(*state.guest)
    return [ref.prove(guest, state.ctx.k, state.ctx.encoding_seed(i),
                      state.ctx.device, **kw) for i in indices]


def check(state: State, records: list) -> dict:
    indices = checked(state, records)
    program = [state.proofs.pop(i)[1] for i in indices]
    state.proofs.clear()                     # free the rest before the check
    refs = reference_proofs(state, indices)
    if not all(r.ok for r in refs):
        raise RuntimeError("the reference's own proof fails its self-check")
    return {"proof_bytes_differing": sum(
        harness.differing_bytes(p, r.proof) for p, r in zip(program, refs))}
