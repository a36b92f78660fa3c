"""Traffic mode `prove_secret`: the `prove` mode's calls for a guest whose
arguments include secret ones.  The configuration's generator gives the
guest and its arguments from the seed (``guest(params, rng)``); its
``private_args`` are marked secret when the program is built, so the
interpreter takes its witness path on every opcode with a secret operand.

The check: as `prove`'s, with the plain reference run with the same
private arguments (``reference.secret``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

import harness

_prove = harness.load_module("modes", "prove")
call = _prove.call


@dataclass
class State(_prove.State):
    private: set = field(default_factory=set)


def setup(ctx: harness.Context) -> State:
    from ligero_prover_tpu_torch.vm.run import make_wat_program
    g = ctx.cell.config["guest"]
    gen = harness.load_module("guests", Path(g["generator"]).stem)
    src, args = gen.guest({**g.get("params", {}), **ctx.guest_params},
                          ctx.rng("message"))
    private = set(ctx.cell.config["private_args"])
    return State(ctx, make_wat_program(src, args, private), (src, args),
                 private=private)


def reference_proofs(state: State, indices, **kw) -> list:
    from reference import prover as ref
    from reference.secret import SecretGuest
    ctx = state.ctx
    g = SecretGuest(*state.guest, state.private)
    return [ref.prove(g, ctx.k, ctx.encoding_seed(i), ctx.device, **kw)
            for i in indices]


def check(state: State, records: list) -> dict:
    indices = _prove.checked(state, records)
    program = [state.proofs.pop(i)[1] for i in indices]
    state.proofs.clear()                     # free the rest before the check
    refs = reference_proofs(state, indices)
    if not all(r.ok for r in refs):
        raise RuntimeError("the reference's own proof fails its self-check")
    return {"proof_bytes_differing": sum(
        harness.differing_bytes(p, r.proof) for p, r in zip(program, refs))}
