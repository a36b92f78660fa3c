"""Traffic mode `verify`: set-up proves the cell's guest twice through the
port's ``prove`` (encoding seeds drawn from the seed) and makes a third
proof from the first by altering one decommitment digest, which only the
Merkle root's check can catch; each call verifies the next of the three
through the port's public entry, ``ligero_prover_tpu_torch.verifier.verify``.

The check: the benchmark's plain reference proves the guest again from the
set-up's encoding seeds, and the bytes in which the program's set-up proofs
differ from its proofs are counted; its verifier gives its verdict on each
of the three proofs, and every verdict of the window that differs from it
is counted.  Both are exact comparisons."""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import harness


@dataclass
class State:
    ctx: harness.Context
    program: object
    guest: tuple
    proofs: list = field(default_factory=list)     # (blob, rows)


def tamper(blob: bytes) -> bytes:
    """The proof with its first decommitment digest's first byte flipped,
    re-serialized by the frozen serializer (the metadata's timestamp comes
    from LIGERO_PROOF_TIMESTAMP, as the prover's does)."""
    from reference.ligero.zkp.proof import deserialize_proof, serialize_proof
    p = deserialize_proof(blob)
    md = p.metadata
    siblings = dict(p.siblings)
    first = next(iter(siblings))
    siblings[first] = bytes([siblings[first][0] ^ 1]) + siblings[first][1:]
    return serialize_proof(
        p.merkle_root, p.encoded_code_limbs, p.encoded_linear_limbs,
        p.encoded_quad_limbs, p.leaf_indices, siblings, p.host_samplings,
        program_hash=md.program_hash.value, k=md.packing_size,
        n=md.codeword_size, timestamp=md.generated_at.seconds)


def setup_seed(ctx: harness.Context, j: int) -> bytes:
    return ctx.encoding_seed(-100 - j)


def setup(ctx: harness.Context) -> State:
    from ligero_prover_tpu_torch.params import RowGeometry
    from ligero_prover_tpu_torch.prover import prove
    from ligero_prover_tpu_torch.vm.run import make_wat_program
    src, args = ctx.guest()
    state = State(ctx, make_wat_program(src, args, set()), (src, args))
    for j in range(int(ctx.cell.traffic["setup_proofs"])):
        res = prove(state.program, geometry=RowGeometry(ctx.k),
                    encoding_seed=setup_seed(ctx, j),
                    device=ctx.device, batch_rows=ctx.batch_rows)
        state.proofs.append((res.proof, res.num_rows))
    for j in range(int(ctx.cell.traffic.get("tampered_proofs", 0))):
        blob, rows = state.proofs[j]
        state.proofs.append((tamper(blob), rows))
    return state


def call(state: State, index: int, warmup: bool = False) -> dict:
    from ligero_prover_tpu_torch.params import RowGeometry
    from ligero_prover_tpu_torch.verifier import verify
    ctx = state.ctx
    which = index % len(state.proofs)
    blob, rows = state.proofs[which]
    t0 = time.perf_counter()
    res = verify(state.program, blob, geometry=RowGeometry(ctx.k),
                 device=ctx.device, batch_rows=ctx.batch_rows)
    harness.synchronize(ctx.device)
    return {"wall": time.perf_counter() - t0, "rows": rows, "ok": True,
            "proof": which, "verdict": res.ok, "stages": {}}


def reference_verdicts(state: State, **kw) -> list[bool]:
    from reference import prover as ref
    guest = ref.Guest(*state.guest)
    return [ref.verify(guest, state.ctx.k, blob, state.ctx.device, **kw)
            for blob, _ in state.proofs]


def check(state: State, records: list) -> dict:
    from reference import prover as ref
    ctx = state.ctx
    guest = ref.Guest(*state.guest)
    made = int(ctx.cell.traffic["setup_proofs"])
    refs = [ref.prove(guest, ctx.k, setup_seed(ctx, j), ctx.device)
            for j in range(made)]
    if not all(r.ok for r in refs):
        raise RuntimeError("the reference's own proof fails its self-check")
    differ = sum(harness.differing_bytes(blob, r.proof)
                 for (blob, _), r in zip(state.proofs, refs))
    del refs
    want = reference_verdicts(state)
    return {"setup_proof_bytes_differing": differ,
            "verdicts_wrong": sum(1 for r in records
                                  if r["verdict"] != want[r["proof"]])}
