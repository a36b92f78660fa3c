"""Three-stage Ligero prover (``src/webgpu_prover.cpp:59-495``).

The witnessed computation is abstracted as ``program(ctx)`` — a callable
that executes against a stage context's backend (the WASM interpreter for
real programs, or any constraint-building callable for tests).  It is run
three times, exactly like the reference:

  stage 1: commit   — encode every flushed row, Merkle-commit the columns
  stage 2: checks   — accumulate code/linear/quadratic test codewords
  stage 3: openings — gather the 192 sampled columns of every row

with Fiat-Shamir seeds between stages and a final self-check of the
decoded test codewords.  Port of ``ligero_prover_tpu.prover``: the
pipelines run on a :class:`TorchExecutor` on an explicit device, or on a
column-sharded :class:`ShardedExecutor` over a mesh of devices.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from .field import bn254 as F
from .field.limbs import limbs_to_ints
from .params import RowGeometry, SAMPLE_SIZE, IV_ANY
from .utils.timer import span, spanned, timer
from .utils.log import get_logger
from .zkp import transcript
from .zkp.csprng import HashRandomEngine
from .zkp.sampling import portable_sample
from .zkp.merkle import MerkleTree
from .zkp.executor import TorchExecutor
from .zkp.context import Stage1Context, Stage2Context, Stage3Context, \
    RowTape
from .zkp.proof import serialize_proof
from .parallel.mesh import ShardedExecutor


@dataclass
class ProveResult:
    proof: bytes
    root: bytes
    valid_code: bool
    valid_linear: bool
    valid_quad: bool
    num_rows: int = 0
    # constraint/gate counts at finalize (``witness_manager.hpp:504-507``)
    num_linear: int = 0
    num_quadratic: int = 0

    @property
    def ok(self) -> bool:
        return self.valid_code and self.valid_linear and self.valid_quad


_log = get_logger("prover")


def _field_sum(vals: list[int]) -> int:
    acc = 0
    for v in vals:
        acc = F.addmod(acc, v)
    return acc


def _stage3_replay(executor, tape: RowTape, sample_index) -> list:
    """Stage 3 from the row tape: encode + gather the sampled columns of
    every recorded stage-1 batch in order — no third program execution,
    and device-resident chunks never touch the host.  Produces the exact
    host_samplings sequence Stage3Context would (flush boundaries only
    group rows; the output is per-row ordered)."""
    idx = np.asarray(sample_index, np.int32)
    outs: list[tuple[int, object]] = []
    for width, cnt, batch in tape.replay():
        outs.append((cnt, executor.open_step(
            batch, idx, width_2k=width != executor.k)))
    # ONE device->host fetch for the whole stage: valid rows of every
    # batch are concatenated on the device first.
    if not outs:
        return []
    arr = executor.fetch(executor.concat([out[:cnt] for cnt, out in outs]))
    return [arr[i] for i in range(arr.shape[0])]


@spanned("prover.prove")
def prove(program, *, geometry: RowGeometry = RowGeometry(),
          instance_hash: bytes = bytes(32),
          program_hash: bytes = bytes(32),
          encoding_seed: bytes | None = None,
          executor: TorchExecutor | None = None,
          mesh=None,
          batch_rows: int = 16,
          device="cuda",
          row_tape: bool = True) -> ProveResult:
    """`device`: where a new executor runs its pipelines (ignored when
    `executor` is given); "cuda" raises when no card is present.

    `mesh`: a ``parallel.mesh.Mesh`` (``make_mesh``): a new executor runs
    the stage pipelines column-sharded over its devices (ignored when
    `executor` is given; `device` is then unused); the proof bytes are
    identical to the single-device prover's.  A mesh over the ranks of a
    process group is proved by every rank at once: each replays
    `program`, runs its own shards, and returns the same result.  Its
    ranks prove under one `encoding_seed`: given, it must be the same on
    every rank (all raise if not); None, rank 0 draws it.  Set
    ``LIGERO_PROOF_TIMESTAMP`` alike on every rank for equal proof bytes.

    `row_tape`: spool stage-1 rows to a temp file and replay them in
    stage 3, skipping the third program execution (rows are identical by
    construction — stage 3 draws the same encoding randomness and runs
    no checks).  Costs 32*k bytes of spool per row; disable to reproduce
    the reference's re-execution behavior exactly."""
    k, l, n = geometry.k, geometry.l, geometry.n
    if executor is None:
        executor = ShardedExecutor(k, n, mesh, batch_rows) \
            if mesh is not None else TorchExecutor(k, n, batch_rows, device)
    mesh = getattr(executor, "mesh", None)
    if mesh is not None:
        encoding_seed = mesh.shared_seed(encoding_seed)
    elif encoding_seed is None:
        encoding_seed = os.urandom(32)  # prover-private randomness

    # Stage 1: commit ------------------------------------------------------
    tape = RowTape(executor.fetch) if row_tape else None
    with timer("stage1"):
        ctx1 = Stage1Context(executor, l, row_tape=tape)
        ctx1.init_encoding_random(encoding_seed, IV_ANY)
        with span("vm.run"):
            program(ctx1)
        ctx1.finalize()
        m1 = ctx1.backend.manager
        num_linear, num_quadratic = m1.linear_counter, m1.quadratic_counter
        tree = MerkleTree(ctx1.flush_digests())
        root = tree.root
    _log.info("stage1: %d rows committed (%d linear, %d quadratic), "
              "root %s", ctx1.rows_absorbed, num_linear, num_quadratic,
              root.hex()[:16])
    seed1 = transcript.stage1_seed(root, instance_hash)

    # Stage 2: checks ------------------------------------------------------
    with timer("stage2"):
        ctx2 = Stage2Context(executor, l)
        ctx2.init_encoding_random(encoding_seed, IV_ANY)
        ctx2.init_witness_random(seed1, IV_ANY)
        with span("vm.run"):
            program(ctx2)
        ctx2.finalize()
        code_cw, linear_cw, quad_cw = ctx2.codewords()
        constsum = ctx2.linear_sums()

    seed2 = transcript.stage2_seed(root, code_cw, linear_cw, quad_cw)
    engine = HashRandomEngine(seed2)
    sample_index = sorted(portable_sample(n, SAMPLE_SIZE, engine))
    _log.debug("stage2 done; %d columns sampled", len(sample_index))
    siblings = tree.decommit(sample_index)

    decoded_code = limbs_to_ints(executor.fetch(executor.decode(code_cw)))
    decoded_linear = limbs_to_ints(
        executor.fetch(executor.decode(linear_cw)))
    decoded_quad = limbs_to_ints(executor.fetch(executor.decode(quad_cw)))

    # Stage 3: openings ----------------------------------------------------
    with timer("stage3"):
        if tape is not None:
            host_samplings = _stage3_replay(executor, tape, sample_index)
            tape.close()
            samplings = (np.concatenate(
                [s.reshape(-1) for s in host_samplings])
                if host_samplings else np.zeros(0, np.uint32))
        else:
            ctx3 = Stage3Context(executor, l, sample_index)
            ctx3.init_encoding_random(encoding_seed, IV_ANY)
            with span("vm.run"):
                program(ctx3)
            ctx3.finalize()
            host_samplings = ctx3.host_samplings
            samplings = ctx3.samplings_u32()

    proof = serialize_proof(
        root, code_cw, linear_cw, quad_cw, sample_index, siblings,
        samplings, program_hash=program_hash, k=k, n=n)
    _log.info("stage3: %d rows opened; proof %d bytes%s",
              len(host_samplings), len(proof),
              " (tape replay)" if tape is not None else "")

    # Self-check (``webgpu_prover.cpp:461-484``)
    valid_code = all(v == 0 for v in decoded_code[k:])
    valid_linear = F.addmod(_field_sum(decoded_linear[:l]), constsum) == 0
    valid_quad = all(v == 0 for v in decoded_quad[:l])

    return ProveResult(proof, root, valid_code, valid_linear, valid_quad,
                       num_rows=len(host_samplings),
                       num_linear=num_linear, num_quadratic=num_quadratic)
