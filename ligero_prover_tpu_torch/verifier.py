"""Ligero verifier (``src/webgpu_verifier.cpp:57-464``).

Re-derives the Fiat-Shamir seeds from the proof, re-executes the *public*
computation against the opened columns, recommits the Merkle root, and
checks:

  1. Merkle root equality
  2. code test: decoded code codeword has degree < k
  3. linear test: sum of the first l decoded entries + constant sum == 0
  4. quadratic test: first l decoded entries are zero
  5. opened columns of the claimed codewords equal the verifier's
     recomputed check values at the sampled positions

Port of ``ligero_prover_tpu.verifier`` onto a :class:`TorchExecutor`.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

import numpy as np

from .vm.values import WasmTrap, ExitProgram

from .field import bn254 as F
from .field.limbs import limbs_to_ints
from .params import RowGeometry, SAMPLE_SIZE, IV_ANY
from .utils.timer import timer
from .zkp import transcript
from .zkp.csprng import HashRandomEngine
from .zkp.sampling import portable_sample
from .zkp.merkle import recommit
from .zkp.executor import TorchExecutor
from .zkp.context import VerifierContext, ProofRejected
from .zkp.proof import deserialize_proof


@dataclass
class VerifyResult:
    valid_merkle: bool = False
    valid_code: bool = False
    valid_linear: bool = False
    valid_quad: bool = False
    code_equal: bool = False
    linear_equal: bool = False
    quad_equal: bool = False

    @property
    def ok(self) -> bool:
        return (self.valid_merkle and self.valid_code and self.valid_linear
                and self.valid_quad and self.code_equal and self.linear_equal
                and self.quad_equal)


def _field_sum(vals) -> int:
    acc = 0
    for v in vals:
        acc = F.addmod(acc, v)
    return acc


def verify(program, proof_blob: bytes, *,
           geometry: RowGeometry = RowGeometry(),
           instance_hash: bytes = bytes(32),
           executor: TorchExecutor | None = None,
           batch_rows: int = 16,
           device="cuda") -> VerifyResult:
    k, l, n = geometry.k, geometry.l, geometry.n
    if executor is None:
        executor = TorchExecutor(k, n, batch_rows, device)

    proof = deserialize_proof(proof_blob)
    root = proof.merkle_root

    seed1 = transcript.stage1_seed(root, instance_hash)
    seed2 = transcript.stage2_seed(
        root, proof.encoded_code_limbs, proof.encoded_linear_limbs,
        proof.encoded_quad_limbs)

    engine = HashRandomEngine(seed2)
    sample_index = sorted(portable_sample(n, SAMPLE_SIZE, engine))

    res = VerifyResult()
    with timer("verify"):
        try:
            vctx = VerifierContext(executor, l, sample_index,
                                   proof.host_samplings)
            vctx.init_witness_random(seed1, IV_ANY)
            program(vctx)
            vctx.finalize()
        except (WasmTrap, ExitProgram, ProofRejected) as e:
            # Protocol-level rejection: a forged/truncated proof makes the
            # re-execution trap or run out of opened columns — reject
            # quietly, matching the reference's reject-by-exception
            # (``webgpu_verifier.cpp:304-310``).
            print(f"verify: rejected during re-execution: {e}",
                  file=sys.stderr)
            return res
        except Exception:
            # Anything else is a verifier bug, not a bad proof: surface the
            # traceback (still reject — never accept on error).
            import traceback
            traceback.print_exc()
            return res

        total_count = (1 if n <= 1 else 1 << (n - 1).bit_length()) * 2 - 1
        try:
            vroot = recommit(vctx.flush_digests(), sample_index,
                             proof.siblings, total_count)
        except KeyError:
            return res
        res.valid_merkle = vroot == root

        vcode, vlinear, vquad = vctx.sampled_codewords()
        constsum = vctx.linear_sums()

    # Decode the prover's claimed codewords
    claimed = {}
    for name, limbs in (("code", proof.encoded_code_limbs),
                        ("linear", proof.encoded_linear_limbs),
                        ("quad", proof.encoded_quad_limbs)):
        if len(limbs) != n * 8:
            return res
        claimed[name] = limbs.reshape(n, 8)

    dec_code = limbs_to_ints(executor.fetch(executor.decode(claimed["code"])))
    dec_linear = limbs_to_ints(
        executor.fetch(executor.decode(claimed["linear"])))
    dec_quad = limbs_to_ints(executor.fetch(executor.decode(claimed["quad"])))

    res.valid_code = all(v == 0 for v in dec_code[k:])
    res.valid_linear = F.addmod(_field_sum(dec_linear[:l]), constsum) == 0
    res.valid_quad = all(v == 0 for v in dec_quad[:l])

    # Sampled-column equality between claimed codewords and recomputed checks
    idx = np.asarray(sample_index)
    res.code_equal = bool(
        (claimed["code"][idx] == vcode).all())
    res.linear_equal = bool(
        (claimed["linear"][idx] == vlinear).all())
    res.quad_equal = bool(
        (claimed["quad"][idx] == vquad).all())
    return res
