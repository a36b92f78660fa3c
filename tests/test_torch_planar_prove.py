"""Whole-slice parity of the planar configuration: with
``ops.ntt.USE_PLANAR = True`` the port's proofs (plain versions of the
planar kernels, on the CPU) are byte-identical to the JAX prover's at
k=256 for a synthetic program, a guest with witness rows (linear and
quadratic callback rows, so the planar check's linear branch runs) and the
vbn254fr guest, and each package's verifier accepts the other's proofs."""

import pytest

from ligero_prover_tpu_torch.ops import ntt as tntt

from _torch_prove_common import (GUESTS, SYNTHETIC, check_cross_verify,
                                 check_identical, make_env, make_proofs)

PROGRAMS = {"simple": SYNTHETIC["simple"],
            "ecdsa_p256": GUESTS["ecdsa_p256"],
            "vbn254fr_make_wat3": GUESTS["vbn254fr_make_wat3"]}


@pytest.fixture(scope="module")
def env():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tntt, "USE_PLANAR", True)
        env = make_env()
    assert env["tex"].use_planar
    return env


@pytest.fixture(scope="module")
def proofs(env):
    return make_proofs(env, PROGRAMS)


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_planar_proof_bytes_identical(proofs, name):
    check_identical(proofs, name)


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_planar_cross_verify(env, proofs, name):
    check_cross_verify(env, proofs, PROGRAMS, name)
