"""Whole-slice parity of the int8 encode engine: with
``ops.ntt.USE_MXU = True`` the port's proofs (plain versions of the KR
kernels, on the CPU) are byte-identical to the JAX prover's at k=256 for
the vbn254fr guest (batch rows only) and a guest with witness rows (linear
and quadratic callback rows, so a second encode per flush runs), in the
planar and the AoS configuration, and the JAX verifier accepts them."""

import pytest

from ligero_prover_tpu_torch.ops import mxu_renorm as tmr
from ligero_prover_tpu_torch.ops import ntt as tntt

from _torch_prove_common import (GUESTS, check_cross_verify, check_identical,
                                 make_env, make_proofs)

PROGRAMS = {"vbn254fr_make_wat3": GUESTS["vbn254fr_make_wat3"],
            "ecdsa_p256": GUESTS["ecdsa_p256"]}


@pytest.fixture(scope="module", params=["planar", "aos"])
def env(request):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tntt, "USE_MXU", True)
        mp.setattr(tntt, "USE_PLANAR", request.param == "planar")
        env = make_env()
    assert env["tex"].use_mxu
    assert env["tex"].use_planar is (request.param == "planar")
    return env


@pytest.fixture(scope="module")
def proofs(env, reference_proofs):
    """The port's proofs in this configuration beside the JAX prover's,
    which are made once for both configurations."""
    tmr.reset_counts()
    out = make_proofs(env, PROGRAMS, reference_proofs)
    assert tmr.PLAIN_CALLS["renorm_final"]["cpu"] > 0
    return out


@pytest.fixture(scope="module")
def reference_proofs():
    return {}


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_mxu_proof_bytes_identical(proofs, name):
    check_identical(proofs, name)


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_mxu_cross_verify(env, proofs, name):
    check_cross_verify(env, proofs, PROGRAMS, name)
