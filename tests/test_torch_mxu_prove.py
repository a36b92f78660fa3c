"""Whole-slice parity of the int8 encode engine: with
``ops.ntt.USE_MXU = True`` the port's proofs (plain versions of the KR
kernels, on the CPU) are byte-identical to the JAX prover's at k=256 for
the vbn254fr guest (batch rows only) and a guest with witness rows (linear
and quadratic callback rows, so a second encode per flush runs), each also
at 5 rows a flush, and the JAX verifier accepts them."""

import pytest

from ligero_prover_tpu_torch.ops import mxu_renorm as tmr
from ligero_prover_tpu_torch.ops import ntt as tntt

from _torch_prove_common import (GUESTS, ODD, check_cross_verify,
                                 check_identical, make_env, make_proofs, odd)

NAMES = ["vbn254fr_make_wat3", "ecdsa_p256"]
PROGRAMS = {name: GUESTS[name] for name in NAMES} | odd(GUESTS, NAMES)


@pytest.fixture(scope="module")
def env():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tntt, "USE_MXU", True)
        env = make_env()
    assert env["tex"].use_mxu and env["tex" + ODD].use_mxu
    return env


@pytest.fixture(scope="module")
def proofs(env):
    tmr.reset_counts()
    out = make_proofs(env, PROGRAMS)
    assert tmr.PLAIN_CALLS["renorm_final"]["cpu"] > 0
    return out


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_mxu_proof_bytes_identical(proofs, name):
    check_identical(proofs, name)


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_mxu_cross_verify(env, proofs, name):
    check_cross_verify(env, proofs, PROGRAMS, name)
