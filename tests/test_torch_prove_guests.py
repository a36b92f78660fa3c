"""Whole-slice parity on WAT guests: the SDK-call guest of
``test_sdk_guest.py``, ``guests/ecdsa_p256.wat`` and the vbn254fr guest of
``bench/e2e_prove.py`` (3 rounds).  The port's proofs are byte-identical to
the JAX prover's at k=256, and each package's verifier accepts the other's
proofs."""

import pytest

from _torch_prove_common import (GUESTS, check_cross_verify, check_identical,
                                 make_env, make_proofs)


@pytest.fixture(scope="module")
def env():
    return make_env()


@pytest.fixture(scope="module")
def proofs(env):
    return make_proofs(env, GUESTS)


@pytest.mark.parametrize("name", list(GUESTS))
def test_proof_bytes_identical(proofs, name):
    check_identical(proofs, name)


@pytest.mark.parametrize("name", list(GUESTS))
def test_cross_verify(env, proofs, name):
    check_cross_verify(env, proofs, GUESTS, name)
