"""Whole-slice parity on WAT guests: the SDK-call guest of
``test_sdk_guest.py``, ``guests/ecdsa_p256.wat`` and the vbn254fr guest of
``bench/e2e_prove.py`` (3 rounds), the last two also at 5 rows a flush.
The port's proofs are byte-identical to the JAX prover's at k=256, and
each package's verifier accepts the other's proofs.  A proof whose row
tape spills every device batch to the host is the same proof."""

import numpy as np
import pytest

from ligero_prover_tpu_torch import prover as tprover
from ligero_prover_tpu_torch.zkp.context import RowTape

from _torch_prove_common import (GUESTS, SEED, check_cross_verify,
                                 check_identical, make_env, make_proofs, odd)

PROGRAMS = GUESTS | odd(GUESTS, ["ecdsa_p256", "vbn254fr_make_wat3"])


@pytest.fixture(scope="module")
def env():
    return make_env()


@pytest.fixture(scope="module")
def proofs(env):
    return make_proofs(env, PROGRAMS)


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_proof_bytes_identical(proofs, name):
    check_identical(proofs, name)


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_cross_verify(env, proofs, name):
    check_cross_verify(env, proofs, PROGRAMS, name)


def test_spilled_tape_gives_the_same_proof(env, proofs, monkeypatch):
    """With the tape's cap at 0 every device batch of stage 1 (the
    vbn254fr guest's batch rows) is fetched to host numpy when it is
    recorded and uploaded again in stage 3; the proof is unchanged."""
    spilled = []
    append = RowTape.append_batch

    def counted(self, batch, cnt, width):
        append(self, batch, cnt, width)
        spilled.append(not isinstance(batch, np.ndarray)
                       and isinstance(self.chunks[-1][2], np.ndarray))

    monkeypatch.setattr(RowTape, "CAP_BYTES", 0)
    monkeypatch.setattr(RowTape, "append_batch", counted)
    monkeypatch.setenv("LIGERO_PROOF_TIMESTAMP", "1700000000")
    name = "vbn254fr_make_wat3"
    got = tprover.prove(PROGRAMS[name][1], geometry=env["tgeo"],
                        executor=env["tex"], encoding_seed=SEED)
    assert any(spilled)
    assert got.ok and got.proof == proofs[name][1].proof
