"""Whole-slice parity on the synthetic programs of ``test_protocol.py``:
the port's proofs are byte-identical to the JAX prover's at k=256 (fixed
encoding seed and proof timestamp; ``simple`` also at 5 rows a flush),
each package's verifier accepts the other's proofs, and the port's
verifier rejects a tampered proof and a wrong program."""

import gzip

import pytest

from ligero_prover_tpu_torch import verifier as tverifier
from ligero_prover_tpu_torch.proto import ligero_proof_pb2 as pb

from _torch_prove_common import (SYNTHETIC, check_cross_verify,
                                 check_identical, make_env, make_proofs, odd)
from test_protocol import simple_program

PROGRAMS = SYNTHETIC | odd(SYNTHETIC, ["simple"])


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


def test_tampered_proof_rejected(env, proofs):
    _, t = proofs["simple"]
    e = pb.LigeroProofEnvelope()
    e.ParseFromString(gzip.decompress(t.proof))
    e.ligero_proof.sampled_data.values[5] ^= 1
    tampered = gzip.compress(e.SerializeToString())
    assert not tverifier.verify(simple_program, tampered,
                                geometry=env["tgeo"],
                                executor=env["tex"]).ok


def test_wrong_program_rejected(env, proofs):
    _, t = proofs["simple"]

    def other_program(ctx):
        b = ctx.backend
        x = b.acquire_witness(8)       # different witness values
        y = b.acquire_witness(40)
        z = b.eval(x * 5)
        b.assert_equal(z, y)
        s = b.eval(x + y)
        b.assert_const(s, 48)
        p = b.eval(x * x)
        b.assert_const(p, 64)
        del x, y, z, s, p

    assert not tverifier.verify(other_program, t.proof,
                                geometry=env["tgeo"],
                                executor=env["tex"]).ok
