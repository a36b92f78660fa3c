"""Whole proofs of the column-sharded prover at k=256 on the CPU: the JAX
``ShardedExecutor`` on 8 virtual devices, the JAX single-device prover,
the port's ``prove(..., mesh=make_mesh(["cpu"] * D))`` for D = 1, 2, 4, 8
(a mesh of one shard encodes by the coset path over the whole codeword)
and the port's single-device prover give the same proof bytes at one
encoding seed and proof timestamp, and the port's verifier accepts the
sharded proof."""

import jax
import pytest

from ligero_prover_tpu import prover as jprover
from ligero_prover_tpu.parallel.mesh import make_mesh as j_make_mesh
from ligero_prover_tpu_torch import prover as tprover, verifier as tverifier
from ligero_prover_tpu_torch.parallel.mesh import make_mesh

from _torch_prove_common import GUESTS, SEED, SYNTHETIC, make_env, \
    make_proofs

PROGRAMS = {"simple": SYNTHETIC["simple"],
            "vbn254fr_make_wat3": GUESTS["vbn254fr_make_wat3"]}


@pytest.fixture(scope="module")
def env():
    return make_env()


@pytest.fixture(scope="module")
def proofs(env):
    """name -> (JAX single, port single) and the JAX sharded proof, made
    once for every test of the module."""
    single = make_proofs(env, PROGRAMS)
    mesh = j_make_mesh(jax.devices()[:8])
    mp = pytest.MonkeyPatch()
    mp.setenv("LIGERO_PROOF_TIMESTAMP", "1700000000")
    try:
        sharded = {name: jprover.prove(jprog, geometry=env["jgeo"],
                                       mesh=mesh, batch_rows=8,
                                       encoding_seed=SEED)
                   for name, (jprog, _) in PROGRAMS.items()}
    finally:
        mp.undo()
    return single, sharded


def _port_sharded(env, name, D, monkeypatch):
    monkeypatch.setenv("LIGERO_PROOF_TIMESTAMP", "1700000000")
    return tprover.prove(PROGRAMS[name][1], geometry=env["tgeo"],
                         mesh=make_mesh(["cpu"] * D), batch_rows=8,
                         encoding_seed=SEED)


@pytest.mark.parametrize("D", [2, 4, 8, 1])
@pytest.mark.parametrize("name", list(PROGRAMS))
def test_sharded_proof_bytes(env, proofs, name, D, monkeypatch):
    """JAX sharded == JAX single == port sharded == port single."""
    (j, t), js = proofs[0][name], proofs[1][name]
    assert j.ok and t.ok and js.ok
    assert js.proof == j.proof == t.proof
    got = _port_sharded(env, name, D, monkeypatch)
    assert got.ok
    assert (got.num_rows, got.num_linear, got.num_quadratic) == \
        (t.num_rows, t.num_linear, t.num_quadratic)
    assert got.proof == t.proof


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_port_verifier_accepts_the_sharded_proof(env, proofs, name,
                                                 monkeypatch):
    got = _port_sharded(env, name, 8, monkeypatch)
    assert tverifier.verify(PROGRAMS[name][1], got.proof,
                            geometry=env["tgeo"], executor=env["tex"]).ok
