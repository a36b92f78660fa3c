"""Shared set-up of the whole-slice parity tests (``test_torch_prove*.py``):
the programs, both packages' executors at k=256, and both packages' proofs
of each program at a fixed encoding seed and proof timestamp.

A program named ``<name>@b5`` is ``<name>`` proved by the port at 5 rows a
flush (partial batches, and the mask rows at other flush boundaries),
against the same JAX proof at 8."""

import os

import pytest

from ligero_prover_tpu import prover as jprover, verifier as jverifier
from ligero_prover_tpu.params import RowGeometry as JGeometry
from ligero_prover_tpu.vm.run import make_wat_program as j_wat_program
from ligero_prover_tpu.zkp.executor import TpuExecutor
from ligero_prover_tpu_torch import prover as tprover, verifier as tverifier
from ligero_prover_tpu_torch.params import RowGeometry
from ligero_prover_tpu_torch.vm.run import make_wat_program as t_wat_program
from ligero_prover_tpu_torch.zkp.executor import TorchExecutor

from bench.e2e_prove import make_wat
from test_protocol import bits_program, simple_program, wide_program
from test_sdk_guest import ARGS as SDK_ARGS, SDK_GUEST_WAT

import _torch_helpers  # noqa: F401  (thread count)

K = 256
ODD = "@b5"
SEED = bytes(range(32))
ECDSA = os.path.join(os.path.dirname(__file__), "guests", "ecdsa_p256.wat")


def _wat(src, args):
    """The same WAT program, parsed by each package's own front end."""
    return j_wat_program(src, args, set()), t_wat_program(src, args, set())


# name -> (JAX program, port program)
SYNTHETIC = {
    "simple": (simple_program, simple_program),
    "bits": (bits_program, bits_program),
    "wide": (wide_program, wide_program),
}
GUESTS = {
    "sdk_guest": _wat(SDK_GUEST_WAT, SDK_ARGS),
    "ecdsa_p256": _wat(ECDSA, [b"Ligero\x00"]),
    "vbn254fr_make_wat3": _wat(make_wat(3), []),
}


def make_env():
    return {"jex": TpuExecutor(K, 4 * K, 8),
            "tex": TorchExecutor(K, 4 * K, 8, "cpu"),
            "tex" + ODD: TorchExecutor(K, 4 * K, 5, "cpu"),
            "jgeo": JGeometry(K), "tgeo": RowGeometry(K)}


def odd(programs, names):
    """`names` of `programs` again as ``<name>@b5``."""
    return {name + ODD: programs[name] for name in names}


def make_proofs(env, programs, reference=None):
    """Both packages' proofs of every program: name -> (JAX, port).  The
    JAX proofs are kept in `reference` (name -> proof; ``<name>@b5`` reads
    ``<name>``'s), so a second configuration of the port reuses them."""
    mp = pytest.MonkeyPatch()
    mp.setenv("LIGERO_PROOF_TIMESTAMP", "1700000000")
    out = {}
    if reference is None:
        reference = {}
    try:
        for name, (jprog, tprog) in programs.items():
            base = name.removesuffix(ODD)
            if base not in reference:
                reference[base] = jprover.prove(
                    jprog, geometry=env["jgeo"], executor=env["jex"],
                    encoding_seed=SEED)
            j = reference[base]
            tex = env["tex" + ODD] if name.endswith(ODD) else env["tex"]
            t = tprover.prove(tprog, geometry=env["tgeo"], executor=tex,
                              encoding_seed=SEED)
            out[name] = (j, t)
    finally:
        mp.undo()
    return out



def check_identical(proofs, name):
    j, t = proofs[name]
    assert j.ok and t.ok
    assert (t.num_rows, t.num_linear, t.num_quadratic) == \
        (j.num_rows, j.num_linear, j.num_quadratic)
    assert t.root == j.root
    assert t.proof == j.proof


def check_cross_verify(env, proofs, programs, name):
    """Each package's verifier accepts the other package's proof."""
    j, t = proofs[name]
    jprog, tprog = programs[name]
    assert tverifier.verify(tprog, j.proof, geometry=env["tgeo"],
                            executor=env["tex"]).ok
    assert jverifier.verify(jprog, t.proof, geometry=env["jgeo"],
                            executor=env["jex"]).ok
