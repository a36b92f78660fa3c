"""The port's CUDA kernels on the card: K1 (mont_mul), K2 (mulmod) and K3
(column SHA-256 absorb) against their plain PyTorch versions, the golden
Python-int model and hashlib; the executor and a whole proof on the card
against the same on the CPU.  Every test here needs a CUDA device and
skips without one.  This file imports no JAX, so it runs on a machine
without it:

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -q
"""

import hashlib

import numpy as np
import pytest
import torch

from ligero_prover_tpu_torch.field import bn254 as F
from ligero_prover_tpu_torch.field.limbs import ints_to_limbs, limbs_to_ints
from ligero_prover_tpu_torch.ops import fieldmul as tfm
from ligero_prover_tpu_torch.ops import sha256 as tsha

from _torch_helpers import (EDGES, NONCANONICAL, cuda_device, rand_limbs,
                            to_np, to_t)

pytestmark = pytest.mark.cuda

R_INV = pow(F.R, -1, F.MODULUS)
GOLDEN = {"mont_mul": lambda a, b: a * b * R_INV % F.MODULUS,
          "mulmod": lambda a, b: a * b % F.MODULUS}


@pytest.mark.parametrize("name", ["mont_mul", "mulmod"])
def test_field_kernel_matches_plain_and_golden(cuda_device, name):
    gen = np.random.default_rng(8)
    kernel, plain = getattr(tfm, name), getattr(tfm, name + "_plain")
    cases = [
        (rand_limbs(gen, (4, 1024), False), rand_limbs(gen, (4, 1024), False)),
        (rand_limbs(gen, (4, 1024)), rand_limbs(gen, (1024,))),   # twiddle
        (rand_limbs(gen, (1024,)), rand_limbs(gen, (4, 1024))),   # swapped
        (rand_limbs(gen, (3, 5)), rand_limbs(gen, ())),           # scalar
        (rand_limbs(gen, (6, 1, 8)), rand_limbs(gen, (6, 8, 1))),  # neither
        (ints_to_limbs(NONCANONICAL + EDGES),
         ints_to_limbs((EDGES + NONCANONICAL)[::-1])),
    ]
    before = tfm.LAUNCHES[name]
    for x, y in cases:
        xt, yt = to_t(x, cuda_device), to_t(y, cuda_device)
        got = kernel(xt, yt)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), plain(xt.cpu(), yt.cpu()))
    assert tfm.LAUNCHES[name] == before + len(cases)
    x, y = cases[1]
    got = limbs_to_ints(to_np(kernel(to_t(x, cuda_device),
                                     to_t(y, cuda_device))))
    xs = limbs_to_ints(x)
    ys = limbs_to_ints(np.broadcast_to(y, x.shape))
    assert got == [GOLDEN[name](a, b) for a, b in zip(xs, ys)]


def test_field_kernel_rejects_bad_operands(cuda_device):
    x = torch.zeros((4, 8), dtype=torch.int64, device=cuda_device)
    with pytest.raises(TypeError):
        tfm.mont_mul(x, x)
    y = torch.zeros((4, 8), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        tfm.mulmod(y, y.cpu())


@pytest.mark.parametrize("schedule", [[5, 3, 1, 4, 5], [4, 2, 4],
                                      [2, 0, 3, 5, 1]])
def test_sha_kernel_matches_plain_and_hashlib(cuda_device, schedule):
    gen = np.random.default_rng(sum(schedule))
    cols, bsz = 4096 + 3, 5              # not a multiple of the block size
    k_st = (tsha.initial_state(cols, cuda_device),
            torch.zeros((cols, 8), dtype=torch.int32, device=cuda_device),
            False)
    p_st = k_st
    absorbed = []
    before = tsha.LAUNCHES["sha256_absorb"]
    for valid in schedule:
        rows = rand_limbs(gen, (bsz, cols), canonical=False)
        absorbed.append(rows[:valid])
        k_st = tsha.absorb_stream(*k_st, to_t(rows, cuda_device), valid)
        p_st = tsha.absorb_stream_plain(*p_st, to_t(rows, cuda_device),
                                        valid)
        torch.cuda.synchronize()
        assert torch.equal(k_st[0], p_st[0])
        assert torch.equal(k_st[1], p_st[1])
        assert k_st[2] == p_st[2]
    assert tsha.LAUNCHES["sha256_absorb"] == before + len(schedule)
    stream = np.concatenate(absorbed, axis=0)
    final = tsha.finalize(*k_st, stream.shape[0])
    want = [hashlib.sha256(stream[:, c].astype(">u4").tobytes()).digest()
            for c in range(cols)]
    assert tsha.digests_to_bytes(final) == want


def test_executor_steps_match_cpu(cuda_device):
    from ligero_prover_tpu_torch import convert
    from ligero_prover_tpu_torch.zkp.executor import TorchExecutor
    k, n, b = 256, 1024, 8
    gpu, cpu = TorchExecutor(k, n, b, cuda_device), TorchExecutor(k, n, b,
                                                                  "cpu")
    gen = np.random.default_rng(9)
    rows = rand_limbs(gen, (b, k))
    sha = gpu.sha_init(n)
    got = gpu.commit_step(sha, rows, 5)
    want = cpu.commit_step(cpu.sha_init(n), rows, 5)
    for g, w in zip(convert.to_numpy(got), convert.to_numpy(want)):
        np.testing.assert_array_equal(g, w)
    accs = tuple(rand_limbs(gen, (n,)) for _ in range(3))
    quads = (gen.integers(0, b, (b, 3)).astype(np.int32),
             rand_limbs(gen, (b,)),
             gen.integers(0, b, (b, 2)).astype(np.int32),
             rand_limbs(gen, (b,)))
    args = (rows, rand_limbs(gen, (b, k)), rand_limbs(gen, (b,))) + quads
    got = gpu.check_step(convert.accs_from_numpy(accs, cuda_device), *args)
    want = cpu.check_step(convert.accs_from_numpy(accs), *args)
    for g, w in zip(convert.to_numpy(got), convert.to_numpy(want)):
        np.testing.assert_array_equal(g, w)


def test_proof_bytes_match_cpu(cuda_device, monkeypatch):
    from chip_smoke import make_wat
    from ligero_prover_tpu_torch.params import RowGeometry
    from ligero_prover_tpu_torch.prover import prove
    from ligero_prover_tpu_torch.verifier import verify
    from ligero_prover_tpu_torch.vm.run import make_wat_program
    monkeypatch.setenv("LIGERO_PROOF_TIMESTAMP", "1700000000")
    geo = RowGeometry(256)
    prog = make_wat_program(make_wat(3), [], set())
    proofs = [prove(prog, geometry=geo, encoding_seed=bytes(32),
                    device=dev, batch_rows=8) for dev in (cuda_device, "cpu")]
    assert proofs[0].ok and proofs[0].proof == proofs[1].proof
    assert verify(prog, proofs[1].proof, geometry=geo,
                  device=cuda_device, batch_rows=8).ok
