"""The port's CUDA kernels on the card: K1 (mont_mul), K2 (mulmod), K3
(column SHA-256 absorb, AoS and planar rows), KB (planar butterfly stages)
and KE (planar element-wise ops) against their plain PyTorch versions, the
golden Python-int model and hashlib; the executor (planar, the CUDA
default, and AoS) and a whole proof on the card against the same on the
CPU.  Every test here needs a CUDA device and
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
    """The CUDA default (planar) against the CPU default (AoS)."""
    from ligero_prover_tpu_torch import convert
    from ligero_prover_tpu_torch.zkp.executor import TorchExecutor
    k, n, b = 256, 1024, 8
    gpu, cpu = TorchExecutor(k, n, b, cuda_device), TorchExecutor(k, n, b,
                                                                  "cpu")
    assert gpu.use_planar and not cpu.use_planar
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


def _planes(arr, device):
    """(..., 8) uint32 limbs -> (8, ...) int32 limb planes on `device`."""
    return to_t(np.moveaxis(arr, -1, 0).copy(), device)


@pytest.mark.parametrize("name", list(tfm.PLANAR_MODE))
def test_planar_eltwise_matches_plain(cuda_device, name):
    gen = np.random.default_rng(len(name))
    kernel, plain = getattr(tfm, name), getattr(tfm, name + "_plain")
    base = _planes(rand_limbs(gen, (6, 1000), False), cuda_device)
    edges = ints_to_limbs(NONCANONICAL + EDGES)
    base[:, 0, :len(edges)] = _planes(edges, cuda_device)
    if name == "mont_mul_scalar_planar":
        ys = [_planes(rand_limbs(gen, (), c), cuda_device)
              for c in (True, False)]
        cases = [(base, y) for y in ys] + [(base[:, 2:5], ys[0])]
    else:
        full = _planes(rand_limbs(gen, (6, 1000), False), cuda_device)
        full[:, 0, :len(edges)] = _planes(edges[::-1].copy(), cuda_device)
        rows = _planes(rand_limbs(gen, (6, 1)), cuda_device)
        cases = [(base, full),                     # same shape
                 (base[:, 1:4], full[:, 2:5]),     # plane-stride views
                 (base, rows),                     # one scalar per row
                 (base[:, :, 7], full[:, :, 3])]   # strided: copied
    before = tfm.LAUNCHES[name]
    for x, y in cases:
        got = kernel(x, y)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), plain(x.cpu(), y.cpu()))
    assert tfm.LAUNCHES[name] == before + len(cases)


@pytest.mark.parametrize("dit,b,w,h", [(True, 3, 2048, 1024),
                                       (True, 2, 512, 1024),
                                       (True, 1, 2, 4),
                                       (False, 3, 2048, 1024)])
def test_planar_stage_matches_plain(cuda_device, dit, b, w, h):
    gen = np.random.default_rng(b * w + dit)
    kernel = tfm.butterfly_dit if dit else tfm.butterfly_dif
    plain = tfm.butterfly_dit_plain if dit else tfm.butterfly_dif_plain
    x = _planes(rand_limbs(gen, (b, w), False), cuda_device)
    tw = _planes(rand_limbs(gen, (h,)), cuda_device)
    out = torch.empty((8, b, 2 * h), dtype=torch.int32, device=cuda_device)
    before = tfm.LAUNCHES[kernel.__name__]
    assert kernel(x, tw, out=out) is out
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), plain(x.cpu(), tw.cpu()))
    assert tfm.LAUNCHES[kernel.__name__] == before + 1


def test_planar_kernels_reject_bad_operands(cuda_device):
    x = torch.zeros((8, 4, 16), dtype=torch.int32, device=cuda_device)
    tw = torch.zeros((8, 8), dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        tfm.addmod_planar(x, x.to(torch.int64))
    with pytest.raises(ValueError):
        tfm.submod_planar(x, x.cpu())
    with pytest.raises(ValueError):                # not a trailing broadcast
        tfm.mont_mul_planar(x, x[:, :1])
    with pytest.raises(ValueError):                # DIF needs the full width
        tfm.butterfly_dif(x[:, :, :8].contiguous(), tw)
    with pytest.raises(ValueError):                # out may not be x
        tfm.butterfly_dit(x, tw, out=x)
    with pytest.raises(ValueError):
        tfm.mont_mul_scalar_planar(x, x[:, 0])


@pytest.mark.parametrize("schedule", [[5, 3, 1, 4, 5], [2, 0, 3, 5, 1]])
def test_planar_sha_kernel_matches_plain(cuda_device, schedule):
    gen = np.random.default_rng(sum(schedule) + 1)
    cols, bsz = 4096 + 3, 5
    k_st = (tsha.initial_state(cols, cuda_device),
            torch.zeros((cols, 8), dtype=torch.int32, device=cuda_device),
            False)
    p_st = a_st = k_st
    before = tsha.LAUNCHES["sha256_absorb_planar"]
    for valid in schedule:
        rows = to_t(rand_limbs(gen, (bsz, cols), canonical=False),
                    cuda_device)
        planes = rows.movedim(-1, 0).contiguous()
        k_st = tsha.absorb_stream_planar(*k_st, planes, valid)
        p_st = tsha.absorb_stream_planar_plain(*p_st, planes, valid)
        a_st = tsha.absorb_stream(*a_st, rows, valid)
        torch.cuda.synchronize()
        for st in (p_st, a_st):
            assert torch.equal(k_st[0], st[0])
            assert torch.equal(k_st[1], st[1])
            assert k_st[2] == st[2]
    assert tsha.LAUNCHES["sha256_absorb_planar"] == before + len(schedule)


def test_aos_executor_steps_match_cpu(cuda_device, monkeypatch):
    """The AoS configuration stays selectable on the card."""
    from ligero_prover_tpu_torch import convert
    from ligero_prover_tpu_torch.ops import ntt
    from ligero_prover_tpu_torch.zkp.executor import TorchExecutor
    monkeypatch.setattr(ntt, "USE_PLANAR", False)
    k, n, b = 256, 1024, 8
    gpu, cpu = TorchExecutor(k, n, b, cuda_device), TorchExecutor(k, n, b,
                                                                  "cpu")
    assert not gpu.use_planar
    gen = np.random.default_rng(19)
    rows = rand_limbs(gen, (b, k))
    got = gpu.commit_step(gpu.sha_init(n), rows, 5)
    want = cpu.commit_step(cpu.sha_init(n), rows, 5)
    for g, w in zip(convert.to_numpy(got), convert.to_numpy(want)):
        np.testing.assert_array_equal(g, w)
    cw = rand_limbs(gen, (n,))
    np.testing.assert_array_equal(convert.to_numpy(gpu.decode(cw)),
                                  convert.to_numpy(cpu.decode(cw)))


def test_mulmod_fma_kernel_matches_plain(cuda_device):
    gen = np.random.default_rng(30)
    for canonical, shape in ((True, (3, 1000)), (False, (1027,))):
        acc, x, y = (to_t(np.moveaxis(rand_limbs(gen, shape, canonical),
                                      -1, 0), cuda_device)
                     for _ in range(3))
        before = tfm.LAUNCHES["mulmod_fma_planar"]
        got = tfm.mulmod_fma_planar(acc, x, y)
        torch.cuda.synchronize()
        assert tfm.LAUNCHES["mulmod_fma_planar"] == before + 1
        assert torch.equal(got.cpu(), tfm.mulmod_fma_planar_plain(
            acc.cpu(), x.cpu(), y.cpu()))
    with pytest.raises(ValueError):
        tfm.mulmod_fma_planar(acc[:, :5], x, y)


def test_renorm_kernels_and_engine_on_the_card(cuda_device):
    """KR on real slots at k=256, B=8 (ragged against the block size at
    level 1), the twiddle read by index and broadcast, and the int8
    engine's encode against the butterfly encode."""
    from ligero_prover_tpu_torch.ops import mxu_ntt as tmx
    from ligero_prover_tpu_torch.ops import mxu_renorm as tmr
    from ligero_prover_tpu_torch.ops import ntt as tntt
    k, n, bsz = 256, 1024, 8
    codec = tntt.RSCodec(k, n, cuda_device)
    tabs = codec.mxu_tabs
    r1, c1 = tabs["geom"][:2]
    rows = to_t(rand_limbs(np.random.default_rng(31), (bsz, k)), cuda_device)
    x = rows.movedim(-1, 0).contiguous()
    tmr.reset_counts()
    xp = tmr.digitize(x)
    assert torch.equal(xp.cpu(), tmr.digitize_plain(x.cpu()))
    slots = tmx.level1_slots(xp.view(8, bsz, r1, c1), tabs).clone()
    tw = tabs["tw1"]
    full = tw.expand(8, r1, bsz, c1).contiguous()
    want = tmr.renorm_mid_plain(slots.cpu(), tw.cpu())
    for table in (tw, full):
        assert torch.equal(tmr.renorm_mid(slots, table).cpu(), want)
    assert torch.equal(tmr.renorm_final(slots).cpu(),
                       tmr.renorm_final_plain(slots.cpu()))
    assert torch.equal(tmr.renorm_pack(slots).cpu(),
                       tmr.renorm_pack_plain(slots.cpu()))
    assert tmr.LAUNCHES == {"digitize": 1, "renorm_final": 1,
                            "renorm_mid": 2, "renorm_pack": 1}
    assert all(not calls["cuda"] for calls in tmr.PLAIN_CALLS.values())
    got = tmx.encode_rows_mxu_core(rows, tabs, n)
    want = tntt.encode_rows_cg_planar_core(rows, codec.dom_k, codec.dom_n, n)
    assert torch.equal(got, want)
    with pytest.raises(TypeError):
        tmr.renorm_final(slots.to(torch.int64))
    with pytest.raises(ValueError):
        tmr.renorm_mid(slots, tw.cpu())
