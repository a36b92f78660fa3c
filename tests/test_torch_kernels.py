"""The port's CUDA kernels on the card: K1 (mont_mul), K2 (mulmod), K3
(column SHA-256 absorb, AoS and planar rows), KA (AoS add/sub), KF (the
verifier's ordered fold), KB (planar butterfly
passes), KE (planar element-wise ops and quad-terms) and KR digitize
against their plain PyTorch versions, the golden Python-int model and
hashlib; the executor's steps and a whole proof on the card against the
same on the CPU.  Every test here needs a CUDA device and skips without
one.  This file imports no JAX, so it runs
on a machine without it:

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -q
"""

import hashlib

import numpy as np
import pytest
import torch

from ligero_prover_tpu_torch.field import bn254 as F
from ligero_prover_tpu_torch.field.limbs import ints_to_limbs, limbs_to_ints
from ligero_prover_tpu_torch.ops import fieldmul as tfm
from ligero_prover_tpu_torch.ops import fieldops as tfo
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


@pytest.mark.parametrize("n", [8192, 3072])
@pytest.mark.parametrize("y_rows", ["n", 1])
def test_mulmod_kernel_at_the_main_path_sizes(cuda_device, n, y_rows):
    """K2 at the vbn254fr arena's 8,192 and the verifier's 3,072 elements,
    the second operand full (y_rows = n) or one broadcast element, on
    non-canonical operands with the edge values, against the plain
    version and the golden model on the canonical ones."""
    gen = np.random.default_rng(n + (y_rows == 1))
    rows = 1 if y_rows == 1 else n
    x, y = rand_limbs(gen, (n,), False), rand_limbs(gen, (rows,), False)
    edges = ints_to_limbs(NONCANONICAL + EDGES)
    x[:len(edges)] = edges
    y[:len(edges)] = edges[::-1][:rows]
    xt, yt = to_t(x, cuda_device), to_t(y, cuda_device)
    before = tfm.LAUNCHES["mulmod"]
    got = tfm.mulmod(xt, yt)
    torch.cuda.synchronize()
    assert tfm.LAUNCHES["mulmod"] == before + 1
    assert torch.equal(got.cpu(), tfm.mulmod_plain(xt.cpu(), yt.cpu()))
    xs = limbs_to_ints(x)
    ys = limbs_to_ints(np.broadcast_to(y, x.shape))
    for g, a, b in zip(limbs_to_ints(to_np(got)), xs, ys):
        if a < F.MODULUS and b < F.MODULUS:
            assert g == GOLDEN["mulmod"](a, b)


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
    """The kernels against the plain versions, step by step: commit,
    check and decode on the card equal them on the CPU."""
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
    cw = rand_limbs(gen, (n,))
    np.testing.assert_array_equal(convert.to_numpy(gpu.decode(cw)),
                                  convert.to_numpy(cpu.decode(cw)))


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


@pytest.mark.parametrize("dit,b,w,log2n", [(True, 3, 2048, 11),
                                           (True, 2, 256, 11),
                                           (True, 1, 2, 3),
                                           (False, 3, 2048, 11),
                                           (False, 5, 8, 3)])
def test_planar_passes_match_plain(cuda_device, dit, b, w, log2n):
    """Every pass (t0, s) of the transform, s up to 8, against the plain
    pass; odd batches leave the last tile partial."""
    gen = np.random.default_rng(b * w + log2n + dit)
    kernel = tfm.butterfly_dit_pass if dit else tfm.butterfly_dif_pass
    plain = tfm.butterfly_dit_pass_plain if dit else \
        tfm.butterfly_dif_pass_plain
    x = _planes(rand_limbs(gen, (b, w), False), cuda_device)
    tws = to_t(np.ascontiguousarray(rand_limbs(
        gen, (log2n, 1 << (log2n - 1)), False).transpose(0, 2, 1)),
        cuda_device)
    name = "butterfly_dit" if dit else "butterfly_dif"
    before = tfm.LAUNCHES[name]
    runs = 0
    for t0 in range(log2n):
        for s in range(1, min(log2n - t0, tfm.MAX_PASS) + 1):
            got = kernel(x, tws, t0, s)
            torch.cuda.synchronize()
            assert torch.equal(got.cpu(), plain(x.cpu(), tws.cpu(), t0, s))
            runs += 1
    assert tfm.LAUNCHES[name] == before + runs
    with pytest.raises(ValueError):
        kernel(x, tws, log2n - 1, 2)


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


@pytest.mark.parametrize("planar", [False, True], ids=["aos", "planar"])
@pytest.mark.parametrize("cols", [192, 200, 128 * tsha.SMS + 5, 32768])
def test_sha_kernel_at_each_tile(cuda_device, planar, cols):
    """K3 at the verifier's C=192 (tile 32, whole tiles), a ragged last
    tile at each tile size (200; 16,901 with tile 128) and the commit
    step's C=32768, over the commit step's flushes at B=16 (15, 9 and 16
    valid: up to 8 blocks, the pending element carried), against the plain
    version and hashlib."""
    gen = np.random.default_rng(cols + planar)
    bsz = 16
    k_st = (tsha.initial_state(cols, cuda_device),
            torch.zeros((cols, 8), dtype=torch.int32, device=cuda_device),
            False)
    p_st = k_st
    name = "sha256_absorb_planar" if planar else "sha256_absorb"
    kernel = tsha.absorb_stream_planar if planar else tsha.absorb_stream
    plain = tsha.absorb_stream_planar_plain if planar else \
        tsha.absorb_stream_plain
    before = tsha.LAUNCHES[name]
    absorbed = []
    for valid in (15, 9, 16):
        rows = rand_limbs(gen, (bsz, cols), canonical=False)
        absorbed.append(rows[:valid])
        rows_t = to_t(rows, cuda_device)
        if planar:
            rows_t = rows_t.movedim(-1, 0).contiguous()
        k_st = kernel(*k_st, rows_t, valid)
        p_st = plain(*p_st, rows_t, valid)
        torch.cuda.synchronize()
        assert torch.equal(k_st[0], p_st[0])
        assert torch.equal(k_st[1], p_st[1])
        assert k_st[2] == p_st[2]
    assert tsha.LAUNCHES[name] == before + 3
    stream = np.concatenate(absorbed, axis=0)
    final = tsha.finalize(*k_st, stream.shape[0])
    want = [hashlib.sha256(stream[:, c].astype(">u4").tobytes()).digest()
            for c in range(cols)]
    assert tsha.digests_to_bytes(final) == want


@pytest.mark.parametrize("name", ["mont_mul_planar", "mulmod_planar"])
def test_ke_products_on_unaligned_and_odd_rows(cuda_device, name):
    """KE mont_mul and mulmod where 16-byte units do not fit: rows of an
    odd length, and plane-stride views that start off a 16-byte
    boundary, times a per-row scalar and a full plane."""
    gen = np.random.default_rng(len(name) + 40)
    kernel, plain = getattr(tfm, name), getattr(tfm, name + "_plain")
    x = _planes(rand_limbs(gen, (6, 1001), False), cuda_device)
    y = _planes(rand_limbs(gen, (6, 1001), False), cuda_device)
    s = _planes(rand_limbs(gen, (6, 1), False), cuda_device)
    cases = [(x, s), (x, y), (x[:, 1:4], s[:, 2:5]), (x[:, 1:4], y[:, 3:6])]
    for a, b in cases:
        got = kernel(a, b)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), plain(a.cpu(), b.cpu()))


@pytest.mark.parametrize("n", [1024, 1030])
def test_quad_terms_kernel_matches_plain(cuda_device, n):
    """quad-terms on the card: repeated indices, zero-padded entries, no
    pairs, no triples, a plane-stride view of the batch; 16-byte units
    (n = 1024) and single elements (n = 1030); an index out of range
    raises before the launch."""
    gen = np.random.default_rng(n)
    e = _planes(rand_limbs(gen, (7, n), False), cuda_device)
    edges = ints_to_limbs(NONCANONICAL + EDGES)
    e[:, 0, :len(edges)] = _planes(edges, cuda_device)
    e[:, 1, :len(edges)] = _planes(edges[::-1].copy(), cuda_device)
    tri = gen.integers(0, 3, (5, 3)).astype(np.int32)
    pair = gen.integers(0, 3, (3, 2)).astype(np.int32)
    padded = np.zeros((4, 3), np.int32), np.zeros((4, 2), np.int32)
    padded[0][0], padded[1][0] = (0, 1, 2), (1, 0)
    cases = [(e, tri, pair), (e, *padded), (e, tri, pair[:0]),
             (e, tri[:0], pair), (e[:, 2:6], tri, pair)]
    before = tfm.LAUNCHES[tfm.QUAD]
    for x, t, p in cases:
        got = tfm.quad_terms_planar(x, t, p)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), tfm.quad_terms_planar_plain(
            x.cpu(), t, p))
    assert tfm.LAUNCHES[tfm.QUAD] == before + len(cases)
    with pytest.raises(IndexError):
        tfm.quad_terms_planar(e, tri + 7, pair)
    assert tfm.LAUNCHES[tfm.QUAD] == before + len(cases)


@pytest.mark.parametrize("n", [1024, 1030, 924])
def test_quad_acc_kernel_matches_plain(cuda_device, n):
    """KQ on the card against its plain version: random and repeated
    indices, x = y = z, zero-padded entries (index 0, scalar 0), T + P odd
    (3 + 2) and at a head's level (3 + 3), no pairs, no triples, one term,
    non-canonical rows, scalars and acc with the edge values, a
    plane-stride view of the batch; at n = 924, T = P = 400 take one
    column a CTA and 51,200 bytes of shared memory (the dynamic opt-in;
    compared with the plain version on the card).  An index out of range
    and scalars on the card raise before the launch."""
    gen = np.random.default_rng(n + 1)
    e = _planes(rand_limbs(gen, (7, n), False), cuda_device)
    edges = ints_to_limbs(NONCANONICAL + EDGES)
    e[:, 0, :len(edges)] = _planes(edges, cuda_device)
    e[:, 1, :len(edges)] = _planes(edges[::-1].copy(), cuda_device)
    acc = to_t(rand_limbs(gen, (n,), False), cuda_device)
    acc[:len(edges)] = to_t(edges, cuda_device)

    def quads(t_, p_, index="random"):
        tri = gen.integers(0, 7, (t_, 3)).astype(np.int32)
        pair = gen.integers(0, 7, (p_, 2)).astype(np.int32)
        tri_r, pair_r = (rand_limbs(gen, (k,), False) for k in (t_, p_))
        tri_r[:min(t_, len(edges))] = edges[:t_]
        if index == "same":
            tri[:] = np.arange(t_)[:, None] % 7
            pair[:] = np.arange(p_)[:, None] % 7
        elif index == "padded":
            tri[1:], pair[1:], tri_r[1:], pair_r[1:] = 0, 0, 0, 0
        return tri, pair, tri_r, pair_r
    cases = [(e, quads(16, 16)), (e, quads(16, 16, "same")),
             (e, quads(16, 16, "padded")), (e, quads(3, 2)),
             (e, quads(3, 3)), (e, quads(5, 0)), (e, quads(0, 4)),
             (e, quads(1, 0)), (e[:, 2:6], quads(6, 6))]
    if n == 924:
        cases = [(e, quads(400, 400)), (e, quads(16, 16))]
    before = tfm.LAUNCHES[tfm.QACC]
    for x, (tri, pair, tri_r, pair_r) in cases:
        tri, pair = tri % x.shape[1], pair % x.shape[1]
        got = tfm.quad_acc_planar(acc, x, tri, pair, tri_r, pair_r)
        on = cuda_device if n == 924 else "cpu"
        want = tfm.quad_acc_planar_plain(acc.to(on), x.to(on), tri, pair,
                                         tri_r, pair_r)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want.cpu())
    assert tfm.LAUNCHES[tfm.QACC] == before + len(cases)
    tri, pair, tri_r, pair_r = quads(4, 4)
    with pytest.raises(IndexError):
        tfm.quad_acc_planar(acc, e, tri + 7, pair, tri_r, pair_r)
    with pytest.raises(ValueError, match="on the host"):
        tfm.quad_acc_planar(acc, e, tri, pair, to_t(tri_r, cuda_device),
                            pair_r)
    assert tfm.LAUNCHES[tfm.QACC] == before + len(cases)


def test_mulmod_fma_kernel_matches_plain(cuda_device):
    """mulmod_fma on full planes (16-byte units, and single elements at an
    odd size), times a per-row scalar, and with an addend whose planes
    start off a 16-byte boundary."""
    gen = np.random.default_rng(30)

    def planes(shape, canonical):
        return to_t(np.moveaxis(rand_limbs(gen, shape, canonical), -1, 0),
                    cuda_device)
    cases = [tuple(planes(shape, canonical) for _ in range(3))
             for canonical, shape in ((True, (3, 1000)), (False, (1027,)))]
    x = planes((3, 1024), False)
    cases.append((planes((3, 1024), False), x, planes((3, 1), False)))
    wide = planes((3, 1025), False)
    cases.append((wide[:, :, 1:], x, planes((3, 1024), False)))
    for acc, x, y in cases:
        before = tfm.LAUNCHES["mulmod_fma_planar"]
        got = tfm.mulmod_fma_planar(acc, x, y)
        torch.cuda.synchronize()
        assert tfm.LAUNCHES["mulmod_fma_planar"] == before + 1
        assert torch.equal(got.cpu(), tfm.mulmod_fma_planar_plain(
            acc.cpu(), x.cpu(), y.cpu()))
    acc, x, y = cases[0]
    with pytest.raises(ValueError):
        tfm.mulmod_fma_planar(acc[:, :2], x, y)


def test_digitize_kernel_reads_views_in_place(cuda_device):
    """digitize on the engine's AoS rows viewed as planes (read in place),
    on planar rows, on a slice of rows and on views it copies, with
    non-canonical words, against the plain version."""
    from ligero_prover_tpu_torch.ops import mxu_renorm as tmr
    gen = np.random.default_rng(32)
    rows = rand_limbs(gen, (4, 256), canonical=False)
    rows[0, :4] = ints_to_limbs([(1 << 256) - 1, int("7f" * 32, 16),
                                 int("80" * 32, 16), F.MODULUS])
    r = to_t(rows, cuda_device)
    planar = r.movedim(-1, 0).contiguous()
    views = [r.movedim(-1, 0), r[1:3].movedim(-1, 0), planar,
             planar[:, 1:3], planar[:, :, 1:], planar.transpose(1, 2),
             planar.view(8, -1)[:, ::2]]
    for view in views:
        before = tmr.LAUNCHES["digitize"]
        got = tmr.digitize(view)
        torch.cuda.synchronize()
        assert tmr.LAUNCHES["digitize"] == before + 1
        assert got.is_contiguous() and got.shape == view.shape
        assert torch.equal(got.cpu(), tmr.digitize_plain(view.cpu()))


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


def _aos_forms(gen, device):
    """(label, x, y) KA operands on `device` in the forms of the port's
    call sites, non-canonical, with the edge values in all pairs first."""
    def t(shape, canonical=False):
        return to_t(rand_limbs(gen, shape, canonical), device)
    vals = NONCANONICAL + EDGES
    xe = to_t(ints_to_limbs([a for a in vals for _ in vals]), device)
    ye = to_t(ints_to_limbs([b for _ in vals for b in vals]), device)
    rows = t((16, 2048))
    return [
        ("edges in all pairs", xe, ye),
        ("arena + constant", t((8192,)), t(())),
        ("const_sub", t((1,)).expand(8192, 8), t((8192,))),
        ("verifier (16, 192, 8)", t((16, 192)), t((16, 192))),
        ("DIT lanes and twiddle", rows.reshape(16, 1024, 2, 8)[:, :, 0],
         t((1024,))),
        ("DIF halves", rows[:, :1024], rows[:, 1024:]),
        ("three element axes (copied)", t((3, 4, 5)).permute(1, 0, 2, 3),
         t((4, 3, 5))),
    ]


@pytest.mark.parametrize("name", list(tfm.AOS_MODE))
def test_aos_eltwise_kernel_matches_plain(cuda_device, name):
    kernel, plain = getattr(tfm, name), getattr(tfm, name + "_plain")
    cases = _aos_forms(np.random.default_rng(len(name) + 3), cuda_device)
    tfm.reset_counts()
    for label, x, y in cases:
        got = kernel(x, y)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), plain(x.cpu(), y.cpu())), label
    assert tfm.LAUNCHES[name] == len(cases)
    # the fieldops entry point: one KA launch per call
    fo_op = getattr(tfo, name.split("_")[0])
    _, x, y = cases[1]
    assert torch.equal(fo_op(x, y), kernel(x, y))
    assert tfm.LAUNCHES[name] == len(cases) + 2
    assert tfm.PLAIN_CALLS[name]["cuda"] == 0


@pytest.mark.parametrize("rows,n", [(0, 192), (1, 192), (2, 192), (16, 192),
                                    (17, 192), (16, 32768)])
def test_masked_sum_kernel_matches_plain(cuda_device, rows, n):
    gen = np.random.default_rng(rows + n)
    acc = to_t(rand_limbs(gen, (n,), False), cuda_device)
    terms = to_t(rand_limbs(gen, (rows, n), False), cuda_device)
    edges = to_t(ints_to_limbs(NONCANONICAL + EDGES), cuda_device)
    acc[:len(edges)] = edges
    if rows:
        terms[:, :len(edges)] = edges.flip(0)
        terms[:, -2:] = -1                     # 2^256 - 1: every add carries
    tfm.reset_counts()
    got = tfm.masked_sum_aos(acc, terms)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), tfm.masked_sum_aos_plain(acc.cpu(),
                                                           terms.cpu()))
    assert tfm.LAUNCHES["masked_sum_aos"] == 1
    assert tfm.PLAIN_CALLS["masked_sum_aos"]["cuda"] == 0


@pytest.mark.parametrize("full", [False, True], ids=["row", "full"])
@pytest.mark.parametrize("rows,n", [(0, 192), (1, 192), (16, 192),
                                    (17, 192), (100, 192), (16, 32768)])
def test_masked_mulsum_kernel_matches_plain(cuda_device, rows, n, full):
    """Fused KF at the verifier's calls and a codeword-wide one (B = 100:
    two chunks of products at 32 columns a CTA would not fit one), on
    non-canonical acc, x and y with the edge values first."""
    gen = np.random.default_rng(rows + n + full)
    vals = to_t(ints_to_limbs(NONCANONICAL + EDGES), cuda_device)
    acc = to_t(rand_limbs(gen, (n,), False), cuda_device)
    x = to_t(rand_limbs(gen, (rows, n), False), cuda_device)
    y = to_t(rand_limbs(gen, (rows, n if full else 1), False), cuda_device)
    acc[:len(vals)] = vals
    if rows:
        x[:, :len(vals)] = vals
        x[:, -2:] = -1                      # 2^256 - 1
        if full:
            y[:, :len(vals)] = vals.flip(0)
    tfm.reset_counts()
    got = tfm.masked_mulsum_aos(acc, x, y)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), tfm.masked_mulsum_aos_plain(
        acc.cpu(), x.cpu(), y.cpu()))
    assert tfm.LAUNCHES["masked_mulsum_aos"] == 1
    assert sum(tfm.LAUNCHES.values()) == 1
    assert tfm.PLAIN_CALLS["masked_mulsum_aos"]["cuda"] == 0


@pytest.mark.parametrize("alias", ["x", "y", "both"])
@pytest.mark.parametrize("name", list(tfm.AOS_MODE))
def test_aos_eltwise_kernel_in_place(cuda_device, name, alias):
    """KA at the arena's (8192, 8) with out = x, y or both, and with a
    host constant by value written into x: one launch each, equal to the
    plain version."""
    kernel, plain = getattr(tfm, name), getattr(tfm, name + "_plain")
    gen = np.random.default_rng(len(alias) + len(name))
    x = to_t(rand_limbs(gen, (8192,), False), cuda_device)
    y = x if alias == "both" else to_t(rand_limbs(gen, (8192,), False),
                                       cuda_device)
    want = plain(x.cpu(), y.cpu())
    tfm.reset_counts()
    out = y if alias == "y" else x
    assert kernel(x, y, out=out) is out
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), want)
    for c in (to_t(ints_to_limbs(NONCANONICAL[-1:])[0]),
              to_t(rand_limbs(gen, ())), to_t(rand_limbs(gen, (1,)))):
        for first in (False, True):
            args = (c, x) if first else (x, c)
            want = plain(*(a.cpu() for a in args))
            kernel(*args, out=x)
            torch.cuda.synchronize()
            assert torch.equal(x.cpu(), want), (first, tuple(c.shape))
    assert tfm.LAUNCHES[name] == 7 and sum(tfm.LAUNCHES.values()) == 7
    assert tfm.PLAIN_CALLS[name]["cuda"] == 0


def test_arena_in_place_on_the_card(cuda_device):
    """The vbn254fr arena's linear ops on the card, output slot an input
    slot, equal the CPU arena's rows, one KA launch each."""
    from ligero_prover_tpu_torch.vm.hostmods.vbn254fr import Arena
    gen = np.random.default_rng(21)
    k = 8192
    rows = [rand_limbs(gen, (k,), False) for _ in range(3)]
    c = ints_to_limbs(NONCANONICAL[:1])[0]
    arenas = [Arena(k, cuda_device), Arena(k, "cpu")]
    for a in arenas:
        for slot, row in enumerate(rows):
            a.set_row(slot, row)
    seq = [("add", (0, 0, 0)), ("sub", (1, 0, 1)), ("add_const", (2, 2, c)),
           ("sub_const", (0, 0, c)), ("const_sub", (1, 1, c)),
           ("add", (2, 1, 1))]
    tfm.reset_counts()
    for op, args in seq:
        for a in arenas:
            getattr(a, op)(*args)
    torch.cuda.synchronize()
    assert torch.equal(arenas[0].rows[:3].cpu(), arenas[1].rows[:3])
    assert tfm.LAUNCHES["addmod_aos"] + tfm.LAUNCHES["submod_aos"] == \
        len(seq)


def test_aos_out_rejects_bad_tensors(cuda_device):
    x = torch.zeros((64, 8), dtype=torch.int32, device=cuda_device)
    flat = torch.zeros(64 * 8 + 4, dtype=torch.int32, device=cuda_device)
    for out in (x.cpu(), x.to(torch.int64), flat[1:513].view(64, 8),
                x[:32], torch.zeros((8, 64), dtype=torch.int32,
                                    device=cuda_device).t()):
        with pytest.raises((ValueError, TypeError)):
            tfm.addmod_aos(x[:64], x, out=out)
    big = torch.zeros((65, 8), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):           # out overlaps x one row on
        tfm.submod_aos(big[:64], x, out=big[1:])
    with pytest.raises(ValueError):           # two host constants
        tfm.addmod_aos(x[0].cpu(), x[0].cpu(), out=x[:1])


def test_aos_kernels_reject_bad_operands(cuda_device):
    x = torch.zeros((4, 8), dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        tfm.addmod_aos(x, x.to(torch.int64))
    with pytest.raises(ValueError):
        tfm.submod_aos(x, x.cpu())
    with pytest.raises(ValueError):
        tfm.addmod_aos(x[:, :7], x[:, :7])
    with pytest.raises(ValueError):                # terms must be (B, *acc)
        tfm.masked_sum_aos(x, x[None, :3])
    with pytest.raises(ValueError):
        tfm.masked_sum_aos(x, x[None].cpu())
