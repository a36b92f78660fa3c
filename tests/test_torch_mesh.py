"""The column-sharded executor (``parallel/mesh.py``) at k=256, n=1024 on
the CPU: the coset encode against the single-device encode, the tiled KE
mode's plain version, every sharded step against the JAX
``ShardedExecutor`` on the 8 virtual CPU devices that ``conftest.py``
makes, and where the shards' state lives.  Exact: tolerance 0.

The tests marked ``cuda`` need the card (the tiled KE mode against its
plain version; every kernel on a tensor of the second card while the
first is current, which needs two cards; a sharded proof on the card).
JAX is imported only where the reference is used, so on the card:

    python -m pytest tests/test_torch_mesh.py -m cuda --noconftest -q
"""

import functools
import os

import numpy as np
import pytest
import torch

from ligero_prover_tpu_torch import convert
from ligero_prover_tpu_torch.field import bn254 as F
from ligero_prover_tpu_torch.field.limbs import ints_to_limbs, limbs_to_ints
from ligero_prover_tpu_torch.ops import fieldmul as tfm
from ligero_prover_tpu_torch.ops import ntt
from ligero_prover_tpu_torch.parallel.mesh import ColumnShards, \
    ShardedExecutor, make_mesh
from ligero_prover_tpu_torch.zkp.executor import TorchExecutor

from _torch_helpers import EDGES, NONCANONICAL, cuda_device, rand_limbs, \
    to_np, to_t

K, N, B, S = 256, 1024, 8, 192


def _cpu_mesh(D):
    return make_mesh(["cpu"] * D)


def _same(got, want):
    got, want = convert.to_numpy(got), convert.to_numpy(want)
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, (bool, np.bool_)) or np.ndim(want) == 0:
        assert bool(got) == bool(want)
    else:
        np.testing.assert_array_equal(np.asarray(got),
                                      np.asarray(want, np.uint32))


# ---- the coset encode ----------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_codec():
    from ligero_prover_tpu.ops import ntt as jntt
    return jntt, jntt.RSCodec(K, N)


@pytest.mark.parametrize("ref", ["jax", "port"])
@pytest.mark.parametrize("width_2k", [False, True], ids=["k", "2k"])
@pytest.mark.parametrize("D", [1, 2, 4, 8])
def test_coset_encode_matches_single_device(D, width_2k, ref):
    """Shard d's columns, interleaved back (column d + D*t from shard d's
    column t), are the single-device encode limb for limb, the JAX
    package's (``encode_rows_cg``) and the port's: at D = 8 both widths
    fold (m = 128 < k), at D = 1 the 2k rows tile."""
    ex = ShardedExecutor(K, N, _cpu_mesh(D), B)
    w = 2 * K if width_2k else K
    gen = np.random.default_rng(D + 10 * width_2k)
    x = rand_limbs(gen, (3, w))
    rows = to_t(x)
    if ref == "jax":
        jntt, jc = _jax_codec()
        want = to_t(np.asarray(jntt.encode_rows_cg(
            x, jc.dom_2k if width_2k else jc.dom_k, jc.dom_n, N)))
    else:
        codec = TorchExecutor(K, N, B, "cpu").codec
        want = (codec.encode_2k if width_2k else codec.encode)(rows)
    coeffs = ex._coeffs(rows, width_2k)
    parts = [ex._encode(coeffs, d).movedim(0, -1) for d in range(D)]
    assert all(p.shape == (3, N // D, 8) for p in parts)
    got = torch.stack(parts, dim=2).flatten(1, 2)
    assert torch.equal(got, want)


def test_coset_domain_is_a_power_of_the_codeword_root():
    """The m-point domain's root is w_n^D: at D = 4 (m = k) its twiddles
    are those of w_n^4, not of the codec's own k-point root w_k."""
    w_k, _, w_n = F.generate_omegas(K, N)
    assert w_k != pow(w_n, 4, F.MODULUS)
    dom = ntt.coset_tables(K, N, 4, 1)["dom"]
    assert torch.equal(dom["cg_fwd_pl"], ntt.build_domain_tables(
        K, pow(w_n, 4, F.MODULUS))["cg_fwd_pl"])
    assert not torch.equal(dom["cg_fwd_pl"],
                           ntt.build_domain_tables(K, w_k)["cg_fwd_pl"])


def test_coset_twist_table():
    """Position pos of shard d's twist table for width w holds
    w^-1 * w_n^(d * bitrev_w(pos)) in Montgomery form, as contiguous
    (8, w) limb planes."""
    p, D, d = F.MODULUS, 8, 5
    w_n = F.generate_omegas(K, N)[2]
    tabs = ntt.coset_tables(K, N, D, d)
    assert tabs["m"] == N // D
    for w in (K, 2 * K):
        rev = ntt._bitrev(w)
        want = [pow(w, p - 2, p) * pow(w_n, d * int(rev[pos]), p) * F.R % p
                for pos in range(w)]
        assert tabs["twist"][w].is_contiguous()
        assert limbs_to_ints(to_np(tabs["twist"][w].T)) == want


# ---- the tiled KE mode ---------------------------------------------------

@pytest.mark.parametrize("shape,y_shape", [((3, 64), (64,)),
                                           ((2, 3, 32), (1, 32)),
                                           ((1, 512), (1, 512))])
def test_tiled_plain_is_the_broadcast_product(shape, y_shape):
    """mont_mul_tiled_planar_plain equals mont_mul_planar_plain of the row
    broadcast over x, also on non-canonical words; the wrapper takes it
    on the CPU and launches nothing."""
    gen = np.random.default_rng(len(shape) + shape[-1])
    x = to_t(np.moveaxis(rand_limbs(gen, shape, False), -1, 0).copy())
    y = to_t(np.moveaxis(rand_limbs(gen, y_shape, False), -1, 0).copy())
    edges = ints_to_limbs(NONCANONICAL + EDGES).T.copy()
    x.view(8, -1)[:, :edges.shape[1]] = to_t(edges)
    bcast = y.reshape((8,) + (1,) * (x.dim() - 2) + (shape[-1],))
    want = tfm.mont_mul_planar_plain(x, bcast.expand(x.shape).contiguous())
    before = tfm.PLAIN_CALLS[tfm.TILED]["cpu"]
    assert torch.equal(tfm.mont_mul_tiled_planar_plain(x, y), want)
    assert torch.equal(tfm.mont_mul_tiled_planar(x, y), want)
    assert tfm.PLAIN_CALLS[tfm.TILED]["cpu"] == before + 2
    assert tfm.LAUNCHES[tfm.TILED] == 0


def test_tiled_rejects_a_row_of_another_width():
    x = torch.zeros((8, 2, 64), dtype=torch.int32)
    for y in (torch.zeros((8, 32), dtype=torch.int32),
              torch.zeros((8, 2, 64), dtype=torch.int32),
              torch.zeros((4, 64), dtype=torch.int32)):
        with pytest.raises(ValueError, match="one row"):
            tfm.mont_mul_tiled_planar(x, y)


# ---- the executor --------------------------------------------------------

def test_mesh_and_executor_arguments():
    """make_mesh() takes every card and raises without one; the shard
    count must be a power of two dividing n."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()
    assert make_mesh(["cpu", "cpu"]).devices == (torch.device("cpu"),) * 2
    for D in (3, 6):
        with pytest.raises(ValueError, match="power of two"):
            ShardedExecutor(K, N, _cpu_mesh(D), B)
    assert not ShardedExecutor(K, N, _cpu_mesh(2), B).use_mxu


def test_sharded_state_is_distributed():
    """Every shard holds n/D columns of the SHA states after sha_init and
    a commit, and of the accumulators after a check (the stage-2 zeros are
    split at first use); the verifier's 192-column state stays whole."""
    D = 8
    ex = ShardedExecutor(K, N, _cpu_mesh(D), B)
    state, pending, hp = ex.sha_init(N)
    assert [p.shape for p in state.parts] == [(8, N // D)] * D
    assert [p.shape for p in pending.parts] == [(N // D, 8)] * D
    gen = np.random.default_rng(1)
    out = ex.commit_step((state, pending, hp), rand_limbs(gen, (B, K)), B)
    assert [p.shape for p in out[0].parts] == [(8, N // D)] * D
    z = ex.zeros((N, 8))
    accs = ex.check_step((z, z, z), rand_limbs(gen, (B, K)),
                         rand_limbs(gen, (B, K)), rand_limbs(gen, (B,)),
                         np.zeros((B, 3), np.int32), np.zeros((B, 8),
                                                              np.uint32),
                         np.zeros((B, 2), np.int32),
                         np.zeros((B, 8), np.uint32))
    for acc in accs:
        assert isinstance(acc, ColumnShards)
        assert [p.shape for p in acc.parts] == [(N // D, 8)] * D
    assert isinstance(ex.sha_init(S)[0], torch.Tensor)


def test_shard_columns_round_trip():
    gen = np.random.default_rng(2)
    state = gen.integers(0, 2 ** 32, (8, N), dtype=np.uint64) \
        .astype(np.uint32)
    acc = rand_limbs(gen, (N,))
    for arr, axis in ((state, 1), (acc, 0)):
        sh = convert.shard_columns(arr, 4, axis)
        np.testing.assert_array_equal(
            to_np(sh.parts[3]), np.take(arr, np.arange(3, N, 4), axis))
        np.testing.assert_array_equal(convert.gather_columns(sh), arr)


# ---- every step against the JAX ShardedExecutor at D = 8 ------------------

D_JAX = 8


@pytest.fixture(scope="module")
def executors():
    """The JAX ShardedExecutor on 8 virtual CPU devices, and the port's
    ShardedExecutor over 8 CPU shards."""
    import jax
    from ligero_prover_tpu.parallel.mesh import ShardedExecutor as JSharded
    from ligero_prover_tpu.parallel.mesh import make_mesh as j_make_mesh
    jex = JSharded(K, N, j_make_mesh(jax.devices()[:D_JAX]), B)
    return jex, ShardedExecutor(K, N, _cpu_mesh(D_JAX), B)


def _fetch(jex, out):
    if isinstance(out, tuple):
        return tuple(_fetch(jex, o) for o in out)
    if isinstance(out, (bool, np.bool_)) or np.ndim(out) == 0:
        return bool(out)
    return jex.fetch(out)


def _sha_state(gen, has_pending):
    words = gen.integers(0, 2 ** 32, (8, N), dtype=np.uint64)
    return (words.astype(np.uint32), rand_limbs(gen, (N,), False),
            np.bool_(has_pending))


def _port_sha(sha):
    state, pending, hp = sha
    return (convert.shard_columns(state, D_JAX, 1),
            convert.shard_columns(pending, D_JAX, 0), bool(hp))


def _port_accs(accs):
    return tuple(convert.shard_columns(a, D_JAX, 0) for a in accs)


@pytest.mark.parametrize("width_2k,valid,has_pending",
                         [(False, 5, True), (False, 8, False),
                          (True, 2, True)])
def test_commit_step_matches_jax(executors, width_2k, valid, has_pending):
    jex, tex = executors
    gen = np.random.default_rng(valid)
    sha = _sha_state(gen, has_pending)
    rows = rand_limbs(gen, (2 if width_2k else B, 2 * K if width_2k else K))
    want = _fetch(jex, jex.commit_step(sha, rows, valid, width_2k=width_2k))
    got = tex.commit_step(_port_sha(sha), rows, valid, width_2k=width_2k)
    assert isinstance(got[0], ColumnShards)
    _same(got, want)
    _same(tex.sha_finalize(got, 77), _fetch(jex, jex.sha_finalize(
        tuple(want), 77)))


@pytest.mark.parametrize("rands_zero", [False, True])
def test_check_step_matches_jax(executors, rands_zero):
    jex, tex = executors
    gen = np.random.default_rng(20 + rands_zero)
    accs = tuple(rand_limbs(gen, (N,)) for _ in range(3))
    rows = rand_limbs(gen, (B, K))
    rands = np.zeros((B, K, 8), np.uint32) if rands_zero else \
        rand_limbs(gen, (B, K))
    code_rs = rand_limbs(gen, (B,))
    tri_idx = gen.integers(0, B, (B, 3)).astype(np.int32)
    pair_idx = gen.integers(0, B, (B, 2)).astype(np.int32)
    tri_r, pair_r = rand_limbs(gen, (B,)), rand_limbs(gen, (B,))
    tri_r[5:] = 0
    pair_r[3:] = 0
    args = (rows, rands, code_rs, tri_idx, tri_r, pair_idx, pair_r)
    want = _fetch(jex, jex.check_step(accs, *args, rands_zero=rands_zero))
    _same(tex.check_step(_port_accs(accs), *args, rands_zero=rands_zero),
          want)


def test_mask_step_matches_jax(executors):
    jex, tex = executors
    gen = np.random.default_rng(30)
    accs = tuple(rand_limbs(gen, (N,)) for _ in range(3))
    rows = (rand_limbs(gen, (K,)), rand_limbs(gen, (2 * K,)),
            rand_limbs(gen, (2 * K,)))
    _same(tex.mask_step(_port_accs(accs), *rows),
          _fetch(jex, jex.mask_step(accs, *rows)))


@pytest.mark.parametrize("width_2k", [False, True])
def test_open_step_matches_jax(executors, width_2k):
    jex, tex = executors
    gen = np.random.default_rng(40 + width_2k)
    rows = rand_limbs(gen, (2, 2 * K) if width_2k else (B, K))
    idx = np.sort(gen.choice(N, S, replace=False)).astype(np.int32)
    _same(tex.open_step(rows, idx, width_2k=width_2k),
          _fetch(jex, jex.open_step(rows, idx, width_2k=width_2k)))


# ---- on the card ---------------------------------------------------------

def _planes(arr, device):
    return to_t(np.moveaxis(arr, -1, 0).copy(), device)


@pytest.mark.cuda
def test_tiled_kernel_matches_plain(cuda_device):
    """KE mont_mul's tiled mode against its plain version: w a multiple
    of 4 and not, a plane-stride view, a strided (copied)
    x, non-canonical words, the 2k mask row's shape, and the sharded
    encode's two calls at full width: the twist (8, 16, 8192) x (8, 8192)
    and the mask row (8, 1, 16384) x (8, 16384); each launch counted in
    TILED_SHAPES under its (B, w)."""
    gen = np.random.default_rng(5)
    x = _planes(rand_limbs(gen, (6, 1000), False), cuda_device)
    x[:, 0, :13] = _planes(ints_to_limbs(NONCANONICAL + EDGES), cuda_device)
    y = _planes(rand_limbs(gen, (1000,), False), cuda_device)
    odd = _planes(rand_limbs(gen, (3, 1002)), cuda_device)
    y_odd = _planes(rand_limbs(gen, (1, 1002)), cuda_device)
    mask = _planes(rand_limbs(gen, (1, 2048)), cuda_device)
    y_mask = _planes(rand_limbs(gen, (2048,)), cuda_device)
    twist = _planes(rand_limbs(gen, (16, 8192)), cuda_device)
    y_twist = _planes(rand_limbs(gen, (8192,)), cuda_device)
    row2k = _planes(rand_limbs(gen, (1, 16384)), cuda_device)
    y_row2k = _planes(rand_limbs(gen, (16384,)), cuda_device)
    cases = [(x, y), (x[:, 1:4], y), (odd, y_odd), (x[:, :, ::2], y[:, :500]),
             (mask, y_mask), (twist, y_twist), (row2k, y_row2k)]
    before = tfm.LAUNCHES[tfm.TILED]
    shapes = dict(tfm.TILED_SHAPES)
    for a, b in cases:
        got = tfm.mont_mul_tiled_planar(a, b)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(),
                           tfm.mont_mul_tiled_planar_plain(a.cpu(), b.cpu()))
    assert tfm.LAUNCHES[tfm.TILED] == before + len(cases)
    for shape in ((16, 8192), (1, 16384)):
        assert tfm.TILED_SHAPES[shape] == shapes.get(shape, 0) + 1


@pytest.mark.cuda
def test_kernels_follow_the_tensor_device(cuda_device):
    """With cuda:0 current, every kernel on tensors of cuda:1 runs there
    and equals its plain version (the launch guard of ``kernels.launch``;
    K3 sets its shared-memory attribute on that card)."""
    from ligero_prover_tpu_torch.ops import mxu_renorm as mr
    from ligero_prover_tpu_torch.ops import sha256 as tsha
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    dev = torch.device("cuda", 1)
    gen = np.random.default_rng(6)
    x = _planes(rand_limbs(gen, (2, 4096)), dev)
    y = _planes(rand_limbs(gen, (4096,)), dev)
    aos = to_t(rand_limbs(gen, (64, 8)), dev)
    tws = _planes(rand_limbs(gen, (12, 2048)), dev)        # (12, 8, 2048)
    tws = tws.permute(1, 0, 2).contiguous()
    cols = 32768                                           # K3 tile 128
    rows = _planes(rand_limbs(gen, (2, cols)), dev)
    sha = (tsha.initial_state(cols, dev),
           torch.zeros((cols, 8), dtype=torch.int32, device=dev))
    slot = aos[1].clone()          # KA in place, its constant by value
    calls = [
        (lambda: tfm.mont_mul(aos, aos), lambda: tfm.mont_mul_plain(
            aos.cpu(), aos.cpu())),
        (lambda: tfm.mulmod(aos, aos), lambda: tfm.mulmod_plain(
            aos.cpu(), aos.cpu())),
        (lambda: tfm.mont_mul_tiled_planar(x, y),
         lambda: tfm.mont_mul_tiled_planar_plain(x.cpu(), y.cpu())),
        (lambda: tfm.addmod_planar(x, x), lambda: tfm.addmod_planar_plain(
            x.cpu(), x.cpu())),
        (lambda: tfm.quad_terms_planar(x, np.array([[0, 1, 1]]),
                                       np.array([[1, 0]])),
         lambda: tfm.quad_terms_planar_plain(x.cpu(), np.array([[0, 1, 1]]),
                                             np.array([[1, 0]]))),
        (lambda: tfm.butterfly_dit_pass(x, tws, 0, 5),
         lambda: tfm.butterfly_dit_pass_plain(x.cpu(), tws.cpu(), 0, 5)),
        (lambda: tsha.absorb_stream_planar(*sha, False, rows, 2)[0],
         lambda: tsha.absorb_stream_planar_plain(
             sha[0].cpu(), sha[1].cpu(), False, rows.cpu(), 2)[0]),
        (lambda: mr.digitize(x), lambda: mr.digitize_plain(x.cpu())),
        (lambda: tfm.addmod_aos(aos, aos[0]), lambda: tfm.addmod_aos_plain(
            aos.cpu(), aos[0].cpu())),
        (lambda: tfm.submod_aos(aos[:1].expand(64, 8, 8), aos),
         lambda: tfm.submod_aos_plain(aos[:1].cpu(), aos.cpu())),
        (lambda: tfm.masked_sum_aos(aos[0], aos),
         lambda: tfm.masked_sum_aos_plain(aos[0].cpu(), aos.cpu())),
        (lambda: tfm.masked_mulsum_aos(aos[0], aos, aos[:, :1]),
         lambda: tfm.masked_mulsum_aos_plain(aos[0].cpu(), aos.cpu(),
                                             aos[:, :1].cpu())),
        (lambda: tfm.addmod_aos(slot, aos[0, :1].cpu(), out=slot),
         lambda: tfm.addmod_aos_plain(aos[1].cpu(), aos[0, :1].cpu())),
    ]
    with torch.cuda.device(0):
        for kernel, plain in calls:
            got = kernel()
            assert got.device == dev
            torch.cuda.synchronize(dev)
            assert torch.equal(got.cpu(), plain())


@pytest.mark.cuda
def test_sharded_prove_on_the_card(cuda_device):
    """A proof of 4 shards on cuda:(i % cards) equals the CPU proof."""
    from chip_smoke import make_wat
    from ligero_prover_tpu_torch import prover
    from ligero_prover_tpu_torch.params import RowGeometry
    from ligero_prover_tpu_torch.vm.run import make_wat_program
    prog = make_wat_program(make_wat(3), [], set())
    geo = RowGeometry(K)
    cards = torch.cuda.device_count()
    mesh = make_mesh([torch.device("cuda", i % cards) for i in range(4)])
    os.environ["LIGERO_PROOF_TIMESTAMP"] = "1700000000"
    try:
        got = prover.prove(prog, geometry=geo, mesh=mesh, batch_rows=8,
                           encoding_seed=bytes(32))
        want = prover.prove(prog, geometry=geo, device="cpu", batch_rows=8,
                            encoding_seed=bytes(32))
    finally:
        del os.environ["LIGERO_PROOF_TIMESTAMP"]
    assert got.ok and got.proof == want.proof
