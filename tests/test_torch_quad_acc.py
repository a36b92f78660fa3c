"""KQ (``fm.quad_acc_planar``), the planar check's whole quadratic-test
accumulation in one launch, on the CPU:

    out = acc + tree_fold_t((e[x]*e[y] - e[z] or e[x] - e[y]) * s_t),
    s_t = mont(r_t, R^2), the fold ``_tree_sum_mod_planar``'s pairwise one

* The kernel's phases (``quad_scale_at``, ``quad_acc_terms_at``,
  ``quad_acc_products_at``, ``quad_acc_fold_at``, ``quad_acc_store_at`` and
  the geometry rule ``quad_geom`` of ``csrc/planar.cu``) are compiled with
  g++ and run CTA by CTA as the kernel runs them: each phase over every
  thread of the CTA before the next (the barriers), threads in order and
  in reverse order (no thread reads what another writes in the same
  phase).  Held against the plain version and Python ints, over the
  rule's geometry at the check's calls (e (8, 16, 32768) and one shard's
  (8, 16, 8192): their first and last CTAs), at odd counts T + P and at
  geometries whose lanes do not divide the terms or columns the CTA.
* ``fm.quad_acc_planar_plain`` against a JAX composition of the
  reference's XLA ops (``ligero_prover_tpu.ops.fieldops`` mulmod, submod,
  mont_mul for the R^2 prescale and the products, addmod in the tree's
  order, as ``ligero_prover_tpu/zkp/executor.py:230-250`` composes them)
  and against Python ints over ``field/bn254.py``, at B = 16, 3 and 1
  (T = P = B, as ``zkp/context.py``'s ``_pack_quads`` pads them), on
  canonical and non-canonical rows and accumulators, with padded and
  repeated indices.  Exact: tolerance 0.
* The wrapper: the CPU takes the plain version; indices and scalars must
  be host arrays; an index out of range or a shape KQ does not take
  raises before anything runs; the executor's planar check makes one KQ
  call whose result equals the sequence it replaced.

The kernel itself on the card: ``tests/test_torch_kernels.py`` (``cuda``)
and ``chip_smoke.py`` phase 3.

    python -m pytest tests/test_torch_quad_acc.py -q
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from ligero_prover_tpu_torch.field import bn254 as F
from ligero_prover_tpu_torch.field.limbs import ints_to_limbs, limbs_to_ints
from ligero_prover_tpu_torch.ops import fieldmul as tfm
from ligero_prover_tpu_torch.zkp import executor as tex

from _torch_helpers import EDGES, NONCANONICAL, rand_limbs, to_np, to_t

CSRC = Path(tfm.__file__).resolve().parent.parent / "csrc"
P, R = F.MODULUS, F.R
R2 = R * R % P

HARNESS = r"""
#include <algorithm>
#include <vector>
#include "planar.cu"
using namespace ligero_pl;

// KQ as its kernel runs it, CTA by CTA over [cta0, cta1) (clipped to the
// grid): each phase over every thread of the CTA before the next, as the
// barriers order them, threads in order or (reverse) in reverse order.
// cols == 0 takes quad_geom's geometry.  The shared buffer starts as
// 0xA5A5A5A5 words.  Returns the grid's CTAs.
extern "C" uint32_t kq_run(const uint32_t* e, uint32_t e_ls, uint32_t n,
                           const int32_t* args, uint32_t T, uint32_t P,
                           const uint32_t* acc, uint32_t* out,
                           uint32_t cols, uint32_t lanes, uint32_t cta0,
                           uint32_t cta1, int reverse) {
  const QuadGeom g = cols ? QuadGeom{n, T, P, cols, lanes}
                          : quad_geom(n, T, P);
  std::vector<uint32_t> sm(quad_smem(g) / 4);
  const uint32_t threads = g.cols * g.lanes;
  auto each = [&](auto&& fn) {
    for (uint32_t k = 0; k < threads; ++k) {
      const uint32_t tid = reverse ? threads - 1 - k : k;
      fn(tid % g.cols, tid / g.cols);
    }
  };
  for (uint32_t cta = cta0; cta < std::min(cta1, quad_ctas(g)); ++cta) {
    std::fill(sm.begin(), sm.end(), 0xA5A5A5A5u);
    each([&](uint32_t c, uint32_t r) {
      quad_scale_at(args, g, r * g.cols + c, sm.data());
      quad_acc_terms_at(e, e_ls, args, g, cta, c, r, sm.data());
    });
    each([&](uint32_t c, uint32_t r) {
      quad_acc_products_at(g, cta, c, r, sm.data());
    });
    for (uint32_t b = T + P; b > 1u; b = (b + 1u) >> 1)
      each([&](uint32_t c, uint32_t r) {
        quad_acc_fold_at(g, b, cta, c, r, sm.data());
      });
    each([&](uint32_t c, uint32_t r) {
      quad_acc_store_at(acc, out, g, cta, c, r, sm.data());
    });
  }
  return quad_ctas(g);
}

// quad_geom(n, T, P) as (cols, lanes, shared bytes, CTAs)
extern "C" void kq_geom(uint32_t n, uint32_t T, uint32_t P, uint32_t* out) {
  const QuadGeom g = quad_geom(n, T, P);
  out[0] = g.cols;
  out[1] = g.lanes;
  out[2] = quad_smem(g);
  out[3] = quad_ctas(g);
}

extern "C" int kq_ok(long long e_ls, long long B, long long n, long long T,
                     long long P) {
  return quad_acc_ok(e_ls, B, n, T, P);
}

extern "C" uint32_t kq_max_terms() { return kQuadMaxTerms; }
"""


@pytest.fixture(scope="module")
def core(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    work = tmp_path_factory.mktemp("quad_acc")
    (work / "harness.cpp").write_text(HARNESS)
    so = work / "libkq.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC",
                    "-Wno-unknown-pragmas", f"-I{CSRC}", "-o", str(so),
                    str(work / "harness.cpp")], check=True)
    lib = ctypes.CDLL(str(so))
    ptr, u32, i64 = ctypes.c_void_p, ctypes.c_uint32, ctypes.c_longlong
    lib.kq_run.argtypes = [ptr, u32, u32, ptr, u32, u32, ptr, ptr, u32, u32,
                           u32, u32, ctypes.c_int]
    lib.kq_run.restype = u32
    lib.kq_geom.argtypes = [u32, u32, u32, ptr]
    lib.kq_ok.argtypes = [i64] * 5
    lib.kq_max_terms.restype = u32
    return lib


def args_of(tri, pair, tri_r, pair_r) -> np.ndarray:
    """KQ's packed int32 arguments (``fm.quad_acc_args``' layout)."""
    return np.concatenate([np.asarray(tri, np.int32).ravel(),
                           np.asarray(pair, np.int32).ravel(),
                           tri_r.view(np.int32).ravel(),
                           pair_r.view(np.int32).ravel()])


def run_kq(core, acc, e, tri, pair, tri_r, pair_r, geom=(0, 0),
           ctas=(0, 1 << 30), reverse=False, e_ls=None):
    """The harness over uint32 numpy operands: acc (n, 8), e (8, B, n)
    (copied to planes at limb stride e_ls, B*n when None), the indices and
    (T, 8) / (P, 8) scalars.  Returns (out (n, 8) with untouched columns
    0xFFFFFFFF, CTAs of the grid)."""
    b, n = e.shape[1:]
    e_ls = b * n if e_ls is None else e_ls
    planes = np.zeros((8, e_ls), np.uint32)
    planes[:, :b * n] = e.reshape(8, -1)
    args = args_of(tri, pair, tri_r, pair_r)
    acc = np.ascontiguousarray(acc, np.uint32)
    out = np.full((n, 8), 0xFFFFFFFF, np.uint32)
    grid = core.kq_run(planes.ctypes.data, e_ls, n, args.ctypes.data,
                       len(tri), len(pair), acc.ctypes.data, out.ctypes.data,
                       *geom, *ctas, int(reverse))
    return out, grid


def plain(acc, e, tri, pair, tri_r, pair_r) -> np.ndarray:
    return to_np(tfm.quad_acc_planar_plain(to_t(acc), to_t(e), tri, pair,
                                           tri_r, pair_r))


# ---- Python ints of the reference's limb algorithms ------------------------

def model_mont(x: int, y: int) -> int:
    u = x * y
    m = ((u & (R - 1)) * F.MONTGOMERY_FACTOR_NEG) & (R - 1)
    t = ((u + m * P) >> 256) & (R - 1)
    return t - P if t >= P else t


def model_add(x: int, y: int) -> int:
    s = (x + y) & (R - 1)
    return s - P if s >= P else s


def model_sub(x: int, y: int) -> int:
    d = (x - y) & (R - 1)
    return (d + P) & (R - 1) if x < y else d


def model_fold(xs: list[int]) -> int:
    """``_tree_sum_mod_planar``'s association over one column."""
    while len(xs) > 1:
        head, body = (xs[:1], xs[1:]) if len(xs) % 2 else ([], xs)
        h = len(body) // 2
        xs = head + [model_add(a, b) for a, b in zip(body[:h], body[h:])]
    return xs[0]


def model(acc, e, tri, pair, tri_r, pair_r) -> list[int]:
    rows = [limbs_to_ints(e[:, b].T.copy()) for b in range(e.shape[1])]
    s = [model_mont(r, R2) for r in limbs_to_ints(np.concatenate(
        [tri_r, pair_r]).reshape(-1, 8))]
    out = []
    for j, a in enumerate(limbs_to_ints(acc)):
        terms = [model_sub(model_mont(model_mont(rows[x][j], rows[y][j]), R2),
                           rows[z][j]) for x, y, z in tri]
        terms += [model_sub(rows[x][j], rows[y][j]) for x, y in pair]
        out.append(model_add(a, model_fold(
            [model_mont(t, st) for t, st in zip(terms, s)])))
    return out


# ---- inputs ------------------------------------------------------------------

def inputs(gen, b: int, n: int, t_: int, p_: int, canonical: bool,
           index: str = "random"):
    """acc (n, 8), e (8, b, n) and the quadratic test's indices and
    scalars, uint32.  Non-canonical: the edge and non-canonical values in
    the first columns of acc and of rows 0 and 1 (reversed in row 1) and
    a column of 2^256 - 1 in row 0.  `index`: "random" (repeats among
    them), "same" (x = y = z), "padded" (as ``_pack_quads`` pads: index 0
    and scalar 0 past the first entry of each kind)."""
    acc = rand_limbs(gen, (n,), canonical)
    e = rand_limbs(gen, (b, n), canonical).transpose(2, 0, 1).copy()
    if not canonical:
        vals = ints_to_limbs(NONCANONICAL + EDGES)[:n]
        acc[:len(vals)] = vals
        e[:, 0, :len(vals)] = vals.T
        if b > 1:
            e[:, 1, :len(vals)] = vals[::-1].T
        e[:, 0, -1] = 0xFFFFFFFF
    tri = gen.integers(0, b, (t_, 3)).astype(np.int32)
    pair = gen.integers(0, b, (p_, 2)).astype(np.int32)
    tri_r = rand_limbs(gen, (t_,), canonical)
    pair_r = rand_limbs(gen, (p_,), canonical)
    if index == "same":
        tri[:] = np.arange(t_)[:, None] % b
        pair[:] = np.arange(p_)[:, None] % b
    elif index == "padded":
        tri[1:], pair[1:], tri_r[1:], pair_r[1:] = 0, 0, 0, 0
    return acc, e, tri, pair, tri_r, pair_r


# ---- the kernel's phases, g++ -----------------------------------------------

@pytest.mark.parametrize("n", [32768, 8192])
def test_core_at_the_check_calls(core, n):
    """The rule's geometry at the single-device call (8, 16, 32768) and a
    shard's (8, 16, 8192), T = P = 16: its first two and last CTAs
    (the columns they own) against the plain version on those columns, and
    the first CTA against Python ints."""
    gen = np.random.default_rng(n)
    acc, e, tri, pair, tri_r, pair_r = inputs(gen, 16, n, 16, 16, False)
    geom = np.zeros(4, np.uint32)
    core.kq_geom(n, 16, 16, geom.ctypes.data)
    cols, ctas = int(geom[0]), int(geom[3])
    for lo, hi in ((0, 2), (ctas - 1, ctas)):
        out, grid = run_kq(core, acc, e, tri, pair, tri_r, pair_r,
                           ctas=(lo, hi))
        assert grid == ctas == -(-n // cols)
        sl = slice(lo * cols, min(hi * cols, n))
        want = plain(acc[sl], e[:, :, sl], tri, pair, tri_r, pair_r)
        np.testing.assert_array_equal(out[sl], want)
        assert (np.delete(out, np.r_[sl], axis=0) == 0xFFFFFFFF).all()
    first, _ = run_kq(core, acc[:cols], e[:, :, :cols], tri, pair, tri_r,
                      pair_r)
    assert limbs_to_ints(first) == model(acc[:cols], e[:, :, :cols], tri,
                                         pair, tri_r, pair_r)


ODD = [(3, 3), (3, 2), (2, 3), (1, 0), (0, 1), (1, 1), (16, 17), (0, 5),
       (7, 0)]


@pytest.mark.parametrize("reverse", [False, True], ids=["in_order",
                                                        "reversed"])
@pytest.mark.parametrize("t_,p_", ODD)
def test_core_odd_counts(core, t_, p_, reverse):
    """Counts T + P whose tree carries a head at some level (6 -> 3, 5,
    33, ...), N = 1 (no fold), no pairs, no triples; n = 45 (the last CTA
    partly past the end), non-canonical rows and acc; against Python ints
    and the plain version, threads in order and reversed."""
    gen = np.random.default_rng(10 * t_ + p_)
    ops = inputs(gen, max(t_, p_, 3), 45, t_, p_, False)
    out, _ = run_kq(core, *ops, reverse=reverse)
    np.testing.assert_array_equal(out, plain(*ops))
    assert limbs_to_ints(out) == model(*ops)


@pytest.mark.parametrize("geom", [(4, 3), (8, 16), (2, 1), (32, 5), (1, 7),
                                  (16, 32)])
@pytest.mark.parametrize("index", ["random", "same", "padded"])
def test_core_geometries(core, geom, index):
    """Geometries the rule does not take (lanes that do not divide
    T + P = 12 + 9, more lanes than terms, columns a CTA that do not
    divide n = 50), on a padded limb stride (e_ls = B*n + 5), with
    repeated, equal (x = y = z) and padded indices: the same bits."""
    gen = np.random.default_rng(sum(geom) + len(index))
    ops = inputs(gen, 6, 50, 12, 9, False, index)
    out, _ = run_kq(core, *ops, geom=geom, e_ls=6 * 50 + 5)
    np.testing.assert_array_equal(out, plain(*ops))


def test_core_in_place(core):
    """out may be acc: each column's lane 0 reads acc before its store."""
    gen = np.random.default_rng(4)
    acc, e, tri, pair, tri_r, pair_r = inputs(gen, 4, 40, 4, 4, False)
    planes = np.ascontiguousarray(e.reshape(8, -1))
    args = args_of(tri, pair, tri_r, pair_r)
    buf = acc.copy()
    core.kq_run(planes.ctypes.data, 160, 40, args.ctypes.data, 4, 4,
                buf.ctypes.data, buf.ctypes.data, 0, 0, 0, 1 << 30, 0)
    np.testing.assert_array_equal(buf, plain(acc, e, tri, pair, tri_r,
                                             pair_r))


def quad_grid_rule(n: int, t_: int, p_: int) -> tuple[int, int, int, int]:
    """chip_smoke's copy of ``quad_geom``: (cols, lanes, smem, CTAs)."""
    from chip_smoke import quad_acc_grid
    ctas, _, cols, lanes, smem = quad_acc_grid(n, t_, p_)
    return cols, lanes, smem, ctas


@pytest.mark.parametrize("n,t_,p_", [(32768, 16, 16), (8192, 16, 16),
                                     (32768, 32, 32), (8192, 3, 3),
                                     (14784, 16, 16), (14783, 16, 16),
                                     (192, 16, 16), (1, 1, 0),
                                     (32768, 512, 512), (5, 1024, 0)])
def test_geometry_matches_chip_smoke(core, n, t_, p_):
    """quad_geom at the main path's calls (one device, one of 4 shards,
    batch_rows 32 and 3) and at the edges of its rule, as chip_smoke.py
    computes it for the floor and the bound; the shared memory fits the
    budget, and a CTA is 128 threads unless T + P lanes are fewer."""
    got = np.zeros(4, np.uint32)
    core.kq_geom(n, t_, p_, got.ctypes.data)
    assert tuple(int(v) for v in got) == quad_grid_rule(n, t_, p_)
    cols, lanes, smem, _ = (int(v) for v in got)
    assert smem <= 100 * 1024 and cols * lanes <= 128
    assert 1 <= lanes <= t_ + p_ and (lanes == t_ + p_ or cols * lanes == 128)


def test_size_limits(core):
    """The entry point's refusals: every plane offset below 2^32 words
    (7 e_ls + B n), 8n below 2^32, e_ls >= B n, 1 <= T + P <= 1024 (the
    wrapper's ``QACC_MAX_TERMS``)."""
    assert core.kq_max_terms() == tfm.QACC_MAX_TERMS
    ok = core.kq_ok
    assert ok(16 * 32768, 16, 32768, 16, 16)
    top = (1 << 32) - 1 - 16 * 8192
    assert ok(top // 7, 16, 8192, 1, 0)
    assert not ok(top // 7 + 1, 16, 8192, 1, 0)
    assert ok((1 << 29) - 1, 1, (1 << 29) - 1, 1, 0)
    assert not ok(1 << 29, 1, 1 << 29, 1, 0)
    assert not ok(99, 16, 8, 1, 1)                   # e_ls < B*n
    assert not ok(128, 16, 8, 0, 0)
    assert ok(128, 16, 8, 1024, 0) and not ok(128, 16, 8, 1024, 1)
    assert not ok(128, 0, 8, 1, 1) and not ok(128, 16, 8, -1, 2)


# ---- the plain version against the JAX composition and Python ints ----------

def _jax_quad_acc(acc, e, tri, pair, tri_r, pair_r):
    """The reference's XLA ops composed as its planar check composes the
    quadratic test, on AoS rows: terms, the R^2 prescale, the products,
    the pairwise fold, the add into acc."""
    import jax
    import jax.numpy as jnp
    from ligero_prover_tpu.ops import fieldops as jfo
    r2 = jnp.asarray(ints_to_limbs([R2])[0], jnp.uint32)

    def body(acc, rows, tri, pair, rs):
        ex, ey, ez = (jnp.take(rows, tri[:, i], axis=0) for i in range(3))
        px, py = (jnp.take(rows, pair[:, i], axis=0) for i in range(2))
        terms = jnp.concatenate([jfo.submod(jfo.mulmod(ex, ey), ez),
                                 jfo.submod(px, py)], axis=0)
        s = jfo.mont_mul(rs, jnp.broadcast_to(r2, rs.shape))
        x = jfo.mont_mul(terms, s[:, None, :])
        while x.shape[0] > 1:
            b = x.shape[0]
            head = x[:1] if b % 2 else None
            body_ = x[1:] if b % 2 else x
            h = body_.shape[0] // 2
            x = jfo.addmod(body_[:h], body_[h:])
            if head is not None:
                x = jnp.concatenate([head, x], axis=0)
        return jfo.addmod(acc, x[0])

    rows = np.moveaxis(e, 0, -1)                           # (B, n, 8)
    out = jax.jit(body)(acc, rows, tri, pair,
                        np.concatenate([tri_r, pair_r]).reshape(-1, 8))
    return np.asarray(out, np.uint32)


@pytest.mark.parametrize("index", ["random", "padded", "same"])
@pytest.mark.parametrize("canonical", [True, False],
                         ids=["canonical", "noncanonical"])
@pytest.mark.parametrize("b", [16, 3, 1])
def test_plain_matches_jax_and_ints(b, canonical, index):
    """T = P = B, n = 24: the plain version equals the JAX composition and
    Python ints exactly."""
    gen = np.random.default_rng(100 * b + 10 * canonical + len(index))
    ops = inputs(gen, b, 24, b, b, canonical, index)
    got = plain(*ops)
    np.testing.assert_array_equal(got, _jax_quad_acc(*ops))
    assert limbs_to_ints(got) == model(*ops)


# ---- the wrapper and the executor ---------------------------------------------

def test_cpu_takes_the_plain_version():
    """On CPU tensors the wrapper runs the plain version once and launches
    nothing; indices and scalars may be numpy arrays (uint32 limbs) or CPU
    tensors (int32 bit patterns)."""
    gen = np.random.default_rng(7)
    acc, e, tri, pair, tri_r, pair_r = inputs(gen, 5, 20, 5, 5, False)
    tfm.reset_counts()
    a = tfm.quad_acc_planar(to_t(acc), to_t(e), tri, pair, tri_r, pair_r)
    b = tfm.quad_acc_planar(to_t(acc), to_t(e), torch.from_numpy(tri),
                            torch.from_numpy(pair.astype(np.int64)),
                            to_t(tri_r), to_t(pair_r))
    assert torch.equal(a, b)
    np.testing.assert_array_equal(to_np(a), plain(acc, e, tri, pair, tri_r,
                                                  pair_r))
    assert tfm.PLAIN_CALLS[tfm.QACC]["cpu"] == 3
    assert set(tfm.LAUNCHES.values()) == {0}


def _ops(seed=3):
    gen = np.random.default_rng(seed)
    acc, e, tri, pair, tri_r, pair_r = inputs(gen, 4, 16, 3, 2, True)
    return to_t(acc), to_t(e), tri, pair, tri_r, pair_r


@pytest.mark.parametrize("field,value,error", [
    ("tri", np.array([[0, 1, 4]]), IndexError),              # an index = B
    ("pair", np.array([[-1, 0]]), IndexError),               # negative
    ("tri", np.array([[0, 1]]), ValueError),                 # width 2
    ("pair", np.array([[0.0, 1.0]]), ValueError),            # not integers
    ("acc", "short", ValueError),                            # (n-1, 8)
    ("acc", "int64", ValueError),                            # not int32
    ("e", "flat", ValueError),                               # (8, B*n)
    ("tri_r", "short", ValueError),                          # (T-1, 8)
    ("pair_r", "float", ValueError),                         # not integers
    ("none", None, ValueError),                              # T + P = 0
    ("many", None, ValueError),                              # T + P > 1024
])
def test_refused_before_running(field, value, error):
    """A row index out of range raises IndexError, any shape KQ does not
    take ValueError, before the plain version or a kernel runs: nothing
    is counted."""
    acc, e, tri, pair, tri_r, pair_r = _ops()
    if field == "tri":
        tri = value
        tri_r = tri_r[:len(value)]
    elif field == "pair":
        pair = value
        pair_r = pair_r[:len(value)]
    elif field == "acc":
        acc = acc[1:] if value == "short" else acc.to(torch.int64)
    elif field == "e":
        e = e.reshape(8, -1)
    elif field == "tri_r":
        tri_r = tri_r[1:]
    elif field == "pair_r":
        pair_r = pair_r.astype(np.float64)
    elif field == "none":
        tri, pair = tri[:0], pair[:0]
        tri_r, pair_r = tri_r[:0], pair_r[:0]
    elif field == "many":
        tri = np.zeros((1025, 3), np.int32)
        tri_r = np.zeros((1025, 8), np.uint32)
    tfm.reset_counts()
    with pytest.raises(error):
        tfm.quad_acc_planar(acc, e, tri, pair, tri_r, pair_r)
    assert not any(sum(v.values()) for v in tfm.PLAIN_CALLS.values())
    assert set(tfm.LAUNCHES.values()) == {0}


def test_wants_host_indices_and_scalars():
    """Indices or scalars on a device raise in the argument check:
    checking them there would wait for the device."""
    acc, e, tri, pair, tri_r, pair_r = _ops()
    meta_idx = torch.zeros((3, 3), dtype=torch.int32, device="meta")
    meta_r = torch.zeros((2, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="on the host"):
        tfm.quad_acc_args(acc, e, meta_idx, pair, tri_r, pair_r)
    with pytest.raises(ValueError, match="on the host"):
        tfm.quad_acc_args(acc, e, tri, pair, tri_r, meta_r)
    args, t_, p_ = tfm.quad_acc_args(acc, e, tri, pair, tri_r, pair_r)
    assert (t_, p_) == (3, 2) and args.dtype == np.int32
    np.testing.assert_array_equal(args, args_of(tri, pair, tri_r, pair_r))


def _replaced_sequence(quad, e, tri, pair, tri_r, pair_r):
    """The planar check's quadratic test before KQ: quad-terms, the
    scalars' prescale, the row-scalar product, the tree sum and the add
    into the planes of acc."""
    r2 = tex._r2(e.device)
    terms = tfm.quad_terms_planar(e, tri, pair)
    scals = tfm.mont_mul_scalar_planar(torch.cat([tri_r, pair_r]).T
                                       .contiguous(), r2)
    prods = tfm.mont_mul_planar(terms, scals[:, :, None])
    out = tfm.addmod_planar(quad.T.contiguous(),
                            tex._tree_sum_mod_planar(prods))
    return out.T.contiguous()


@pytest.mark.parametrize("b", [16, 3])
def test_executor_makes_one_kq_call(b):
    """``_check_terms_planar`` takes the quadratic test through one KQ
    call (its plain version here, on CPU tensors), and its accumulator
    equals the sequence KQ replaced, limb for limb; the code and linear
    tests are unchanged."""
    gen = np.random.default_rng(b)
    acc, e, tri, pair, tri_r, pair_r = inputs(gen, b, 32, b, b, False)
    code, lin = (to_t(rand_limbs(gen, (32,))) for _ in range(2))
    r, code_rs = to_t(rand_limbs(gen, (b, 32)).transpose(2, 0, 1).copy()), \
        to_t(rand_limbs(gen, (b,)))
    tfm.reset_counts()
    got = tex._check_terms_planar(code, lin, to_t(acc), to_t(e), r, code_rs,
                                  tri, tri_r, pair, pair_r)
    assert tfm.PLAIN_CALLS[tfm.QACC]["cpu"] == 1
    assert set(tfm.LAUNCHES.values()) == {0}
    want = _replaced_sequence(to_t(acc), to_t(e), tri, pair, to_t(tri_r),
                              to_t(pair_r))
    assert torch.equal(got[2], want)
    assert got[2].shape == (32, 8) and got[2].is_contiguous()
