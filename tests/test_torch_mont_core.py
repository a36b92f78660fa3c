"""The carry-chain Montgomery product of ``csrc/field.cuh`` on the CPU.

``mont_mul_cc``/``mulmod_cc`` (PTX carry chains, run here by the header's
interpreter of the same PTX text, ``cc_run``) against today's
``mont_mul``/``mulmod`` of the same header and against a Python-int model
of the reference's limb algorithm (``field/bn254.py`` constants), on the
edge values in all pairs, on carry-heavy limb patterns, on random
non-canonical pairs and on pairs whose Montgomery sum
t = (U + m*p) / 2^256 reaches 2^256, where the reference drops the carry
out of limb 7.  Then the element functions of K1 and K2
(``mont_mul_at`` and ``mulmod_at`` in ``csrc/fieldmul.cu``, with their
broadcast index math; K1 with its 32-bit and its 64-bit index) and of KE
mont_scalar (``mont_scalar_at`` in ``csrc/planar.cu``) against the plain
PyTorch versions ``fm.mont_mul_plain``, ``fm.mulmod_plain`` and
``fm.mont_mul_scalar_planar_plain``.  The sources are compiled with g++;
the tests skip where it is absent.  Exact: tolerance 0.

    python -m pytest tests/test_torch_mont_core.py -q
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

from _torch_helpers import rand_limbs, to_np, to_t

CSRC = Path(tfm.__file__).resolve().parent.parent / "csrc"
P, R = F.MODULUS, F.R
R2 = R * R % P
EDGES = [0, 1, P - 1, P, P + 1, 2 * P, R - P, R - 2, R - 1]

HARNESS = r"""
#include "fieldmul.cu"
#include "planar.cu"
using namespace ligero_fm;

// n pairs of (n, 8) limbs through one of the four products
extern "C" void product(const uint32_t* x, const uint32_t* y, uint32_t* out,
                        int n, int which) {
  for (int i = 0; i < n; ++i) {
    const uint32_t *a = x + 8 * i, *b = y + 8 * i;
    uint32_t* r = out + 8 * i;
    if (which == 0) mont_mul(a, b, r);
    else if (which == 1) mont_mul_cc(a, b, r);
    else if (which == 2) mulmod(a, b, r);
    else mulmod_cc(a, b, r);
  }
}

// K1 as its kernel runs it: element i on thread i, with the 32-bit index
// or (wide) the 64-bit one
extern "C" void k1(const uint32_t* x, const uint32_t* y, uint32_t* out,
                   uint32_t n, uint32_t y_rows, int wide) {
  for (uint32_t i = 0; i < n; ++i) {
    if (wide)
      mont_mul_at<unsigned long long>(x, y, out, n, y_rows, i);
    else
      mont_mul_at<uint32_t>(x, y, out, n, y_rows, i);
  }
}

// the row of y that each element i < n of K1 reads
extern "C" void k1_rows(uint32_t n, uint32_t y_rows, uint32_t* rows) {
  for (uint32_t i = 0; i < n; ++i) rows[i] = mont_mul_row(n, y_rows, i);
}

// K2 as its kernel runs it: element i on thread i
extern "C" void k2(const uint32_t* x, const uint32_t* y, uint32_t* out,
                   uint32_t n, uint32_t y_rows) {
  for (uint32_t i = 0; i < n; ++i) mulmod_at(x, y, out, n, y_rows, i);
}

extern "C" uint32_t k2_threads(uint32_t n) { return mulmod_threads(n); }

// KE mont_scalar as its kernel runs it: the scalar's limbs read once (at
// limb stride s_ls), then element i on thread i
// KE mont_mul and mulmod as launch_product runs them: every thread of
// every CTA of the run geometry (rows of y_div > 1 elements with one y
// element each, else one run with y a full plane), 4-element units if vec
template <bool kMulmod, bool kRow>
static void ke_product_runs(const uint32_t* x, uint32_t x_ls,
                            const uint32_t* y, uint32_t y_ls, uint32_t* out,
                            const ligero_pl::RunGeom& g) {
  for (uint32_t c = 0; c < ligero_pl::run_ctas(g); ++c)
    for (uint32_t t = 0; t < ligero_pl::kRunThreads; ++t) {
      if (g.vec)
        ligero_pl::run_product_at<kMulmod, kRow, 4>(x, x_ls, y, y_ls, out, g,
                                                    c, t);
      else
        ligero_pl::run_product_at<kMulmod, kRow, 1>(x, x_ls, y, y_ls, out, g,
                                                    c, t);
    }
}

extern "C" void ke_product(const uint32_t* x, uint32_t x_ls,
                           const uint32_t* y, uint32_t y_ls, uint32_t y_div,
                           uint32_t* out, uint32_t n, int mulmod, int vec) {
  const bool row = y_div > 1u;
  const ligero_pl::RunGeom g = ligero_pl::run_geom(n, row ? y_div : n, vec);
  if (mulmod && row) ke_product_runs<true, true>(x, x_ls, y, y_ls, out, g);
  else if (mulmod) ke_product_runs<true, false>(x, x_ls, y, y_ls, out, g);
  else if (row) ke_product_runs<false, true>(x, x_ls, y, y_ls, out, g);
  else ke_product_runs<false, false>(x, x_ls, y, y_ls, out, g);
}

// quad-terms as ligero_planar_quad_terms runs it: rows of n elements,
// every thread of every CTA
extern "C" void quad_terms(const uint32_t* e, uint32_t e_ls, uint32_t n,
                           const int32_t* tri, uint32_t T,
                           const int32_t* pair, uint32_t P, uint32_t* out,
                           int vec) {
  const ligero_pl::RunGeom g = ligero_pl::run_geom((T + P) * n, n, vec);
  for (uint32_t c = 0; c < ligero_pl::run_ctas(g); ++c)
    for (uint32_t t = 0; t < ligero_pl::kRunThreads; ++t) {
      if (vec)
        ligero_pl::quad_terms_at<4>(e, e_ls, tri, T, pair, out, g, c, t);
      else
        ligero_pl::quad_terms_at<1>(e, e_ls, tri, T, pair, out, g, c, t);
    }
}

// the CTAs of a launch over n elements in runs of len
extern "C" uint32_t run_ctas(uint32_t n, uint32_t len, int vec) {
  return ligero_pl::run_ctas(ligero_pl::run_geom(n, len, vec));
}

extern "C" void mont_scalar(const uint32_t* x, uint32_t x_ls,
                            const uint32_t* sc, uint32_t s_ls, uint32_t* out,
                            uint32_t n) {
  uint32_t s[8];
  for (int l = 0; l < 8; ++l) s[l] = sc[l * s_ls];
  for (uint32_t i = 0; i < n; ++i)
    ligero_pl::mont_scalar_at(x, x_ls, s, out, n, i);
}
"""

PRODUCTS = {"mont_mul": 0, "mont_mul_cc": 1, "mulmod": 2, "mulmod_cc": 3}


# the KE run geometry as built for the card, and with small CTAs of
# several units per thread, so that threads loop over their units
RUN_BUILDS = {"default": [], "looped": ["-DLIGERO_RUN_THREADS=32",
                                        "-DLIGERO_RUN_UNITS=3"]}


def _build(tmp_path_factory, name, defines):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    work = tmp_path_factory.mktemp(name)
    (work / "harness.cpp").write_text(HARNESS)
    so = work / "libmontcore.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC",
                    "-Wno-unknown-pragmas", *defines, f"-I{CSRC}", "-o",
                    str(so), str(work / "harness.cpp")], check=True)
    lib = ctypes.CDLL(str(so))
    ptr, u32, i32 = ctypes.c_void_p, ctypes.c_uint32, ctypes.c_int
    lib.product.argtypes = [ptr, ptr, ptr, i32, i32]
    lib.k1.argtypes = [ptr, ptr, ptr, u32, u32, i32]
    lib.k1_rows.argtypes = [u32, u32, ptr]
    lib.k2.argtypes = [ptr, ptr, ptr, u32, u32]
    lib.k2_threads.argtypes = [u32]
    lib.k2_threads.restype = u32
    lib.mont_scalar.argtypes = [ptr, u32, ptr, u32, ptr, u32]
    lib.ke_product.argtypes = [ptr, u32, ptr, u32, u32, ptr, u32, i32, i32]
    lib.quad_terms.argtypes = [ptr, u32, u32, ptr, u32, ptr, u32, ptr, i32]
    lib.run_ctas.argtypes = [u32, u32, i32]
    lib.run_ctas.restype = u32
    return lib


@pytest.fixture(scope="module")
def core(tmp_path_factory):
    return _build(tmp_path_factory, "mont_core", [])


@pytest.fixture(scope="module", params=list(RUN_BUILDS))
def run_core(request, tmp_path_factory):
    """The harness built with each KE run geometry of RUN_BUILDS."""
    if request.param == "default":
        return request.getfixturevalue("core")
    return _build(tmp_path_factory, "mont_core_" + request.param,
                  RUN_BUILDS[request.param])


def run_product(core, name, xs, ys) -> list[int]:
    x, y = ints_to_limbs(xs), ints_to_limbs(ys)
    out = np.zeros_like(x)
    core.product(x.ctypes.data, y.ctypes.data, out.ctypes.data, len(xs),
                 PRODUCTS[name])
    return limbs_to_ints(out)


def model_mont(x: int, y: int) -> int:
    """The reference's limb Montgomery product (Pallas ``_k_mont_mul``):
    t = (U + m*p) / 2^256 kept mod 2^256, then one conditional subtract."""
    u = x * y
    m = ((u & (R - 1)) * F.MONTGOMERY_FACTOR_NEG) & (R - 1)
    t = ((u + m * P) >> 256) & (R - 1)
    return t - P if t >= P else t


def overflows(x: int, y: int) -> bool:
    """Whether the Montgomery sum of x*y reaches 2^256."""
    u = x * y
    m = ((u & (R - 1)) * F.MONTGOMERY_FACTOR_NEG) & (R - 1)
    return (u + m * P) >> 256 >= R


def edge_pairs():
    return [a for a in EDGES for _ in EDGES], EDGES * len(EDGES)


def random_pairs(count=10_000):
    """Uniform 256-bit operands, almost all of them in [p, 2^256)."""
    gen = np.random.default_rng(20261017)
    xs = limbs_to_ints(rand_limbs(gen, (count,), canonical=False))
    ys = limbs_to_ints(rand_limbs(gen, (count,), canonical=False))
    return xs, ys


def pattern_pairs():
    """Carry-heavy operands in all pairs: every limb one value c, one limb
    c and the rest 0, or every limb c but one limb's bits flipped, for c
    in 1, 2, 2^31 - 1, 2^31, 2^32 - 2, 2^32 - 1.  Their products' low
    words are all ones or close, so the chains carry at every limb."""
    ones = sum(1 << (32 * j) for j in range(8))
    vals = set()
    for c in (1, 2, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF):
        vals.add(c * ones)
        for k in range(8):
            vals.add(c << (32 * k))
            vals.add(c * ones ^ (0xFFFFFFFF << (32 * k)))
    vals = sorted(vals)
    return [a for a in vals for _ in vals], vals * len(vals)


def overflow_pairs(count=300):
    """Pairs with t >= 2^256: operands drawn near 2^256, then filtered."""
    gen = np.random.default_rng(7)
    xs, ys = [], []
    while len(xs) < count:
        raw = rand_limbs(gen, (2, 4096), canonical=False)
        raw[..., 7] |= 0xF0000000
        for x, y in zip(limbs_to_ints(raw[0]), limbs_to_ints(raw[1])):
            if overflows(x, y):
                xs.append(x)
                ys.append(y)
    return xs[:count], ys[:count]


PAIR_SETS = {"edges": edge_pairs, "patterns": pattern_pairs,
             "random": random_pairs, "overflow": overflow_pairs}


@pytest.mark.parametrize("pairs", list(PAIR_SETS))
@pytest.mark.parametrize("name", ["mont_mul", "mulmod"])
def test_carry_chain_product_is_bit_identical(core, name, pairs):
    xs, ys = PAIR_SETS[pairs]()
    got = run_product(core, name + "_cc", xs, ys)
    assert got == run_product(core, name, xs, ys)
    if name == "mont_mul":
        want = [model_mont(x, y) for x, y in zip(xs, ys)]
    else:
        want = [model_mont(model_mont(x, y), R2) for x, y in zip(xs, ys)]
    assert got == want
    # the Python ints of field/bn254.py: equal wherever t stays below
    # 2^256 (canonical there for canonical operands); different where the
    # reference drops the carry
    over = [overflows(x, y) for x, y in zip(xs, ys)]
    golden = F.mont_mul if name == "mont_mul" else F.mulmod
    for x, y, g, o in zip(xs, ys, got, over):
        assert (g == golden(x, y)) is not o, (x, y)
        if x < P and y < P:
            assert g == golden(x, y) < P
    if pairs == "overflow":
        assert all(over) and len(xs) >= 300
    else:
        assert len(xs) >= {"edges": 81, "patterns": 10_000,
                           "random": 10_000}[pairs]


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("pairs", list(PAIR_SETS))
def test_k1_element_function_is_bit_identical(core, pairs, wide):
    """K1's mont_mul_at (element i reads y[i], y_rows = n) with either
    index width over the edge, pattern, random and overflow pairs, against
    mont_mul_cc and the Python-int model of the reference."""
    xs, ys = PAIR_SETS[pairs]()
    x, y = ints_to_limbs(xs), ints_to_limbs(ys)
    out = np.zeros_like(x)
    core.k1(x.ctypes.data, y.ctypes.data, out.ctypes.data, len(xs), len(xs),
            int(wide))
    got = limbs_to_ints(out)
    assert got == run_product(core, "mont_mul_cc", xs, ys)
    assert got == [model_mont(a, b) for a, b in zip(xs, ys)]


@pytest.mark.parametrize("n", [1, 7, 96, 3072, 16384])
def test_k1_row_is_i_mod_y_rows(core, n):
    """mont_mul_row equals i % y_rows for every element and every row
    count a caller can pass (1 to n, powers of two and others; _tiled's h
    for the AoS scans' twiddles is a power of two, the arena's 1 or n)."""
    counts = {1, 2, 3, 5, 64, 96, 4096, 12288, 16384, n, max(n - 1, 1)}
    i = np.arange(n, dtype=np.uint32)
    for y_rows in sorted(c for c in counts if c <= n):
        rows = np.zeros(n, dtype=np.uint32)
        core.k1_rows(n, y_rows, rows.ctypes.data)
        np.testing.assert_array_equal(rows, i % y_rows)


def _tiled(x, y_rows):
    """(n, 8) rows whose element i uses row i % y_rows, as a broadcast."""
    return x.reshape(-1, y_rows, 8)


@pytest.mark.parametrize("n,y_rows", [(3072, 3072), (3072, 1), (3072, 192),
                                      (8192, 8192), (8192, 1), (8192, 64)])
def test_k2_element_function_matches_plain(core, n, y_rows):
    """K2's mulmod_at over every element, with y read at i (y_rows = n),
    at 0 (y_rows = 1) or at i % y_rows, on non-canonical operands with
    the edge values, against fm.mulmod_plain on the broadcast."""
    gen = np.random.default_rng(n + y_rows)
    x = rand_limbs(gen, (n,), canonical=False)
    y = rand_limbs(gen, (y_rows,), canonical=False)
    x[:len(EDGES)] = ints_to_limbs(EDGES)
    y[:len(EDGES)] = ints_to_limbs(EDGES[::-1][:y_rows])
    out = np.zeros_like(x)
    core.k2(x.ctypes.data, y.ctypes.data, out.ctypes.data, n, y_rows)
    want = tfm.mulmod_plain(_tiled(to_t(x), y_rows), to_t(y))
    np.testing.assert_array_equal(out, to_np(want).reshape(n, 8))


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("n,y_rows", [(3072, 3072), (8192, 1), (8192, 8192),
                                      (16 * 1024, 1024), (16 * 1024, 96),
                                      (3000, 7)])
def test_k1_element_function_matches_plain(core, n, y_rows, wide):
    """K1's mont_mul_at over every element, with y read at i (y_rows = n),
    at 0 (y_rows = 1: mont_mul_const, the ladder's one), at i & (y_rows -
    1) (a power of two: the AoS twiddles) or at i % y_rows, on
    non-canonical operands with the edge values, against
    fm.mont_mul_plain on the broadcast."""
    gen = np.random.default_rng(n + y_rows)
    x = rand_limbs(gen, (n,), canonical=False)
    y = rand_limbs(gen, (y_rows,), canonical=False)
    x[:len(EDGES)] = ints_to_limbs(EDGES)
    y[:len(EDGES)] = ints_to_limbs(EDGES[::-1][:y_rows])
    out = np.zeros_like(x)
    core.k1(x.ctypes.data, y.ctypes.data, out.ctypes.data, n, y_rows,
            int(wide))
    if n % y_rows == 0:
        want = tfm.mont_mul_plain(_tiled(to_t(x), y_rows), to_t(y))
    else:
        want = tfm.mont_mul_plain(to_t(x), to_t(y[np.arange(n) % y_rows]))
    np.testing.assert_array_equal(out, to_np(want).reshape(n, 8))


@pytest.mark.parametrize("n,threads", [(3072, 32), (8192, 32),
                                       (20000, 128), (16 * 32768, 256),
                                       (1, 32), (16 * 4096, 256),
                                       (16 * 16384, 256)])
def test_k2_block_size_spreads_small_calls(core, n, threads):
    """256-thread blocks where they give each of the 132 SMs one, smaller
    blocks down to one warp below that (K2's rule, which K1 takes too: its
    DIT calls of 16 x 4096 and 16 x 16384 elements, the arena's 8192);
    chip_smoke.py times the launch floor at the same grid."""
    from chip_smoke import k2_grid
    assert core.k2_threads(n) == threads
    assert k2_grid(n) == (-(-n // threads), threads)


@pytest.mark.parametrize("shape,x_ls", [((16, 64), 1024), ((16,), 16),
                                        ((1, 4096), 4096 + 8)])
def test_mont_scalar_element_function_matches_plain(core, shape, x_ls):
    """KE mont_scalar's element function over (8, ...) planes at limb
    stride x_ls, the scalar read once from limbs at stride 3, against
    fm.mont_mul_scalar_planar_plain; non-canonical rows and scalar with
    the edge values."""
    gen = np.random.default_rng(x_ls)
    n = int(np.prod(shape))
    rows = rand_limbs(gen, (n,), canonical=False)
    rows[:len(EDGES)] = ints_to_limbs(EDGES)[:n]
    planes = np.zeros((8, x_ls), dtype=np.uint32)
    planes[:, :n] = rows.T
    s = rand_limbs(gen, (), canonical=False)
    s_strided = np.zeros((8, 3), dtype=np.uint32)
    s_strided[:, 0] = s
    out = np.zeros((8, n), dtype=np.uint32)
    core.mont_scalar(planes.ctypes.data, x_ls, s_strided.ctypes.data, 3,
                     out.ctypes.data, n)
    want = tfm.mont_mul_scalar_planar_plain(
        to_t(rows.T.copy().reshape((8,) + shape)), to_t(s))
    np.testing.assert_array_equal(out, to_np(want).reshape(8, n))
    for edge in (R - 1, P):
        s_strided[:, 0] = ints_to_limbs([edge])[0]
        core.mont_scalar(planes.ctypes.data, x_ls, s_strided.ctypes.data, 3,
                         out.ctypes.data, n)
        want = tfm.mont_mul_scalar_planar_plain(
            to_t(rows.T.copy().reshape((8,) + shape)),
            to_t(ints_to_limbs([edge])[0]))
        np.testing.assert_array_equal(out, to_np(want).reshape(8, n))


def _wild_rows(gen, count):
    """`count` (count, 8) uint32 operands: non-canonical random ones with
    the edge values and carry-heavy patterns in the first slots."""
    rows = rand_limbs(gen, (count,), canonical=False)
    pats = sorted(set(pattern_pairs()[1]))
    special = ints_to_limbs(EDGES + pats[::3])[:count]
    rows[:len(special)] = special
    return rows


def _strided(planes, ls):
    """(8, ...) uint32 planes stored at limb stride ls >= their size."""
    flat = planes.reshape(8, -1)
    out = np.zeros((8, ls), dtype=np.uint32)
    out[:, :flat.shape[1]] = flat
    return out


@pytest.mark.parametrize("vec,n", [(True, 2048), (False, 1030)])
@pytest.mark.parametrize("form", ["row", "full", "one"])
@pytest.mark.parametrize("name", ["mont_mul_planar", "mulmod_planar"])
def test_ke_product_element_function_matches_plain(run_core, name, form,
                                                   vec, n):
    """KE mont_mul and mulmod on the carry-chain products, every thread of
    the run geometry, on (8, 3, n) rows at a padded limb stride: times a
    per-row scalar (8, 3, 1) read once per thread (the check's calls),
    a full plane (the linear test) or one scalar for all (8, 1, 1);
    16-byte units (n a multiple of 4) or single elements; non-canonical
    operands with the edge values and carry-heavy limb patterns; against
    the plain versions."""
    rows = 3
    gen = np.random.default_rng(n + len(form) + len(name))
    x = _wild_rows(gen, rows * n).T.reshape(8, rows, n)
    yshape = {"row": (rows, 1), "full": (rows, n), "one": (1, 1)}[form]
    ycount = int(np.prod(yshape))
    y = _wild_rows(gen, ycount)[::-1].T.reshape((8,) + yshape)
    pad = 4 if vec else 3
    xs, ys = _strided(x, rows * n + pad), _strided(y, ycount + pad)
    y_div = {"row": n, "full": 1, "one": rows * n}[form]
    out = np.zeros((8, rows * n), dtype=np.uint32)
    run_core.ke_product(xs.ctypes.data, rows * n + pad, ys.ctypes.data,
                        ycount + pad, y_div, out.ctypes.data, rows * n,
                        int(name == "mulmod_planar"), int(vec))
    want = getattr(tfm, name + "_plain")(to_t(x), to_t(y))
    np.testing.assert_array_equal(out, to_np(want).reshape(8, rows * n))


def _quad_indices(case, b):
    """(tri (T, 3), pair (P, 2)) int32 row indices of one pattern."""
    gen = np.random.default_rng(len(case))
    if case == "repeats":
        return (gen.integers(0, 2, (5, 3)).astype(np.int32),
                gen.integers(0, 2, (4, 2)).astype(np.int32))
    if case == "same":                       # x = y = z, x = y
        v = gen.integers(0, b, 4).astype(np.int32)
        return np.repeat(v[:, None], 3, 1), np.repeat(v[:3, None], 2, 1)
    if case == "padded":                     # _pack_quads' zero entries
        tri = np.zeros((b, 3), np.int32)
        pair = np.zeros((b, 2), np.int32)
        tri[:2] = gen.integers(0, b, (2, 3))
        pair[:1] = gen.integers(0, b, (1, 2))
        return tri, pair
    if case == "t_ne_p":
        return (gen.integers(0, b, (2, 3)).astype(np.int32),
                gen.integers(0, b, (7, 2)).astype(np.int32))
    if case == "no_pairs":
        return (gen.integers(0, b, (4, 3)).astype(np.int32),
                np.zeros((0, 2), np.int32))
    assert case == "no_triples"
    return (np.zeros((0, 3), np.int32),
            gen.integers(0, b, (3, 2)).astype(np.int32))


QUAD_CASES = ["repeats", "same", "padded", "t_ne_p", "no_pairs",
              "no_triples"]


@pytest.mark.parametrize("vec,n", [(True, 1028), (False, 130)])
@pytest.mark.parametrize("case", QUAD_CASES)
def test_quad_terms_element_function_matches_plain(run_core, case, vec, n):
    """quad-terms, every thread of the run geometry (one output row per
    run), reading the rows of e (8, 6, n) at a padded limb stride by
    index: repeated indices, x = y = z, zero-padded entries, T != P, no
    pairs, no triples; non-canonical rows with the edge values and
    carry-heavy patterns; against fm.quad_terms_planar_plain."""
    b = 6
    gen = np.random.default_rng(n + len(case))
    e = _wild_rows(gen, b * n).T.reshape(8, b, n)
    e[:, 1] = e[:, 0, ::-1]                  # edges meet other edges
    tri, pair = _quad_indices(case, b)
    e_ls = b * n + (8 if vec else 5)
    es = _strided(e, e_ls)
    t_, p_ = len(tri), len(pair)
    out = np.zeros((8, (t_ + p_) * n), dtype=np.uint32)
    run_core.quad_terms(es.ctypes.data, e_ls, n, tri.ctypes.data, t_,
                        pair.ctypes.data, p_, out.ctypes.data, int(vec))
    want = tfm.quad_terms_planar_plain(to_t(e), tri, pair)
    assert want.shape == (8, t_ + p_, n)
    np.testing.assert_array_equal(out, to_np(want).reshape(8, -1))


@pytest.mark.parametrize("n,length,vec", [(16 * 32768, 32768, 1),
                                          (32 * 32768, 32768, 1),
                                          (16 * 32768, 16 * 32768, 1),
                                          (3 * 1030, 1030, 0),
                                          (16 * 6, 6, 0)])
def test_run_geometry_matches_chip_smoke(core, n, length, vec):
    """The CTAs of KE mont_mul, mulmod and quad-terms at the check's calls
    and at odd sizes, as chip_smoke.py computes them for the launch
    floor."""
    from chip_smoke import run_grid
    assert core.run_ctas(n, length, vec) == run_grid(n, length, vec)[0]
