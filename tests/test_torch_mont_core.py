"""The carry-chain Montgomery product of ``csrc/field.cuh`` on the CPU.

``mont_mul_cc``/``mulmod_cc`` (PTX carry chains, run here by the header's
interpreter of the same PTX text, ``cc_run``) against today's
``mont_mul``/``mulmod`` of the same header and against a Python-int model
of the reference's limb algorithm (``field/bn254.py`` constants), on the
edge values in all pairs, on carry-heavy limb patterns, on random
non-canonical pairs and on pairs whose Montgomery sum
t = (U + m*p) / 2^256 reaches 2^256, where the reference drops the carry
out of limb 7.  Then the element functions of K2
(``mulmod_at`` in ``csrc/fieldmul.cu``, with its broadcast index math) and
of KE mont_scalar (``mont_scalar_at`` in ``csrc/planar.cu``) against the
plain PyTorch versions ``fm.mulmod_plain`` and
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

// K2 as its kernel runs it: element i on thread i
extern "C" void k2(const uint32_t* x, const uint32_t* y, uint32_t* out,
                   uint32_t n, uint32_t y_rows) {
  for (uint32_t i = 0; i < n; ++i) mulmod_at(x, y, out, n, y_rows, i);
}

extern "C" uint32_t k2_threads(uint32_t n) { return mulmod_threads(n); }

// KE mont_scalar as its kernel runs it: the scalar's limbs read once (at
// limb stride s_ls), then element i on thread i
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


@pytest.fixture(scope="module")
def core(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    work = tmp_path_factory.mktemp("mont_core")
    (work / "harness.cpp").write_text(HARNESS)
    so = work / "libmontcore.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC",
                    "-Wno-unknown-pragmas", f"-I{CSRC}", "-o", str(so),
                    str(work / "harness.cpp")], check=True)
    lib = ctypes.CDLL(str(so))
    ptr, u32 = ctypes.c_void_p, ctypes.c_uint32
    lib.product.argtypes = [ptr, ptr, ptr, ctypes.c_int, ctypes.c_int]
    lib.k2.argtypes = [ptr, ptr, ptr, u32, u32]
    lib.k2_threads.argtypes = [u32]
    lib.k2_threads.restype = u32
    lib.mont_scalar.argtypes = [ptr, u32, ptr, u32, ptr, u32]
    return lib


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


@pytest.mark.parametrize("n,threads", [(3072, 32), (8192, 32),
                                       (20000, 128), (16 * 32768, 256)])
def test_k2_block_size_spreads_small_calls(core, n, threads):
    """256-thread blocks where they give each of the 132 SMs one, smaller
    blocks down to one warp below that; chip_smoke.py times the launch
    floor at the same grid."""
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
