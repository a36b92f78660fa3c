"""Fused KF (``fm.masked_mulsum_aos``: acc + x[0]*y[0] + ... +
x[B-1]*y[B-1] mod p, the products added in row order) on the CPU.

* The kernel's core (``mulsum_products_at``, ``mulsum_fold_at`` and the
  geometry rule ``mulsum_geom`` of ``csrc/fieldmul.cu``) is compiled with
  g++ and run CTA by CTA and chunk by chunk as the kernel runs it: every
  thread's products into the shared buffer, then each column's ordered
  fold.  Held against Python ints of the reference's limb algorithms
  (``field/bn254.py``'s modulus and Montgomery factor) and the plain
  version, for B in {0, 1, 2, 16, 17}, chunks that end inside B, a row
  scalar and a full y, and non-canonical acc, x and y.  Exact.
* ``fm.masked_mulsum_aos_plain`` against the JAX
  ``_masked_sum(acc, fo.mulmod(x, y))`` (``ligero_prover_tpu/zkp/
  executor.py:108``), jitted on the CPU, on seeded numpy inputs.  Exact.
* The plain version reaches no kernel wrapper (they are patched to
  raise), the wrapper checks its operands before anything runs, and the
  executor's sums go through the wrapper.

    python -m pytest tests/test_torch_kf_mulsum.py -q
"""

import ctypes
import inspect
import shutil
import subprocess
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ligero_prover_tpu.ops import fieldops as jfo
from ligero_prover_tpu.zkp import executor as jex
from ligero_prover_tpu_torch.field import bn254 as F
from ligero_prover_tpu_torch.field.limbs import ints_to_limbs, limbs_to_ints
from ligero_prover_tpu_torch.ops import fieldmul as tfm
from ligero_prover_tpu_torch.zkp import executor as tex

from _torch_helpers import EDGES, NONCANONICAL, rand_limbs, to_np, to_t

CSRC = Path(tfm.__file__).resolve().parent.parent / "csrc"
P, R = F.MODULUS, F.R
R2 = R * R % P

HARNESS = r"""
#include <vector>
#include "fieldmul.cu"
using namespace ligero_fm;

// The fused KF as its kernel runs it, CTA by CTA: in each chunk, every
// thread (c, r) computes its products into the CTA's shared buffer (the
// first __syncthreads), then thread (c, 0) folds column c's products in
// order.  cols == 0 takes mulsum_geom's geometry.
extern "C" void kf_mulsum(const uint32_t* acc, const uint32_t* x,
                          const uint32_t* y, uint32_t* out, uint32_t n,
                          uint32_t rows, int y_full, uint32_t cols,
                          uint32_t lanes, uint32_t chunk) {
  const MulsumGeom g = cols ? MulsumGeom{n, rows, cols, lanes, chunk}
                            : mulsum_geom(n, rows);
  std::vector<uint32_t> s(8u * g.chunk * g.cols);
  std::vector<uint32_t> a(8u * g.cols);
  for (uint32_t blk = 0; blk * g.cols < n; ++blk) {
    for (uint32_t c = 0; c < g.cols; ++c)
      if (blk * g.cols + c < n) load_elem(acc + 8ull * (blk * g.cols + c),
                                          &a[8u * c]);
    for (uint32_t b0 = 0; b0 < g.rows; b0 += g.chunk) {
      for (uint32_t r = 0; r < g.lanes; ++r)
        for (uint32_t c = 0; c < g.cols; ++c) {
          if (y_full)
            mulsum_products_at<true>(x, y, g, b0, c, r, blk * g.cols + c,
                                     s.data());
          else
            mulsum_products_at<false>(x, y, g, b0, c, r, blk * g.cols + c,
                                      s.data());
        }
      for (uint32_t c = 0; c < g.cols; ++c)
        if (blk * g.cols + c < n) mulsum_fold_at(g, b0, c, s.data(),
                                                 &a[8u * c]);
    }
    for (uint32_t c = 0; c < g.cols; ++c)
      if (blk * g.cols + c < n) store_elem(out + 8ull * (blk * g.cols + c),
                                           &a[8u * c]);
  }
}

// mulsum_geom(n, rows) as (cols, lanes, chunk)
extern "C" void kf_geom(uint32_t n, uint32_t rows, uint32_t* out) {
  const MulsumGeom g = mulsum_geom(n, rows);
  out[0] = g.cols;
  out[1] = g.lanes;
  out[2] = g.chunk;
}
"""


@pytest.fixture(scope="module")
def core(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    work = tmp_path_factory.mktemp("kf_mulsum")
    (work / "harness.cpp").write_text(HARNESS)
    so = work / "libkfmulsum.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC",
                    "-Wno-unknown-pragmas", f"-I{CSRC}", "-o", str(so),
                    str(work / "harness.cpp")], check=True)
    lib = ctypes.CDLL(str(so))
    ptr, u32, i32 = ctypes.c_void_p, ctypes.c_uint32, ctypes.c_int
    lib.kf_mulsum.argtypes = [ptr, ptr, ptr, ptr, u32, u32, i32, u32, u32,
                              u32]
    lib.kf_geom.argtypes = [u32, u32, ptr]
    return lib


def run_kf(core, acc, x, y, geom=(0, 0, 0)) -> torch.Tensor:
    """The harness over CPU tensors acc (n, 8), x (B, n, 8) and y (B, n, 8)
    or (B, 1, 8); `geom` (cols, lanes, chunk), (0, 0, 0) for the rule's."""
    acc, x, y = acc.contiguous(), x.contiguous(), y.contiguous()
    out = torch.empty_like(acc)
    core.kf_mulsum(acc.data_ptr(), x.data_ptr(), y.data_ptr(),
                   out.data_ptr(), acc.shape[0], x.shape[0],
                   int(y.shape == x.shape), *geom)
    return out


def model_mont(x: int, y: int) -> int:
    """The reference's limb Montgomery product: t = (U + m*p) / 2^256
    kept mod 2^256, then one conditional subtract."""
    u = x * y
    m = ((u & (R - 1)) * F.MONTGOMERY_FACTOR_NEG) & (R - 1)
    t = ((u + m * P) >> 256) & (R - 1)
    return t - P if t >= P else t


def model_add(x: int, y: int) -> int:
    """The reference's addmod: the carry out of 2^256 dropped, then one
    conditional subtract."""
    s = (x + y) & (R - 1)
    return s - P if s >= P else s


def model(acc, x, y) -> list[int]:
    """acc + mulmod(x[0], y[0]) + ... in row order, on Python ints."""
    acc_i = limbs_to_ints(acc)
    n = len(acc_i)
    for b in range(x.shape[0]):
        xs = limbs_to_ints(x[b])
        ys = limbs_to_ints(y[b]) if y.shape[1] == n else \
            limbs_to_ints(y[b]) * n
        acc_i = [model_add(a, model_mont(model_mont(u, v), R2))
                 for a, u, v in zip(acc_i, xs, ys)]
    return acc_i


def _inputs(gen, rows: int, n: int, full: bool):
    """Non-canonical acc (n, 8), x (rows, n, 8) and y, with the edge and
    non-canonical values in the first columns of acc and x, reversed in
    y, and columns of 2^256 - 1 (Montgomery sums that reach 2^256)."""
    vals = ints_to_limbs(NONCANONICAL + EDGES)
    acc = rand_limbs(gen, (n,), False)
    x = rand_limbs(gen, (rows, n), False)
    y = rand_limbs(gen, (rows, n if full else 1), False)
    acc[:len(vals)] = vals
    if rows:
        x[:, :len(vals)] = vals
        x[:, -2:] = 0xFFFFFFFF
        if full:
            y[:, :len(vals)] = vals[::-1]
            y[:, -1] = 0xFFFFFFFF
        else:
            y[0] = 0xFFFFFFFF
    return acc, x, y


@pytest.mark.parametrize("full", [False, True], ids=["row", "full"])
@pytest.mark.parametrize("rows", [0, 1, 2, 16, 17])
def test_core_is_bit_identical(core, rows, full):
    """The rule's geometry at n = 37 (one column a CTA, the whole row set
    one chunk) against Python ints and the plain version."""
    acc, x, y = _inputs(np.random.default_rng(rows + 10 * full), rows, 37,
                        full)
    got = run_kf(core, to_t(acc), to_t(x), to_t(y))
    assert limbs_to_ints(to_np(got)) == model(acc, x, y)
    assert torch.equal(got, tfm.masked_mulsum_aos_plain(
        to_t(acc), to_t(x), to_t(y)))


@pytest.mark.parametrize("geom", [(4, 3, 5), (8, 16, 16), (2, 1, 1),
                                  (32, 4, 7)])
@pytest.mark.parametrize("full", [False, True], ids=["row", "full"])
def test_core_chunks_end_inside_b(core, geom, full):
    """Geometries whose chunks end inside B = 17 (and lanes that do not
    divide the chunk, n not a multiple of the columns a CTA): the chunk
    loop and its fold order give the same bits."""
    acc, x, y = _inputs(np.random.default_rng(sum(geom)), 17, 45, full)
    want = tfm.masked_mulsum_aos_plain(to_t(acc), to_t(x), to_t(y))
    got = run_kf(core, to_t(acc), to_t(x), to_t(y), geom)
    assert torch.equal(got, want)
    assert limbs_to_ints(to_np(got)) == model(acc, x, y)


def mulsum_grid_rule(n: int, rows: int) -> tuple[int, int, int]:
    """``mulsum_geom`` restated: (cols, lanes, chunk)."""
    from chip_smoke import mulsum_grid
    return mulsum_grid(n, rows)[2:]


@pytest.mark.parametrize("n,rows", [(192, 16), (192, 0), (192, 1),
                                    (32768, 16), (32768, 100), (4223, 16),
                                    (4224, 16), (1, 17)])
def test_geometry_matches_chip_smoke(core, n, rows):
    """mulsum_geom's (cols, lanes, chunk) at the main path's calls and at
    the edges of its rule, as chip_smoke.py computes them for the floor;
    the chunk's products fit the shared-memory budget."""
    got = np.zeros(3, np.uint32)
    core.kf_geom(n, rows, got.ctypes.data)
    assert tuple(int(v) for v in got) == mulsum_grid_rule(n, rows)
    cols, lanes, chunk = got
    assert 32 * int(chunk) * int(cols) <= 48 * 1024
    assert 1 <= lanes <= min(max(rows, 1), 16) and cols * lanes <= 512


def _jax_sum(acc, x, y):
    return jax.jit(lambda a, u, v: jex._masked_sum(a, jfo.mulmod(u, v)))(
        acc, x, y)


@pytest.mark.parametrize("full", [False, True], ids=["row", "full"])
@pytest.mark.parametrize("rows,n", [(1, 192), (16, 192), (17, 100)])
def test_plain_matches_jax(rows, n, full):
    """The plain version equals the JAX ``_masked_sum(acc, fo.mulmod(x,
    y))`` on non-canonical inputs (the JAX loop cannot be traced over no
    rows; B = 0 is held by the core test)."""
    acc, x, y = _inputs(np.random.default_rng(n + rows), rows, n, full)
    got = tfm.masked_mulsum_aos_plain(to_t(acc), to_t(x), to_t(y))
    np.testing.assert_array_equal(to_np(got),
                                  np.asarray(_jax_sum(acc, x, y), np.uint32))


def _refuse(name):
    def wrapper(*args, **kwargs):
        raise AssertionError(f"the plain version reached {name}")
    return wrapper


def test_plain_reaches_no_kernel_wrapper(monkeypatch):
    """Every public wrapper of ``ops/fieldmul.py`` that launches a kernel
    on a CUDA tensor is patched to raise; the plain version still runs,
    and counts only its own call."""
    wrappers = [name for name, fn in inspect.getmembers(tfm,
                                                        inspect.isfunction)
                if name in tfm.LAUNCHES or name in ("butterfly_dit_pass",
                                                    "butterfly_dif_pass")]
    assert "masked_mulsum_aos" in wrappers and "mulmod" in wrappers
    for name in wrappers:
        monkeypatch.setattr(tfm, name, _refuse(name))
    acc, x, y = _inputs(np.random.default_rng(3), 16, 40, True)
    tfm.reset_counts()
    got = tfm.masked_mulsum_aos_plain(to_t(acc), to_t(x), to_t(y))
    assert limbs_to_ints(to_np(got)) == model(acc, x, y)
    assert {k: dict(v) for k, v in tfm.PLAIN_CALLS.items() if v} == \
        {"masked_mulsum_aos": {"cpu": 1}}


def test_wrapper_checks_operands_first():
    """Shapes that are not acc (..., 8), x (B, *acc.shape) and y x's shape
    or one element a row raise before anything runs, on the CPU too."""
    gen = np.random.default_rng(5)
    acc, x = to_t(rand_limbs(gen, (6,))), to_t(rand_limbs(gen, (3, 6)))
    for a, u, v in ((acc, x, x[:, :2]), (acc, x[:, :5], x[:, :1]),
                    (acc, x, x[:2, :1]), (acc[:, :7], x, x),
                    (acc, x, x[:, :1, None])):
        with pytest.raises(ValueError):
            tfm.masked_mulsum_aos(a, u, v)
    tfm.reset_counts()
    assert tfm.mulsum_form(acc, x, x) and not tfm.mulsum_form(acc, x,
                                                              x[:, :1])
    tfm.masked_mulsum_aos(acc, x, x[:, :1])
    assert tfm.PLAIN_CALLS["masked_mulsum_aos"]["cpu"] == 1


def test_executor_sums_are_fused():
    """The verifier's step adds the products of its three tests through
    the fused wrapper (two calls for the quadratic test's triples and
    pairs): four calls, and K2 only for the triples' e_x * e_y."""
    gen = np.random.default_rng(8)
    b, n = 3, 16
    e, r = (to_t(rand_limbs(gen, (b, n))) for _ in range(2))
    accs = [to_t(rand_limbs(gen, (n,))) for _ in range(3)]
    code_rs, tri_r, pair_r = (to_t(rand_limbs(gen, (b,))) for _ in range(3))
    tri = torch.tensor([[0, 1, 2], [1, 1, 0], [2, 0, 1]])
    pair = torch.tensor([[0, 1], [2, 2], [1, 0]])
    tfm.reset_counts()
    got = tex._verify_terms(*accs, e, r, code_rs, tri, tri_r, pair,
                            pair_r)
    assert tfm.PLAIN_CALLS["masked_mulsum_aos"]["cpu"] == 4
    assert tfm.PLAIN_CALLS["mulmod"]["cpu"] == 1
    # against the JAX composition of the same sums
    quad = jex._masked_sum(to_np(accs[2]), jfo.mulmod(
        jfo.submod(jfo.mulmod(to_np(e)[tri[:, 0]], to_np(e)[tri[:, 1]]),
                   to_np(e)[tri[:, 2]]), to_np(tri_r)[:, None, :]))
    quad = jex._masked_sum(quad, jfo.mulmod(
        jfo.submod(to_np(e)[pair[:, 0]], to_np(e)[pair[:, 1]]),
        to_np(pair_r)[:, None, :]))
    code = jex._masked_sum(to_np(accs[0]), jfo.mulmod(
        to_np(e), to_np(code_rs)[:, None, :]))
    linear = jex._masked_sum(to_np(accs[1]), jfo.mulmod(to_np(e),
                                                        to_np(r)))
    for g, w in zip(got, (code, linear, quad)):
        np.testing.assert_array_equal(to_np(g), np.asarray(w, np.uint32))
