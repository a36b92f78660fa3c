"""KA (AoS add/sub) and KF (the ordered fold) of ``csrc/fieldmul.cu`` on
the CPU.

The element functions the kernels run on each thread (``aos_eltwise_at``
with its operand views ``aos_elem``/``make_aos_view``, and
``masked_sum_at`` with its loop over the B rows) are compiled with g++ and
run over every element, against the plain PyTorch versions
(``fm.addmod_aos_plain``, ``fm.submod_aos_plain``,
``fm.masked_sum_aos_plain``), the JAX package's XLA ops
(``fo.addmod``/``fo.submod`` and the verifier's ``_masked_sum``, jitted on
the CPU) and a Python-int model of the reference's limb algorithm: the
edge values in all pairs, random non-canonical limbs, sums that carry out
of 2^256, and B in {0, 1, 2, 16, 17}.  The operand views are the ones the
wrapper computes (``fm.aos_view``) for the call shapes of the port: the
vbn254fr arena's constant, its broadcast-first ``const_sub``, the AoS
codec's strided halves and twiddles.  Exact: tolerance 0.  The tests skip
where g++ is absent.

    python -m pytest tests/test_torch_aos_core.py -q
"""

import ctypes
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

from _torch_helpers import rand_limbs, to_np, to_t

CSRC = Path(tfm.__file__).resolve().parent.parent / "csrc"
P, R = F.MODULUS, F.R
EDGES = [0, 1, P - 1, P, P + 1, 2 * P, R - P, R - 2, R - 1]

HARNESS = r"""
#include "fieldmul.cu"
using namespace ligero_fm;

template <int kMode>
static void ka_mode(const uint32_t* x, const AosView& xv, const uint32_t* y,
                    const AosView& yv, const Elem& c, int c_side,
                    uint32_t* out, uint32_t i) {
  if (c_side == kConstX) aos_eltwise_at<kMode, kConstX>(x, xv, y, yv, c, out, i);
  else if (c_side == kConstY) aos_eltwise_at<kMode, kConstY>(x, xv, y, yv, c, out, i);
  else aos_eltwise_at<kMode, kNoConst>(x, xv, y, yv, c, out, i);
}

// KA as its kernel runs it: element i on thread i, each operand through
// the view that ligero_aos_eltwise makes of its arguments, or the one
// c_side names (1 x, 2 y) taken from the 8 words at c, as the entry
// copies them into the kernel's argument; out may be x or y
extern "C" void ka(const uint32_t* x, long long x_div, long long x_outer,
                   long long x_inner, const uint32_t* y, long long y_div,
                   long long y_outer, long long y_inner, const uint32_t* c,
                   int c_side, uint32_t* out, uint32_t n, int mode) {
  const AosView xv = make_aos_view(x_div, x_outer, x_inner, n);
  const AosView yv = make_aos_view(y_div, y_outer, y_inner, n);
  Elem cv{};
  if (c_side != 0)
    for (int l = 0; l < 8; ++l) cv.w[l] = c[l];
  for (uint32_t i = 0; i < n; ++i) {
    if (mode == 0) ka_mode<0>(x, xv, y, yv, cv, c_side, out, i);
    else ka_mode<1>(x, xv, y, yv, cv, c_side, out, i);
  }
}

// the element of the operand that element i < n reads, for every i
extern "C" void ka_elems(long long div, long long outer, long long inner,
                         uint32_t n, unsigned long long* elems) {
  const AosView v = make_aos_view(div, outer, inner, n);
  for (uint32_t i = 0; i < n; ++i) elems[i] = aos_elem(v, i);
}

// KF as its kernel runs it: column i on thread i
extern "C" void kf(const uint32_t* acc, const uint32_t* terms, uint32_t* out,
                   uint32_t n, uint32_t rows) {
  for (uint32_t i = 0; i < n; ++i) masked_sum_at(acc, terms, out, n, rows, i);
}

extern "C" uint32_t threads_for(uint32_t n) { return mulmod_threads(n); }
"""


@pytest.fixture(scope="module")
def core(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    work = tmp_path_factory.mktemp("aos_core")
    (work / "harness.cpp").write_text(HARNESS)
    so = work / "libaoscore.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC",
                    "-Wno-unknown-pragmas", f"-I{CSRC}", "-o", str(so),
                    str(work / "harness.cpp")], check=True)
    lib = ctypes.CDLL(str(so))
    ptr, i64, u32, i32 = (ctypes.c_void_p, ctypes.c_longlong,
                          ctypes.c_uint32, ctypes.c_int)
    lib.ka.argtypes = [ptr, i64, i64, i64, ptr, i64, i64, i64, ptr, i32, ptr,
                       u32, i32]
    lib.ka_elems.argtypes = [i64, i64, i64, u32, ptr]
    lib.kf.argtypes = [ptr, ptr, ptr, u32, u32]
    lib.threads_for.argtypes = [u32]
    lib.threads_for.restype = u32
    return lib


def run_ka(core, name, x: torch.Tensor, y: torch.Tensor,
           by_value: bool = False, out: torch.Tensor | None = None
           ) -> torch.Tensor:
    """KA over the broadcast of CPU tensors x and y, each read through the
    view the wrapper computes for it, or (`by_value`) an operand of one
    element passed by value as the wrapper passes a host constant; into
    `out` when given (it may be x or y)."""
    shape = torch.broadcast_shapes(x.shape, y.shape)
    n = int(np.prod(shape[:-1], dtype=np.int64))
    consts = [tfm.host_element(t) if by_value else None for t in (x, y)]
    side = 1 if consts[0] is not None else 2 if consts[1] is not None else 0
    views = [(None, 1, 0, 0) if c is not None else tfm.aos_view(t, shape)
             for t, c in zip((x, y), consts)]
    (xv, *xd), (yv, *yd) = views
    if out is None:
        out = torch.empty(shape, dtype=torch.int32)
    core.ka(None if xv is None else xv.data_ptr(), *xd,
            None if yv is None else yv.data_ptr(), *yd,
            consts[side - 1].data_ptr() if side else None, side,
            out.data_ptr(), n, tfm.AOS_MODE[name])
    return out


def run_kf(core, acc: torch.Tensor, terms: torch.Tensor) -> torch.Tensor:
    acc, terms = acc.contiguous(), terms.contiguous()
    out = torch.empty_like(acc)
    core.kf(acc.data_ptr(), terms.data_ptr(), out.data_ptr(),
            acc.numel() // 8, terms.shape[0])
    return out


def model(name: str, x: int, y: int) -> int:
    """The reference's limb algorithm on Python ints: the carry out of
    2^256 dropped, then one conditional subtract (add); + p mod 2^256 on
    a borrow (sub)."""
    m = (1 << 256) - 1
    if name == "addmod_aos":
        s = (x + y) & m
        return s - P if s >= P else s
    return (x - y) & m if x >= y else (x - y + P) & m


def _pairs(kind: str, gen) -> tuple[np.ndarray, np.ndarray]:
    """(n, 8) operand pairs: the edge values in all pairs; random
    non-canonical limbs; pairs whose sum carries out of 2^256."""
    if kind == "edges":
        xs = [a for a in EDGES for _ in EDGES]
        ys = [b for _ in EDGES for b in EDGES]
        return ints_to_limbs(xs), ints_to_limbs(ys)
    if kind == "noncanonical":
        return (rand_limbs(gen, (2000,), False),
                rand_limbs(gen, (2000,), False))
    x = rand_limbs(gen, (2000,), False)
    y = rand_limbs(gen, (2000,), False)
    x[:, 7] |= 0x80000000                 # both >= 2^255: the sum carries
    y[:, 7] |= 0x80000000
    return x, y


JAX_OP = {"addmod_aos": jax.jit(jfo.addmod), "submod_aos": jax.jit(jfo.submod)}
PLAIN = {"addmod_aos": tfm.addmod_aos_plain,
         "submod_aos": tfm.submod_aos_plain}


@pytest.mark.parametrize("kind", ["edges", "noncanonical", "carry"])
@pytest.mark.parametrize("name", list(tfm.AOS_MODE))
def test_ka_element_function_is_bit_identical(core, name, kind):
    x, y = _pairs(kind, np.random.default_rng(1 + len(kind)))
    got = to_np(run_ka(core, name, to_t(x), to_t(y)))
    np.testing.assert_array_equal(
        got, to_np(PLAIN[name](to_t(x), to_t(y))))
    np.testing.assert_array_equal(
        got, np.asarray(JAX_OP[name](x, y), np.uint32))
    want = [model(name, a, b)
            for a, b in zip(limbs_to_ints(x), limbs_to_ints(y))]
    assert limbs_to_ints(got) == want
    if kind == "carry" and name == "addmod_aos":
        # the case the dropped carry decides: x + y >= 2^256
        assert any(a + b >= 1 << 256 for a, b in
                   zip(limbs_to_ints(x), limbs_to_ints(y)))


def _views(gen):
    """(label, x, y) CPU operands in the forms of the port's call sites,
    each the broadcast, strided or sliced view the caller passes."""
    def t(shape):
        return to_t(rand_limbs(gen, shape, False))
    k, b, h = 64, 3, 16
    rows = t((b, 2 * h))
    pair = rows.reshape(b, h, 2, 8)
    quad = t((b, 4 * h)).reshape(b, h, 4, 8)
    coset = t((b, 8))
    coset_v = coset.reshape(b, 4, 2, 8)          # m = 4 runs of w/m = 2
    wide = t((3, 4, 5)).permute(1, 0, 2, 3)       # three element axes
    return [
        ("same shape", t((k,)), t((k,))),
        ("arena + constant (8,)", t((k,)), t(())),
        ("arena + constant (1, 8)", t((k,)), t((1,))),
        ("const_sub: constant expanded first", t((1,)).expand(k, 8),
         t((k,))),
        ("verifier rows (T, 192, 8)", t((4, 192)), t((4, 192))),
        ("DIT scan: v[:, :, 0] and a broadcast twiddle", pair[:, :, 0],
         t((h,))),
        ("DIT scan: a broadcast twiddle first", t((h,)), pair[:, :, 1]),
        ("DIF scan: x[:, :h] and x[:, h:]", rows[:, :h], rows[:, h:]),
        ("decode fold: v[:, :, 0] and v[:, :, 2]", quad[:, :, 0],
         quad[:, :, 2]),
        ("coset fold: v[:, :, :h] and v[:, :, h:]", coset_v[:, :, :1],
         coset_v[:, :, 1:]),
        ("three element axes (copied)", wide, t((4, 3, 5))),
        ("one element", t(()), t(())),
    ]


@pytest.mark.parametrize("name", list(tfm.AOS_MODE))
def test_ka_reads_every_call_form_through_its_view(core, name):
    for label, x, y in _views(np.random.default_rng(5)):
        got = run_ka(core, name, x, y)
        want = PLAIN[name](x, y)
        assert torch.equal(got, want), label
        jax_want = JAX_OP[name](*np.broadcast_arrays(to_np(x), to_np(y)))
        np.testing.assert_array_equal(to_np(got), np.asarray(jax_want),
                                      err_msg=label)


@pytest.mark.parametrize("div,outer,inner,n", [
    (10, 0, 1, 10), (10**9, 0, 1, 10), (1, 0, 0, 7), (7, 0, 0, 7),
    (16, 0, 1, 48), (16, 32, 1, 48), (5, 40, 4, 20), (3, 1, 0, 12)])
def test_ka_view_index_math(core, div, outer, inner, n):
    """aos_elem over every i < n: (i / div) * outer + (i % div) * inner,
    with a div of n or more read as n."""
    elems = np.zeros(n, np.uint64)
    core.ka_elems(div, outer, inner, n, elems.ctypes.data)
    d = min(div, n)
    assert elems.tolist() == [(i // d) * outer + (i % d) * inner
                              for i in range(n)]


@pytest.mark.parametrize("name", list(tfm.AOS_MODE))
def test_ka_takes_a_host_constant_by_value(core, name):
    """The arena's constant calls with the constant as a kernel argument:
    x +- c and c - x (c first), on edge and non-canonical x and c, equal
    the same calls with c read through its view, the plain versions, the
    JAX ops and Python ints."""
    gen = np.random.default_rng(17)
    x = rand_limbs(gen, (64,), False)
    x[:len(EDGES)] = ints_to_limbs(EDGES)
    for cv in EDGES + [int(v) for v in limbs_to_ints(
            rand_limbs(gen, (3,), False))]:
        c = ints_to_limbs([cv])[0]
        for xt, ct, first in ((to_t(x), to_t(c), False),
                              (to_t(x), to_t(c), True)):
            a, b = (ct, xt) if first else (xt, ct)
            got = run_ka(core, name, a, b, by_value=True)
            assert torch.equal(got, run_ka(core, name, a, b))
            assert torch.equal(got, PLAIN[name](a, b))
            ja, jb = np.broadcast_arrays(to_np(a), to_np(b))
            np.testing.assert_array_equal(
                to_np(got), np.asarray(JAX_OP[name](ja, jb)))
            want = [model(name, cv, v) if first else model(name, v, cv)
                    for v in limbs_to_ints(x)]
            assert limbs_to_ints(to_np(got)) == want


@pytest.mark.parametrize("alias", ["x", "y", "both"])
@pytest.mark.parametrize("name", list(tfm.AOS_MODE))
def test_ka_writes_in_place(core, name, alias):
    """out is x, y or both (the arena's ``add(i, i, i)``): every element
    of the result equals the out-of-place result."""
    gen = np.random.default_rng(len(alias) + 7)
    x = to_t(rand_limbs(gen, (300,), False))
    y = x if alias == "both" else to_t(rand_limbs(gen, (300,), False))
    want = run_ka(core, name, x.clone(), y.clone())
    target = y if alias == "y" else x
    got = run_ka(core, name, x, y, out=target)
    assert got is target and torch.equal(target, want)
    # with a constant by value beside the slot written in place
    c = to_t(rand_limbs(gen, (), False))
    want = run_ka(core, name, x.clone(), c)
    run_ka(core, name, x, c, by_value=True, out=x)
    assert torch.equal(x, want)


def _fold_inputs(gen, rows: int, n: int):
    """acc (n, 8) and terms (rows, n, 8), non-canonical, with the edge
    values in the first columns of acc and of every row, and columns
    where every row is 2^256 - 1 (each add carries out of 2^256)."""
    acc = rand_limbs(gen, (n,), False)
    terms = rand_limbs(gen, (rows, n), False)
    edges = ints_to_limbs(EDGES)
    acc[:len(EDGES)] = edges
    if rows:
        terms[:, :len(EDGES)] = edges[::-1]
        terms[:, -2:] = 0xFFFFFFFF
    return acc, terms


@pytest.mark.parametrize("rows", [0, 1, 2, 16, 17])
def test_kf_element_function_adds_in_order(core, rows):
    acc, terms = _fold_inputs(np.random.default_rng(rows), rows, 37)
    got = to_np(run_kf(core, to_t(acc), to_t(terms)))
    np.testing.assert_array_equal(
        got, to_np(tfm.masked_sum_aos_plain(to_t(acc), to_t(terms))))
    # the reference's loop of no rows is acc (its jitted body cannot be
    # traced on an empty axis)
    jax_sum = jax.jit(jex._masked_sum)(acc, terms) if rows else acc
    np.testing.assert_array_equal(got, np.asarray(jax_sum, np.uint32))
    want = limbs_to_ints(acc)
    for r in range(rows):
        want = [model("addmod_aos", a, b)
                for a, b in zip(want, limbs_to_ints(terms[r]))]
    assert limbs_to_ints(got) == want


def test_kf_order_is_the_function():
    """On non-canonical rows a reordered sum is another function: the
    reference's order and the reverse order differ (why KF keeps it)."""
    x, y, z = (1 << 256) - 1, (1 << 256) - 1, 1

    def fold(vals):
        a = 0
        for v in vals:
            a = model("addmod_aos", a, v)
        return a
    assert fold([x, y, z]) != fold([z, y, x])


@pytest.mark.parametrize("n,threads", [(192, 32), (8192, 32), (8448, 64),
                                       (32768, 128), (65536, 256)])
def test_block_rule_spreads_small_calls(core, n, threads):
    """KA and KF take K2's block rule: the largest of 256, 128, 64, 32
    threads that still gives each of the 132 SMs a block."""
    assert core.threads_for(n) == threads
