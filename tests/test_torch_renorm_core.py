"""The element functions of the KR kernels (``csrc/renorm.cu``) on the CPU.

``renorm_at<kFinal|kMid|kPack>`` and ``digitize_at`` run over every
element of a call, as the kernels run them, against the plain PyTorch
versions ``mr.renorm_*_plain`` and ``mr.digitize_plain`` (which
``tests/test_torch_mxu_renorm.py`` holds against the JAX package's XLA
twins), at k=256 with both levels' geometry: level 1's slots
(64, R1, B, C1) against ``tw1`` (8, R1, 1, C1) and level 2's
(64, R2, B, C2) against ``tw3`` (8, R2, 1, C2), the table read with the
shifts the wrapper passes (``mr.twiddle_shifts``), and a table of the
slots' own shape at an X that is not a power of two.  Slot sets: a level
product of random canonical rows, of every digit +127 or -128, and zero.
Then field.cuh's ``redc_cc`` (the carry-chain reduction the KR kernels
run, PTX through the header's interpreter ``cc_run``) against ``redc``
and a Python-int model of the reference on edge and random 512-bit U.
The sources are compiled with g++; the tests skip where it is absent.
Exact: tolerance 0.

    python -m pytest tests/test_torch_renorm_core.py -q
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
from ligero_prover_tpu_torch.ops import mxu_ntt as tmx
from ligero_prover_tpu_torch.ops import mxu_renorm as tmr

from _torch_helpers import EDGES, rand_limbs, to_np, to_t

CSRC = Path(tmr.__file__).resolve().parent.parent / "csrc"
K, N, B = 256, 1024, 4
P, R = F.MODULUS, 1 << 256

HARNESS = r"""
#include "renorm.cu"
using namespace ligero_rn;

// a renorm call as its kernel runs it: element i on thread i
extern "C" void renorm(const int32_t* slots, const uint32_t* tw,
                       uint32_t tw_ls, uint32_t lbc, uint32_t lc,
                       uint32_t* out, uint32_t X, int mode) {
  for (uint32_t i = 0; i < X; ++i) {
    if (mode == kFinal)
      renorm_at<kFinal>(slots, tw, tw_ls, lbc, lc, out, X, i);
    else if (mode == kMid)
      renorm_at<kMid>(slots, tw, tw_ls, lbc, lc, out, X, i);
    else
      renorm_at<kPack>(slots, tw, tw_ls, lbc, lc, out, X, i);
  }
}

extern "C" void digitize(const uint32_t* x, uint32_t* out, uint32_t X) {
  for (uint32_t i = 0; i < X; ++i) digitize_at(x, out, X, i);
}

// n 512-bit U (16 limbs each) through redc or redc_cc
extern "C" void reduce(const uint32_t* u, uint32_t* out, int n, int cc) {
  for (int i = 0; i < n; ++i) {
    if (cc)
      redc_cc(u + 16 * i, out + 8 * i);
    else
      redc(u + 16 * i, out + 8 * i);
  }
}

extern "C" uint32_t twiddle(uint32_t lbc, uint32_t lc, uint32_t i) {
  return twiddle_at(lbc, lc, i);
}

extern "C" int fits(long long X, long long tw_ls, long long lbc,
                    long long lc) {
  return twiddles_fit(X, tw_ls, lbc, lc);
}
"""


@pytest.fixture(scope="module")
def core(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    work = tmp_path_factory.mktemp("renorm_core")
    (work / "harness.cpp").write_text(HARNESS)
    so = work / "librenormcore.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC",
                    "-Wno-unknown-pragmas", f"-I{CSRC}", "-o", str(so),
                    str(work / "harness.cpp")], check=True)
    lib = ctypes.CDLL(str(so))
    ptr, u32, i32, i64 = (ctypes.c_void_p, ctypes.c_uint32, ctypes.c_int,
                          ctypes.c_longlong)
    lib.renorm.argtypes = [ptr, ptr, u32, u32, u32, ptr, u32, i32]
    lib.digitize.argtypes = [ptr, ptr, u32]
    lib.reduce.argtypes = [ptr, ptr, i32, i32]
    lib.twiddle.argtypes = [u32, u32, u32]
    lib.twiddle.restype = u32
    lib.fits.argtypes = [i64, i64, i64, i64]
    return lib


@pytest.fixture(scope="module")
def tabs():
    w_k, _, w_n = F.generate_omegas(K, N)
    return tmx.tables_to_device(tmx.build_codec_tables(K, N, w_k, w_n), "cpu")


def _rows():
    """(8, B, K) canonical planes with the edge values in the first slots."""
    rows = rand_limbs(np.random.default_rng(17), (B, K))
    rows[0, :len(EDGES)] = ints_to_limbs(EDGES)
    return to_t(np.moveaxis(rows, -1, 0))


SETS = ["real", "plus127", "minus128", "zero"]
DIGITS = {"plus127": 0x7F7F7F7F, "minus128": -0x7F7F7F80}


@pytest.fixture(scope="module")
def levels(tabs):
    """level -> (slot set name -> slots, twiddle table): level 1's
    (64, R1, B, C1) against tw1 and level 2's (64, R2, B, C2) against tw3,
    each from real packed digits or every digit +127 or -128, and zero."""
    r1, c1 = tabs["geom"][:2]
    real = tmr.digitize_plain(_rows()).view(8, B, r1, c1)
    out = {}
    for level, slots_of, tw, packed in (
            (1, tmx.level1_slots, "tw1", real),
            (2, tmx.level2_slots, "tw3",
             tmr.renorm_mid_plain(tmx.level1_slots(real, tabs).clone(),
                                  tabs["tw1"]))):
        sets = {"real": slots_of(packed, tabs).clone()}
        for name, word in DIGITS.items():
            sets[name] = slots_of(torch.full_like(packed, word), tabs).clone()
        sets["zero"] = torch.zeros_like(sets["real"])
        out[level] = (sets, tabs[tw])
    return out


def run_renorm(core, mode, slots, tw=None):
    """renorm_at over every element of (64, ...) slots: (8, ...) out."""
    x = slots[0].numel()
    s = np.ascontiguousarray(slots.reshape(64, x).numpy())
    out = np.zeros((8, x), dtype=np.uint32)
    tw_ptr, tw_ls, lbc, lc = None, 0, 0, 0
    if tw is not None:
        lbc, lc = tmr.twiddle_shifts("renorm_mid", x, *tmr.twiddle_index(
            "renorm_mid", slots.shape[1:], tw.shape[1:]))
        t = np.ascontiguousarray(to_np(tw).reshape(8, -1))
        tw_ptr, tw_ls = t.ctypes.data, t.shape[1]
        assert core.fits(x, tw_ls, lbc, lc)
    core.renorm(s.ctypes.data, tw_ptr, tw_ls, lbc, lc, out.ctypes.data, x,
                tmr.RENORM_MODE[mode])
    return out


@pytest.mark.parametrize("name", SETS)
@pytest.mark.parametrize("level", [1, 2])
@pytest.mark.parametrize("mode", ["renorm_final", "renorm_mid",
                                  "renorm_pack"])
def test_renorm_element_function_matches_plain(core, levels, mode, level,
                                               name):
    sets, tw = levels[level]
    slots = sets[name]
    if mode == "renorm_mid":
        got = run_renorm(core, mode, slots, tw)
        want = tmr.renorm_mid_plain(slots, tw)
    else:
        got = run_renorm(core, mode, slots)
        want = getattr(tmr, mode + "_plain")(slots)
    np.testing.assert_array_equal(got, to_np(want).reshape(8, -1))


@pytest.mark.parametrize("x", [1, 1000, 1024])
def test_renorm_mid_with_a_full_table(core, levels, x):
    """A table of the slots' own shape is read at i (equal row and column
    counts give shifts that keep the index), also at an X that is not a
    power of two."""
    sets, tw = levels[1]
    slots = sets["real"].reshape(64, -1)[:, :x].contiguous()
    full = tw.expand((8,) + sets["real"].shape[1:]).reshape(8, -1)[:, :x] \
        .contiguous()
    assert tmr.twiddle_index("t", slots.shape[1:], full.shape[1:]) == (x, x)
    got = run_renorm(core, "renorm_mid", slots, full)
    np.testing.assert_array_equal(
        got, to_np(tmr.renorm_mid_plain(slots, full)))


def test_digitize_element_function_matches_plain(core):
    x = _rows().reshape(8, -1).contiguous()
    n = x.shape[1]
    out = np.zeros((8, n), dtype=np.uint32)
    core.digitize(np.ascontiguousarray(to_np(x)).ctypes.data,
                  out.ctypes.data, n)
    np.testing.assert_array_equal(out, to_np(tmr.digitize_plain(x)))


@pytest.mark.parametrize("x,bc,c", [(1 << 13, 1 << 10, 1 << 6),
                                    (1 << 14, 1 << 11, 1 << 7),
                                    (3 * 64 + 5, 64, 16), (100, 100, 100),
                                    (5, 8, 1)])
def test_twiddle_shifts_index_as_twiddle_index(core, x, bc, c):
    """The kernel's shift index equals (i // tw_bc) * tw_c + i % tw_c for
    every element, and the entry point's bounds check admits a table of
    exactly the rows the call reads, and not one word less."""
    lbc, lc = tmr.twiddle_shifts("t", x, bc, c)
    idx = [core.twiddle(lbc, lc, i) for i in range(x)]
    assert idx == [(i // bc) * c + i % c for i in range(x)]
    need = max(idx) + 1
    assert core.fits(x, need, lbc, lc) and not core.fits(x, need - 1, lbc, lc)


def test_twiddle_shifts_refuse_other_geometries():
    with pytest.raises(ValueError):
        tmr.twiddle_shifts("t", 96, 48, 16)
    with pytest.raises(ValueError):
        tmr.twiddle_shifts("t", 96, 32, 12)


def model_redc(u: int) -> int:
    """The reference's REDC of a 512-bit U (field.cuh's redc contract)."""
    lo, hi = u & (R - 1), u >> 256
    m = (lo * F.MONTGOMERY_FACTOR_NEG) & (R - 1)
    t = (hi + ((m * P) >> 256) + (lo != 0)) & (R - 1)
    return t - P if t >= P else t


def edge_us() -> list[int]:
    """U_lo = 0 under several U_hi, U near 2^505 (KR's contract) and 2^512,
    halves all ones or zero, p and 2^256*p around, and random U."""
    ones = R - 1
    his = [0, 1, P - 1, P, ones, ones - 1, 1 << 255]
    out = [h << 256 for h in his]                          # U_lo = 0
    out += [(h << 256) | ones for h in his]                # U_lo all ones
    out += [1, ones, (1 << 505) - 1, 1 << 505, (1 << 504) + 1,
            (1 << 512) - 1, (1 << 512) - 2, R * P - 1, R * P, R * P + 1,
            P, P * P, (P - 1) * (P - 1)]
    gen = np.random.default_rng(505)
    for bits in (256, 505, 512):
        for _ in range(300):
            words = gen.integers(0, 2 ** 32, 16, dtype=np.uint64)
            v = sum(int(w) << (32 * i) for i, w in enumerate(words))
            out.append(v & ((1 << bits) - 1))
    return out


def test_redc_cc_equals_redc_and_the_model(core):
    us = edge_us()
    u = np.array([[(v >> (32 * i)) & 0xFFFFFFFF for i in range(16)]
                  for v in us], dtype=np.uint32)
    outs = []
    for cc in (0, 1):
        out = np.zeros((len(us), 8), dtype=np.uint32)
        core.reduce(u.ctypes.data, out.ctypes.data, len(us), cc)
        outs.append(limbs_to_ints(out))
    assert outs[1] == outs[0]
    assert outs[1] == [model_redc(v) for v in us]
    # inside KR's contract (U < 2^256 * p) the result is U * 2^-256 mod p
    inv = pow(R, -1, P)
    for v, got in zip(us, outs[1]):
        if v < R * P:
            assert got == v * inv % P
