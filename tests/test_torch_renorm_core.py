"""The element functions of the KR kernels (``csrc/renorm.cu``) on the CPU.

``renorm_at<kFinal|kMid|kPack>`` runs over every element of a call, as the
kernels run it, against the plain PyTorch versions ``mr.renorm_*_plain``
(which ``tests/test_torch_mxu_renorm.py`` holds against the JAX package's
XLA twins), at k=256 with both levels' geometry: level 1's slots
(64, R1, B, C1) against ``tw1`` (8, R1, 1, C1) and level 2's
(64, R2, B, C2) against ``tw3`` (8, R2, 1, C2), the table read with the
shifts the wrapper passes (``mr.twiddle_shifts``), and a table of the
slots' own shape at an X that is not a power of two.  Slot sets: a level
product of random canonical rows, of every digit +127 or -128, and zero.
``canonical_to_packed`` (one 256-bit add of 0x80..80 through the header's
PTX interpreter ``cc_run``, then XOR) against the byte-serial recoding it
replaced (kept here as the oracle) and Python ints on edge, random,
canonical and byte-pattern words.  ``digitize_at`` over every thread of
each form (word by word on planar rows and at an element stride of 2, two
16-byte loads on the engine's AoS rows viewed as planes) against
``mr.digitize_plain`` and the JAX ``digitize_xla``; the wrapper's choice
of what it reads in place (``mr.digitize_args``) and the entry point's
choice of form (``digitize_aos``).  Then field.cuh's ``redc_cc`` (the
carry-chain reduction the KR kernels run) against ``redc`` and a
Python-int model of the reference on edge and random 512-bit U.  The sources are compiled with
g++; the tests skip where it is absent.  Exact: tolerance 0.

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

# canonical_to_packed as it was before it became one 256-bit add: the
# byte-serial signed recoding, kept here as the oracle
OLD_PACKED = r"""
static void old_canonical_to_packed(const uint32_t limbs[8],
                                    uint32_t out[8]) {
  uint32_t carry = 0;
  for (int i = 0; i < 8; ++i) {
    uint32_t w = 0;
    for (int j = 0; j < 4; ++j) {
      const uint32_t b = ((limbs[i] >> (8 * j)) & 0xFFu) + carry;
      carry = b > 127u ? 1u : 0u;
      w |= ((b - (carry << 8)) & 0xFFu) << (8 * j);
    }
    out[i] = w;
  }
}
"""

HARNESS = r"""
#include "renorm.cu"
using namespace ligero_rn;
""" + OLD_PACKED + r"""

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

// a digitize call as its kernel runs it, 16-byte AoS loads (aos) or
// word by word: element i on thread i
extern "C" void digitize(const uint32_t* x, uint32_t ls, uint32_t es,
                         uint32_t* out, uint32_t X, int aos) {
  for (uint32_t i = 0; i < X; ++i) {
    if (aos)
      digitize_at<true>(x, ls, es, out, X, i);
    else
      digitize_at<false>(x, ls, es, out, X, i);
  }
}

// whether the entry point reads x as the AoS view, 16 bytes at a time
extern "C" int aos_form(long long ls, long long es, unsigned long long x) {
  return digitize_aos(ls, es, x);
}

extern "C" int digitize_threads_per_cta() { return kDigitThreads; }

// n values (8 limbs each) through canonical_to_packed, or (old) through
// the byte-serial recoding it replaced
extern "C" void packed(const uint32_t* x, uint32_t* out, int n, int old) {
  for (int i = 0; i < n; ++i) {
    if (old)
      old_canonical_to_packed(x + 8 * i, out + 8 * i);
    else
      canonical_to_packed(x + 8 * i, out + 8 * i);
  }
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
    lib.digitize.argtypes = [ptr, u32, u32, ptr, u32, i32]
    lib.aos_form.argtypes = [i64, i64, ctypes.c_uint64]
    lib.digitize_threads_per_cta.argtypes = []
    lib.packed.argtypes = [ptr, ptr, i32, i32]
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


M = int("80" * 32, 16)
MAX = (1 << 256) - 1


def byte_words(gen, count):
    """256-bit words whose bytes are drawn from the recoding's edges."""
    alphabet = np.array([0x00, 0x7E, 0x7F, 0x80, 0x81, 0xFF], np.uint8)
    raw = alphabet[gen.integers(0, len(alphabet), (count, 32))]
    return [int.from_bytes(bytes(row), "little") for row in raw]


def wild_words():
    """Non-canonical words: 2^256 - 1 and every byte 0x7F, 0x80 or 0xFF,
    beside p and its neighbours."""
    return [MAX, int("7f" * 32, 16), M, P, P + 1, P - 1, 0]


def packed_inputs(name):
    gen = np.random.default_rng(len(name))
    if name == "edges":
        return wild_words() + [R - P, (1 << 255) - 1, 1 << 255,
                               int("81" * 32, 16), int("7e" * 32, 16)]
    if name == "random":
        return limbs_to_ints(rand_limbs(gen, (20000,), canonical=False))
    if name == "canonical":
        return limbs_to_ints(rand_limbs(gen, (20000,)))
    assert name == "bytes"
    return byte_words(gen, 20000)


@pytest.mark.parametrize("name", ["edges", "random", "canonical", "bytes"])
def test_canonical_to_packed_is_the_byte_loop(core, name):
    """The 256-bit add of M = 0x80..80, XOR M, equals the byte-serial
    recoding on every input class: edge words (p - 1, p, p + 1, 0,
    2^256 - 1, M, every byte 0x7F), random 256-bit and canonical values,
    and words of the bytes 0x00/0x7E/0x7F/0x80/0x81/0xFF; both equal the
    identity on Python ints and the plain version."""
    xs = packed_inputs(name)
    x = ints_to_limbs(xs)
    outs = []
    for old in (1, 0):
        out = np.zeros_like(x)
        core.packed(x.ctypes.data, out.ctypes.data, len(xs), old)
        outs.append(out)
    np.testing.assert_array_equal(outs[1], outs[0])
    assert limbs_to_ints(outs[1]) == [((v + M) & MAX) ^ M for v in xs]
    np.testing.assert_array_equal(
        outs[1], to_np(tmr._canonical_to_packed(to_t(x))))


def _digit_rows(count):
    """(count, 8) uint32 limbs: canonical rows with the edge values, then
    the non-canonical words."""
    rows = rand_limbs(np.random.default_rng(count), (count,))
    special = ints_to_limbs(EDGES + wild_words())
    rows[:len(special)] = special
    return rows


def run_digitize(core, view, aos):
    """digitize_at over every thread of a call on `view`, read where and
    at the strides digitize_args gives."""
    xa, ls, es, n = tmr.digitize_args(view)
    out = np.zeros((8, n), dtype=np.uint32)
    core.digitize(xa.data_ptr(), ls, es, out.ctypes.data, n, int(aos))
    return out


# (form, the view it reads): planar at a padded limb stride (word by
# word, element stride 1), the engine's AoS rows viewed as planes (16-byte
# loads), and word by word at an element stride of 2
DIGIT_CASES = ["planar", "aos", "strided"]


@pytest.mark.parametrize("layout", DIGIT_CASES)
def test_digitize_element_function_matches_plain(core, layout):
    """digitize_at over every element of each form against the plain
    version and the JAX package's digitize_xla, on canonical rows with the
    edge values and on non-canonical words."""
    from ligero_prover_tpu.ops.pallas import mxu_renorm as jmr
    n = 1032
    rows = _digit_rows(n)
    if layout == "planar":                 # (8, n) at limb stride n + 8
        base = np.zeros((8, n + 8), np.uint32)
        base[:, :n] = rows.T
        view = to_t_shared(base)[:, :n]
    elif layout == "aos":                  # (n, 8) rows as (8, n) planes
        base = np.ascontiguousarray(rows)
        view = to_t_shared(base).movedim(-1, 0)
    else:                                  # every other element of (n, 16)
        base = np.zeros((8, 2 * n), np.uint32)
        base[:, ::2] = rows.T
        view = to_t_shared(base)[:, ::2]
    got = run_digitize(core, view, layout == "aos")
    np.testing.assert_array_equal(got, to_np(tmr.digitize_plain(view)))
    np.testing.assert_array_equal(
        got, np.asarray(jmr.digitize_xla(np.ascontiguousarray(rows.T))))


def to_t_shared(arr):
    """An int32 tensor over the uint32 numpy buffer `arr` (no copy)."""
    return torch.from_numpy(arr.view(np.int32))


def _views():
    """name -> ((8, ...) view over a numpy buffer, read in place?, (ls,
    es) in place)."""
    b, w = 3, 64
    rows = np.arange(b * w * 8, dtype=np.uint32).reshape(b, w, 8)
    planar = np.ascontiguousarray(np.moveaxis(rows, -1, 0))
    wide = np.zeros((b, w, 16), np.uint32)
    wide[..., :8] = rows
    flat = np.ascontiguousarray(planar.reshape(8, -1))
    t = to_t_shared
    return {
        "aos rows": (t(rows).movedim(-1, 0), True, (1, 8)),
        "aos row slice": (t(rows)[1:3].movedim(-1, 0), True, (1, 8)),
        "planar": (t(planar), True, (b * w, 1)),
        "planar row slice": (t(planar)[:, 1:3], True, (b * w, 1)),
        "every other element": (t(flat)[:, ::2], True, (b * w, 2)),
        "aos of wider rows": (t(wide)[..., :8].movedim(-1, 0), True,
                              (1, 16)),
        "planar column slice": (t(planar)[:, :, :w // 2], False, None),
        "transposed": (t(planar).transpose(1, 2), False, None),
        "broadcast row": (t(planar)[:, :1].expand(8, b, w), False, None),
    }


@pytest.mark.parametrize("name", list(_views()))
def test_digitize_wrapper_reads_views_in_place(core, name):
    """digitize_args passes a view whose trailing axes collapse to one
    element stride in place (the engine's AoS rows at limb stride 1 and
    element stride 8, planar rows and slices of rows), and copies the
    others; the kernel's element function over what it passes equals the
    plain version of the view."""
    view, in_place, strides = _views()[name]
    xa, ls, es, n = tmr.digitize_args(view)
    assert n == view[0].numel()
    if in_place:
        assert xa is view and (ls, es) == strides
    else:
        assert xa.is_contiguous() and (ls, es) == (n, 1)
        assert xa.data_ptr() != view.data_ptr()
    got = run_digitize(core, view, core.aos_form(ls, es, xa.data_ptr()))
    np.testing.assert_array_equal(
        got, to_np(tmr.digitize_plain(view)).reshape(8, -1))


def test_digitize_geometry_matches_chip_smoke(core):
    """The threads per CTA chip_smoke.py assumes for digitize's launch
    floor are the kernel's."""
    from chip_smoke import DIGIT_THREADS
    assert DIGIT_THREADS == core.digitize_threads_per_cta()


# (ls, es, x's address, 16-byte AoS loads?)
FORM_CASES = [
    (1, 8, 16, True), (1, 8, 0, True), (1, 8, 8, False), (1, 8, 4, False),
    (4096, 1, 0, False), (1, 16, 0, False), (2, 8, 0, False),
    (8, 1, 0, False)]


@pytest.mark.parametrize("ls,es,xa,want", FORM_CASES)
def test_digitize_reads_aos_rows_in_16_bytes_only_where_they_fit(
        core, ls, es, xa, want):
    """The entry point's choice: two 16-byte loads an element need the AoS
    view's strides (limb stride 1, element stride 8) and x at a 16-byte
    boundary; anything else is read word by word."""
    assert bool(core.aos_form(ls, es, xa)) is want


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
