"""KB passes (several constant-geometry stages per launch) on the CPU.

* :func:`ops.ntt.pass_plan` covers every stage exactly once, in passes of
  at most the largest pass size, and takes at most 3 passes for every
  transform of the k=8192 path.
* The plain pass over any split of a transform equals the one-stage loop
  and the JAX package's ``_cg_dit_scan_planar``/``_cg_dif_scan_planar``.
* ``encode_rows_cg_planar_core`` and ``decode_rows_cg_planar`` equal the
  JAX ones at (k, n) = (256, 1024) and (512, 2048) for several largest
  pass sizes, on canonical, non-canonical and edge inputs.
* The pass kernel's index math (``pass_load_at``, ``pass_twiddle_at``,
  ``pass_step_at``, ``pass_store_at`` in ``csrc/planar.cu``), compiled as plain C++ with
  g++ and run tile by tile as the CUDA kernel runs it, equals the plain
  pass for every pass of transforms up to N = 2048, with 4-word and
  one-word accesses and DIT inputs read tiled.

The JAX planar scans call the Pallas butterflies, which run in interpret
mode on the CPU and take minutes there; here they are routed to their XLA
reference (the JAX package's ``ops.fieldops``), as
``tests/test_torch_planar_kernels.py`` holds the port's plain versions to
it.  Everything is exact: tolerance 0."""

import ctypes
import shutil
import subprocess
from itertools import product
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from ligero_prover_tpu.field import bn254 as JF
from ligero_prover_tpu.ops import fieldops as jfo
from ligero_prover_tpu.ops import ntt as jntt
from ligero_prover_tpu.ops.pallas import fieldmul as jfm
from ligero_prover_tpu_torch.field.limbs import ints_to_limbs
from ligero_prover_tpu_torch.ops import fieldmul as tfm
from ligero_prover_tpu_torch.ops import ntt as tntt

from _torch_helpers import EDGES, NONCANONICAL, rand_limbs, to_np, to_t

CSRC = Path(tntt.__file__).resolve().parent.parent / "csrc"


# ---- the JAX planar path with the Pallas kernels on their XLA reference ----

def _planar(fn):
    """A JAX fieldops function of (..., 8) limbs applied to (8, X) planes."""
    return lambda *ps: jnp.moveaxis(
        fn(*(jnp.moveaxis(p, 0, -1) for p in ps)), -1, 0)


def _dit_xla(a, b, w):
    wb = _planar(jfo.mont_mul)(b, w)
    return _planar(jfo.addmod)(a, wb), _planar(jfo.submod)(a, wb)


def _dif_xla(a, b, w):
    return (_planar(jfo.addmod)(a, b),
            _planar(jfo.mont_mul)(_planar(jfo.submod)(a, b), w))


@pytest.fixture(scope="module")
def jax_planar():
    """The JAX package's ``ops.ntt`` with its Pallas planar kernels routed
    to their XLA reference."""
    twins = {"butterfly_dit": _dit_xla, "butterfly_dif": _dif_xla,
             "addmod_planar": _planar(jfo.addmod),
             "mont_mul_scalar_planar": lambda x, s: _planar(jfo.mont_mul)(
                 x, jnp.asarray(s, jnp.uint32)[:, None])}
    with pytest.MonkeyPatch.context() as mp:
        for name, fn in twins.items():
            mp.setattr(jfm, name, fn)
        yield jntt


def _wild(gen, shape, seed_edges=True):
    """Random (*shape, 8) limbs in [0, 2^256), the non-canonical and edge
    values in the first slots of the first row."""
    arr = rand_limbs(gen, shape, canonical=False)
    if seed_edges:
        flat = arr.reshape(-1, 8)
        edges = ints_to_limbs(NONCANONICAL + EDGES)[:flat.shape[0]]
        flat[:len(edges)] = edges
    return arr


def _tables(log2n, seed, canonical=True):
    """A random (log2n, 8, N/2) stage table (any limbs: the passes must
    agree on every operand, not only on real twiddles)."""
    gen = np.random.default_rng(seed)
    tws = rand_limbs(gen, (log2n, 1 << (log2n - 1)), canonical)
    return to_t(np.ascontiguousarray(tws.transpose(0, 2, 1)))


def _planes(arr):
    return to_t(np.ascontiguousarray(np.moveaxis(arr, -1, 0)))


def _compositions(count, largest):
    """Every split of `count` stages into ordered parts of <= largest."""
    if count == 0:
        yield ()
        return
    for first in range(1, min(count, largest) + 1):
        for rest in _compositions(count - first, largest):
            yield (first,) + rest


def _split_plan(first_stage, parts):
    plan, t0 = [], first_stage
    for s in parts:
        plan.append((t0, s))
        t0 += s
    return plan


# ---- the plan ----------------------------------------------------------------

@settings(max_examples=60, deadline=None)
@given(log2n=st.integers(1, 11), data=st.data(),
       max_pass=st.integers(1, 6))
def test_plan_covers_every_stage_once(log2n, data, max_pass):
    first = data.draw(st.integers(0, log2n))
    count = data.draw(st.integers(0, log2n - first))
    plan = tntt.pass_plan(log2n, first, count, max_pass)
    stages = [t for t0, s in plan for t in range(t0, t0 + s)]
    assert stages == list(range(first, first + count))
    assert all(1 <= s <= min(max_pass, log2n) for _, s in plan)
    largest = min(max_pass, log2n)
    assert len(plan) == -(-count // largest)
    assert max((s for _, s in plan), default=0) \
        - min((s for _, s in plan), default=0) <= 1


@pytest.mark.parametrize("log2n,first,count", [
    (15, 2, 13),     # k-width encode, DIT at n = 32768 from (8, B, 8192)
    (13, 0, 13),     # k-width encode DIF; decode DIT at k = 8192
    (14, 0, 14),     # 2k mask encode DIF at 16384
    (15, 1, 14),     # 2k mask encode DIT
    (15, 0, 15)])    # decode DIF at n = 32768
def test_plan_takes_at_most_three_passes_on_the_path(log2n, first, count):
    plan = tntt.pass_plan(log2n, first, count, tntt.LARGEST_PASS)
    assert len(plan) <= 3
    assert plan[0][0] == first and sum(s for _, s in plan) == count


def test_plan_rejects_what_is_not_a_transform():
    for args in [(4, 3, 2, 5), (4, 0, 4, 0), (4, -1, 2, 2)]:
        with pytest.raises(ValueError):
            tntt.pass_plan(*args)


# ---- the plain pass against the stage loop and the JAX scans -------------

@pytest.mark.parametrize("dit", [True, False])
def test_plain_pass_every_split_equals_stage_loop_and_jax(jax_planar, dit):
    """N = 64, B = 2, non-canonical rows with the edge values: every split
    of the 6 stages (and, for DIT, of stages 2..5 reading a (8, 2, 16)
    input tiled) equals the one-stage loop and the JAX planar scan."""
    log2n, bsz = 6, 2
    gen = np.random.default_rng(50 + dit)
    tws = _tables(log2n, 60 + dit, canonical=False)
    cases = [(0, 1 << log2n)] + ([(2, 16)] if dit else [])
    for first, width in cases:
        x = _planes(_wild(gen, (bsz, width)))
        loop = x
        for t in (range(first, log2n) if dit else
                  range(log2n - 1, -1, -1)):
            loop = (tfm.butterfly_dit if dit else tfm.butterfly_dif)(
                loop, tws[t])
        jtws = np.ascontiguousarray(to_np(tws).transpose(0, 2, 1))
        if dit:
            xin = np.tile(to_np(x), (1, 1, (1 << log2n) // width))
            want = jax_planar._cg_dit_scan_planar(jnp.asarray(xin), jtws,
                                                  first_stage=first)
        else:
            want = jax_planar._cg_dif_scan_planar(jnp.asarray(to_np(x)),
                                                  jtws)
        np.testing.assert_array_equal(to_np(loop), np.asarray(want))
        splits = list(_compositions(log2n - first, log2n))
        assert len(splits) == 2 ** (log2n - first - 1)
        for parts in splits:
            plan = _split_plan(first, parts)
            y = x
            for t0, s in (plan if dit else reversed(plan)):
                y = (tfm.butterfly_dit_pass if dit else
                     tfm.butterfly_dif_pass)(y, tws, t0, s)
            assert torch.equal(y, loop), parts


def test_pass_wrappers_count_one_plain_call_and_fill_out():
    tws = _tables(5, 70)
    x = _planes(_wild(np.random.default_rng(71), (3, 32)))
    before = {n: tfm.PLAIN_CALLS[n]["cpu"] for n in tfm.STAGES}
    out = torch.empty_like(x)
    assert tfm.butterfly_dit_pass(x, tws, 1, 4, out=out) is out
    assert torch.equal(out, tfm.butterfly_dit_pass_plain(x, tws, 1, 4))
    y = tfm.butterfly_dif_pass(x, tws, 0, 5)
    assert tfm.PLAIN_CALLS["butterfly_dit"]["cpu"] == \
        before["butterfly_dit"] + 2
    assert tfm.PLAIN_CALLS["butterfly_dif"]["cpu"] == \
        before["butterfly_dif"] + 1
    for t in range(4, -1, -1):
        x = tfm.butterfly_dif_plain(x, tws[t])
    assert torch.equal(y, x)


# ---- encode and decode through passes against the JAX planar path --------

@pytest.fixture(scope="module", params=[(256, 1024), (512, 2048)],
                ids=["k256", "k512-n2048"])
def geometry(request, jax_planar):
    k, n = request.param
    w_k, w_2k, w_n = JF.generate_omegas(k, n)
    jdoms = [jntt.build_domain_tables(m, w) for m, w in
             ((k, w_k), (2 * k, w_2k), (n, w_n))]
    tc = tntt.RSCodec(k, n, "cpu")
    gen = np.random.default_rng(k)
    rows = rand_limbs(gen, (2, k))
    rows[0, :len(EDGES)] = ints_to_limbs(EDGES)
    wild = _wild(gen, (1, k))
    rows_2k = rand_limbs(gen, (1, 2 * k)) if k == 256 else None
    cws = np.concatenate([rand_limbs(gen, (1, n)), _wild(gen, (1, n))])
    jk, j2k, jn = jdoms
    want = {
        "enc": np.asarray(jax_planar.encode_rows_cg_planar_core(
            jnp.asarray(np.concatenate([rows, wild])), jk, jn, n)),
        "enc_2k": None if rows_2k is None else np.asarray(
            jax_planar.encode_rows_cg_planar_core(jnp.asarray(rows_2k), j2k,
                                                  jn, n)),
        "dec": np.asarray(jax_planar.decode_rows_cg_planar(
            jnp.asarray(cws), jk, jn, k)),
    }
    return k, n, tc, np.concatenate([rows, wild]), rows_2k, cws, want


@pytest.mark.parametrize("max_pass", [1, 3, tntt.LARGEST_PASS, 6])
def test_encode_decode_through_passes_match_jax(geometry, max_pass):
    k, n, tc, rows, rows_2k, cws, want = geometry
    enc = tntt.encode_rows_cg_planar_core(to_t(rows), tc.dom_k, tc.dom_n, n,
                                          max_pass)
    np.testing.assert_array_equal(to_np(enc), want["enc"])
    if rows_2k is not None:                 # the 2k mask rows, at k = 256
        enc = tntt.encode_rows_cg_planar_core(to_t(rows_2k), tc.dom_2k,
                                              tc.dom_n, n, max_pass)
        np.testing.assert_array_equal(to_np(enc), want["enc_2k"])
    dec = tntt.decode_rows_cg_planar(to_t(cws), tc.dom_k, tc.dom_n, k,
                                     max_pass)
    np.testing.assert_array_equal(to_np(dec), want["dec"])


# ---- the kernel's index math, compiled as plain C++ -----------------------

HARNESS = r"""
#include "planar.cu"
#include <vector>
using namespace ligero_pl;

// One KB pass on the host, tile by tile, as pass_kernel runs it: every
// thread's loads, then each stage's butterflies (a barrier between), then
// the stores.  `vec` asks for 4-word accesses where pass_vec allows them;
// returns whether they were used.
extern "C" int pass_host(const uint32_t* x, const uint32_t* tw, uint32_t* y,
                         int B, int log2n, int in_n, int s, int dit,
                         int vec) {
  const uint32_t w = dit ? (uint32_t)in_n : 1u << log2n;
  const PassGeom pg = {(uint32_t)B, (uint32_t)log2n, (uint32_t)s, w,
                       vec ? pass_vec(log2n, s, w) : 0u};
  const uint32_t sp = pass_plane(s);
  std::vector<uint32_t> sm(2 * 8 * sp, 0xdeadbeefu);
  const uint64_t tiles = (((uint64_t)B << log2n) + kTile - 1) / kTile;
  const uint32_t units = pg.vec ? kTile / 4 : kTile;
  for (uint32_t tile = 0; tile < tiles; ++tile) {
    uint32_t* cur = sm.data();
    uint32_t* nxt = cur + 8 * sp;
    for (uint32_t u = 0; u < units; ++u) {
      if (dit) pass_load_at<true>(x, cur, pg, tile, u);
      else pass_load_at<false>(x, cur, pg, tile, u);
    }
    for (uint32_t i = 0; i < pg.s; ++i) {
      const uint32_t r = dit ? i : s - 1 - i;
      for (uint32_t bf = 0; bf < kTile / 2; ++bf) {
        uint32_t w[8];
        pass_twiddle_at(tw, pg, tile, r, bf, w);
        if (dit) pass_step_at<true>(cur, nxt, pg, tile, r, bf, w);
        else pass_step_at<false>(cur, nxt, pg, tile, r, bf, w);
      }
      uint32_t* t = cur; cur = nxt; nxt = t;
    }
    for (uint32_t u = 0; u < units; ++u) {
      if (dit) pass_store_at<true>(cur, y, pg, tile, u);
      else pass_store_at<false>(cur, y, pg, tile, u);
    }
  }
  return (int)pg.vec;
}
"""


@pytest.fixture(scope="module")
def host_pass(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    work = tmp_path_factory.mktemp("pass_host")
    (work / "harness.cpp").write_text(HARNESS)
    so = work / "libpasshost.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC",
                    "-Wno-unknown-pragmas", f"-I{CSRC}", "-o", str(so),
                    str(work / "harness.cpp")], check=True)
    fn = ctypes.CDLL(str(so)).pass_host
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
    fn.restype = ctypes.c_int

    def run(x, tws, t0, s, dit, vec):
        n = 2 * tws.shape[2]
        y = torch.full((8, x.shape[1], n), -1, dtype=torch.int32)
        used = fn(x.data_ptr(), tws[t0].data_ptr(), y.data_ptr(), x.shape[1],
                  n.bit_length() - 1, x.shape[2], s, int(dit), int(vec))
        return y, bool(used)
    return run


@pytest.mark.parametrize("log2n,bsz", [(1, 3), (2, 1), (3, 5), (6, 3),
                                       (11, 2)])
def test_host_pass_cores_equal_the_plain_pass(host_pass, log2n, bsz):
    """Every pass (t0, s) of an N = 2^log2n transform, s <= 9, through the
    CUDA source's cores on the host, both access widths, against the plain
    pass; DIT also from inputs read tiled.  Every split of the transform is
    a sequence of these passes."""
    n = 1 << log2n
    gen = np.random.default_rng(log2n * 10 + bsz)
    tws = _tables(log2n, log2n, canonical=False)
    full = _planes(_wild(gen, (bsz, n)))
    widths = sorted({2, 4, n // 4, n} & set(range(2, n + 1)))
    if log2n > 6:
        widths = [n // 4, n]
    vec_used = False
    for dit, t0 in product((True, False), range(log2n)):
        for s in range(1, min(log2n - t0, tfm.MAX_PASS) + 1):
            for w in (widths if dit else [n]):
                x = full[:, :, :w].contiguous()
                want = (tfm.butterfly_dit_pass_plain if dit else
                        tfm.butterfly_dif_pass_plain)(x, tws, t0, s)
                for vec in (True, False):
                    got, used = host_pass(x, tws, t0, s, dit, vec)
                    vec_used |= used
                    assert torch.equal(got, want), (dit, t0, s, w, vec)
    assert vec_used is (log2n >= 4)
