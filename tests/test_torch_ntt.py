"""Port RS codec (the planar constant-geometry path; on the CPU its KB and
KE kernels run their plain versions): tables, encode and decode against
the JAX package's constant-geometry path (``encode_rows_cg`` /
``decode_rows_cg``) at k=256, n=1024 — exact limb equality.  The JAX
package's own planar path is interpret-mode Pallas on the CPU; its tests
hold it equal to its AoS XLA path (``tests/test_pallas.py``)."""

import numpy as np
import pytest
import torch

from ligero_prover_tpu.field import bn254 as F
from ligero_prover_tpu.field import golden
from ligero_prover_tpu.field.limbs import ints_to_limbs, limbs_to_ints
from ligero_prover_tpu.ops import ntt as jntt
from ligero_prover_tpu_torch import convert
from ligero_prover_tpu_torch.ops import ntt as tntt

from _torch_helpers import rand_limbs, to_np, to_t

K, N = 256, 1024


@pytest.fixture(scope="module")
def codecs():
    return jntt.RSCodec(K, N), tntt.RSCodec(K, N, "cpu")


@pytest.mark.parametrize("dom", ["dom_k", "dom_2k", "dom_n"])
def test_tables_match_reference(codecs, dom):
    jc, tc = codecs
    want = convert.domain_tables_from_numpy(getattr(jc, dom))
    got = getattr(tc, dom)
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype
        assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("dom", ["dom_k", "dom_2k", "dom_n"])
def test_planar_tables_are_stage_planes(codecs, dom):
    """Plane (t, :, j) holds root^((j >> s) << s) in Montgomery form,
    s = log2(n) - 1 - t, for the domain's root (cg_fwd_pl) and its
    inverse (cg_inv_pl): the stage twiddles from Python ints."""
    _, tc = codecs
    w_k, w_2k, w_n = F.generate_omegas(K, N)
    n, root = {"dom_k": (K, w_k), "dom_2k": (2 * K, w_2k),
               "dom_n": (N, w_n)}[dom]
    p, log2n = F.MODULUS, n.bit_length() - 1
    tabs = getattr(tc, dom)
    for key, r in (("cg_fwd_pl", root), ("cg_inv_pl", pow(root, p - 2, p))):
        pl = tabs[key]
        assert pl.is_contiguous() and pl.shape == (log2n, 8, n // 2)
        for t in range(log2n):
            s = log2n - 1 - t
            want = [pow(r, (j >> s) << s, p) * F.R % p for j in range(n // 2)]
            np.testing.assert_array_equal(to_np(pl[t].T),
                                          ints_to_limbs(want))


@pytest.mark.parametrize("width,rows,seed", [
    pytest.param("k", 4, 11 + K, id="k"),
    pytest.param("2k", 4, 11 + 2 * K, id="2k"),
    pytest.param("k", 3, 31 + K, id="k-3rows"),
    pytest.param("2k", 3, 31 + 2 * K, id="2k-3rows")])
def test_encode_matches_reference(codecs, width, rows, seed):
    """The limb-plane core, its (B, n, 8) form and the codec's entry."""
    jc, tc = codecs
    w = K if width == "k" else 2 * K
    jdom, tdom = (jc.dom_k, tc.dom_k) if width == "k" else \
        (jc.dom_2k, tc.dom_2k)
    x = rand_limbs(np.random.default_rng(seed), (rows, w))
    want = np.asarray(jntt.encode_rows_cg(x, jdom, jc.dom_n, N))
    core = tntt.encode_rows_cg_planar_core(to_t(x), tdom, tc.dom_n, N)
    assert core.shape == (8, rows, N)
    np.testing.assert_array_equal(to_np(core.movedim(0, -1)), want)
    got = tntt.encode_rows_cg_planar(to_t(x), tdom, tc.dom_n, N)
    np.testing.assert_array_equal(to_np(got), want)
    got = (tc.encode if width == "k" else tc.encode_2k)(to_t(x))
    np.testing.assert_array_equal(to_np(got), want)


@pytest.mark.parametrize("rows,seed", [pytest.param(4, 13, id="4rows"),
                                       pytest.param(3, 33, id="3rows")])
def test_decode_matches_reference_and_golden(codecs, rows, seed):
    jc, tc = codecs
    gen = np.random.default_rng(seed)
    cws = rand_limbs(gen, (rows, N))
    got = to_np(tntt.decode_rows_cg_planar(to_t(cws), tc.dom_k, tc.dom_n,
                                           K))
    want = np.asarray(jntt.decode_rows_cg(cws, jc.dom_k, jc.dom_n, K))
    np.testing.assert_array_equal(got, want)
    # a codeword of a k-row decodes back to the row, degree part zero
    row = rand_limbs(gen, (1, K))
    cw = tc.encode(to_t(row))
    dec = limbs_to_ints(to_np(tc.decode(cw))[0])
    assert dec[:K] == limbs_to_ints(row[0])
    assert all(v == 0 for v in dec[K:])


def test_encode_matches_golden_rs(codecs):
    """encode = NTT_n(zero_extend(iNTT_k(row))) on the golden model."""
    _, tc = codecs
    w_k, _, w_n = F.generate_omegas(K, N)
    row = rand_limbs(np.random.default_rng(14), (1, K))
    vals = limbs_to_ints(row[0])
    coeffs = golden.intt(vals, w_k) + [0] * (N - K)
    want = golden.ntt(coeffs, w_n)
    assert limbs_to_ints(to_np(tc.encode(to_t(row)))[0]) == want
