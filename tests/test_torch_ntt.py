"""Port RS codec: constant-geometry tables, encode and decode against the
JAX package's AoS constant-geometry path (``encode_rows_cg`` /
``decode_rows_cg``) at k=256, n=1024, B=4 — exact limb equality."""

import numpy as np
import pytest
import torch

from ligero_prover_tpu.field import bn254 as F
from ligero_prover_tpu.field import golden
from ligero_prover_tpu.field.limbs import limbs_to_ints
from ligero_prover_tpu.ops import ntt as jntt
from ligero_prover_tpu_torch import convert
from ligero_prover_tpu_torch.ops import ntt as tntt

from _torch_helpers import rand_limbs, to_np, to_t

K, N, B = 256, 1024, 4


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


@pytest.mark.parametrize("width", ["k", "2k"])
def test_encode_matches_reference(codecs, width):
    jc, tc = codecs
    w = K if width == "k" else 2 * K
    jdom, tdom = (jc.dom_k, tc.dom_k) if width == "k" else \
        (jc.dom_2k, tc.dom_2k)
    rows = rand_limbs(np.random.default_rng(11 + w), (B, w))
    got = to_np(tntt.encode_rows_cg(to_t(rows), tdom, tc.dom_n, N))
    want = np.asarray(jntt.encode_rows_cg(rows, jdom, jc.dom_n, N))
    np.testing.assert_array_equal(got, want)


def test_decode_matches_reference_and_golden(codecs):
    jc, tc = codecs
    gen = np.random.default_rng(13)
    cws = rand_limbs(gen, (B, N))
    got = to_np(tntt.decode_rows_cg(to_t(cws), tc.dom_k, tc.dom_n, K))
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
