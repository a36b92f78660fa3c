"""The port's planar configuration (``ops.ntt.USE_PLANAR = True``) on the
CPU, where every planar kernel runs its plain version: the planar codec
against the JAX package's constant-geometry encode/decode, and every
``TorchExecutor`` step against ``TpuExecutor`` at k=256 — exact equality.

The JAX package's own planar path is interpret-mode Pallas on the CPU; its
tests hold it equal to its AoS XLA path (``tests/test_pallas.py``), so the
reference here is ``TpuExecutor`` as it runs on the CPU."""

import numpy as np
import pytest
import torch

from ligero_prover_tpu.ops import ntt as jntt
from ligero_prover_tpu.zkp.executor import TpuExecutor
from ligero_prover_tpu_torch import convert
from ligero_prover_tpu_torch.field.limbs import limbs_to_ints
from ligero_prover_tpu_torch.ops import fieldmul as tfm
from ligero_prover_tpu_torch.ops import ntt as tntt
from ligero_prover_tpu_torch.zkp.executor import TorchExecutor

from _torch_helpers import rand_limbs, to_np, to_t
from test_torch_executor import _quads, _same, _sha_state

K, N, B, S = 256, 1024, 8, 192


@pytest.fixture(scope="module")
def codecs():
    return jntt.RSCodec(K, N), tntt.RSCodec(K, N, "cpu")


@pytest.fixture(scope="module")
def executors():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tntt, "USE_PLANAR", True)
        te = TorchExecutor(K, N, B, "cpu")
    assert te.use_planar
    return TpuExecutor(K, N, B), te


@pytest.mark.parametrize("dom", ["dom_k", "dom_2k", "dom_n"])
def test_planar_tables_are_stage_planes(codecs, dom):
    _, tc = codecs
    tabs = getattr(tc, dom)
    for key in ("cg_fwd", "cg_inv"):
        pl = tabs[key + "_pl"]
        assert pl.is_contiguous()
        assert torch.equal(pl, tabs[key].transpose(1, 2))


@pytest.mark.parametrize("width", ["k", "2k"])
def test_planar_encode_matches_reference(codecs, width):
    jc, tc = codecs
    w = K if width == "k" else 2 * K
    jdom, tdom = (jc.dom_k, tc.dom_k) if width == "k" else \
        (jc.dom_2k, tc.dom_2k)
    rows = rand_limbs(np.random.default_rng(31 + w), (3, w))
    want = np.asarray(jntt.encode_rows_cg(rows, jdom, jc.dom_n, N))
    core = tntt.encode_rows_cg_planar_core(to_t(rows), tdom, tc.dom_n, N)
    assert core.shape == (8, 3, N)
    np.testing.assert_array_equal(to_np(core.movedim(0, -1)), want)
    got = tntt.encode_rows(to_t(rows), tdom, tc.dom_n, N, use_planar=True)
    np.testing.assert_array_equal(to_np(got), want)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tntt, "USE_PLANAR", True)
        got = (tc.encode if width == "k" else tc.encode_2k)(to_t(rows))
    np.testing.assert_array_equal(to_np(got), want)


def test_planar_decode_matches_reference(codecs):
    jc, tc = codecs
    gen = np.random.default_rng(33)
    cws = rand_limbs(gen, (3, N))
    got = to_np(tntt.decode_rows(to_t(cws), tc.dom_k, tc.dom_n, K,
                                 use_planar=True))
    want = np.asarray(jntt.decode_rows_cg(cws, jc.dom_k, jc.dom_n, K))
    np.testing.assert_array_equal(got, want)
    row = rand_limbs(gen, (1, K))
    cw = tntt.encode_rows(to_t(row), tc.dom_k, tc.dom_n, N, use_planar=True)
    dec = limbs_to_ints(to_np(tntt.decode_rows(
        cw, tc.dom_k, tc.dom_n, K, use_planar=True))[0])
    assert dec[:K] == limbs_to_ints(row[0])
    assert all(v == 0 for v in dec[K:])


@pytest.mark.parametrize("flag,planar", [(None, False), (True, True),
                                         (False, False)])
def test_use_planar_selects_the_path(codecs, monkeypatch, flag, planar):
    """Auto is AoS for CPU tensors; the flag overrides it, and the codec
    and a new executor follow it."""
    _, tc = codecs
    monkeypatch.setattr(tntt, "USE_PLANAR", flag)
    assert tntt._planar_use("cpu") is planar
    assert tntt._planar_use("cuda") is (True if flag is None else flag)
    assert TorchExecutor(16, 64, 2, "cpu").use_planar is planar
    before = tfm.PLAIN_CALLS["butterfly_dit"]["cpu"]
    tc.encode(to_t(rand_limbs(np.random.default_rng(34), (1, K))))
    assert (tfm.PLAIN_CALLS["butterfly_dit"]["cpu"] > before) is planar


@pytest.mark.parametrize("width_2k,valid,has_pending",
                         [(False, 5, True), (False, 8, False),
                          (True, 2, True)])
def test_planar_commit_step(executors, width_2k, valid, has_pending):
    je, te = executors
    gen = np.random.default_rng(40 + valid)
    sha = _sha_state(gen, N, has_pending)
    rows = rand_limbs(gen, (2 if width_2k else B, 2 * K if width_2k else K))
    want = je.commit_step(sha, rows, valid, width_2k=width_2k)
    got = te.commit_step(convert.sha_from_numpy(sha), rows, valid,
                         width_2k=width_2k)
    _same(got, want)


@pytest.mark.parametrize("rands_zero,rows,triples,pairs",
                         [(False, B, B, B), (True, B, B, B),
                          (False, 5, 7, 4), (True, 3, 3, 2)])
def test_planar_check_step(executors, rands_zero, rows, triples, pairs):
    """Full and odd batches: 7 triples + 4 pairs make an 11-row tree sum,
    whose odd head is carried through the folds."""
    je, te = executors
    gen = np.random.default_rng(50 + rows + rands_zero)
    accs = tuple(rand_limbs(gen, (N,)) for _ in range(3))
    e_rows = rand_limbs(gen, (rows, K))
    rands = np.zeros((rows, K, 8), np.uint32) if rands_zero else \
        rand_limbs(gen, (rows, K))
    code_rs = rand_limbs(gen, (rows,))
    tri_idx = gen.integers(0, rows, (triples, 3)).astype(np.int32)
    pair_idx = gen.integers(0, rows, (pairs, 2)).astype(np.int32)
    tri_r, pair_r = rand_limbs(gen, (triples,)), rand_limbs(gen, (pairs,))
    tri_r[-1:] = 0                      # padded entries carry zero scalars
    quads = (tri_idx, tri_r, pair_idx, pair_r)
    want = je.check_step(accs, e_rows, rands, code_rs, *quads,
                         rands_zero=rands_zero)
    got = te.check_step(convert.accs_from_numpy(accs), e_rows, rands,
                        code_rs, *quads, rands_zero=rands_zero)
    _same(got, want)


def test_planar_tree_sum_matches_sequential_sum():
    from ligero_prover_tpu_torch.ops import fieldops as fo
    from ligero_prover_tpu_torch.zkp.executor import _tree_sum_mod_planar
    gen = np.random.default_rng(55)
    for rows in (1, 2, 5, 11, 16):
        x = to_t(rand_limbs(gen, (rows, 64)))
        want = x[0]
        for i in range(1, rows):
            want = fo.addmod(want, x[i])
        got = _tree_sum_mod_planar(x.movedim(-1, 0).contiguous())
        assert torch.equal(got.T, want)


def test_planar_mask_step(executors):
    je, te = executors
    gen = np.random.default_rng(60)
    accs = tuple(rand_limbs(gen, (N,)) for _ in range(3))
    code, lin, quad = (rand_limbs(gen, (K,)), rand_limbs(gen, (2 * K,)),
                       rand_limbs(gen, (2 * K,)))
    _same(te.mask_step(convert.accs_from_numpy(accs), code, lin, quad),
          je.mask_step(accs, code, lin, quad))


@pytest.mark.parametrize("width_2k", [False, True])
def test_planar_open_step(executors, width_2k):
    je, te = executors
    gen = np.random.default_rng(70 + width_2k)
    rows = rand_limbs(gen, (2, 2 * K) if width_2k else (B, K))
    idx = np.sort(gen.choice(N, S, replace=False)).astype(np.int32)
    _same(te.open_step(rows, idx, width_2k=width_2k),
          je.open_step(rows, idx, width_2k=width_2k))


@pytest.mark.parametrize("valid,has_pending", [(8, True), (3, False)])
def test_planar_verify_step(executors, valid, has_pending):
    je, te = executors
    gen = np.random.default_rng(80 + valid)
    sha = _sha_state(gen, S, has_pending)
    accs = tuple(rand_limbs(gen, (S,)) for _ in range(3))
    samples = rand_limbs(gen, (B, S), canonical=False)   # proof-supplied
    rands = rand_limbs(gen, (B, K))
    code_rs = rand_limbs(gen, (B,))
    quads = _quads(gen)
    idx = np.sort(gen.choice(N, S, replace=False)).astype(np.int32)
    want = je.verify_step(sha, accs, samples, rands, code_rs, *quads, idx,
                          valid)
    got = te.verify_step(convert.sha_from_numpy(sha),
                         convert.accs_from_numpy(accs), samples, rands,
                         code_rs, *quads, idx, valid)
    _same(got, want)


def test_planar_decode_step(executors):
    je, te = executors
    cw = rand_limbs(np.random.default_rng(90), (N,))
    _same(te.decode(cw), je.decode(cw))
