"""Every TorchExecutor step against TpuExecutor at k=256, B=8, started from
the same state (random mid-stream SHA states and accumulators handed to
both through ``convert``) — exact equality of states, accumulators,
openings and decodes.  On the CPU every kernel of the executor's planar
path runs its plain version; the JAX package's own planar path is
interpret-mode Pallas there, and its tests hold it equal to its AoS XLA
path (``tests/test_pallas.py``), so the reference here is ``TpuExecutor``
as it runs on the CPU.  Each step runs on two seeds' inputs, and the
check step also on partial batches."""

import numpy as np
import pytest
import torch

from ligero_prover_tpu.zkp.executor import TpuExecutor
from ligero_prover_tpu_torch import convert
from ligero_prover_tpu_torch.ops import fieldops as fo
from ligero_prover_tpu_torch.zkp.executor import TorchExecutor, \
    _tree_sum_mod_planar

from _torch_helpers import rand_limbs, to_t

K, N, B, S = 256, 1024, 8, 192


@pytest.fixture(scope="module")
def executors():
    return TpuExecutor(K, N, B), TorchExecutor(K, N, B, "cpu")


def _same(got, want):
    got, want = convert.to_numpy(got), convert.to_numpy(want)
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, (bool, np.bool_)) or np.ndim(want) == 0:
        assert bool(got) == bool(want)
    else:
        np.testing.assert_array_equal(np.asarray(got),
                                      np.asarray(want, np.uint32))


def _sha_state(gen, cols, has_pending):
    words = gen.integers(0, 2 ** 32, (8, cols), dtype=np.uint64)
    return (words.astype(np.uint32), rand_limbs(gen, (cols,), False),
            np.bool_(has_pending))


def _quads(gen, rows=B, triples=B, pairs=B, live=(5, 3)):
    """Quadratic-test bookkeeping over `rows` rows: entries past `live`
    (triples, pairs) are padding and carry zero scalars."""
    tri_idx = gen.integers(0, rows, (triples, 3)).astype(np.int32)
    pair_idx = gen.integers(0, rows, (pairs, 2)).astype(np.int32)
    tri_r, pair_r = rand_limbs(gen, (triples,)), rand_limbs(gen, (pairs,))
    tri_r[live[0]:] = 0
    pair_r[live[1]:] = 0
    return tri_idx, tri_r, pair_idx, pair_r


@pytest.mark.parametrize("width_2k,valid,has_pending,seed", [
    pytest.param(False, 5, True, 5, id="False-5-True"),
    pytest.param(False, 8, False, 8, id="False-8-False"),
    pytest.param(True, 2, True, 2, id="True-2-True"),
    pytest.param(False, 5, True, 45, id="False-5-True-seed45"),
    pytest.param(False, 8, False, 48, id="False-8-False-seed48"),
    pytest.param(True, 2, True, 42, id="True-2-True-seed42")])
def test_commit_step(executors, width_2k, valid, has_pending, seed):
    je, te = executors
    gen = np.random.default_rng(seed)
    sha = _sha_state(gen, N, has_pending)
    rows = rand_limbs(gen, (B if not width_2k else 2,
                            2 * K if width_2k else K))
    want = je.commit_step(sha, rows, valid, width_2k=width_2k)
    got = te.commit_step(convert.sha_from_numpy(sha), rows, valid,
                         width_2k=width_2k)
    _same(got, want)


@pytest.mark.parametrize("rands_zero,rows,triples,pairs,live,seed", [
    pytest.param(False, B, B, B, (5, 3), 20, id="False"),
    pytest.param(True, B, B, B, (5, 3), 21, id="True"),
    pytest.param(False, B, B, B, (B - 1, B), 58, id="False-8-8-8"),
    pytest.param(True, B, B, B, (B - 1, B), 59, id="True-8-8-8"),
    pytest.param(False, 5, 7, 4, (6, 4), 55, id="False-5-7-4"),
    pytest.param(True, 3, 3, 2, (2, 2), 54, id="True-3-3-2")])
def test_check_step(executors, rands_zero, rows, triples, pairs, live, seed):
    """Full and partial batches: 7 triples + 4 pairs make an 11-row tree
    sum, whose odd head is carried through the folds."""
    je, te = executors
    gen = np.random.default_rng(seed)
    accs = tuple(rand_limbs(gen, (N,)) for _ in range(3))
    e_rows = rand_limbs(gen, (rows, K))
    rands = np.zeros((rows, K, 8), np.uint32) if rands_zero else \
        rand_limbs(gen, (rows, K))
    code_rs = rand_limbs(gen, (rows,))
    quads = _quads(gen, rows, triples, pairs, live)
    want = je.check_step(accs, e_rows, rands, code_rs, *quads,
                         rands_zero=rands_zero)
    got = te.check_step(convert.accs_from_numpy(accs), e_rows, rands,
                        code_rs, *quads, rands_zero=rands_zero)
    _same(got, want)


def test_tree_sum_matches_sequential_sum():
    gen = np.random.default_rng(55)
    for rows in (1, 2, 5, 11, 16):
        x = to_t(rand_limbs(gen, (rows, 64)))
        want = x[0]
        for i in range(1, rows):
            want = fo.addmod(want, x[i])
        got = _tree_sum_mod_planar(x.movedim(-1, 0).contiguous())
        assert torch.equal(got.T, want)


@pytest.mark.parametrize("seed", [30, 60])
def test_mask_step(executors, seed):
    je, te = executors
    gen = np.random.default_rng(seed)
    accs = tuple(rand_limbs(gen, (N,)) for _ in range(3))
    code, lin, quad = (rand_limbs(gen, (K,)), rand_limbs(gen, (2 * K,)),
                       rand_limbs(gen, (2 * K,)))
    _same(te.mask_step(convert.accs_from_numpy(accs), code, lin, quad),
          je.mask_step(accs, code, lin, quad))


@pytest.mark.parametrize("width_2k,seed", [
    pytest.param(False, 40, id="False"), pytest.param(True, 41, id="True"),
    pytest.param(False, 70, id="False-seed70"),
    pytest.param(True, 71, id="True-seed71")])
def test_open_step(executors, width_2k, seed):
    je, te = executors
    gen = np.random.default_rng(seed)
    rows = rand_limbs(gen, (2, 2 * K) if width_2k else (B, K))
    idx = np.sort(gen.choice(N, S, replace=False)).astype(np.int32)
    _same(te.open_step(rows, idx, width_2k=width_2k),
          je.open_step(rows, idx, width_2k=width_2k))


@pytest.mark.parametrize("valid,has_pending,seed", [
    pytest.param(8, True, 58, id="8-True"),
    pytest.param(3, False, 53, id="3-False"),
    pytest.param(8, True, 88, id="8-True-seed88"),
    pytest.param(3, False, 83, id="3-False-seed83")])
def test_verify_step(executors, valid, has_pending, seed):
    je, te = executors
    gen = np.random.default_rng(seed)
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


def test_verify_mask_step(executors):
    je, te = executors
    gen = np.random.default_rng(60)
    sha = _sha_state(gen, S, True)
    accs = tuple(rand_limbs(gen, (S,)) for _ in range(3))
    ms = rand_limbs(gen, (3, S), canonical=False)
    _same(te.verify_mask_step(convert.sha_from_numpy(sha),
                              convert.accs_from_numpy(accs), ms),
          je.verify_mask_step(sha, accs, ms))


@pytest.mark.parametrize("seed", [70, 90])
def test_decode_and_sha_endpoints(executors, seed):
    je, te = executors
    gen = np.random.default_rng(seed)
    cw = rand_limbs(gen, (N,))
    _same(te.decode(cw), je.decode(cw))
    _same(te.sha_init(S), je.sha_init(S))
    sha = _sha_state(gen, S, True)
    _same(te.sha_finalize(convert.sha_from_numpy(sha), 77),
          je.sha_finalize(sha, 77))


def test_stack_batch_and_concat(executors):
    _, te = executors
    gen = np.random.default_rng(80)
    rows = [rand_limbs(gen, (K,)) for _ in range(3)]
    host = te.stack_batch(rows, B, K)
    assert isinstance(host, np.ndarray) and host.shape == (B, K, 8)
    mixed = te.stack_batch([rows[0], te._limbs(rows[1]), rows[2]], B, K)
    np.testing.assert_array_equal(te.fetch(mixed), host)
    np.testing.assert_array_equal(
        te.fetch(te.concat([mixed[:2], host[2:]])), host)
    assert not te.fetch(te.zeros((2, 8))).any()
