"""Every TorchExecutor step against TpuExecutor at k=256, B=8, started from
the same state (random mid-stream SHA states and accumulators handed to
both through ``convert``) — exact equality of states, accumulators,
openings and decodes."""

import numpy as np
import pytest

from ligero_prover_tpu.zkp.executor import TpuExecutor
from ligero_prover_tpu_torch import convert
from ligero_prover_tpu_torch.zkp.executor import TorchExecutor

from _torch_helpers import rand_limbs

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


def _quads(gen):
    tri_idx = gen.integers(0, B, (B, 3)).astype(np.int32)
    pair_idx = gen.integers(0, B, (B, 2)).astype(np.int32)
    tri_r, pair_r = rand_limbs(gen, (B,)), rand_limbs(gen, (B,))
    tri_r[5:] = 0                        # padded entries carry zero scalars
    pair_r[3:] = 0
    return tri_idx, tri_r, pair_idx, pair_r


@pytest.mark.parametrize("width_2k,valid,has_pending",
                         [(False, 5, True), (False, 8, False),
                          (True, 2, True)])
def test_commit_step(executors, width_2k, valid, has_pending):
    je, te = executors
    gen = np.random.default_rng(valid)
    sha = _sha_state(gen, N, has_pending)
    rows = rand_limbs(gen, (B if not width_2k else 2,
                            2 * K if width_2k else K))
    want = je.commit_step(sha, rows, valid, width_2k=width_2k)
    got = te.commit_step(convert.sha_from_numpy(sha), rows, valid,
                         width_2k=width_2k)
    _same(got, want)


@pytest.mark.parametrize("rands_zero", [False, True])
def test_check_step(executors, rands_zero):
    je, te = executors
    gen = np.random.default_rng(20 + rands_zero)
    accs = tuple(rand_limbs(gen, (N,)) for _ in range(3))
    rows = rand_limbs(gen, (B, K))
    rands = np.zeros((B, K, 8), np.uint32) if rands_zero else \
        rand_limbs(gen, (B, K))
    code_rs = rand_limbs(gen, (B,))
    quads = _quads(gen)
    want = je.check_step(accs, rows, rands, code_rs, *quads,
                         rands_zero=rands_zero)
    got = te.check_step(convert.accs_from_numpy(accs), rows, rands, code_rs,
                        *quads, rands_zero=rands_zero)
    _same(got, want)


def test_mask_step(executors):
    je, te = executors
    gen = np.random.default_rng(30)
    accs = tuple(rand_limbs(gen, (N,)) for _ in range(3))
    code, lin, quad = (rand_limbs(gen, (K,)), rand_limbs(gen, (2 * K,)),
                       rand_limbs(gen, (2 * K,)))
    _same(te.mask_step(convert.accs_from_numpy(accs), code, lin, quad),
          je.mask_step(accs, code, lin, quad))


@pytest.mark.parametrize("width_2k", [False, True])
def test_open_step(executors, width_2k):
    je, te = executors
    gen = np.random.default_rng(40 + width_2k)
    rows = rand_limbs(gen, (2, 2 * K) if width_2k else (B, K))
    idx = np.sort(gen.choice(N, S, replace=False)).astype(np.int32)
    _same(te.open_step(rows, idx, width_2k=width_2k),
          je.open_step(rows, idx, width_2k=width_2k))


@pytest.mark.parametrize("valid,has_pending", [(8, True), (3, False)])
def test_verify_step(executors, valid, has_pending):
    je, te = executors
    gen = np.random.default_rng(50 + valid)
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


def test_decode_and_sha_endpoints(executors):
    je, te = executors
    gen = np.random.default_rng(70)
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
