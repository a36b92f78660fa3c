"""Port column SHA-256: the plain absorb (the CPU path of kernel K3) plus
``finalize`` against the JAX package's ``_absorb_stream`` +
``sha256.finalize`` and against ``hashlib`` per column — odd and even
counts, valid_count < B, an odd element carried across several flushes."""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ligero_prover_tpu.ops import sha256 as jsha
from ligero_prover_tpu.zkp.executor import _absorb_stream as j_absorb
from ligero_prover_tpu_torch import convert
from ligero_prover_tpu_torch.ops import sha256 as tsha

from _torch_helpers import rand_limbs, to_np, to_t

C, B = 24, 5

# valid counts per flush: odd carries, valid < B, an empty flush, full ones
SCHEDULES = {
    "odd_carry": [5, 3, 1, 4, 5],
    "even": [4, 2, 4],
    "partial_and_empty": [2, 0, 3, 5, 1],
}


def _hashlib_digests(rows: np.ndarray) -> list[bytes]:
    """Per column: SHA-256 of the column's elements, limbs big-endian."""
    return [hashlib.sha256(rows[:, c].astype(">u4").tobytes()).digest()
            for c in range(rows.shape[1])]


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_plain_absorb_and_finalize_match_reference(schedule):
    gen = np.random.default_rng(sorted(SCHEDULES).index(schedule))
    j_st = (jnp.asarray(jsha.initial_state(C)), jnp.zeros((C, 8), jnp.uint32),
            jnp.asarray(False))
    t_st = (tsha.initial_state(C), torch.zeros((C, 8), dtype=torch.int32),
            False)
    absorbed = []
    for valid in SCHEDULES[schedule]:
        rows = rand_limbs(gen, (B, C), canonical=False)
        absorbed.append(rows[:valid])
        j_st = j_absorb(*j_st, jnp.asarray(rows),
                        jnp.asarray(valid, jnp.int32))
        t_st = tsha.absorb_stream(*t_st, to_t(rows), valid)
        want = convert.sha_from_numpy(j_st)
        assert torch.equal(t_st[0], want[0])
        assert torch.equal(t_st[1], want[1])
        assert t_st[2] == want[2]
    total = sum(len(r) for r in absorbed)
    got = tsha.finalize(*t_st, total)
    want = jsha.finalize(*j_st, jnp.asarray(total, jnp.int32))
    np.testing.assert_array_equal(to_np(got), np.asarray(want))
    assert tsha.digests_to_bytes(got) == \
        _hashlib_digests(np.concatenate(absorbed, axis=0))


def test_single_transform_matches_reference():
    gen = np.random.default_rng(7)
    state = gen.integers(0, 2 ** 32, (8, C), dtype=np.uint64).astype(np.uint32)
    block = gen.integers(0, 2 ** 32, (16, C), dtype=np.uint64).astype(
        np.uint32)
    np.testing.assert_array_equal(
        to_np(tsha.transform(to_t(state), to_t(block))),
        np.asarray(jsha.transform(jnp.asarray(state), jnp.asarray(block))))

