"""Port field layer: ligero_prover_tpu_torch.ops.fieldops / fieldmul against
the golden Python-int model and against the JAX package's fieldops on the
same limbs.  Every comparison is exact (zero tolerance): the arithmetic is
exact integer arithmetic."""

import numpy as np
import pytest
import torch

from ligero_prover_tpu.field import bn254 as F
from ligero_prover_tpu.field.limbs import ints_to_limbs, limbs_to_ints
from ligero_prover_tpu.ops import fieldops as jfo
from ligero_prover_tpu_torch.ops import fieldmul as tfm
from ligero_prover_tpu_torch.ops import fieldops as tfo

from _torch_helpers import EDGES, NONCANONICAL, rand_limbs, to_np, to_t


def _operands(seed, n=96, canonical=True):
    gen = np.random.default_rng(seed)
    x = rand_limbs(gen, (n,), canonical)
    y = rand_limbs(gen, (n,), canonical)
    e = ints_to_limbs(EDGES)
    x[:len(EDGES)] = e                                  # edge x edge pairs
    y[:len(EDGES)] = e[::-1]
    x[len(EDGES):2 * len(EDGES)] = e                    # edge x random
    return x, y


GOLDEN = {"addmod": F.addmod, "submod": F.submod, "mont_mul": F.mont_mul,
          "mulmod": F.mulmod}


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_binary_ops_match_golden_and_jax(name):
    x, y = _operands(1)
    got = to_np(getattr(tfo, name)(to_t(x), to_t(y)))
    want = [GOLDEN[name](a, b)
            for a, b in zip(limbs_to_ints(x), limbs_to_ints(y))]
    assert limbs_to_ints(got) == want
    np.testing.assert_array_equal(got, np.asarray(getattr(jfo, name)(x, y)))


def test_negmod_matches_golden_and_jax():
    x, _ = _operands(2)
    got = to_np(tfo.negmod(to_t(x)))
    assert limbs_to_ints(got) == [F.negate(a) for a in limbs_to_ints(x)]
    np.testing.assert_array_equal(got, np.asarray(jfo.negmod(x)))


@pytest.mark.parametrize("name", ["mont_mul", "mulmod", "addmod", "submod"])
def test_noncanonical_operands_bit_identical_to_jax(name):
    """Operands in [p, 2^256) (a vbn254fr constant is reduced only mod
    2^256): the port must reproduce the reference's exact bits, not just
    the residue."""
    x, y = _operands(3, canonical=False)
    nc = ints_to_limbs(NONCANONICAL)
    x[:len(NONCANONICAL)] = nc
    y[len(NONCANONICAL):2 * len(NONCANONICAL)] = nc
    assert any(v >= F.MODULUS for v in limbs_to_ints(x))
    got = to_np(getattr(tfo, name)(to_t(x), to_t(y)))
    np.testing.assert_array_equal(got, np.asarray(getattr(jfo, name)(x, y)))


def test_carry_helpers_match_jax():
    x, y = _operands(4, canonical=False)
    s, c = tfo.add_cc(to_t(x), to_t(y))
    js, jc = jfo.add_cc(x, y)
    np.testing.assert_array_equal(to_np(s), np.asarray(js))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc).astype(np.int32))
    d, b = tfo.sub_cc(to_t(x), to_t(y))
    jd, jb = jfo.sub_cc(x, y)
    np.testing.assert_array_equal(to_np(d), np.asarray(jd))
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb).astype(np.int32))
    np.testing.assert_array_equal(
        to_np(tfo.cond_sub(to_t(x), jfo.P2_LIMBS)),
        np.asarray(jfo.cond_sub(x, jfo.P2_LIMBS)))


def test_invmod_matches_golden_and_jax():
    gen = np.random.default_rng(5)
    x = rand_limbs(gen, (6,))
    x[:3] = ints_to_limbs([0, 1, F.MODULUS - 1])
    got = to_np(tfo.invmod(to_t(x)))
    want = [F.invmod(a) for a in limbs_to_ints(x)]
    assert limbs_to_ints(got) == want
    np.testing.assert_array_equal(got, np.asarray(jfo.invmod(x)))


def test_broadcast_operands_match_expanded():
    """A (h, 8) twiddle broadcast over (B, h, 8) rows and a (8,) scalar give
    the same limbs as the fully expanded operands (the NTT call shapes)."""
    gen = np.random.default_rng(6)
    x = to_t(rand_limbs(gen, (3, 16)))
    tw = to_t(rand_limbs(gen, (16,)))
    full = tfm.mont_mul_plain(x, tw.expand(3, 16, 8).contiguous())
    assert torch.equal(tfo.mont_mul(x, tw), full)
    assert torch.equal(tfo.mont_mul(tw, x), full)
    s = to_t(rand_limbs(gen, ()))
    assert torch.equal(tfo.mulmod(x, s),
                       tfm.mulmod_plain(x, s.expand(3, 16, 8).contiguous()))


def test_wrapper_dispatch_on_cpu_counts_no_launch():
    """On CPU tensors a wrapper runs the plain version and launches
    nothing; a tensor on neither the CPU nor a card is refused."""
    tfm.reset_counts()
    x = to_t(rand_limbs(np.random.default_rng(7), (4,)))
    tfm.mont_mul(x, x)
    tfm.mulmod(x, x)
    tfm.mulmod(x, x)
    assert set(tfm.LAUNCHES.values()) == {0}
    assert {k: v for k, v in tfm.PLAIN_CALLS.items() if v} == \
        {"mont_mul": {"cpu": 1}, "mulmod": {"cpu": 2}}
    meta = torch.empty((4, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        tfm.mont_mul(meta, meta)

