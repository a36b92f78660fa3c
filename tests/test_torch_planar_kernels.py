"""The plain versions of the port's planar kernels (KB butterflies, KE
add/sub/Montgomery products) at one (8, 1024) tile — canonical operands and
one non-canonical set (values in [p, 2^256) and edge values), exact
equality — against:

* the JAX package's XLA field ops (``ligero_prover_tpu.ops.fieldops``) and
  the ``field.bn254`` Python-int model, in the fast tier;
* the JAX package's Pallas wrappers, run in interpret mode on the CPU as
  ``tests/test_pallas.py`` runs them.  Interpret mode takes minutes per
  kernel inside the test process, so these cases are in the slow tier
  with ``test_pallas.py``.

The port's :func:`butterfly_dit` is one whole stage; the reference's
``butterfly_dit(a, b, w)`` is that stage at B = 1 on the interleaved input
x[2j] = a[j], x[2j+1] = b[j], its outputs the two halves of y.  DIF is the
transpose: x = [a, b], y interleaves the outputs."""

import numpy as np
import pytest
import torch

from ligero_prover_tpu.field import bn254 as F
from ligero_prover_tpu.ops import fieldops as jfo
from ligero_prover_tpu.ops.pallas import fieldmul as jfm
from ligero_prover_tpu_torch.field.limbs import ints_to_limbs, limbs_to_ints
from ligero_prover_tpu_torch.ops import fieldmul as tfm

from _torch_helpers import EDGES, NONCANONICAL, rand_limbs, to_np, to_t

P = 1024                      # one (8, 8, 128) Pallas tile


@pytest.fixture
def interpret_mode():
    jfm.FORCE_INTERPRET = True
    yield
    jfm.FORCE_INTERPRET = None


def _operands(seed, count):
    """`count` planar (8, P) operand sets: canonical, then non-canonical
    with the edge values in the first slots (reversed in every other
    operand so that unlike edges meet)."""
    gen = np.random.default_rng(seed)
    edges = ints_to_limbs(NONCANONICAL + EDGES)
    canon = [rand_limbs(gen, (P,)) for _ in range(count)]
    wild = [rand_limbs(gen, (P,), canonical=False) for _ in range(count)]
    for i, w in enumerate(wild):
        w[:len(edges)] = edges if i % 2 == 0 else edges[::-1]
    return [[np.ascontiguousarray(a.T) for a in ops]
            for ops in (canon, wild)]


def _jax(fn, *args):
    out = fn(*args)
    return tuple(np.asarray(o, np.uint32) for o in out) \
        if isinstance(out, (tuple, list)) else np.asarray(out, np.uint32)


def _aos(fn, *planes):
    """A JAX fieldops function applied to planar (8, X) operands."""
    return np.ascontiguousarray(
        np.asarray(fn(*(p.T for p in planes)), np.uint32).T)


ELTWISE = ["addmod_planar", "submod_planar", "mont_mul_planar",
           "mulmod_planar"]
XLA = {"addmod_planar": jfo.addmod, "submod_planar": jfo.submod,
       "mont_mul_planar": jfo.mont_mul, "mulmod_planar": jfo.mulmod}


@pytest.mark.parametrize("name", ELTWISE)
def test_eltwise_plain_matches_xla(name):
    for x, y in _operands(len(name), 2):
        got = getattr(tfm, name + "_plain")(to_t(x), to_t(y))
        np.testing.assert_array_equal(to_np(got), _aos(XLA[name], x, y))


def test_mont_scalar_plain_matches_xla_and_ints():
    for x, s in _operands(17, 2):
        s = s[:, 0].copy()
        got = to_np(tfm.mont_mul_scalar_planar_plain(to_t(x), to_t(s)))
        np.testing.assert_array_equal(
            got, _aos(lambda a: jfo.mont_mul(a, s[None, :]), x))
    x, s = _operands(18, 2)[0]
    got = limbs_to_ints(to_np(tfm.mont_mul_scalar_planar_plain(
        to_t(x), to_t(s[:, 0].copy()))).T)
    sv = limbs_to_ints(s[:, :1].T)[0]
    assert got == [F.mont_mul(v, sv) for v in limbs_to_ints(x.T)]


@pytest.mark.parametrize("dit", [True, False])
def test_butterfly_plain_matches_xla_and_ints(dit):
    """One stage on a (8, 2, 2048) batch: the reference's AoS constant-
    geometry stage body in XLA field ops (``ntt.py:276-297``), and on
    canonical operands the Python-int butterfly."""
    for a, b, w in _operands(19 + dit, 3):
        x = np.concatenate([a, b], axis=1).reshape(8, 2, P)
        tw = np.ascontiguousarray(w[:, :P // 2])
        y = to_np((tfm.butterfly_dit_plain if dit else
                   tfm.butterfly_dif_plain)(to_t(x), to_t(tw)))
        xa = x.transpose(1, 2, 0)                            # (2, P, 8)
        if dit:
            u, v = xa[:, 0::2], xa[:, 1::2]
            wv = jfo.mont_mul(v, tw.T[None])
            want = np.concatenate([jfo.addmod(u, wv), jfo.submod(u, wv)], 1)
        else:
            u, v = xa[:, :P // 2], xa[:, P // 2:]
            want = np.stack([jfo.addmod(u, v),
                             jfo.mont_mul(jfo.submod(u, v), tw.T[None])],
                            axis=2).reshape(2, P, 8)
        np.testing.assert_array_equal(y.transpose(1, 2, 0),
                                      np.asarray(want, np.uint32))
    a, b, w = _operands(21, 3)[0]
    ai, bi, wi = (limbs_to_ints(v.T) for v in (a, b, w))
    x = np.stack([a, b], axis=2).reshape(8, 1, 2 * P)
    y = limbs_to_ints(to_np(tfm.butterfly_dit_plain(to_t(x), to_t(w)))[:, 0].T)
    wb = [F.mont_mul(u, v) for u, v in zip(bi, wi)]
    assert y[:P] == [(u + v) % F.MODULUS for u, v in zip(ai, wb)]
    assert y[P:] == [(u - v) % F.MODULUS for u, v in zip(ai, wb)]


@pytest.mark.slow
@pytest.mark.parametrize("name", ELTWISE)
def test_eltwise_plain_matches_pallas(interpret_mode, name):
    for x, y in _operands(100 + ELTWISE.index(name), 2):
        want = _jax(getattr(jfm, name), x, y)
        got = getattr(tfm, name + "_plain")(to_t(x), to_t(y))
        np.testing.assert_array_equal(to_np(got), want)


@pytest.mark.slow
def test_mont_scalar_plain_matches_pallas(interpret_mode):
    for (x, s) in _operands(7, 2):
        s = s[:, 0].copy()                                   # one (8,) scalar
        want = _jax(jfm.mont_mul_scalar_planar, x, s)
        got = tfm.mont_mul_scalar_planar_plain(to_t(x), to_t(s))
        np.testing.assert_array_equal(to_np(got), want)


@pytest.mark.slow
def test_butterfly_dit_plain_matches_pallas(interpret_mode):
    for a, b, w in _operands(8, 3):
        s, d = _jax(jfm.butterfly_dit, a, b, w)
        x = np.stack([a, b], axis=2).reshape(8, 1, 2 * P)    # interleave
        y = tfm.butterfly_dit_plain(to_t(x), to_t(w))
        np.testing.assert_array_equal(to_np(y)[:, 0],
                                      np.concatenate([s, d], axis=1))


@pytest.mark.slow
def test_butterfly_dif_plain_matches_pallas(interpret_mode):
    for a, b, w in _operands(9, 3):
        s, d = _jax(jfm.butterfly_dif, a, b, w)
        x = np.concatenate([a, b], axis=1)[:, None, :]        # halves
        y = tfm.butterfly_dif_plain(to_t(x), to_t(w))
        np.testing.assert_array_equal(
            to_np(y)[:, 0], np.stack([s, d], axis=2).reshape(8, 2 * P))


def test_wrappers_take_plain_versions_on_cpu():
    """On CPU tensors every wrapper is its plain version (and counts it);
    `out` receives a butterfly's result."""
    gen = np.random.default_rng(10)
    x, y = (to_t(rand_limbs(gen, (P,)).T.copy()) for _ in range(2))
    before = {k: v["cpu"] for k, v in tfm.PLAIN_CALLS.items()}
    for name in tfm.PLANAR_MODE:
        arg = y[:, 0] if name == "mont_mul_scalar_planar" else y
        assert torch.equal(getattr(tfm, name)(x, arg),
                           getattr(tfm, name + "_plain")(x, arg))
    xb = x.reshape(8, 2, P // 2)
    for name in tfm.STAGES:
        out = torch.empty_like(xb)
        res = getattr(tfm, name)(xb, y[:, :P // 4], out=out)
        assert res is out
        assert torch.equal(out, getattr(tfm, name + "_plain")(
            xb, y[:, :P // 4]))
    for name, calls in tfm.PLAIN_CALLS.items():
        if name in tfm.PLANAR_MODE or name in tfm.STAGES:
            assert calls["cpu"] == before[name] + 2
    assert all(v == 0 for v in tfm.LAUNCHES.values())


def test_dit_reads_a_narrow_input_tiled():
    """The zero-extension: a DIT stage of an x narrower than the stage
    equals the stage of x tiled to full width."""
    gen = np.random.default_rng(11)
    x = to_t(rand_limbs(gen, (3, 64)).transpose(2, 0, 1).copy())
    tw = to_t(rand_limbs(gen, (128,)).T.copy())
    assert torch.equal(tfm.butterfly_dit_plain(x, tw),
                       tfm.butterfly_dit_plain(x.repeat(1, 1, 4), tw))


def test_row_scalar_broadcast():
    """A (8, B, 1) second operand is one scalar per row of (8, B, n)."""
    gen = np.random.default_rng(12)
    x = to_t(rand_limbs(gen, (3, 16)).transpose(2, 0, 1).copy())
    s = to_t(rand_limbs(gen, (3,)).T.copy())[:, :, None]
    got = tfm.mont_mul_planar_plain(x, s)
    for b in range(3):
        assert torch.equal(got[:, b], tfm.mont_mul_scalar_planar_plain(
            x[:, b], s[:, b, 0]))
