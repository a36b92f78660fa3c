"""KA in place (``out=``) and with a host constant by value, and the
vbn254fr arena that writes its slots through it, on the CPU.

* ``fo.addmod``/``fo.submod`` with ``out=`` x, y or both, and with a
  constant of one element, equal the JAX ``fo.addmod``/``fo.submod`` on
  non-canonical limbs.  Exact.
* A sequence of arena ops whose output slot is an input slot (``add(i, i,
  i)``, ``sub_const(i, i, c)``, ...) leaves every row equal to the JAX
  arena's (``ligero_prover_tpu/vm/hostmods/vbn254fr.py``, jitted on the
  CPU).
* A bad ``out=`` (another dtype, shape or device, not contiguous, not
  16-byte aligned, overlapping an operand other than element for
  element) raises before anything runs.
* Which operands KA takes by value (``fm.host_element``).

The kernel's element function in place and by value is held in
``tests/test_torch_aos_core.py`` (g++), and the kernel on the card in
``tests/test_torch_kernels.py``.

    python -m pytest tests/test_torch_arena_inplace.py -q
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ligero_prover_tpu.ops import fieldops as jfo
from ligero_prover_tpu.vm.hostmods import vbn254fr as jarena
from ligero_prover_tpu_torch.field.limbs import ints_to_limbs
from ligero_prover_tpu_torch.ops import fieldmul as tfm
from ligero_prover_tpu_torch.ops import fieldops as tfo
from ligero_prover_tpu_torch.vm.hostmods.vbn254fr import Arena

from _torch_helpers import EDGES, NONCANONICAL, rand_limbs, to_np, to_t

OPS = {"addmod": jax.jit(jfo.addmod), "submod": jax.jit(jfo.submod)}


def _rows(gen, shape):
    """Non-canonical limbs with the edge and non-canonical values first."""
    a = rand_limbs(gen, shape, False)
    vals = ints_to_limbs(NONCANONICAL + EDGES)
    a.reshape(-1, 8)[:len(vals)] = vals
    return a


@pytest.mark.parametrize("alias", ["x", "y", "both"])
@pytest.mark.parametrize("name", list(OPS))
def test_out_may_be_an_operand(name, alias):
    gen = np.random.default_rng(len(alias) + len(name))
    x = _rows(gen, (50,))
    y = x if alias == "both" else _rows(gen, (50,))[::-1].copy()
    want = np.asarray(OPS[name](x, y))
    xt = to_t(x)
    yt = xt if alias == "both" else to_t(y)
    out = yt if alias == "y" else xt
    tfm.reset_counts()
    got = getattr(tfo, name)(xt, yt, out=out)
    assert got is out
    np.testing.assert_array_equal(to_np(out), want)
    assert tfm.PLAIN_CALLS[name + "_aos"]["cpu"] == 1
    assert set(tfm.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("first", [False, True], ids=["x-c", "c-x"])
@pytest.mark.parametrize("name", list(OPS))
def test_constant_into_a_slot(name, first):
    """The arena's constant calls: x +- c and c - x with c one element,
    written into x itself, on edge and non-canonical c."""
    gen = np.random.default_rng(7 + first)
    x = _rows(gen, (40,))
    for c in ints_to_limbs(NONCANONICAL + EDGES[:3]):
        a, b = (c, x) if first else (x, c)
        want = np.asarray(OPS[name](*np.broadcast_arrays(a, b)))
        xt, ct = to_t(x), to_t(c)
        getattr(tfo, name)(*((ct, xt) if first else (xt, ct)), out=xt)
        np.testing.assert_array_equal(to_np(xt), want)


def test_host_element():
    """KA takes an operand by value when it is one element on the host,
    a broadcast view of one included; anything else is read in place."""
    gen = np.random.default_rng(2)
    c = to_t(rand_limbs(gen, ()))
    assert torch.equal(tfm.host_element(c), c)
    for view in (c[None], c[None, None], c.expand(9, 8),
                 c[None].expand(3, 4, 8)):
        got = tfm.host_element(view)
        assert got.shape == (8,) and torch.equal(got, c)
    rows = to_t(rand_limbs(gen, (2,)))
    for t in (rows, rows.T.contiguous(), torch.zeros(())):
        assert tfm.host_element(t) is None
    meta = torch.empty((1, 8), dtype=torch.int32, device="meta")
    assert tfm.host_element(meta) is None


def _bad_calls(big):
    """(label, x, y, out) that the wrapper must refuse; big (12, 8)."""
    x, y = big[:6], big[6:]
    wide = torch.zeros((6, 9), dtype=torch.int32)
    flat = torch.zeros(6 * 8 + 4, dtype=torch.int32)
    return [
        ("int64", x, y, torch.zeros((6, 8), dtype=torch.int64)),
        ("shape", x, y, torch.zeros((5, 8), dtype=torch.int32)),
        ("broadcast shape", x, y, torch.zeros((2, 6, 8), dtype=torch.int32)),
        ("not contiguous", x, y, wide[:, :8]),
        ("not 16-byte aligned", x, y, flat[1:49].view(6, 8)),
        ("another device", x, y, torch.empty((6, 8), dtype=torch.int32,
                                             device="meta")),
        ("overlaps x one row on", x, y, big[1:7]),
        ("a broadcast operand inside out", big[0], y, big[:6]),
    ]


@pytest.mark.parametrize("name", list(OPS))
def test_bad_out_raises_before_anything_runs(name):
    big = to_t(rand_limbs(np.random.default_rng(4), (12,)))
    before = big.clone()
    for label, x, y, out in _bad_calls(big):
        tfm.reset_counts()
        with pytest.raises(ValueError):
            getattr(tfo, name)(x, y, out=out)
        assert not any(sum(v.values()) for v in tfm.PLAIN_CALLS.values()), \
            label
        assert torch.equal(big, before), label


# (op, args): slots 0-3 hold non-canonical rows; every op's output slot
# is one of its inputs, as a guest's `x = x + y` makes it
SEQUENCE = [("add", (0, 0, 0)), ("add", (0, 1, 1)), ("sub", (1, 0, 0)),
            ("sub", (2, 2, 2)), ("add_const", (3, 3, "c0")),
            ("sub_const", (0, 0, "c1")), ("const_sub", (1, 1, "c0")),
            ("add", (2, 3, 2)), ("sub", (3, 1, 3)),
            ("const_sub", (2, 3, "c2")), ("add_const", (1, 0, "c2"))]


def test_arena_in_place_matches_jax_arena():
    k = 24
    gen = np.random.default_rng(13)
    rows = [_rows(gen, (k,)) for _ in range(4)]
    rows[3][:] = rows[3][::-1]
    consts = {"c0": ints_to_limbs([(1 << 256) - 1])[0],
              "c1": ints_to_limbs([EDGES[3]])[0],
              "c2": rand_limbs(gen, ())}
    ops = jarena._build_jits()
    ja = jnp.zeros((jarena.MAX_VARIABLES, k, 8), jnp.uint32)
    ta = Arena(k, "cpu")
    for slot, row in enumerate(rows):
        ja = ops["set_row"](ja, slot, row)
        ta.set_row(slot, row)
    for op, args in SEQUENCE:
        args = tuple(consts[a] if isinstance(a, str) else a for a in args)
        ja = ops[op](ja, *args)
        getattr(ta, op)(*args)
        np.testing.assert_array_equal(to_np(ta.rows[:4]),
                                      np.asarray(ja[:4]), err_msg=op)
    np.testing.assert_array_equal(to_np(ta.rows), np.asarray(ja))
