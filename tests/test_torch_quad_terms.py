"""quad-terms (``fm.quad_terms_planar``), the quadratic test's terms read
from the encoded batch by row index, on the CPU: its plain version
against the JAX package's composition of the same terms (``jnp.take`` and
the XLA ``mulmod``/``submod`` of ``ligero_prover_tpu.ops.fieldops``, then
``concatenate``, as ``ligero_prover_tpu/zkp/executor.py:233-250`` builds
them), the wrapper's dispatch on CPU tensors, and its argument check of
the row indices, which runs on the host before anything is launched.
Exact: tolerance 0.  The kernel's own thread function is held against the
plain version in ``tests/test_torch_mont_core.py`` (g++), and the
kernel on the card in ``tests/test_torch_kernels.py``.

    python -m pytest tests/test_torch_quad_terms.py -q
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ligero_prover_tpu.ops import fieldops as jfo
from ligero_prover_tpu_torch.field.limbs import ints_to_limbs
from ligero_prover_tpu_torch.ops import fieldmul as tfm

from _torch_helpers import EDGES, NONCANONICAL, rand_limbs, to_np, to_t

B, N = 6, 64


def _batch(seed, canonical):
    """(B, N, 8) uint32 rows; the non-canonical batch has the edge values
    in its first two rows, reversed in the second."""
    rows = rand_limbs(np.random.default_rng(seed), (B, N), canonical)
    if not canonical:
        edges = ints_to_limbs(NONCANONICAL + EDGES)
        rows[0, :len(edges)] = edges
        rows[1, :len(edges)] = edges[::-1]
    return rows


def _reference(rows, tri, pair):
    """The JAX package's terms: (T+P, N, 8)."""
    e = jnp.asarray(rows)
    ex, ey, ez = (jnp.take(e, jnp.asarray(tri[:, i]), axis=0)
                  for i in range(3))
    px, py = (jnp.take(e, jnp.asarray(pair[:, i]), axis=0)
              for i in range(2))
    t_ = jfo.submod(jfo.mulmod(ex, ey), ez)
    d_ = jfo.submod(px, py)
    return np.asarray(jnp.concatenate([t_, d_], axis=0), np.uint32)


INDEX_CASES = {
    "random": (np.array([[0, 1, 2], [3, 4, 5], [5, 0, 1]]),
               np.array([[1, 2], [4, 0]])),
    "repeats": (np.array([[1, 1, 1], [1, 1, 2], [2, 1, 1], [1, 1, 1]]),
                np.array([[2, 2], [2, 1], [2, 2]])),
    "padded": (np.array([[3, 4, 1], [0, 0, 0], [0, 0, 0]]),
               np.array([[5, 2], [0, 0], [0, 0]])),
    "t_ne_p": (np.array([[0, 5, 3]]),
               np.array([[1, 0], [2, 3], [4, 5], [5, 1], [0, 0]])),
    "no_pairs": (np.array([[2, 3, 4], [4, 3, 2]]), np.zeros((0, 2), int)),
    "no_triples": (np.zeros((0, 3), int), np.array([[0, 1], [1, 0]])),
}


@pytest.mark.parametrize("canonical", [True, False])
@pytest.mark.parametrize("case", list(INDEX_CASES))
def test_quad_terms_plain_matches_jax_composition(case, canonical):
    tri, pair = INDEX_CASES[case]
    rows = _batch(len(case), canonical)
    e = to_t(np.moveaxis(rows, -1, 0).copy())              # (8, B, N)
    got = tfm.quad_terms_planar_plain(e, tri, pair)
    assert got.shape == (8, len(tri) + len(pair), N)
    np.testing.assert_array_equal(to_np(got.movedim(0, -1)),
                                  _reference(rows, tri, pair))


def test_quad_terms_on_cpu_takes_the_plain_version():
    """On CPU tensors the wrapper runs the plain version once (counted
    under its own name) and launches nothing; the indices may be numpy
    arrays or CPU tensors, of any integer type."""
    tri, pair = INDEX_CASES["random"]
    e = to_t(np.moveaxis(_batch(3, False), -1, 0).copy())
    tfm.reset_counts()
    a = tfm.quad_terms_planar(e, tri, pair)
    b = tfm.quad_terms_planar(e, torch.from_numpy(tri.astype(np.int32)),
                              torch.from_numpy(pair))
    assert torch.equal(a, b)
    assert torch.equal(a, tfm.quad_terms_planar_plain(e, tri, pair))
    assert tfm.PLAIN_CALLS[tfm.QUAD]["cpu"] == 3
    assert tfm.LAUNCHES[tfm.QUAD] == 0
    assert sum(tfm.PLAIN_CALLS["mulmod_planar"].values()) == 0


@pytest.mark.parametrize("tri,pair,error", [
    ([[0, 1, B]], [[0, 1]], IndexError),          # an index = B
    ([[0, 1, 2]], [[-1, 0]], IndexError),         # a negative index
    ([[0, 1]], [[0, 1]], ValueError),             # triples of width 2
    ([[0, 1, 2]], [[0.0, 1.0]], ValueError),      # not integers
])
def test_quad_terms_rejects_bad_indices_before_running(tri, pair, error):
    """The argument check runs on the host before the plain version or a
    kernel: a row index outside [0, B) raises IndexError, as
    ``index_select`` does; nothing is counted."""
    e = to_t(np.moveaxis(_batch(4, True), -1, 0).copy())
    tfm.reset_counts()
    with pytest.raises(error):
        tfm.quad_terms_planar(e, np.asarray(tri), np.asarray(pair))
    assert sum(tfm.PLAIN_CALLS[tfm.QUAD].values()) == 0
    assert tfm.LAUNCHES[tfm.QUAD] == 0


def test_quad_terms_wants_host_indices():
    """Indices on a device raise in the argument check: checking them
    there would wait for the device."""
    e = to_t(np.moveaxis(_batch(5, True), -1, 0).copy())
    tri = torch.zeros((1, 3), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="on the host"):
        tfm.quad_indices(e, tri, np.zeros((0, 2), np.int32))
    with pytest.raises(ValueError, match=r"\(8, B, n\)"):
        tfm.quad_indices(e[:, 0], np.zeros((0, 3), np.int32),
                         np.zeros((0, 2), np.int32))
