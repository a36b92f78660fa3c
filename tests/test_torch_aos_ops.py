"""The AoS limb ops on the CPU: ``fo.addmod``/``fo.submod`` (KA on CUDA
tensors) and the verifier's ordered sums (KF: ``fm.masked_sum_aos`` and
the fused ``fm.masked_mulsum_aos``), their dispatch, their parity with the
JAX package, the operand views KA reads in place, and the independence of
every other kernel's plain version from them.

* On CPU tensors ``fo.addmod``, ``fo.submod`` and both KF wrappers run
  the plain versions and launch nothing; a tensor on neither the CPU nor a
  card is refused.
* KF's fold equals the JAX ``_masked_sum`` on non-canonical terms at
  B = 16, and ``fo.addmod``/``fo.submod`` equal the JAX ops in the
  broadcast forms of the port's call sites.  Exact.
* ``fm.aos_view`` reads the call sites' operands in place (no copy).
* No kernel's plain version, nor the planar NTT scans on CPU tensors,
  reaches the KA/KF wrappers: they are patched to raise while every
  ``*_plain`` of ``ops/fieldmul.py`` runs.
* The executor's mask step and the verifier's quadratic test reach KA
  through its wrapper.

The element functions themselves are held in ``tests/test_torch_aos_core.py``
(g++), and the kernels on the card in ``tests/test_torch_kernels.py``.

    python -m pytest tests/test_torch_aos_ops.py -q
"""

import inspect

import jax
import numpy as np
import pytest
import torch

from ligero_prover_tpu.ops import fieldops as jfo
from ligero_prover_tpu.zkp import executor as jex
from ligero_prover_tpu_torch.field.limbs import ints_to_limbs
from ligero_prover_tpu_torch.ops import fieldmul as tfm
from ligero_prover_tpu_torch.ops import fieldops as tfo
from ligero_prover_tpu_torch.ops import ntt as tntt
from ligero_prover_tpu_torch.zkp import executor as tex

from _torch_helpers import EDGES, NONCANONICAL, rand_limbs, to_np, to_t

WRAPPERS = ("addmod_aos", "submod_aos", "masked_sum_aos",
            "masked_mulsum_aos")


def test_dispatch_on_cpu_runs_plain_and_counts_no_launch():
    gen = np.random.default_rng(11)
    x, y = to_t(rand_limbs(gen, (5,))), to_t(rand_limbs(gen, (5,)))
    terms = to_t(rand_limbs(gen, (3, 5)))
    tfm.reset_counts()
    tfo.addmod(x, y)
    tfo.submod(x, y)
    tfo.submod(y, x)
    tfm.masked_sum_aos(x, terms)
    tfm.masked_mulsum_aos(x, terms, terms[:, :1])
    assert set(tfm.LAUNCHES.values()) == {0}
    assert {k: dict(v) for k, v in tfm.PLAIN_CALLS.items() if v} == {
        "addmod_aos": {"cpu": 1}, "submod_aos": {"cpu": 2},
        "masked_sum_aos": {"cpu": 1}, "masked_mulsum_aos": {"cpu": 1}}
    meta = torch.empty((4, 8), dtype=torch.int32, device="meta")
    for fn in (tfo.addmod, tfo.submod, tfm.masked_sum_aos):
        with pytest.raises(ValueError):
            fn(meta, meta if fn is not tfm.masked_sum_aos else meta[None])
    with pytest.raises(ValueError):
        tfm.masked_mulsum_aos(meta, meta[None], meta[None])


def _noncanonical_terms(gen, rows, n):
    """Non-canonical (rows, n, 8) terms and (n, 8) acc, with the edge and
    non-canonical values in the first columns and columns of 2^256 - 1."""
    terms = rand_limbs(gen, (rows, n), False)
    acc = rand_limbs(gen, (n,), False)
    vals = ints_to_limbs(NONCANONICAL + EDGES)
    terms[:, :len(vals)] = vals
    terms[1::2, :len(vals)] = vals[::-1]
    acc[:len(vals)] = vals
    terms[:, -3:] = 0xFFFFFFFF
    return acc, terms


@pytest.mark.parametrize("n", [192, 1000])
def test_masked_sum_matches_jax_on_noncanonical_terms(n):
    acc, terms = _noncanonical_terms(np.random.default_rng(n), 16, n)
    got = tfm.masked_sum_aos(to_t(acc), to_t(terms))
    want = jax.jit(jex._masked_sum)(acc, terms)
    np.testing.assert_array_equal(to_np(got), np.asarray(want, np.uint32))


def _call_forms(gen):
    """(label, x, y) numpy operands as the call sites pass them, and the
    torch views that the port builds of them."""
    k, b, h = 32, 2, 8
    rows = rand_limbs(gen, (b, 2 * h), False)
    tw = rand_limbs(gen, (h,), False)
    const = rand_limbs(gen, (), False)
    arena = rand_limbs(gen, (k,), False)
    return [
        ("arena + constant", arena, const,
         lambda: (to_t(arena), to_t(const))),
        ("const_sub", np.broadcast_to(const, arena.shape), arena,
         lambda: (to_t(const).expand(k, 8), to_t(arena))),
        ("DIF halves", rows[:, :h], rows[:, h:],
         lambda: (to_t(rows)[:, :h], to_t(rows)[:, h:])),
        ("DIT even lanes and twiddle",
         rows.reshape(b, h, 2, 8)[:, :, 0], np.broadcast_to(tw, (b, h, 8)),
         lambda: (to_t(rows).reshape(b, h, 2, 8)[:, :, 0], to_t(tw))),
    ]


@pytest.mark.parametrize("name,jop", [("addmod", jfo.addmod),
                                      ("submod", jfo.submod)])
def test_fieldops_match_jax_in_the_call_forms(name, jop):
    for label, x, y, views in _call_forms(np.random.default_rng(3)):
        got = getattr(tfo, name)(*views())
        want = jax.jit(jop)(np.ascontiguousarray(x), np.ascontiguousarray(y))
        np.testing.assert_array_equal(to_np(got), np.asarray(want),
                                      err_msg=label)


def _shares_storage(v, t):
    return v.untyped_storage().data_ptr() == t.untyped_storage().data_ptr()


@pytest.mark.parametrize("form", ["arena constant", "const_sub", "twiddle",
                                  "dif half", "dit lanes", "decode lanes",
                                  "coset half", "contiguous"])
def test_aos_view_reads_call_sites_in_place(form):
    """Each call site's operand is read in place: the view's tensor shares
    the operand's storage and its (div, outer, inner) walk the elements
    the broadcast result reads."""
    gen = np.random.default_rng(4)
    b, h, k = 3, 16, 64
    rows = to_t(rand_limbs(gen, (b, 2 * h)))
    t, shape = {
        "arena constant": (to_t(rand_limbs(gen, ())), (k, 8)),
        "const_sub": (to_t(rand_limbs(gen, (1,))).expand(k, 8), (k, 8)),
        "twiddle": (to_t(rand_limbs(gen, (h,))), (b, h, 8)),
        "dif half": (rows[:, h:], (b, h, 8)),
        "dit lanes": (rows.reshape(b, h, 2, 8)[:, :, 1], (b, h, 8)),
        "decode lanes": (rows.reshape(b, h // 2, 4, 8)[:, :, 2],
                         (b, h // 2, 8)),
        "coset half": (rows.reshape(b, 4, 2 * h // 4, 8)[:, :, :h // 4],
                       (b, 4, h // 4, 8)),
        "contiguous": (rows, (b, 2 * h, 8)),
    }[form]
    v, div, outer, inner = tfm.aos_view(t, shape)
    assert _shares_storage(v, t)
    n = int(np.prod(shape[:-1]))
    base = v.storage_offset()
    flat = torch.as_strided(v, (v.untyped_storage().nbytes() // 4,), (1,),
                            0).reshape(-1, 8)
    want = t.expand(shape).reshape(n, 8)
    d = min(div, n)
    for i in range(n):
        e = base // 8 + (i // d) * outer + (i % d) * inner
        assert torch.equal(flat[e], want[i]), (form, i)


def test_aos_view_copies_what_it_cannot_walk():
    """Three element axes that do not merge, and a limb axis that is not
    contiguous, are read from a contiguous copy."""
    gen = np.random.default_rng(8)
    wide = to_t(rand_limbs(gen, (3, 4, 5))).permute(1, 0, 2, 3)
    v, div, outer, inner = tfm.aos_view(wide, wide.shape)
    assert not _shares_storage(v, wide) and v.is_contiguous()
    assert (div, inner) == (60, 1) and torch.equal(v, wide)
    planes = to_t(rand_limbs(gen, (6,))).T.contiguous().T   # limb stride 6
    v, div, outer, inner = tfm.aos_view(planes, planes.shape)
    assert not _shares_storage(v, planes) and torch.equal(v, planes)


def _plain_args(gen):
    """Arguments of every plain version of ``ops/fieldmul.py`` at a small
    size: AoS (4, 8) operands, (8, 2, 16) limb planes."""
    def aos(shape):
        return to_t(rand_limbs(gen, shape, False))

    def planes(shape):
        return aos(shape).movedim(-1, 0).contiguous()
    tws = planes((4, 8)).movedim(1, 0).contiguous()      # (S, 8, N/2)
    tri = np.array([[0, 1, 0], [1, 1, 0]])
    pair = np.array([[1, 0]])
    return {
        "mont_mul_plain": (aos((4,)), aos((4,))),
        "mulmod_plain": (aos((4,)), aos(())),
        "addmod_aos_plain": (aos((4,)), aos(())),
        "submod_aos_plain": (aos(()).expand(4, 8), aos((4,))),
        "masked_sum_aos_plain": (aos((4,)), aos((3, 4))),
        "masked_mulsum_aos_plain": (aos((4,)), aos((3, 4)), aos((3, 1))),
        "addmod_planar_plain": (planes((2, 16)), planes((2, 16))),
        "submod_planar_plain": (planes((2, 16)), planes((2, 16))),
        "mont_mul_planar_plain": (planes((2, 16)), planes((2, 1))),
        "mulmod_planar_plain": (planes((2, 16)), planes((2, 16))),
        "mont_mul_scalar_planar_plain": (planes((2, 16)), aos(())),
        "mont_mul_tiled_planar_plain": (planes((2, 16)), planes((16,))),
        "mulmod_fma_planar_plain": (planes((2, 16)), planes((2, 16)),
                                    planes((2, 16))),
        "quad_terms_planar_plain": (planes((2, 16)), tri, pair),
        "quad_acc_planar_plain": (aos((16,)), planes((2, 16)), tri, pair,
                                  aos((2,)), aos((1,))),
        "butterfly_dit_plain": (planes((2, 16)), tws[0]),
        "butterfly_dif_plain": (planes((2, 16)), tws[0]),
        "butterfly_dit_pass_plain": (planes((2, 16)), tws, 0, 4),
        "butterfly_dif_pass_plain": (planes((2, 16)), tws, 0, 4),
    }


def _refuse(name):
    def wrapper(*args, **kwargs):
        raise AssertionError(f"a plain version reached {name}")
    return wrapper


def test_plain_versions_do_not_reach_the_aos_wrappers(monkeypatch):
    """Every plain version of ``ops/fieldmul.py``, and the planar NTT scans
    on CPU tensors (the KB/KE plain passes), run with KA's and KF's
    wrappers patched to raise: their plain references stay independent of
    the kernels they would be compared against on the card."""
    args = _plain_args(np.random.default_rng(9))
    plain = {name for name, fn in inspect.getmembers(tfm, inspect.isfunction)
             if name.endswith("_plain") and not name.startswith("_")
             and fn.__module__ == tfm.__name__}
    assert plain == set(args)
    for name in WRAPPERS:
        monkeypatch.setattr(tfm, name, _refuse(name))
    tfm.reset_counts()
    for name, a in args.items():
        getattr(tfm, name)(*a)
    k, n = 16, 64
    codec = tntt.RSCodec(k, n, "cpu")
    rows = to_t(rand_limbs(np.random.default_rng(2), (2, k)))
    cws = tntt.encode_rows_cg_planar_core(rows, codec.dom_k, codec.dom_n, n)
    tntt.decode_rows_cg_planar(cws.movedim(0, -1).contiguous(), codec.dom_k,
                               codec.dom_n, k)
    tabs = tntt.coset_tables(k, n, 2, 1)
    tntt.encode_rows_coset_planar_core(
        tntt.coset_coeffs(rows, codec.dom_k), tabs)
    assert set(tfm.LAUNCHES.values()) == {0}
    # KA's and KF's plain versions ran once each, called above by name
    assert {k: dict(tfm.PLAIN_CALLS[k]) for k in WRAPPERS} == \
        {k: {"cpu": 1} for k in WRAPPERS}


def test_executor_steps_run_through_ka():
    """The mask step's three adds into the accumulators and the
    verifier's two subtractions (e_x*e_y - e_z, and x - y of the pairs)
    are main-path callers, not plain versions: they go through the KA
    wrapper (here its plain version, on CPU tensors)."""
    k, n, b = 16, 64, 3
    ex = tex.TorchExecutor(k, n, b, "cpu")
    gen = np.random.default_rng(12)
    accs = tuple(to_t(rand_limbs(gen, (n,))) for _ in range(3))
    tfm.reset_counts()
    ex.mask_step(accs, rand_limbs(gen, (k,)), rand_limbs(gen, (2 * k,)),
                 rand_limbs(gen, (2 * k,)))
    assert tfm.PLAIN_CALLS["addmod_aos"]["cpu"] == 3
    e, r = (to_t(rand_limbs(gen, (b, 6))) for _ in range(2))
    sums = [to_t(rand_limbs(gen, (6,))) for _ in range(3)]
    scalars = [to_t(rand_limbs(gen, (b,))) for _ in range(3)]
    tri = torch.tensor([[0, 1, 2], [1, 1, 0], [2, 0, 1]])
    pair = torch.tensor([[0, 1], [2, 2], [1, 0]])
    tfm.reset_counts()
    tex._verify_terms(*sums, e, r, scalars[0], tri, scalars[1], pair,
                      scalars[2])
    assert tfm.PLAIN_CALLS["submod_aos"]["cpu"] == 2
