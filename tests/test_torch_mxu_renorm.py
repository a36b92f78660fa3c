"""The plain versions of the port's renormalisation kernels (KR: digitize,
renorm_mid, renorm_final, renorm_pack) and of KE mulmod_fma against the JAX
package, on the same numpy inputs made from a seed — exact equality.

* Fast tier: the whole-array XLA twins of the Pallas kernels
  (``digitize_xla``, ``renorm_mid_xla``, ``renorm_final_xla``,
  ``renorm_pack_xla`` of ``ops/pallas/mxu_renorm.py``), which the JAX
  package's own tests use on the CPU, and for ``mulmod_fma`` the XLA field
  ops and the Python-int model.
* Slow tier: the Pallas wrappers in interpret mode at one (., 1024) tile.

Slot inputs are real: a level product of the built k=256 tables on random
canonical rows, plus an extreme set (every input digit +127 against the
table, the largest V the contract allows, and all-zero slots).  Random
int32 slots, or every digit -128 (V < 0), would break the kernels' contract
(V >= 0, |S_e| < 2^28), outside which the reference's 16-bit digit sums
wrap and its result is not defined."""

import numpy as np
import pytest
import torch

from ligero_prover_tpu.field import bn254 as F
from ligero_prover_tpu.ops import fieldops as jfo
from ligero_prover_tpu.ops.pallas import fieldmul as jfm
from ligero_prover_tpu.ops.pallas import mxu_renorm as jmr
from ligero_prover_tpu_torch.field.limbs import ints_to_limbs, limbs_to_ints
from ligero_prover_tpu_torch.ops import fieldmul as tfm
from ligero_prover_tpu_torch.ops import mxu_ntt as tmx
from ligero_prover_tpu_torch.ops import mxu_renorm as tmr

from _torch_helpers import EDGES, NONCANONICAL, rand_limbs, to_np, to_t

K, N, B = 256, 1024, 4
P = 1024                      # one (., 8, 128) Pallas tile


@pytest.fixture
def interpret_mode():
    jfm.FORCE_INTERPRET = True
    yield
    jfm.FORCE_INTERPRET = None


@pytest.fixture(scope="module")
def tabs():
    w_k, _, w_n = F.generate_omegas(K, N)
    return tmx.tables_to_device(tmx.build_codec_tables(K, N, w_k, w_n), "cpu")


def _rows(seed):
    """(8, B, K) canonical planes with the edge values in the first slots."""
    rows = rand_limbs(np.random.default_rng(seed), (B, K))
    rows[0, :len(EDGES)] = ints_to_limbs(EDGES)
    return np.ascontiguousarray(np.moveaxis(rows, -1, 0))


def _level1_slots(tabs, packed):
    """Slots (64, R1, B, C1) of the first level product on packed digits
    (8, B, K), copied out of the engine's buffer."""
    r1, c1 = tabs["geom"][:2]
    return tmx.level1_slots(packed.view(8, B, r1, c1), tabs).clone()


def _slot_sets(tabs):
    """name -> (64, R1, B, C1) int32 slots inside the kernels' contract."""
    real = tmr.digitize_plain(to_t(_rows(3)))
    sets = {"real": _level1_slots(tabs, real),
            "max_digits": _level1_slots(
                tabs, torch.full_like(real, 0x7F7F7F7F))}
    sets["zero"] = torch.zeros_like(sets["real"])
    return sets


SETS = ["real", "max_digits", "zero"]


def test_digitize_plain_matches_xla_and_ints():
    x = _rows(1).reshape(8, -1)
    got = to_np(tmr.digitize_plain(to_t(x)))
    np.testing.assert_array_equal(got, np.asarray(jmr.digitize_xla(x)))
    # the 32 signed digits of each value sum back to it
    digits = got.view(np.int8).reshape(8, -1, 4).transpose(1, 0, 2) \
        .reshape(-1, 32).astype(object)
    vals = [sum(int(d) << (8 * i) for i, d in enumerate(row))
            for row in digits[:64]]
    assert vals == limbs_to_ints(x.T[:64])


@pytest.mark.parametrize("name", SETS)
def test_renorm_final_plain_matches_xla(tabs, name):
    slots = _slot_sets(tabs)[name]
    got = to_np(tmr.renorm_final_plain(slots))
    want = np.asarray(jmr.renorm_final_xla(slots.reshape(64, -1).numpy()))
    np.testing.assert_array_equal(got.reshape(8, -1), want)


@pytest.mark.parametrize("name", SETS)
def test_renorm_pack_plain_matches_xla(tabs, name):
    slots = _slot_sets(tabs)[name]
    got = to_np(tmr.renorm_pack_plain(slots))
    want = np.asarray(jmr.renorm_pack_xla(slots.reshape(64, -1).numpy()))
    np.testing.assert_array_equal(got.reshape(8, -1), want)


@pytest.mark.parametrize("name", SETS)
def test_renorm_mid_plain_matches_xla(tabs, name):
    """The table read unbroadcast, (8, R1, 1, C1), equals the reference on
    the table broadcast over the batch, as the reference's caller makes
    it."""
    slots = _slot_sets(tabs)[name]
    tw = tabs["tw1"]
    full = tw.expand((8,) + slots.shape[1:]).contiguous()
    want = np.asarray(jmr.renorm_mid_xla(slots.reshape(64, -1).numpy(),
                                         to_np(full).reshape(8, -1)))
    for table in (tw, full):
        got = to_np(tmr.renorm_mid_plain(slots, table))
        np.testing.assert_array_equal(got.reshape(8, -1), want)


def test_renorm_final_is_the_scaled_sum(tabs):
    """renorm_final of a level product is W[s, :] . x mod p (the table's
    2^256 cancelled by the REDC), checked on Python ints."""
    r1, c1 = tabs["geom"][:2]
    w_k = F.generate_omegas(K, N)[0]
    w_inv = pow(w_k, F.MODULUS - 2, F.MODULUS)
    x = _rows(5)
    slots = _level1_slots(tabs, tmr.digitize_plain(to_t(x)))
    got = to_np(tmr.renorm_final_plain(slots))             # (8, r1, B, c1)
    xi = np.array(limbs_to_ints(x.reshape(8, -1).T), object) \
        .reshape(B, r1, c1)
    for s, b, c in ((0, 0, 0), (3, 1, 5), (r1 - 1, B - 1, c1 - 1)):
        want = sum(pow(w_inv, c1 * r * s, F.MODULUS) * int(xi[b, r, c])
                   for r in range(r1)) % F.MODULUS
        assert limbs_to_ints(got[:, s, b, c][None])[0] == want


def test_mulmod_fma_plain_matches_xla_and_ints():
    gen = np.random.default_rng(6)
    edges = ints_to_limbs(NONCANONICAL + EDGES)
    for canonical in (True, False):
        acc, x, y = (rand_limbs(gen, (P,), canonical) for _ in range(3))
        if not canonical:
            acc[:len(edges)], x[:len(edges)] = edges, edges[::-1]
            y[:len(edges)] = edges
        got = to_np(tfm.mulmod_fma_planar_plain(
            *(to_t(np.ascontiguousarray(v.T)) for v in (acc, x, y)))).T
        want = np.asarray(jfo.addmod(acc, jfo.mulmod(x, y)), np.uint32)
        np.testing.assert_array_equal(got, want)
        if canonical:
            ints = [limbs_to_ints(v) for v in (acc, x, y)]
            assert limbs_to_ints(got) == [
                F.addmod(a, F.mulmod(u, v)) for a, u, v in zip(*ints)]


def test_wrappers_take_plain_versions_on_cpu(tabs):
    slots = _slot_sets(tabs)["real"]
    x = to_t(_rows(7))
    before = {k: v["cpu"] for k, v in tmr.PLAIN_CALLS.items()}
    assert torch.equal(tmr.digitize(x), tmr.digitize_plain(x))
    assert torch.equal(tmr.renorm_final(slots), tmr.renorm_final_plain(slots))
    assert torch.equal(tmr.renorm_pack(slots), tmr.renorm_pack_plain(slots))
    assert torch.equal(tmr.renorm_mid(slots, tabs["tw1"]),
                       tmr.renorm_mid_plain(slots, tabs["tw1"]))
    for name, calls in tmr.PLAIN_CALLS.items():
        assert calls["cpu"] == before[name] + 2
    assert all(v == 0 for v in tmr.LAUNCHES.values())
    acc = to_t(_rows(8))
    assert torch.equal(tfm.mulmod_fma_planar(acc, x, x),
                       tfm.mulmod_fma_planar_plain(acc, x, x))
    assert tfm.LAUNCHES["mulmod_fma_planar"] == 0
    tmr.reset_counts()
    assert all(not c for c in tmr.PLAIN_CALLS.values())


def test_twiddle_index_shapes():
    assert tmr.twiddle_index("t", (16, 8, 16), (16, 1, 16)) == (128, 16)
    assert tmr.twiddle_index("t", (16, 8, 16), (16, 8, 16)) == (2048, 2048)
    assert tmr.twiddle_index("t", (2048,), (2048,)) == (2048, 2048)
    with pytest.raises(ValueError):
        tmr.twiddle_index("t", (16, 8, 16), (1, 8, 16))
    with pytest.raises(ValueError):
        tmr.renorm_mid(torch.zeros((64, 4, 2, 4), dtype=torch.int32),
                       torch.zeros((8, 4, 2, 1), dtype=torch.int32))


# ---- slow tier: interpret-mode Pallas at one tile ------------------------

def _tile(tabs, name):
    """(64, P) slots and (8, P) twiddles: the head of a real slot set."""
    slots = _slot_sets(tabs)[name]
    tw = tabs["tw1"].expand((8,) + slots.shape[1:])
    return (slots.reshape(64, -1)[:, :P].contiguous(),
            tw.reshape(8, -1)[:, :P].contiguous())


@pytest.mark.slow
def test_digitize_plain_matches_pallas(interpret_mode):
    x = _rows(11).reshape(8, -1)[:, :P].copy()
    want = np.asarray(jmr.digitize(x), np.uint32)
    np.testing.assert_array_equal(to_np(tmr.digitize_plain(to_t(x))), want)


@pytest.mark.slow
@pytest.mark.parametrize("kind", ["final", "pack", "mid"])
def test_renorm_plain_matches_pallas(interpret_mode, tabs, kind):
    slots, tw = _tile(tabs, "real")
    if kind == "mid":
        want = jmr.renorm_mid(slots.numpy(), to_np(tw))
        got = tmr.renorm_mid_plain(slots, tw)
    else:
        want = getattr(jmr, f"renorm_{kind}")(slots.numpy())
        got = getattr(tmr, f"renorm_{kind}_plain")(slots)
    np.testing.assert_array_equal(to_np(got), np.asarray(want, np.uint32))


@pytest.mark.slow
def test_mulmod_fma_plain_matches_pallas(interpret_mode):
    gen = np.random.default_rng(12)
    acc, x, y = (np.ascontiguousarray(rand_limbs(gen, (P,)).T)
                 for _ in range(3))
    want = np.asarray(jfm.mulmod_fma_planar(acc, x, y), np.uint32)
    got = tfm.mulmod_fma_planar_plain(to_t(acc), to_t(x), to_t(y))
    np.testing.assert_array_equal(to_np(got), want)
