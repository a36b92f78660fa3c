"""The port's int8 four-step encode engine (``ops/mxu_ntt.py``) on the CPU,
where the KR kernels run their plain versions, against the JAX package —
exact equality throughout:

* the host tables against ``mxu_ntt.build_codec_tables`` array for array,
  at (256, 1024) (g = 2), (512, 1024) (the 2k width) and (512, 2048)
  (R1 != C1, g = 1), and built by the port against carried across by
  ``convert.mxu_tables_from_numpy``;
* ``encode_rows_mxu`` against the JAX ``encode_rows_mxu(use_pallas=False)``,
  the port's own butterfly encode and ``field.golden``;
* the commit, check and open bodies with the engine on, in the planar and
  the AoS configuration, against the JAX bodies called eagerly with
  ``use_mxu=True`` as ``tests/test_mxu_ntt.py`` calls them."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ligero_prover_tpu.field import bn254 as F
from ligero_prover_tpu.field import golden
from ligero_prover_tpu.ops import mxu_ntt as jmx
from ligero_prover_tpu.ops import ntt as jntt
from ligero_prover_tpu.zkp import executor as jex
from ligero_prover_tpu_torch import convert
from ligero_prover_tpu_torch.field.limbs import ints_to_limbs, limbs_to_ints
from ligero_prover_tpu_torch.ops import mxu_ntt as tmx
from ligero_prover_tpu_torch.ops import mxu_renorm as tmr
from ligero_prover_tpu_torch.ops import ntt as tntt
from ligero_prover_tpu_torch.zkp import executor as tex

from _torch_helpers import rand_limbs, to_np, to_t
from test_torch_executor import _same, _sha_state

K, N, B, S = 256, 1024, 4, 12
GEOMETRIES = {"k": (256, 1024), "2k": (512, 1024), "wide": (512, 2048)}
_TABLES: dict = {}


def _tables(name):
    """(JAX tables, the port's host tables) of one geometry, built once."""
    if name not in _TABLES:
        w, n = GEOMETRIES[name]
        w_k, w_2k, w_n = F.generate_omegas(n // 4, n)
        root_w = w_k if w == n // 4 else w_2k
        _TABLES[name] = (jmx.build_codec_tables(w, n, root_w, w_n),
                         tmx.build_codec_tables(w, n, root_w, w_n))
    return _TABLES[name]


@pytest.fixture(scope="module")
def codecs():
    return jntt.RSCodec(K, N), tntt.RSCodec(K, N, "cpu")


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_tables_match_reference(name):
    jt, tt = _tables(name)
    assert tuple(tt["geom"]) == tuple(jt["geom"])
    for key in tmx.TABLE_KEYS:
        want = np.asarray(jt[key])
        assert tt[key].dtype == want.dtype and tt[key].shape == want.shape
        np.testing.assert_array_equal(tt[key], want)
    r1, c1, r2, c2, ratio = tt["geom"]
    assert (r1 * c1, r2 * c2) == GEOMETRIES[name]
    assert (c2 // r1 == 2) is (name == "k")


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_built_tables_equal_carried_across(name):
    jt, tt = _tables(name)
    built = tmx.tables_to_device(tt, "cpu")
    carried = convert.mxu_tables_from_numpy(jt, "cpu")
    assert built["geom"] == carried["geom"]
    for key in tmx.TABLE_KEYS:
        assert built[key].dtype == carried[key].dtype
        assert torch.equal(built[key], carried[key])
    assert built["w1"].dtype == torch.int8
    assert built["tw1"].dtype == torch.int32
    assert tmx.table_bytes(built) == sum(
        np.asarray(jt[key]).nbytes for key in tmx.TABLE_KEYS)


def test_codec_caches_tables_per_geometry_and_device(codecs):
    _, tc = codecs
    tabs = tc.mxu_tabs
    assert tntt.RSCodec(K, N, "cpu").mxu_tabs is tabs
    assert tabs["geom"] == _tables("k")[1]["geom"]
    assert torch.equal(tabs["wm"], torch.from_numpy(_tables("k")[1]["wm"]))


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_encode_matches_reference_and_butterflies(name):
    """Against the JAX engine (XLA twins of its kernels) and the port's
    constant-geometry encode of the same domain."""
    w, n = GEOMETRIES[name]
    jt, tt = _tables(name)
    rows = rand_limbs(np.random.default_rng(w + n), (3, w))
    tabs = tmx.tables_to_device(tt, "cpu")
    got = to_np(tmx.encode_rows_mxu(to_t(rows), tabs, n))
    want = np.asarray(jmx.encode_rows_mxu(jnp.asarray(rows), jt, n,
                                          use_pallas=False))
    np.testing.assert_array_equal(got, want)
    core = tmx.encode_rows_mxu_core(to_t(rows), tabs, n)
    assert core.shape == (8, 3, n)
    np.testing.assert_array_equal(to_np(core.movedim(0, -1)), want)
    tc = tntt.RSCodec(n // 4, n, "cpu")
    dom = tc.dom_k if w == n // 4 else tc.dom_2k
    cg = tntt.encode_rows_cg(to_t(rows), dom, tc.dom_n, n)
    np.testing.assert_array_equal(got, to_np(cg))


def test_encode_matches_golden(codecs):
    _, tc = codecs
    w_k, _, w_n = F.generate_omegas(K, N)
    rows = rand_limbs(np.random.default_rng(2), (2, K))
    out = to_np(tmx.encode_rows_mxu(to_t(rows), tc.mxu_tabs, N))
    for i in range(2):
        assert limbs_to_ints(out[i]) == golden.encode(
            limbs_to_ints(rows[i]), K, N, w_k, w_n)


def test_edge_values(codecs):
    """All-zero, all-(p-1) and single-element rows."""
    jc, tc = codecs
    rows = np.zeros((3, K, 8), np.uint32)
    ints_to_limbs([F.MODULUS - 1] * K, rows[1])
    ints_to_limbs([0] * (K - 1) + [12345], rows[2])
    want = np.asarray(jntt.encode_rows_cg(jnp.asarray(rows), jc.dom_k,
                                          jc.dom_n, N))
    got = to_np(tmx.encode_rows_mxu(to_t(rows), tc.mxu_tabs, N))
    np.testing.assert_array_equal(got, want)


def test_engine_runs_the_renorm_kernels_and_reuses_its_slot_buffer(codecs):
    _, tc = codecs
    tabs = tc.mxu_tabs
    rows = to_t(rand_limbs(np.random.default_rng(4), (B, K)))
    tmx.encode_rows_mxu_core(rows, tabs, N)
    buf = tabs["slots"]
    tmr.reset_counts()
    tmx.encode_rows_mxu_core(rows, tabs, N)
    assert tabs["slots"] is buf
    calls = {k: v["cpu"] for k, v in tmr.PLAIN_CALLS.items()}
    assert calls == {"digitize": 1, "renorm_mid": 2, "renorm_final": 1,
                     "renorm_pack": 0}
    with pytest.raises(ValueError, match="geometry"):
        tmx.encode_rows_mxu_core(rows[:, :K // 2], tabs, N)


@pytest.mark.parametrize("flag,cpu,cuda", [(None, False, tntt.MXU_ON_CUDA),
                                           (True, True, True),
                                           (False, False, False)])
def test_use_mxu_selects_the_engine(monkeypatch, flag, cpu, cuda):
    """Auto is off for CPU tensors; the flag overrides it and a new
    executor follows it, for k-width rows only."""
    monkeypatch.setattr(tntt, "USE_MXU", flag)
    assert tntt._mxu_use("cpu") is cpu
    assert tntt._mxu_use("cuda") is cuda
    ex = tex.TorchExecutor(K, N, B, "cpu")
    assert ex.use_mxu is cpu
    assert (ex._mxu_tabs() is not None) is cpu
    assert ex._mxu_tabs(width_2k=True) is None


# ---- executor bodies -----------------------------------------------------

@pytest.fixture(scope="module")
def body_inputs():
    gen = np.random.default_rng(3)
    tri_r, pair_r = rand_limbs(gen, (4,)), rand_limbs(gen, (4,))
    tri_r[2:] = 0                       # padded entries carry zero scalars
    pair_r[1:] = 0
    return {
        "rows": rand_limbs(gen, (B, K)), "rands": rand_limbs(gen, (B, K)),
        "code_rs": rand_limbs(gen, (B,)),
        "tri_idx": np.array([[0, 1, 2], [1, 2, 3], [0, 0, 0], [0, 0, 0]],
                            np.int32),
        "tri_r": tri_r,
        "pair_idx": np.array([[0, 1], [0, 0], [0, 0], [0, 0]], np.int32),
        "pair_r": pair_r,
        "idx": np.sort(gen.choice(N, S, replace=False)).astype(np.int32),
        "accs": tuple(rand_limbs(gen, (N,)) for _ in range(3)),
        "sha": _sha_state(gen, N, True),
    }


@pytest.fixture(scope="module")
def reference_bodies(codecs, body_inputs):
    """The JAX bodies, eager, engine on, AoS (on the CPU the reference's
    planar layout is interpret-mode Pallas; its own tests hold the two
    layouts equal)."""
    jc, _ = codecs
    d = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
         for k, v in body_inputs.items()}
    tabs = jc.mxu_tabs
    state, pending, hp = (jnp.asarray(v) for v in body_inputs["sha"])
    accs = tuple(jnp.asarray(a) for a in body_inputs["accs"])
    quads = (d["tri_idx"], d["tri_r"], d["pair_idx"], d["pair_r"])
    out = {"commit": jex._commit_body(
        state, pending, hp, d["rows"], jnp.asarray(3, jnp.int32), jc.dom_k,
        jc.dom_n, N, False, tabs, True)}
    for rz in (False, True):
        rands = jnp.zeros_like(d["rands"]) if rz else d["rands"]
        out["check", rz] = jex._check_body(
            *accs, d["rows"], rands, d["code_rs"], *quads, jc.dom_k,
            jc.dom_n, N, False, tabs, True, rz)
    out["open"] = jex._open_body(d["rows"], d["idx"], jc.dom_k, jc.dom_n, N,
                                 False, tabs, True)
    return out


@pytest.fixture(scope="module", params=["planar", "aos"])
def mxu_executor(request):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tntt, "USE_MXU", True)
        mp.setattr(tntt, "USE_PLANAR", request.param == "planar")
        ex = tex.TorchExecutor(K, N, B, "cpu")
    assert ex.use_mxu and ex.use_planar is (request.param == "planar")
    return ex


def test_mxu_commit_step(mxu_executor, body_inputs, reference_bodies):
    tmr.reset_counts()
    got = mxu_executor.commit_step(
        convert.sha_from_numpy(body_inputs["sha"]), body_inputs["rows"], 3)
    _same(got, reference_bodies["commit"])
    assert tmr.PLAIN_CALLS["renorm_final"]["cpu"] == 1
    # 2k rows keep the butterfly encode
    rows2k = rand_limbs(np.random.default_rng(5), (2, 2 * K))
    sha = convert.sha_from_numpy(body_inputs["sha"])
    mxu_executor.commit_step(sha, rows2k, 2, width_2k=True)
    assert tmr.PLAIN_CALLS["renorm_final"]["cpu"] == 1


@pytest.mark.parametrize("rands_zero", [False, True])
def test_mxu_check_step(mxu_executor, body_inputs, reference_bodies,
                        rands_zero):
    d = body_inputs
    rands = np.zeros_like(d["rands"]) if rands_zero else d["rands"]
    tmr.reset_counts()
    got = mxu_executor.check_step(
        convert.accs_from_numpy(d["accs"]), d["rows"], rands, d["code_rs"],
        d["tri_idx"], d["tri_r"], d["pair_idx"], d["pair_r"],
        rands_zero=rands_zero)
    _same(got, reference_bodies["check", rands_zero])
    assert tmr.PLAIN_CALLS["renorm_final"]["cpu"] == (1 if rands_zero else 2)


def test_mxu_open_step(mxu_executor, body_inputs, reference_bodies):
    got = mxu_executor.open_step(body_inputs["rows"], body_inputs["idx"])
    _same(got, reference_bodies["open"])


def test_mxu_steps_equal_butterfly_steps(mxu_executor, body_inputs):
    """The two engines are interchangeable mid-protocol: every step of an
    executor with the engine on equals the same step with it off."""
    d = body_inputs
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tntt, "USE_PLANAR", mxu_executor.use_planar)
        off = tex.TorchExecutor(K, N, B, "cpu")
    assert not off.use_mxu
    outs = [(ex.commit_step(convert.sha_from_numpy(d["sha"]), d["rows"], B),
             ex.check_step(convert.accs_from_numpy(d["accs"]), d["rows"],
                           d["rands"], d["code_rs"], d["tri_idx"],
                           d["tri_r"], d["pair_idx"], d["pair_r"]),
             ex.open_step(d["rows"], d["idx"]))
            for ex in (mxu_executor, off)]
    _same(outs[0], outs[1])
