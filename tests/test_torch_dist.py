"""The column-sharded prover over several processes (``parallel/mesh.py``
with a ``torch.distributed`` process group) on the CPU, under gloo.

Each case spawns P ranks of ``_torch_dist_worker.py``, L CPU shards each
(D = P*L), at k=256 and batch_rows=8; they meet through a ``TCPStore``
that the launcher binds on ``tcp://127.0.0.1`` at a port the system picks
and holds until they end (a port picked, freed and handed on could be
taken meanwhile).  Every group is started when the module's first test
runs, so the groups run beside one another and beside the references this
process makes.  Held bit for bit (tolerance 0):

* every rank's proof equals every other rank's, the port's one-process
  proof and the JAX single-device proof, and the port's verifier accepts
  it;
* every step's gathered output equals the JAX ``ShardedExecutor``'s on the
  8 virtual CPU devices that ``conftest.py`` makes;
* ranks agree on the encoding seed, or all raise; unequal meshes raise on
  every rank; a one-process mesh makes no ``torch.distributed`` call.

Every launch has a time limit and a rank that outlives it is killed.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from ligero_prover_tpu_torch import prover as tprover, verifier as tverifier
from ligero_prover_tpu_torch.parallel.mesh import ShardedExecutor, make_mesh

from _torch_helpers import rand_limbs
from _torch_prove_common import SEED, _wat, make_env, make_proofs
from bench.e2e_prove import make_wat

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "_torch_dist_worker.py")
BIT_DECOMPOSE = os.path.join(HERE, "guests", "bit_decompose.wat")
K, N, B, S = 256, 1024, 8, 192
LAUNCH_TIMEOUT = 420        # seconds a group may take, start-up included
COLLECTIVE_TIMEOUT = 300    # the process group's own limit per collective


class Group:
    """P ranks of the worker, started at once; :meth:`results` waits for
    them (within LAUNCH_TIMEOUT of the start), kills any rank still
    running, and returns each rank's (exit code, RESULT dict or None,
    stderr)."""

    def __init__(self, ranks: list[dict]):
        self.store = dist.TCPStore("127.0.0.1", 0, len(ranks),
                                   is_master=True, wait_for_workers=False)
        port = self.store.port
        env = dict(os.environ, OMP_NUM_THREADS="1")
        self.start = time.monotonic()
        self.procs = [subprocess.Popen(
            [sys.executable, WORKER, json.dumps(dict(
                cfg, rank=r, world=len(ranks), port=port,
                timeout=COLLECTIVE_TIMEOUT))],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env) for r, cfg in enumerate(ranks)]
        self._results = None

    def results(self) -> list:
        if self._results is None:
            results = []
            try:
                for p in self.procs:
                    left = self.start + LAUNCH_TIMEOUT - time.monotonic()
                    out, err = p.communicate(timeout=max(left, 1))
                    lines = [ln for ln in out.splitlines()
                             if ln.startswith("RESULT ")]
                    results.append((p.returncode, json.loads(
                        lines[-1][7:]) if lines else None, err))
            finally:
                self.kill()
            self._results = results
        return self._results

    def ok(self) -> list[dict]:
        """Each rank's RESULT, after asserting that every rank exited 0."""
        for rc, res, err in self.results():
            assert rc == 0 and res is not None, f"rank failed:\n{err}"
        return [res for _, res, _ in self.results()]

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


def _prove(out_dir, program, world, local, seeds=None):
    seeds = seeds or [SEED.hex()] * world
    return [{"mode": "prove", "program": program, "k": K, "batch_rows": B,
             "seed": seed, "local": local, "out": str(out_dir)}
            for seed in seeds]


# name -> (program, P, L)
PROOFS = {"make_wat3-P2xL2": ("make_wat3", 2, 2),
          "make_wat3-P4xL1": ("make_wat3", 4, 1),
          "make_wat3-P2xL4": ("make_wat3", 2, 4),
          "bit_decompose-P2xL2": ("bit_decompose", 2, 2)}
# name -> (P, L): D = 8, as the JAX executor's 8 devices
STEPS = {"P2xL4": (2, 4), "P4xL2": (4, 2)}


def _step_inputs(path):
    """The steps' inputs, made from a numpy seed, as the JAX side and
    every rank read them."""
    gen = np.random.default_rng(2026)
    tri_r, pair_r = rand_limbs(gen, (B,)), rand_limbs(gen, (B,))
    tri_r[5:] = 0
    pair_r[3:] = 0
    inp = {
        "state": gen.integers(0, 2 ** 32, (8, N), dtype=np.uint64)
        .astype(np.uint32),
        "pending": rand_limbs(gen, (N,), False),
        "has_pending": np.bool_(True), "valid": np.int64(5),
        "rows": rand_limbs(gen, (B, K)), "rands": rand_limbs(gen, (B, K)),
        "code_rs": rand_limbs(gen, (B,)),
        "tri_idx": gen.integers(0, B, (B, 3)).astype(np.int32),
        "pair_idx": gen.integers(0, B, (B, 2)).astype(np.int32),
        "tri_r": tri_r, "pair_r": pair_r,
        "code_row": rand_limbs(gen, (K,)),
        "linear_row": rand_limbs(gen, (2 * K,)),
        "quad_row": rand_limbs(gen, (2 * K,)),
        "idx": np.sort(gen.choice(N, S, replace=False)).astype(np.int32),
        "rows_2k": rand_limbs(gen, (2, 2 * K)),
        **{f"acc{i}": rand_limbs(gen, (N,)) for i in range(3)}}
    np.savez(path, **inp)
    return inp


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Every group of ranks, started together; killed at the end."""
    base = tmp_path_factory.mktemp("dist")
    wat = base / "make_wat3.wat"
    wat.write_text(make_wat(3))
    programs = {"make_wat3": str(wat), "bit_decompose": BIT_DECOMPOSE}
    inputs = base / "inputs.npz"
    step_inputs = _step_inputs(inputs)
    started = {}
    for name, (prog, world, local) in PROOFS.items():
        out = base / name
        out.mkdir()
        started[name] = Group(_prove(out, programs[prog], world, local))
    for name, (world, local) in STEPS.items():
        out = base / f"steps-{name}"
        out.mkdir()
        started[f"steps-{name}"] = Group([{
            "mode": "steps", "inputs": str(inputs), "k": K,
            "local": local, "out": str(out)}] * world)
    for name, seeds in (("seed-none", [None, None]),
                        ("seed-differs", [SEED.hex(), bytes(32).hex()])):
        out = base / name
        out.mkdir()
        started[name] = Group(_prove(out, programs["make_wat3"], 2, 1,
                                     seeds=seeds))
    started["mesh-unequal"] = Group([{"mode": "mesh", "k": K, "local": 1},
                                     {"mode": "mesh", "k": K, "local": 2}])
    started["mesh-three"] = Group([{"mode": "mesh", "k": K, "local": 1}] * 3)
    yield {"groups": started, "inputs": step_inputs}
    for group in started.values():
        group.kill()


@pytest.fixture(scope="module")
def env():
    return make_env()


@pytest.fixture(scope="module")
def references(groups, env):
    """program -> the port's one-process proof, and the JAX single-device
    proof of make_wat(3)."""
    progs = {"make_wat3": _wat(make_wat(3), [])}
    both = make_proofs(env, progs)
    mp = pytest.MonkeyPatch()
    mp.setenv("LIGERO_PROOF_TIMESTAMP", "1700000000")
    try:
        bd = tprover.prove(_wat(BIT_DECOMPOSE, [])[1], geometry=env["tgeo"],
                           executor=env["tex"], encoding_seed=SEED)
    finally:
        mp.undo()
    return {"make_wat3": (both["make_wat3"][1], both["make_wat3"][0]),
            "bit_decompose": (bd, None)}


def _rank_proofs(group) -> list[bytes]:
    out = []
    for res in group.ok():
        assert res["ok"]
        with open(res["proof"], "rb") as f:
            out.append(f.read())
    return out


# ---- whole proofs ----------------------------------------------------------

@pytest.mark.parametrize("name", list(PROOFS))
def test_every_rank_proves_the_single_device_proof(groups, references,
                                                   name):
    """Every rank's proof == each other's == the port's one-process proof
    (== the JAX single-device proof, for make_wat(3)); each rank made
    collectives over the CPU tensors and staged nothing."""
    prog, world, local = PROOFS[name]
    proofs = _rank_proofs(groups["groups"][name])
    assert len(proofs) == world
    port, jax_proof = references[prog]
    assert port.ok
    assert all(p == port.proof for p in proofs)
    if jax_proof is not None:
        assert jax_proof.ok and jax_proof.proof == port.proof
    for res in groups["groups"][name].ok():
        assert res["butterfly_passes"] > 0
        counts = res["counts"]
        assert counts["collectives"] > 0 and counts["bytes"] > 0
        assert counts["staged_bytes"] == 0


@pytest.mark.slow
def test_bit_decompose_ranks_equal_the_jax_proof(groups, env):
    """bit_decompose.wat's rank proofs == the JAX single-device proof
    (the JAX prove takes about two minutes on this CPU)."""
    from ligero_prover_tpu import prover as jprover
    proofs = _rank_proofs(groups["groups"]["bit_decompose-P2xL2"])
    mp = pytest.MonkeyPatch()
    mp.setenv("LIGERO_PROOF_TIMESTAMP", "1700000000")
    try:
        want = jprover.prove(_wat(BIT_DECOMPOSE, [])[0],
                             geometry=env["jgeo"], executor=env["jex"],
                             encoding_seed=SEED)
    finally:
        mp.undo()
    assert want.ok and all(p == want.proof for p in proofs)


def test_port_verifier_accepts_a_rank_proof(groups, env):
    proof = _rank_proofs(groups["groups"]["make_wat3-P4xL1"])[3]
    assert tverifier.verify(_wat(make_wat(3), [])[1], proof,
                            geometry=env["tgeo"], executor=env["tex"]).ok


# ---- steps against the JAX ShardedExecutor ---------------------------------

@pytest.fixture(scope="module")
def jax_steps(groups):
    """The JAX ShardedExecutor's output of every step, on the same inputs
    as the ranks, over 8 virtual CPU devices."""
    import jax
    from ligero_prover_tpu.parallel.mesh import ShardedExecutor as JSharded
    from ligero_prover_tpu.parallel.mesh import make_mesh as j_make_mesh
    inp = groups["inputs"]
    jex = JSharded(K, N, j_make_mesh(jax.devices()[:8]), B)
    accs = tuple(inp[f"acc{i}"] for i in range(3))
    sha = (inp["state"], inp["pending"], inp["has_pending"])
    commit = jex.commit_step(sha, inp["rows"], int(inp["valid"]))
    want = {"commit_state": jex.fetch(commit[0]),
            "commit_pending": jex.fetch(commit[1]),
            "commit_has_pending": np.asarray(commit[2])}
    want["finalize"] = jex.fetch(jex.sha_finalize(
        (want["commit_state"], want["commit_pending"],
         want["commit_has_pending"]), 77))
    check = jex.check_step(accs, inp["rows"], inp["rands"], inp["code_rs"],
                           inp["tri_idx"], inp["tri_r"], inp["pair_idx"],
                           inp["pair_r"])
    mask = jex.mask_step(accs, inp["code_row"], inp["linear_row"],
                         inp["quad_row"])
    for i in range(3):
        want[f"check{i}"] = jex.fetch(check[i])
        want[f"mask{i}"] = jex.fetch(mask[i])
    want["open"] = jex.fetch(jex.open_step(inp["rows"], inp["idx"]))
    want["open_2k"] = jex.fetch(jex.open_step(inp["rows_2k"], inp["idx"],
                                              width_2k=True))
    want["decode"] = jex.fetch(jex.decode(accs[0]))
    return want


@pytest.mark.parametrize("name", list(STEPS))
def test_steps_match_jax(groups, jax_steps, name):
    """commit + finalize, check + fetch, mask, open (k and 2k rows) and
    decode, run by every rank on its share of the column state and
    gathered, equal the JAX ShardedExecutor's on every rank."""
    world, _ = STEPS[name]
    results = groups["groups"][f"steps-{name}"].ok()
    assert len(results) == world
    for res in results:
        assert res["butterfly_passes"] > 0
        got = dict(np.load(res["steps"]))
        assert sorted(got) == sorted(jax_steps)
        for key, want in jax_steps.items():
            np.testing.assert_array_equal(
                got[key], np.asarray(want, got[key].dtype), err_msg=key)


# ---- the seed and the mesh's arguments ------------------------------------

def test_drawn_seed_is_shared(groups):
    """encoding_seed=None: rank 0 draws the seed, and both ranks prove
    the same bytes."""
    proofs = _rank_proofs(groups["groups"]["seed-none"])
    assert len(set(proofs)) == 1


def _all_raise(group, what: str):
    """Every rank exited non-zero, with `what` in its traceback, well
    inside the launch's time limit (no rank hung in a collective)."""
    results = group.results()
    assert time.monotonic() - group.start < LAUNCH_TIMEOUT
    for rc, res, err in results:
        assert rc != 0 and res is None
        assert what in err, err


def test_different_seeds_raise_on_every_rank(groups):
    _all_raise(groups["groups"]["seed-differs"], "different encoding seeds")


def test_unequal_meshes_raise_on_every_rank(groups):
    """Ranks with 1 and 2 devices, and D = 3 shards (not a power of two),
    raise on every rank."""
    _all_raise(groups["groups"]["mesh-unequal"], "needs as many shards")
    _all_raise(groups["groups"]["mesh-three"], "power of two")


# ---- one process -----------------------------------------------------------

@pytest.fixture
def no_collectives(monkeypatch):
    """Every torch.distributed collective the mesh could call raises."""
    def forbidden(*args, **kwargs):
        raise AssertionError("a one-process mesh made a collective")
    for name in ("all_gather", "all_gather_object", "broadcast",
                 "broadcast_object_list", "init_process_group"):
        monkeypatch.setattr(dist, name, forbidden)


def test_one_process_mesh_makes_no_collective(no_collectives, env,
                                              monkeypatch):
    """With every collective raising, a one-process mesh proves the
    single-device proof with a given and with a drawn seed, and its
    column state gathers; its rank is 0 of 1."""
    import test_torch_mesh
    monkeypatch.setenv("LIGERO_PROOF_TIMESTAMP", "1700000000")
    mesh = make_mesh(["cpu"] * 4)
    assert (mesh.rank, mesh.world, mesh.group) == (0, 1, None)
    assert list(mesh.local_shards) == [0, 1, 2, 3]
    prog = _wat(make_wat(3), [])[1]
    got = tprover.prove(prog, geometry=env["tgeo"], mesh=mesh, batch_rows=B,
                        encoding_seed=SEED)
    want = tprover.prove(prog, geometry=env["tgeo"], executor=env["tex"],
                         encoding_seed=SEED)
    assert got.ok and got.proof == want.proof
    assert tprover.prove(prog, geometry=env["tgeo"], mesh=mesh,
                         batch_rows=B).ok
    assert mesh.counts["collectives"] == 0
    test_torch_mesh.test_sharded_state_is_distributed()
    test_torch_mesh.test_shard_columns_round_trip()


def test_rank_share_of_the_columns():
    """convert.shard_columns with a mesh keeps that rank's shards; on one
    process that is all D, equal to the mesh-less split."""
    from ligero_prover_tpu_torch import convert
    gen = np.random.default_rng(3)
    acc = rand_limbs(gen, (N,))
    mesh = make_mesh(["cpu"] * 4)
    sh = convert.shard_columns(acc, 4, 0, mesh=mesh)
    plain = convert.shard_columns(acc, 4, 0)
    assert sh.mesh is mesh
    assert all(torch.equal(a, b) for a, b in zip(sh.parts, plain.parts))
    np.testing.assert_array_equal(convert.gather_columns(sh), acc)
    with pytest.raises(ValueError, match="a mesh of 4 shards"):
        convert.shard_columns(acc, 8, 0, mesh=mesh)
    assert ShardedExecutor(K, N, mesh, B).shards[3]["m"] == N // 4
