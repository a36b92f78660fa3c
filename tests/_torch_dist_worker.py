"""One rank of a multi-process column-sharded prover on the CPU, for
``tests/test_torch_dist.py``.

The launcher starts P of these processes; each joins a gloo process group
through the store the launcher holds on ``tcp://127.0.0.1:<port>``,
builds ``make_mesh(["cpu"] * L)`` (D = P*L shards, rank r holding shards
[r*L, (r+1)*L)), runs one mode and prints ``RESULT <json>`` as its last
line.  It imports only the port, never JAX,
and asserts so before it prints.

Usage: python _torch_dist_worker.py '<json config>'

The config holds ``rank``, ``world``, ``port`` (the launcher's
``TCPStore``), ``timeout`` (seconds of the process group's collectives),
``local`` (L), ``mode`` and the mode's own keys:

* ``prove``: ``program`` (a WAT path), ``k``, ``batch_rows``, ``seed``
  (hex, or null: rank 0 draws it) and ``out`` (a directory): prove through ``prove(..., mesh=...)`` with
  ``LIGERO_PROOF_TIMESTAMP=1700000000`` and write the proof to
  ``out/proof<rank>.gz``.
* ``steps``: ``inputs`` (an npz the launcher wrote), ``k``, ``out``: run every step of a ``ShardedExecutor`` from the rank's share of
  the whole column state and write the gathered outputs to
  ``out/steps<rank>.npz``.
* ``mesh``: only build the mesh and a ``ShardedExecutor`` at ``k``
  (``local`` may differ between ranks here).
"""

import datetime
import hashlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def prove_mode(cfg, mesh):
    from ligero_prover_tpu_torch import prover
    from ligero_prover_tpu_torch.ops import fieldmul as fm
    from ligero_prover_tpu_torch.params import RowGeometry
    from ligero_prover_tpu_torch.vm.run import make_wat_program

    os.environ["LIGERO_PROOF_TIMESTAMP"] = "1700000000"
    prog = make_wat_program(cfg["program"], [], set())
    seed = None if cfg["seed"] is None else bytes.fromhex(cfg["seed"])
    res = prover.prove(prog, geometry=RowGeometry(cfg["k"]), mesh=mesh,
                       batch_rows=cfg["batch_rows"], encoding_seed=seed)
    path = os.path.join(cfg["out"], f"proof{mesh.rank}.gz")
    with open(path, "wb") as f:
        f.write(res.proof)
    return {"ok": res.ok, "proof": path,
            "sha256": hashlib.sha256(res.proof).hexdigest(),
            "butterfly_passes": fm.PLAIN_CALLS["butterfly_dit"]["cpu"]}


def steps_mode(cfg, mesh):
    import numpy as np
    from ligero_prover_tpu_torch import convert
    from ligero_prover_tpu_torch.ops import fieldmul as fm
    from ligero_prover_tpu_torch.parallel.mesh import ShardedExecutor

    k, D = cfg["k"], mesh.size
    inp = dict(np.load(cfg["inputs"]))
    ex = ShardedExecutor(k, 4 * k, mesh, 8)

    def split(name, axis=0):
        return convert.shard_columns(inp[name], D, axis, mesh=mesh)

    accs = tuple(split(f"acc{i}") for i in range(3))
    sha = (split("state", 1), split("pending"), bool(inp["has_pending"]))
    out = {}
    commit = ex.commit_step(sha, inp["rows"], int(inp["valid"]))
    out["commit_state"], out["commit_pending"] = \
        convert.to_numpy(commit[:2])
    out["commit_has_pending"] = np.asarray(commit[2])
    out["finalize"] = ex.fetch(ex.sha_finalize(commit, 77))
    check = ex.check_step(accs, inp["rows"], inp["rands"], inp["code_rs"],
                          inp["tri_idx"], inp["tri_r"], inp["pair_idx"],
                          inp["pair_r"])
    for i, acc in enumerate(check):
        out[f"check{i}"] = ex.fetch(acc)
    mask = ex.mask_step(accs, inp["code_row"], inp["linear_row"],
                        inp["quad_row"])
    for i, acc in enumerate(mask):
        out[f"mask{i}"] = ex.fetch(acc)
    out["open"] = ex.fetch(ex.open_step(inp["rows"], inp["idx"]))
    out["open_2k"] = ex.fetch(ex.open_step(inp["rows_2k"], inp["idx"],
                                           width_2k=True))
    out["decode"] = ex.fetch(ex.decode(accs[0]))
    path = os.path.join(cfg["out"], f"steps{mesh.rank}.npz")
    np.savez(path, **out)
    return {"steps": path,
            "butterfly_passes": fm.PLAIN_CALLS["butterfly_dit"]["cpu"]}


def mesh_mode(cfg, mesh):
    from ligero_prover_tpu_torch.parallel.mesh import ShardedExecutor
    ShardedExecutor(cfg["k"], 4 * cfg["k"], mesh, 8)
    return {}


MODES = {"prove": prove_mode, "steps": steps_mode, "mesh": mesh_mode}


def main():
    cfg = json.loads(sys.argv[1])
    sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    timeout = datetime.timedelta(seconds=cfg["timeout"])
    store = dist.TCPStore("127.0.0.1", cfg["port"], cfg["world"],
                          is_master=False, timeout=timeout)
    dist.init_process_group("gloo", store=store, rank=cfg["rank"],
                            world_size=cfg["world"], timeout=timeout)
    try:
        from ligero_prover_tpu_torch.parallel.mesh import make_mesh
        mesh = make_mesh(["cpu"] * cfg["local"])
        out = MODES[cfg["mode"]](cfg, mesh)
        out["counts"] = mesh.counts
    finally:
        dist.destroy_process_group()
    imported = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
                or m == "ligero_prover_tpu"
                or m.startswith("ligero_prover_tpu.")]
    assert not imported, f"a rank imported {imported[:5]}"
    print("RESULT " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
