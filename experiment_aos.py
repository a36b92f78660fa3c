#!/usr/bin/env python3
"""Prove and verify walls and device kernels per row of two source trees of
the port, in turns, on one GPU.

    python3 experiment_aos.py --trees build/parent,.,.,build/parent \
        [--rounds 400] [--out chiprun_out/experiment_aos.json]

Each entry of ``--trees`` is a checkout of the repository (for example
``git archive`` of a parent commit unpacked into ``build/parent``); the
runs go in the order given, so ``parent, change, change, parent`` takes
both in turns.  Each run is a process of its own that imports the port and
``chip_smoke.py`` from its tree only, builds that tree's kernels into its
``build/``, and on the vbn254fr guest of ``chip_smoke.make_wat`` at
k=8192, planar path: proves and verifies once to warm up; takes one
unprofiled prove wall and verify wall, with the wrappers' launch counts
of each; then one prove and one verify under ``torch.profiler`` (device
kernels and copies, device seconds, the memcpys among them, the ten
device ops with the most launches).
Prints one JSON line per run and writes them all to ``--out``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
K = 8192


def one_run(tree: Path, rounds: int) -> dict:
    """The measurements of one tree (this process imports only from it)."""
    sys.path[:] = [str(tree)] + [p for p in sys.path
                                 if Path(p or ".").resolve() != ROOT]
    import torch
    import chip_smoke as cs
    import ligero_prover_tpu_torch as port
    from ligero_prover_tpu_torch import kernels
    from ligero_prover_tpu_torch.ops import fieldmul as fm, sha256 as sha, \
        mxu_renorm as mr
    from ligero_prover_tpu_torch.params import RowGeometry
    from ligero_prover_tpu_torch.prover import prove
    from ligero_prover_tpu_torch.verifier import verify
    from torch.profiler import ProfilerActivity, profile
    assert Path(port.__file__).resolve().is_relative_to(tree.resolve()), \
        port.__file__
    os.environ["LIGERO_PROOF_TIMESTAMP"] = "1700000000"
    t0 = time.perf_counter()
    kernels.lib()
    build_s = time.perf_counter() - t0
    geo = RowGeometry(K)
    prog = cs.wat_program(cs.make_wat(rounds))

    def sync():
        torch.cuda.synchronize()

    def counts():
        return {**fm.LAUNCHES, **sha.LAUNCHES, **mr.LAUNCHES}

    def profiled(fn):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = fn()
            sync()
        dev = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        us = sum(float(getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0)))
                 for e in dev)
        top = sorted(dev, key=lambda e: e.count, reverse=True)[:10]
        memcpys = sum(e.count for e in dev if e.key.startswith("Memcpy"))
        return out, sum(e.count for e in dev), us / 1e6, memcpys, \
            [(e.key[:60], e.count) for e in top]

    with cs.configuration(True):
        res = prove(prog, geometry=geo, encoding_seed=bytes(32),
                    device="cuda")
        assert verify(prog, res.proof, geometry=geo, device="cuda").ok
        sync()
        for module in (fm, sha, mr):
            module.reset_counts()
        t0 = time.perf_counter()
        res = prove(prog, geometry=geo, encoding_seed=bytes(32),
                    device="cuda")
        sync()
        prove_s = time.perf_counter() - t0
        proved = counts()
        t0 = time.perf_counter()
        ok = verify(prog, res.proof, geometry=geo, device="cuda").ok
        sync()
        verify_s = time.perf_counter() - t0
        verified = {k: v - proved[k] for k, v in counts().items()
                    if v != proved[k]}
        _, kp, tp, mp, top_p = profiled(lambda: prove(
            prog, geometry=geo, encoding_seed=bytes(32), device="cuda"))
        vres, kv, tv, mv, top_v = profiled(lambda: verify(
            prog, res.proof, geometry=geo, device="cuda"))
    rows = res.num_rows
    assert res.ok and ok and vres.ok
    return {"tree": str(tree), "build_s": build_s, "rows": rows,
            "prove_s": prove_s, "verify_s": verify_s,
            "prove_launches": {k: v for k, v in proved.items() if v},
            "verify_launches": verified,
            "prove_device_kernels": kp, "prove_kernels_per_row": kp / rows,
            "prove_device_s": tp, "prove_memcpys": mp,
            "prove_memcpys_per_row": mp / rows, "verify_device_kernels": kv,
            "verify_kernels_per_row": kv / rows, "verify_device_s": tv,
            "verify_memcpys": mv, "verify_memcpys_per_row": mv / rows,
            "prove_top_by_launches": top_p, "verify_top_by_launches": top_v,
            "proof_bytes": len(res.proof),
            "proof_sha256": hashlib.sha256(res.proof).hexdigest()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", default=".")
    ap.add_argument("--rounds", type=int, default=400)
    ap.add_argument("--out", default="chiprun_out/experiment_aos.json")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print("RESULT " + json.dumps(one_run(Path(args.one), args.rounds)),
              flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("experiment_aos: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    results = []
    for tree in args.trees.split(","):
        path = (ROOT / tree).resolve()
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--one", str(path), "--rounds",
                               str(args.rounds)], cwd=path,
                              capture_output=True, text=True, timeout=1200)
        found = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("RESULT ")]
        if proc.returncode != 0 or not found:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        r = json.loads(found[-1][len("RESULT "):])
        r["card"] = card
        print(json.dumps(r), flush=True)
        results.append(r)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
