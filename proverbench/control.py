#!/usr/bin/env python3
"""The readings of a cell's control: the plain reference with one of the
configuration's guarantees broken, put in the program's place.

    python3 proverbench/control.py --workload <cell> --seeds 11,12,13

For a `prove` cell the control opens 191 columns instead of 192; as many
proofs as a run's check proves again are compared byte for byte with the
reference's.  For a `verify` cell the
control is the reference verifier without the Merkle root's check (the
commitment's binding); its verdicts on the set-up's proofs, made by the
program as a run's set-up makes them, are compared with the reference's,
and a window that verifies the proofs in turn would count the differing
verdicts once per turn.  Prints one JSON line per seed; needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def readings(cell_name: str, seed: int, device: str = "cuda",
             k: int | None = None, guest_params: dict | None = None) -> dict:
    """The control's reading of the cell's compared number on `seed`; `k`
    and `guest_params` shrink the cell for the CPU tests."""
    import harness
    cell = harness.Cell.load(cell_name)
    ctx = harness.Context(cell, seed, device,
                          k or int(cell.config["packing"]), guest_params or {})
    mode = cell.mode
    t0 = time.perf_counter()
    if cell.traffic["mode"] == "prove":
        state = mode.State(ctx, None, ctx.guest())
        # as many proofs as a run's check proves again
        indices = range(int(cell.workload.get("checked_proofs", 1)) + 1)
        refs = mode.reference_proofs(state, indices)
        controls = mode.reference_proofs(state, indices, openings=191)
        value = sum(harness.differing_bytes(c.proof, r.proof)
                    for c, r in zip(controls, refs))
        name = "proof_bytes_differing"
    else:
        state = mode.setup(ctx)
        want = mode.reference_verdicts(state)
        got = mode.reference_verdicts(state, check_merkle=False)
        value = sum(1 for a, b in zip(got, want) if a != b)
        name = "verdicts_wrong"
    return {"workload": cell_name, "seed": seed, "control": name,
            "value": value, "limit": cell.workload["limits"][name],
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(HERE))
    sys.path.insert(1, str(HERE.parent))
    import harness
    import torch
    os.environ["LIGERO_PROOF_TIMESTAMP"] = harness.PROOF_TIMESTAMP
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(args.workload, seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
