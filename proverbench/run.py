#!/usr/bin/env python3
"""Run one cell of the benchmark once, on one NVIDIA GPU.

    python3 proverbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Prints, as its last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device``,
``breakdown`` (traced runs) and, last, ``checks``: each number compared
with the plain reference beside its limit, which also end standard error.
Exits non-zero, printing no result, without a CUDA device, when the
program cannot be imported, or when a module of JAX, of the JAX package or
of its old benchmark is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # One thread for every CPU library: the program's host work is one
    # Python thread, and a pool of them only fights the host's other load.
    for var in THREAD_VARS:
        os.environ[var] = "1"
    sys.path.insert(0, str(HERE))
    sys.path.insert(1, str(HERE.parent))
    import harness
    os.environ["LIGERO_PROOF_TIMESTAMP"] = harness.PROOF_TIMESTAMP

    cell = harness.Cell.load(args.workload)
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("proverbench: no CUDA device", file=sys.stderr)
        return 2
    try:
        import ligero_prover_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"proverbench: the program is not here: {e}", file=sys.stderr)
        return 3
    t_imports = time.perf_counter() - T_START
    torch.zeros(1, device="cuda")                 # the CUDA context
    print(f"proverbench: set-up at imports {t_imports:.3f} s, CUDA context "
          f"{time.perf_counter() - T_START:.3f} s", file=sys.stderr)
    result, lines = harness.execute(cell, args.seed, args.seconds,
                                    bool(args.trace), device="cuda",
                                    t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        print("proverbench: forbidden modules loaded: " + ", ".join(bad),
              file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    for line in lines:
        print(line, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
