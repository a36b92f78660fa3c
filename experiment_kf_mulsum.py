#!/usr/bin/env python3
"""Sweep the geometry of fused KF (``masked_mulsum_kernel`` of
``csrc/fieldmul.cu``: acc + x[0]*y[0] + ... + x[B-1]*y[B-1] mod p, the
products added in row order) on one GPU.

    python3 experiment_kf_mulsum.py [--out build/exp_kf_mulsum.json]

Builds ``csrc/fieldmul.cu`` once with an entry point of its own
(``exp_mulsum``, in the source string below only) that launches the port's
kernel with a given geometry: C columns x R row-lanes a CTA, and a chunk of
rows whose products one phase holds in shared memory (the whole row set,
or R rows: a phase per R rows).  At the main path's three calls (the
verifier's (16, 192, 8) with a row scalar y and with a full y, the AoS
check's (16, 32768, 8) with a row scalar), it times in turns: the port's
own launch (``mulsum_geom``'s geometry), the K2 + fold-only KF pair the
fused kernel replaced, the fold-only KF alone, every geometry of the sweep,
then the pair and the port again.  Every output must equal the port's,
limb for limb.  Times as ``chip_smoke.py`` takes them (L2-cold rotating
copies behind a device sleep; the L2-hot time beside) with the launch
floor of an empty kernel at the same grid.  Prints the card's name and
power limit, one line per call, the ten fastest geometries of each, and
one JSON object, also written to ``--out``.  Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import chip_smoke as cs

SOURCE = r"""
#include "fieldmul.cu"

// The port's fused KF with a geometry of the caller's choosing.
extern "C" int exp_mulsum(const void* acc, const void* x, const void* y,
                          void* out, unsigned n, unsigned rows, int y_full,
                          unsigned cols, unsigned lanes, unsigned chunk,
                          void* stream) {
  return ligero_fm::launch_mulsum(
      acc, x, y, out, ligero_fm::MulsumGeom{n, rows, cols, lanes, chunk},
      y_full, (cudaStream_t)stream);
}
"""

COLS = (1, 2, 4, 8, 16, 32)
LANES = (1, 2, 4, 8, 16)


def build(work: Path):
    """(ctypes library, .so path, nvcc log) of SOURCE."""
    from ligero_prover_tpu_torch import kernels
    work.mkdir(parents=True, exist_ok=True)
    src = work / "exp_kf_mulsum.cu"
    src.write_text(SOURCE)
    so = work / "libexp_kf_mulsum.so"
    proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared",
                           f"-I{kernels.CSRC}", "-o", str(so), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}\n{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    u32, p = ctypes.c_uint32, ctypes.c_void_p
    lib.exp_mulsum.argtypes = [p, p, p, p, u32, u32, ctypes.c_int, u32, u32,
                               u32, p]
    lib.exp_mulsum.restype = ctypes.c_int
    return lib, so, proc.stdout + proc.stderr


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/exp_kf_mulsum.json")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("experiment_kf_mulsum: no CUDA device", file=sys.stderr)
        return 1
    from ligero_prover_tpu_torch import kernels
    from ligero_prover_tpu_torch.ops import fieldmul as fm
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    clk = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True,
                         check=True).stdout.split()[0]
    print(card, flush=True)
    cs.CARD["clock_hz"] = float(clk) * 1e6      # for cs.bound
    device = torch.device("cuda", 0)
    lib, stream = kernels.lib(), kernels.stream_handle(device)
    vlib, so, log = build(kernels.BUILD_DIR / "exp_kf_mulsum")
    names = {"row": "masked_mulsum_kernelILb0E",
             "full": "masked_mulsum_kernelILb1E"}
    ptxas, sass = cs.ptxas_report(log, names), cs.sass_counts(so, names)
    gen = np.random.default_rng(cs.SEED)
    result = {"card": card, "ptxas": ptxas, "sass": sass, "calls": {}}
    for label, rows, n, full in cs.MULSUM_CALLS:
        acc = cs.random_limbs(gen, (n,), device, False)
        x = cs.random_limbs(gen, (rows, n), device, False)
        y = cs.random_limbs(gen, (rows, n if full else 1), device, False)
        want = fm.masked_mulsum_aos(acc, x, y)
        out = torch.empty_like(acc)
        yx = y.expand(x.shape).contiguous()
        prod = torch.empty_like(x)
        nbytes = 32 * (2 * n + x.numel() // 8 + y.numel() // 8)
        bnd = cs.bound(fm.MULSUM, nbytes, rows * n)

        def timed(launch, *bufs, check=True):
            out.fill_(-1)
            launch(*bufs)
            torch.cuda.synchronize()
            if check:
                cs.require(torch.equal(out, want), f"{label}: equal to the "
                           "port's")
            return cs.launches_ms(launch, *bufs)

        def port(a, u, v, o):
            kernels.check(lib.ligero_masked_mulsum(
                a.data_ptr(), u.data_ptr(), v.data_ptr(), o.data_ptr(), n,
                rows, int(full), stream), "port")

        def pair(a, u, v, p, o):
            kernels.check(lib.ligero_mont_mul(
                u.data_ptr(), v.data_ptr(), p.data_ptr(), rows * n,
                rows * n, 1, stream), "mulmod")
            kernels.check(lib.ligero_masked_sum(
                a.data_ptr(), p.data_ptr(), o.data_ptr(), n, rows, stream),
                "fold")

        def fold(a, p, o):
            kernels.check(lib.ligero_masked_sum(
                a.data_ptr(), p.data_ptr(), o.data_ptr(), n, rows, stream),
                "fold")

        grid = cs.mulsum_grid(n, rows)
        row = {"rows": rows, "n": n, "y_full": full, "bound_ms": bnd[0],
               "bound_by": bnd[1], "port_geometry": grid[2:],
               "floor_ms": cs.floor_ms(lib, stream, *grid[:2]),
               "turns": [], "sweep": []}
        turns = (("port", port, (acc, x, y, out), True),
                 ("K2 + fold", pair, (acc, x, yx, prod, out), True),
                 ("fold only", fold, (acc, prod, out), False))
        for name, launch, bufs, check in turns:
            row["turns"].append((name, timed(launch, *bufs, check=check)))
        for cols in COLS:
            for lanes in LANES:
                if lanes > rows or cols * lanes > 512:
                    continue
                for chunk in sorted({rows, lanes}):
                    if 32 * chunk * cols > cs.MULSUM_SMEM:
                        continue

                    def launch(a, u, v, o, c=cols, r=lanes, h=chunk):
                        kernels.check(vlib.exp_mulsum(
                            a.data_ptr(), u.data_ptr(), v.data_ptr(),
                            o.data_ptr(), n, rows, int(full), c, r, h,
                            stream), "exp_mulsum")
                    ms = timed(launch, acc, x, y, out)
                    ctas = -(-n // cols)
                    row["sweep"].append({
                        "cols": cols, "lanes": lanes, "chunk": chunk,
                        "ctas": ctas, "ms": ms,
                        "floor_ms": cs.floor_ms(lib, stream, ctas,
                                                cols * lanes)})
        for name, launch, bufs, check in turns[1::-1]:
            row["turns"].append((name, timed(launch, *bufs, check=check)))
        result["calls"][label] = row
        print(f"{label} ({rows}, {n}, 8): bound {bnd[0]:.4f} ms ({bnd[1]});"
              f" port geometry (cols, lanes, chunk) {row['port_geometry']},"
              f" floor {row['floor_ms']:.4f}; (cold, hot) ms in turns "
              f"{[(k, tuple(round(t, 4) for t in v)) for k, v in row['turns']]}",
              flush=True)
        for r in sorted(row["sweep"], key=lambda r: r["ms"][0])[:10]:
            print(f"  cols={r['cols']} lanes={r['lanes']} chunk={r['chunk']}"
                  f" CTAs={r['ctas']}: {r['ms'][0]:.4f} (hot "
                  f"{r['ms'][1]:.4f}; floor {r['floor_ms']:.4f})",
                  flush=True)
    print(f"registers (registers, spill stores, spill loads): {ptxas}; "
          f"SASS (IMAD.WIDE, IMAD.HI, all): {sass}", flush=True)
    print(json.dumps(result), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
