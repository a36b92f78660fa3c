#!/usr/bin/env python3
"""Sweep the geometry of KQ (``quad_acc_kernel`` of ``csrc/planar.cu``: the
planar check's whole quadratic-test accumulation) on one GPU.

    python3 experiment_kq.py [--rounds 3] [--out build/exp_kq.json]

Builds ``csrc/planar.cu`` once with an entry point of its own
(``exp_quad_acc``, in the source string below only) that launches the
port's kernel with a given geometry: C columns x R row-lanes a CTA.  At
the check's two calls (e (8, 16, 32768) on one device, (8, 16, 8192) on
one of 4 shards; T = P = 16, random row indices), it times in turns: the
port's own launch (``quad_geom``'s geometry), the 13-op sequence KQ
replaced on operands already on the card
(``chip_smoke.quad_acc_sequence``, replayed as a CUDA graph: its device
time) and the same sequence as the check ran it, from Python with its
row indices uploaded by ``fm.quad_terms_planar`` (the host's pace, where
it is slower than the device's); then every geometry of the sweep, ``--rounds`` times over in turns; then
the three in reverse order.  Every output must equal the port's, limb for
limb.  Times as ``chip_smoke.py`` takes them (L2-cold rotating copies
behind a device sleep; the L2-hot time beside) with the launch floor of
an empty kernel at the same grid; a sweep geometry's time is the median
of its rounds.  Prints the card's name and power limit, one line per
call, the ten fastest geometries of each, and one JSON object, also
written to ``--out``.  Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import chip_smoke as cs

SOURCE = r"""
#include "planar.cu"

// The port's KQ with a geometry of the caller's choosing.
extern "C" int exp_quad_acc(const void* e, unsigned e_ls, const void* args,
                            const void* acc, void* out, unsigned n,
                            unsigned T, unsigned P, unsigned cols,
                            unsigned lanes, void* stream) {
  return ligero_pl::launch_quad_acc(
      (const uint32_t*)e, e_ls, (const int32_t*)args, (const uint32_t*)acc,
      (uint32_t*)out, ligero_pl::QuadGeom{n, T, P, cols, lanes},
      (cudaStream_t)stream);
}
"""

COLS = (2, 4, 8, 16, 32)
LANES = (1, 2, 4, 8, 16, 32)


def build(work: Path):
    """(ctypes library, .so path, nvcc log) of SOURCE."""
    from ligero_prover_tpu_torch import kernels
    work.mkdir(parents=True, exist_ok=True)
    src = work / "exp_kq.cu"
    src.write_text(SOURCE)
    so = work / "libexp_kq.so"
    proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared",
                           f"-I{kernels.CSRC}", "-o", str(so), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}\n{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    u32, p = ctypes.c_uint32, ctypes.c_void_p
    lib.exp_quad_acc.argtypes = [p, u32, p, p, p, u32, u32, u32, u32, u32, p]
    lib.exp_quad_acc.restype = ctypes.c_int
    return lib, so, proc.stdout + proc.stderr


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default="build/exp_kq.json")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("experiment_kq: no CUDA device", file=sys.stderr)
        return 1
    from ligero_prover_tpu_torch import kernels
    from ligero_prover_tpu_torch.ops import fieldmul as fm
    from ligero_prover_tpu_torch.zkp.executor import _r2, \
        _tree_sum_mod_planar
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
    vlib, so, log = build(kernels.BUILD_DIR / "exp_kq")
    names = {"kq": "quad_acc_kernel"}
    ptxas, sass = cs.ptxas_report(log, names), cs.sass_counts(so, names)
    gen = np.random.default_rng(cs.SEED)
    r2 = _r2(device)
    result = {"card": card, "ptxas": ptxas, "sass": sass, "calls": {}}
    for label, bsz, n in cs.QUAD_ACC_CALLS:
        t_ = p_ = bsz
        acc = cs.random_limbs(gen, (n,), device, False)
        e = cs.random_limbs(gen, (bsz, n), device, False).movedim(-1, 0) \
            .contiguous()
        tri = gen.integers(0, bsz, (t_, 3)).astype(np.int32)
        pair = gen.integers(0, bsz, (p_, 2)).astype(np.int32)
        tri_r, pair_r = (cs.random_limbs(gen, (k,), "cpu", False).numpy()
                         .view(np.uint32) for k in (t_, p_))
        want = fm.quad_acc_planar(acc, e, tri, pair, tri_r, pair_r)
        packed, _, _ = fm.quad_acc_args(acc, e, tri, pair, tri_r, pair_r)
        dev_args = torch.from_numpy(packed).to(device)
        tr_d, pr_d = (torch.from_numpy(a.view(np.int32)).to(device)
                      for a in (tri_r, pair_r))
        out = torch.empty_like(acc)
        distinct = len(set(tri.ravel()) | set(pair.ravel()))
        bnd = cs.bound(fm.QACC, 32 * n * (distinct + 2) + 4 * packed.size,
                       n * (3 * t_ + p_) + t_ + p_)

        def timed(launch, *bufs, graph=False):
            """(cold, hot) ms of `launch` (replayed as a CUDA graph where
            `graph`), whose result (its return, or `out` where it returns
            None) must equal the port's."""
            out.fill_(-1)
            res = launch(*bufs)
            torch.cuda.synchronize()
            cs.require(torch.equal(out if res is None else res, want),
                       f"{label}: equal to the port's")
            return (cs.graph_ms if graph else cs.launches_ms)(launch, *bufs)

        def port(e, a, acc, out):
            kernels.check(lib.ligero_planar_quad_acc(
                e.data_ptr(), bsz * n, bsz, n, a.data_ptr(), t_, p_,
                acc.data_ptr(), out.data_ptr(), stream), "port")

        def sequence(acc, e, a, tr, pr):
            return cs.quad_acc_sequence(lib, acc, e, a, t_, p_, tr, pr)

        def uploading(acc, e, tr, pr):
            terms = fm.quad_terms_planar(e, tri, pair)
            scals = fm.mont_mul_scalar_planar(
                torch.cat([tr, pr]).T.contiguous(), r2)
            prods = fm.mont_mul_planar(terms, scals[:, :, None])
            return fm.addmod_planar(acc.T.contiguous(),
                                    _tree_sum_mod_planar(prods)).T \
                .contiguous()

        grid = cs.quad_acc_grid(n, t_, p_)
        row = {"rows": bsz, "n": n, "T": t_, "P": p_, "bound_ms": bnd[0],
               "bound_by": bnd[1], "port_geometry": grid[2:4],
               "floor_ms": cs.floor_ms(lib, stream, *grid[:2]),
               "turns": [], "sweep": []}
        turns = (("port", port, (e, dev_args, acc, out), False),
                 ("13-op sequence, a CUDA graph", sequence,
                  (acc, e, dev_args, tr_d, pr_d), True),
                 ("13-op sequence from Python, indices uploaded",
                  uploading, (acc, e, tr_d, pr_d), False))
        for name, launch, bufs, graph in turns:
            row["turns"].append((name, timed(launch, *bufs, graph=graph)))
        geoms = [(c, r) for c in COLS for r in LANES
                 if c * r <= 512 and r <= t_ + p_]
        times = {g: [] for g in geoms}
        for _ in range(args.rounds):
            for cols, lanes in geoms:
                def launch(e, a, acc, out, c=cols, r=lanes):
                    kernels.check(vlib.exp_quad_acc(
                        e.data_ptr(), bsz * n, a.data_ptr(), acc.data_ptr(),
                        out.data_ptr(), n, t_, p_, c, r, stream),
                        "exp_quad_acc")
                times[cols, lanes].append(timed(launch, e, dev_args, acc,
                                                out))
        for (cols, lanes), ts in times.items():
            ctas = -(-n // cols)
            row["sweep"].append({
                "cols": cols, "lanes": lanes, "ctas": ctas,
                "ms": [statistics.median(t[i] for t in ts) for i in (0, 1)],
                "rounds": ts,
                "floor_ms": cs.floor_ms(lib, stream, ctas, cols * lanes)})
        for name, launch, bufs, graph in turns[::-1]:
            row["turns"].append((name, timed(launch, *bufs, graph=graph)))
        result["calls"][label] = row
        print(f"{label} e (8, {bsz}, {n}), T={t_} P={p_}: bound "
              f"{bnd[0]:.4f} ms ({bnd[1]}); port geometry (cols, lanes) "
              f"{row['port_geometry']}, floor {row['floor_ms']:.4f}; "
              f"(cold, hot) ms in turns "
              f"{[(k, tuple(round(t, 4) for t in v)) for k, v in row['turns']]}",
              flush=True)
        for r in sorted(row["sweep"], key=lambda r: r["ms"][0])[:10]:
            print(f"  cols={r['cols']} lanes={r['lanes']} CTAs={r['ctas']}: "
                  f"{r['ms'][0]:.4f} (hot {r['ms'][1]:.4f}; floor "
                  f"{r['floor_ms']:.4f}; rounds "
                  f"{[round(t[0], 4) for t in r['rounds']]})", flush=True)
    print(f"registers (registers, spill stores, spill loads): {ptxas}; "
          f"SASS (IMAD.WIDE, IMAD.HI, all): {sass}", flush=True)
    print(json.dumps(result), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
