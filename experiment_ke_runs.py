#!/usr/bin/env python3
"""Sweep the CTA geometry of KE mont_mul, KE mulmod and quad-terms on one
GPU (threads per CTA, 4-element units per thread, and the least CTAs per
SM that ptxas sizes the registers for), beside a second design that
stages its operands through shared memory.

    python3 experiment_ke_runs.py [--out build/exp_ke_runs.json]

Builds ``ligero_prover_tpu_torch/csrc/planar.cu`` (with the staged
design's kernels, which exist only in the source string below) once per
variant with ``-DLIGERO_RUN_THREADS``, ``-DLIGERO_RUN_UNITS`` and
``-DLIGERO_RUN_MIN_BLOCKS`` (the nvcc runs side by side), then times each
variant at the calls of the planar check step at k=8192 (n=32768), as
``chip_smoke.py`` times the port's kernels (L2-cold rotating copies, the
L2-hot time beside): mont_mul on (8, 16, n) x (8, 16, 1) (code test) and
(8, 32, n) x (8, 32, 1) (quad test) and on full (8, 16, n) planes (linear
test), mulmod on full (8, 16, n) planes, quad-terms on e (8, 16, n) with
16 triples and 16 pairs.  The staged design (a CTA of 128 threads loads a
tile of 128 elements into shared memory in 16-byte units, each thread
multiplies one element, the tile goes back in 16-byte units; two tiles
per CTA) is timed at the same calls from the first variant's build.
Every output must equal the port's own build's, limb for limb.  Prints
the card's name and power limit, one line per variant (registers, spill
bytes, SASS, times) and one JSON object, also written to ``--out``.
Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import chip_smoke as cs

SOURCE = r"""
#include "planar.cu"

namespace ligero_exp {

using namespace ligero_fm;
using ligero_pl::load4;
using ligero_pl::store4;
enum { kThreads = 128, kTiles = 2 };   // one element per thread per tile

// runs of len elements, `chunks` CTAs each; CTA c of a run takes the
// tiles of kThreads elements c, c + chunks, ...
struct Geom {
  uint32_t n, len, chunks;
};

// tile k of CTA `cta`: its run, first element and count (0 past the end)
__device__ __forceinline__ uint32_t tile_of(const Geom& g, uint32_t cta,
                                            uint32_t k, uint32_t& run,
                                            uint32_t& base) {
  run = cta / g.chunks;
  const uint32_t c = cta - run * g.chunks, end = run * g.len + g.len;
  base = run * g.len + (c + k * g.chunks) * (uint32_t)kThreads;
  if (base >= end) return 0u;
  return end - base < (uint32_t)kThreads ? end - base : (uint32_t)kThreads;
}

// operand o's limb l of element j at src[o][l*ls + j] into the shared
// planes sm[(8*o + l)*kThreads + j], 16 bytes at a time
__device__ __forceinline__ void stage_in(const uint32_t* const src[3],
                                         uint32_t ls, uint32_t ops,
                                         uint32_t cnt, uint32_t* sm,
                                         uint32_t t) {
  const uint32_t per_plane = (uint32_t)kThreads / 4u;
#pragma unroll
  for (uint32_t o = 0; o < 3u; ++o) {
    if (o >= ops) break;
#pragma unroll
    for (uint32_t k = 0; k < 2u; ++k) {
      const uint32_t u = t + k * (uint32_t)kThreads;
      const uint32_t l = u / per_plane, j = 4u * (u % per_plane);
      if (j < cnt) {
        uint32_t w[4];
        load4(src[o] + l * ls + j, w);
        store4(sm + (8u * o + l) * kThreads + j, w);
      }
    }
  }
}

// the result planes (operand 0's) to out[l*n + j], 16 bytes at a time
__device__ __forceinline__ void stage_out(uint32_t* sm, uint32_t* out,
                                          uint32_t n, uint32_t cnt,
                                          uint32_t t) {
  const uint32_t per_plane = (uint32_t)kThreads / 4u;
#pragma unroll
  for (uint32_t k = 0; k < 2u; ++k) {
    const uint32_t u = t + k * (uint32_t)kThreads;
    const uint32_t l = u / per_plane, j = 4u * (u % per_plane);
    if (j < cnt) {
      uint32_t w[4];
      load4(sm + l * kThreads + j, w);
      store4(out + l * n + j, w);
    }
  }
}

__device__ __forceinline__ void operand(const uint32_t* sm, uint32_t o,
                                        uint32_t t, uint32_t v[8]) {
#pragma unroll
  for (int l = 0; l < 8; ++l) v[l] = sm[(8u * o + l) * kThreads + t];
}

__device__ __forceinline__ void result(uint32_t* sm, uint32_t t,
                                       const uint32_t r[8]) {
#pragma unroll
  for (int l = 0; l < 8; ++l) sm[l * kThreads + t] = r[l];
}

// x (8, n) contiguous times a per-row scalar (kRow, runs of len) or a full
// plane; each tile staged in, multiplied one element per thread, staged out
template <bool kMulmod, bool kRow>
__global__ void __launch_bounds__(kThreads)
staged_product_kernel(const uint32_t* __restrict__ x,
                      const uint32_t* __restrict__ y, uint32_t y_ls,
                      uint32_t* __restrict__ out, Geom g) {
  __shared__ __align__(16) uint32_t sm[(kRow ? 8 : 16) * kThreads];
  const uint32_t t = threadIdx.x;
  uint32_t run, base, s[8];
  if (kRow) {
    tile_of(g, blockIdx.x, 0, run, base);
#pragma unroll
    for (int l = 0; l < 8; ++l) s[l] = y[l * y_ls + run];
  }
  for (uint32_t k = 0; k < (uint32_t)kTiles; ++k) {
    const uint32_t cnt = tile_of(g, blockIdx.x, k, run, base);
    if (cnt == 0u) break;
    const uint32_t* src[3] = {x + base, kRow ? y : y + base, x};
    stage_in(src, g.n, kRow ? 1u : 2u, cnt, sm, t);
    __syncthreads();
    if (t < cnt) {
      uint32_t a[8], b[8], r[8];
      operand(sm, 0, t, a);
      if (!kRow) operand(sm, 1, t, b);
      if (kMulmod)
        mulmod_cc(a, kRow ? s : b, r);
      else
        mont_mul_cc(a, kRow ? s : b, r);
      result(sm, t, r);
    }
    __syncthreads();
    stage_out(sm, out + base, g.n, cnt, t);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
staged_quad_kernel(const uint32_t* __restrict__ e, uint32_t e_ls,
                   const int32_t* __restrict__ tri, uint32_t T,
                   const int32_t* __restrict__ pair,
                   uint32_t* __restrict__ out, Geom g) {
  __shared__ __align__(16) uint32_t sm[24 * kThreads];
  const uint32_t t = threadIdx.x;
  for (uint32_t k = 0; k < (uint32_t)kTiles; ++k) {
    uint32_t row, base;
    const uint32_t cnt = tile_of(g, blockIdx.x, k, row, base);
    if (cnt == 0u) break;
    const bool triple = row < T;
    const int32_t* ix = triple ? tri + 3u * row : pair + 2u * (row - T);
    const uint32_t col = base - row * g.len;
    const uint32_t* src[3] = {
        e + (uint32_t)ix[0] * g.len + col, e + (uint32_t)ix[1] * g.len + col,
        triple ? e + (uint32_t)ix[2] * g.len + col : e};
    stage_in(src, e_ls, triple ? 3u : 2u, cnt, sm, t);
    __syncthreads();
    if (t < cnt) {
      uint32_t a[8], b[8], r[8];
      operand(sm, 0, t, a);
      operand(sm, 1, t, b);
      if (triple) {
        uint32_t m[8];
        mulmod_cc(a, b, m);
        operand(sm, 2, t, a);
        sub_mod(m, a, r);
      } else {
        sub_mod(a, b, r);
      }
      result(sm, t, r);
    }
    __syncthreads();
    stage_out(sm, out + base, g.n, cnt, t);
    __syncthreads();
  }
}

}  // namespace ligero_exp

// the staged design at the check's calls: x (8, n) contiguous, y one
// element per run of y_div > 1 or a full plane; 16-byte aligned, n and
// y_div multiples of 4
extern "C" int exp_staged_product(const void* x, const void* y, void* out,
                                  long long n, long long y_div, int mulmod,
                                  void* stream) {
  const uint32_t len = y_div > 1 ? (uint32_t)y_div : (uint32_t)n;
  const ligero_exp::Geom g = {(uint32_t)n, len, (len + 255u) / 256u};
  const unsigned grid = (uint32_t)n / len * g.chunks;
  const uint32_t yl = y_div > 1 ? (uint32_t)(n / y_div) : (uint32_t)n;
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* xp = (const uint32_t*)x;
  const uint32_t* yp = (const uint32_t*)y;
  uint32_t* op = (uint32_t*)out;
  if (y_div > 1 && mulmod)
    ligero_exp::staged_product_kernel<true, true><<<grid, 128, 0, s>>>(
        xp, yp, yl, op, g);
  else if (y_div > 1)
    ligero_exp::staged_product_kernel<false, true><<<grid, 128, 0, s>>>(
        xp, yp, yl, op, g);
  else if (mulmod)
    ligero_exp::staged_product_kernel<true, false><<<grid, 128, 0, s>>>(
        xp, yp, yl, op, g);
  else
    ligero_exp::staged_product_kernel<false, false><<<grid, 128, 0, s>>>(
        xp, yp, yl, op, g);
  return (int)cudaGetLastError();
}

extern "C" int exp_staged_quad(const void* e, long long e_ls, long long n,
                               const void* tri, long long T, const void* pair,
                               long long P, void* out, void* stream) {
  const ligero_exp::Geom g = {(uint32_t)((T + P) * n), (uint32_t)n,
                              ((uint32_t)n + 255u) / 256u};
  ligero_exp::staged_quad_kernel<<<(unsigned)(T + P) * g.chunks, 128, 0,
                                   (cudaStream_t)stream>>>(
      (const uint32_t*)e, (uint32_t)e_ls, (const int32_t*)tri, (uint32_t)T,
      (const int32_t*)pair, (uint32_t*)out, g);
  return (int)cudaGetLastError();
}
"""

# (threads per CTA, units per thread, least CTAs per SM); the port's own
# choice (csrc/planar.cu) comes first
VARIANTS = [(128, 2, 1)] + [(t, u, 1) for t in (64, 128, 256, 512)
                            for u in (1, 2, 4) if (t, u) != (128, 2)] \
    + [(256, 1, 2), (256, 1, 3), (128, 2, 4)]
KERNELS = ("mont_mul_planar", "mont_mul_planar_full", "mulmod_planar",
           "quad_terms_planar")
STAGED_SASS = {"mont_mul_planar": "staged_product_kernelILb0ELb1EE",
               "mont_mul_planar_full": "staged_product_kernelILb0ELb0EE",
               "mulmod_planar": "staged_product_kernelILb1ELb0EE",
               "quad_terms_planar": "staged_quad_kernel"}

def build_all(work: Path) -> dict:
    """{variant: (ctypes library, .so path, ptxas log)}, built side by
    side, at most one nvcc per CPU."""
    from ligero_prover_tpu_torch import kernels
    work.mkdir(parents=True, exist_ok=True)
    src = work / "exp_ke_runs.cu"
    src.write_text(SOURCE)
    out, pending = {}, list(VARIANTS)
    while pending:
        batch, pending = pending[:os.cpu_count() or 4], \
            pending[os.cpu_count() or 4:]
        procs = {}
        for t, u, b in batch:
            so = work / f"libke_{t}_{u}_{b}.so"
            procs[(t, u, b)] = (so, subprocess.Popen(
                [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared",
                 f"-DLIGERO_RUN_THREADS={t}", f"-DLIGERO_RUN_UNITS={u}",
                 f"-DLIGERO_RUN_MIN_BLOCKS={b}", f"-I{kernels.CSRC}", "-o",
                 str(so), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for key, (so, proc) in procs.items():
            log = proc.communicate()[0]
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {key}:\n{log}")
            lib = ctypes.CDLL(str(so))
            for name in ("ligero_planar_eltwise", "ligero_planar_quad_terms"):
                fn = getattr(lib, name)
                fn.argtypes = list(kernels.SIGNATURES[name])
                fn.restype = ctypes.c_int
            p, i64 = ctypes.c_void_p, ctypes.c_longlong
            lib.exp_staged_product.argtypes = [p, p, p, i64, i64,
                                               ctypes.c_int, p]
            lib.exp_staged_quad.argtypes = [p, i64, i64, p, i64, p, i64, p, p]
            out[key] = (lib, so, log)
    return out


def main() -> int:
    import numpy as np
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/exp_ke_runs.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("experiment_ke_runs: no CUDA device", file=sys.stderr)
        return 1
    from ligero_prover_tpu_torch import kernels
    from ligero_prover_tpu_torch.ops import fieldmul as fm

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    device = torch.device("cuda", 0)
    lib, stream = kernels.lib(), kernels.stream_handle(device)
    builds = build_all(kernels.BUILD_DIR / "exp_ke_runs")
    gen = np.random.default_rng(cs.SEED)
    n, bsz = 4 * cs.FULL_K, 16

    def planes(shape):
        return cs.random_limbs(gen, shape, device, True).movedim(-1, 0) \
            .contiguous()

    def product(mode, x, y, y_div):
        size = x[0].numel()

        def launch(lib_, x, y, out):
            kernels.check(lib_.ligero_planar_eltwise(
                x.data_ptr(), size, y.data_ptr(), y[0].numel(), y_div, None,
                0, out.data_ptr(), size, mode, stream), "product")
        return launch, (x, y, torch.empty_like(x))

    e = planes((bsz, n))
    tri = gen.integers(0, bsz, (bsz, 3)).astype(np.int32)
    pair = gen.integers(0, bsz, (bsz, 2)).astype(np.int32)
    idx = torch.from_numpy(np.concatenate([tri.ravel(), pair.ravel()])) \
        .to(device)

    def quad_launch(lib_, e, idx, out):
        kernels.check(lib_.ligero_planar_quad_terms(
            e.data_ptr(), bsz * n, bsz, n, idx.data_ptr(), bsz,
            idx.data_ptr() + 12 * bsz, bsz, out.data_ptr(), stream), "quad")

    mont, mulmod = fm.PLANAR_MODE["mont_mul_planar"], \
        fm.PLANAR_MODE["mulmod_planar"]
    calls = {
        "mont_mul code (8,16,n)x(8,16,1)":
            product(mont, planes((bsz, n)), planes((bsz, 1)), n),
        "mont_mul quad (8,32,n)x(8,32,1)":
            product(mont, planes((2 * bsz, n)), planes((2 * bsz, 1)), n),
        "mont_mul full (8,16,n)x(8,16,n)":
            product(mont, planes((bsz, n)), planes((bsz, n)), 1),
        "mulmod full (8,16,n)x(8,16,n)":
            product(mulmod, planes((bsz, n)), planes((bsz, n)), 1),
        "quad-terms e (8,16,n) T=P=16":
            (quad_launch, (e, idx, torch.empty((8, 2 * bsz, n),
                                               dtype=torch.int32,
                                               device=device))),
    }
    want = {}
    for label, (launch, bufs) in calls.items():
        launch(lib, *bufs)
        torch.cuda.synchronize()
        want[label] = bufs[-1].clone()
    result = {"card": card, "variants": []}
    names = {k: cs.SASS_NAME[k] for k in KERNELS}
    for (t, u, b), (vlib, so, log) in builds.items():
        ptxas = cs.ptxas_report(log, names)
        sass = {k: v[2] for k, v in cs.sass_counts(so, names).items()}
        row = {"threads": t, "units": u, "min_blocks": b,
               "elements_per_thread": 4 * u,
               "ptxas": {k: ptxas.get(k) for k in KERNELS}, "sass": sass,
               "ms": {}}
        for label, (launch, bufs) in calls.items():
            bufs[-1].zero_()
            launch(vlib, *bufs)
            torch.cuda.synchronize()
            cs.require(torch.equal(bufs[-1], want[label]),
                       f"variant {(t, u, b)} equals the port's build at "
                       f"{label}")
            row["ms"][label] = cs.launches_ms(
                lambda *a: launch(vlib, *a), *bufs)
        result["variants"].append(row)
        print(f"threads={t} units={u} min_blocks={b}: (registers, spill "
              f"stores, spill loads) {row['ptxas']}; SASS of the body "
              f"{sass}; (cold, hot) ms "
              f"{ {k: tuple(round(x, 4) for x in v)
                   for k, v in row['ms'].items()} }", flush=True)
    # the staged design, from the first variant's build
    vlib, so, log = builds[VARIANTS[0]]

    def staged_product(y_div, mulmod):
        return lambda x, y, out: kernels.check(vlib.exp_staged_product(
            x.data_ptr(), y.data_ptr(), out.data_ptr(), x[0].numel(), y_div,
            int(mulmod), stream), "staged product")

    def staged_quad(e, idx, out):
        kernels.check(vlib.exp_staged_quad(
            e.data_ptr(), bsz * n, n, idx.data_ptr(), bsz,
            idx.data_ptr() + 12 * bsz, bsz, out.data_ptr(), stream),
            "staged quad")

    staged = {
        "mont_mul code (8,16,n)x(8,16,1)": staged_product(n, False),
        "mont_mul quad (8,32,n)x(8,32,1)": staged_product(n, False),
        "mont_mul full (8,16,n)x(8,16,n)": staged_product(1, False),
        "mulmod full (8,16,n)x(8,16,n)": staged_product(1, True),
        "quad-terms e (8,16,n) T=P=16": staged_quad,
    }
    ptxas = cs.ptxas_report(log, STAGED_SASS)
    row = {"design": "staged", "threads": 128, "tiles_per_cta": 2,
           "ptxas": {k: ptxas.get(k) for k in KERNELS},
           "sass": {k: v[2] for k, v in
                    cs.sass_counts(so, STAGED_SASS).items()}, "ms": {}}
    for label, (_, bufs) in calls.items():
        launch = staged[label]
        bufs[-1].zero_()
        launch(*bufs)
        torch.cuda.synchronize()
        cs.require(torch.equal(bufs[-1], want[label]),
                   f"the staged design equals the port's build at {label}")
        row["ms"][label] = cs.launches_ms(launch, *bufs)
    result["staged_design"] = row
    print(f"staged design (a tile of 128 elements per CTA through shared "
          f"memory, one element per thread, 2 tiles per CTA): "
          f"{row['ptxas']}; SASS {row['sass']}; (cold, hot) ms "
          f"{ {k: tuple(round(x, 4) for x in v)
               for k, v in row['ms'].items()} }", flush=True)
    print(json.dumps(result), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
