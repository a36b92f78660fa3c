#!/usr/bin/env python3
"""Sweep the CTA geometry of KE mont_mul, KE mulmod and quad-terms on one
GPU (threads per CTA, 4-element units per thread, and the least CTAs per
SM that ptxas sizes the registers for), beside a second design that
stages its operands through shared memory; and the geometry of KE
mont_mul's tiled mode (``tiled_kernel``) beside the run geometry it ran on
before.

    python3 experiment_ke_runs.py [--out build/exp_ke_runs.json] [--tiled]

``--tiled`` runs the tiled mode's sweep alone: one build of the source
below, then, at the sharded encode's twist (8, 16, 8192) x (8, 1, 8192)
and its 2k mask row (8, 1, 16384) x (8, 1, 16384), every geometry of
``TILED_THREADS`` threads a CTA, ``TILED_V`` elements and ``TILED_G`` rows
a thread and ``TILED_MIN_BLOCKS`` register caps (``tiled_vg_kernel``,
``exp_tiled``: in the source below only), each output equal to the
port's; the port's own launch (``tiled_geom``'s grid) and the run
geometry's tiled form that mode 6 ran on before (``tiled_runs_kernel``,
``exp_tiled_runs``) are timed first and last, in turns: run geometry,
port, the sweep, port, run geometry.  Times as
``chip_smoke.py`` takes them (L2-cold rotating copies behind a device
sleep; the L2-hot time beside).

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

// KE mont_mul's tiled mode with V elements (4: 16-byte units) and G rows
// a thread, y's V elements read once into registers and multiplied into
// each row of the thread's group; CTA c takes column slice c mod slices
// of row group c / slices.  The port keeps V = G = 1 (tiled_kernel).
struct TiledVG {
  uint32_t B, w, V, G, threads, slices;
};

template <int V, int kMinBlocks>
__global__ void __launch_bounds__(256, kMinBlocks)
tiled_vg_kernel(const uint32_t* __restrict__ x, uint32_t x_ls,
                const uint32_t* __restrict__ y, uint32_t y_ls,
                uint32_t* __restrict__ out, TiledVG g) {
  const uint32_t group = blockIdx.x / g.slices;
  const uint32_t slice = blockIdx.x - group * g.slices;
  const uint32_t i = (uint32_t)V * (slice * g.threads + threadIdx.x);
  if (i >= g.w) return;
  const uint32_t r0 = group * g.G;
  const uint32_t r1 = g.B - r0 < g.G ? g.B : r0 + g.G;
  uint32_t b[V][8];
  ligero_pl::load_planes<V>(y, y_ls, i, b);
  for (uint32_t r = r0; r < r1; ++r) {
    uint32_t a[V][8], res[V][8];
    ligero_pl::load_planes<V>(x, x_ls, r * g.w + i, a);
#pragma unroll
    for (int j = 0; j < V; ++j) mont_mul_cc(a[j], b[j], res[j]);
    ligero_pl::store_planes<V>(out, g.B * g.w, r * g.w + i, res);
  }
}

// the run geometry's tiled form, which mode 6 ran on before tiled_kernel:
// runs of w elements (rows), each over g.chunks CTAs of kRunThreads, a
// thread V elements at a time, y read at the element's offset in its run
template <int V>
__global__ void __launch_bounds__(ligero_pl::kRunThreads,
                                  LIGERO_RUN_MIN_BLOCKS)
tiled_runs_kernel(const uint32_t* __restrict__ x, uint32_t x_ls,
                  const uint32_t* __restrict__ y, uint32_t y_ls,
                  uint32_t* __restrict__ out, ligero_pl::RunGeom g) {
  const uint32_t run = blockIdx.x / g.chunks;
  const uint32_t c = blockIdx.x - run * g.chunks, start = run * g.len;
  const uint32_t end = g.n - start < g.len ? g.n : start + g.len;
  const uint32_t t = (uint32_t)ligero_pl::kRunThreads;
  for (uint32_t i = start + (uint32_t)V * (c * t + threadIdx.x); i < end;
       i += (uint32_t)V * g.chunks * t) {
    uint32_t a[V][8], b[V][8], r[V][8];
    ligero_pl::load_planes<V>(x, x_ls, i, a);
    ligero_pl::load_planes<V>(y, y_ls, i - start, b);
#pragma unroll
    for (int j = 0; j < V; ++j) mont_mul_cc(a[j], b[j], r[j]);
    ligero_pl::store_planes<V>(out, g.n, i, r);
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

#define EXP_TILED_CASE(v, mb)                                             \
  if (V == v && min_blocks == mb) {                                       \
    ligero_exp::tiled_vg_kernel<v, mb><<<grid, threads, 0, s>>>(          \
        xp, (uint32_t)x_ls, yp, (uint32_t)y_ls, op, g);                   \
    return (int)cudaGetLastError();                                       \
  }

// KE mont_mul's tiled mode on an explicit geometry: V elements and G rows
// a thread, `threads` a CTA, registers capped at min_blocks CTAs of 256 a
// SM; x (8, B, w) at limb stride x_ls, y one row at y_ls, out (8, B*w)
extern "C" int exp_tiled(const void* x, long long x_ls, const void* y,
                         long long y_ls, long long B, long long w, void* out,
                         int V, int G, int threads, int min_blocks,
                         void* stream) {
  const uint32_t units = (uint32_t)((w + V - 1) / V);
  const ligero_exp::TiledVG g = {
      (uint32_t)B, (uint32_t)w, (uint32_t)V, (uint32_t)G, (uint32_t)threads,
      (units + (uint32_t)threads - 1u) / (uint32_t)threads};
  const unsigned grid = g.slices * (((uint32_t)B + g.G - 1u) / g.G);
  const uint32_t* xp = (const uint32_t*)x;
  const uint32_t* yp = (const uint32_t*)y;
  uint32_t* op = (uint32_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  EXP_TILED_CASE(1, 4) EXP_TILED_CASE(1, 5) EXP_TILED_CASE(4, 1)
  EXP_TILED_CASE(4, 2)
  return (int)cudaErrorInvalidValue;
}

// the run geometry's tiled form over n = B*w elements, 16-byte units
// where run_vec allows them and w is a multiple of 4
extern "C" int exp_tiled_runs(const void* x, long long x_ls, const void* y,
                              long long y_ls, long long w, void* out,
                              long long n, void* stream) {
  const uint32_t* xp = (const uint32_t*)x;
  const uint32_t* yp = (const uint32_t*)y;
  uint32_t* op = (uint32_t*)out;
  const bool vec = ligero_pl::run_vec((uint32_t)n, (uint32_t)x_ls,
                                      ligero_pl::aligned16(xp),
                                      ligero_pl::aligned16(op), false,
                                      (uint32_t)w, (uint32_t)y_ls,
                                      ligero_pl::aligned16(yp)) &&
                   w % 4 == 0;
  const ligero_pl::RunGeom g = ligero_pl::run_geom((uint32_t)n, (uint32_t)w,
                                                   vec);
  const unsigned grid = ligero_pl::run_ctas(g);
  cudaStream_t s = (cudaStream_t)stream;
  if (vec)
    ligero_exp::tiled_runs_kernel<4><<<grid, ligero_pl::kRunThreads, 0, s>>>(
        xp, (uint32_t)x_ls, yp, (uint32_t)y_ls, op, g);
  else
    ligero_exp::tiled_runs_kernel<1><<<grid, ligero_pl::kRunThreads, 0, s>>>(
        xp, (uint32_t)x_ls, yp, (uint32_t)y_ls, op, g);
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

# the tiled mode's sweep: threads a CTA, elements V and rows G a thread,
# and for each V the register caps that exp_tiled is built with (CTAs of
# 256 threads a SM: 64 and 51 registers at V = 1, 255 and 128 at 4)
TILED_THREADS = (32, 64, 128, 256)
TILED_V = (1, 4)
TILED_G = (1, 2, 4, 8)
TILED_MIN_BLOCKS = {1: (4, 5), 4: (1, 2)}
TILED_CALLS = {"twist (8,16,8192)x(8,1,8192)": (16, 8192),
               "mask row (8,1,16384)x(8,1,16384)": (1, 16384)}


def build_all(work: Path, variants=VARIANTS) -> dict:
    """{variant: (ctypes library, .so path, ptxas log)}, built side by
    side, at most one nvcc per CPU."""
    from ligero_prover_tpu_torch import kernels
    work.mkdir(parents=True, exist_ok=True)
    src = work / "exp_ke_runs.cu"
    src.write_text(SOURCE)
    out, pending = {}, list(variants)
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
            i32 = ctypes.c_int
            lib.exp_tiled.argtypes = [p, i64, p, i64, i64, i64, p, i32, i32,
                                      i32, i32, p]
            lib.exp_tiled_runs.argtypes = [p, i64, p, i64, i64, p, i64, p]
            out[key] = (lib, so, log)
    return out


def tiled_sweep(card: str, out_path: str) -> int:
    """The tiled mode's sweep (``--tiled``): see the module docstring.
    Prints one line per call and design, the ten fastest geometries of
    each call, and one JSON object, also written to `out_path`."""
    import numpy as np
    import torch
    from ligero_prover_tpu_torch import kernels
    from ligero_prover_tpu_torch.ops import fieldmul as fm
    device = torch.device("cuda", 0)
    clk = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True,
                         check=True).stdout.split()[0]
    cs.CARD["clock_hz"] = float(clk) * 1e6      # for cs.bound
    lib, stream = kernels.lib(), kernels.stream_handle(device)
    vlib, so, log = build_all(kernels.BUILD_DIR / "exp_ke_runs",
                              VARIANTS[:1])[VARIANTS[0]]
    names = {f"v{v} min_blocks{mb}": f"tiled_vg_kernelILi{v}ELi{mb}EE"
             for v in TILED_V for mb in TILED_MIN_BLOCKS[v]}
    names["port"] = "tiled_kernel"
    names["run geometry"] = "tiled_runs_kernelILi4EE"
    ptxas = cs.ptxas_report(log, names)
    # (IMAD.WIDE, IMAD.HI, all) SASS of each kernel's body
    sass = cs.sass_counts(so, names)
    gen = np.random.default_rng(cs.SEED)
    result = {"card": card, "ptxas": ptxas, "sass": sass, "calls": {}}
    for label, (b, w) in TILED_CALLS.items():
        x = cs.random_limbs(gen, (b, w), device, True).movedim(-1, 0) \
            .contiguous()
        y = cs.random_limbs(gen, (w,), device, True).movedim(-1, 0) \
            .contiguous()
        n = b * w
        want = fm.mont_mul_tiled_planar(x, y).reshape(8, n)
        out = torch.empty((8, n), dtype=torch.int32, device=device)
        nbytes = 64 * n + 32 * w
        bnd = cs.bound(fm.TILED, nbytes, n)

        def port(x, y, out):
            kernels.check(lib.ligero_planar_eltwise(
                x.data_ptr(), n, y.data_ptr(), w, w, None, 0, out.data_ptr(),
                n, fm.TILED_MODE, stream), "port")

        def runs(x, y, out):
            kernels.check(vlib.exp_tiled_runs(
                x.data_ptr(), n, y.data_ptr(), w, w, out.data_ptr(), n,
                stream), "run geometry")

        def timed(launch):
            out.fill_(-1)
            launch(x, y, out)
            torch.cuda.synchronize()
            cs.require(torch.equal(out, want), f"{label}: equal to the port")
            return cs.launches_ms(launch, x, y, out)

        row = {"bound_ms": bnd[0], "bound_by": bnd[1],
               "port_grid": cs.tiled_grid(b, w),
               "runs_grid": cs.run_grid(n, w, True),
               "floor_ms": {
                   "port": cs.floor_ms(lib, stream, *cs.tiled_grid(b, w)),
                   "runs": cs.floor_ms(lib, stream,
                                       *cs.run_grid(n, w, True))},
               "turns": [], "sweep": []}
        for name, launch in (("runs", runs), ("port", port)):
            row["turns"].append((name, timed(launch)))
        for t in TILED_THREADS:
            for v in TILED_V:
                for g in TILED_G:
                    if g > b:
                        continue
                    for mb in TILED_MIN_BLOCKS[v]:
                        def launch(x, y, out, t=t, v=v, g=g, mb=mb):
                            kernels.check(vlib.exp_tiled(
                                x.data_ptr(), n, y.data_ptr(), w, b, w,
                                out.data_ptr(), v, g, t, mb, stream),
                                "exp_tiled")
                        ms = timed(launch)
                        ctas = -(-(w // v) // t) * -(-b // g)
                        row["sweep"].append({
                            "threads": t, "V": v, "G": g, "min_blocks": mb,
                            "ctas": ctas,
                            "registers": ptxas.get(f"v{v} min_blocks{mb}"),
                            "ms": ms})
        for name, launch in (("port", port), ("runs", runs)):
            row["turns"].append((name, timed(launch)))
        result["calls"][label] = row
        print(f"{label}: bound {bnd[0]:.4f} ms ({bnd[1]}); (cold, hot) ms "
              f"in turns {[(k, tuple(round(t, 4) for t in v)) for k, v in row['turns']]}; "
              f"port grid (CTAs, threads) {row['port_grid']}, run "
              f"geometry grid {row['runs_grid']}; floors {row['floor_ms']}",
              flush=True)
        for r in sorted(row["sweep"], key=lambda r: r["ms"][0])[:10]:
            print(f"  threads={r['threads']} V={r['V']} G={r['G']} "
                  f"min_blocks={r['min_blocks']} "
                  f"CTAs={r['ctas']} (registers, spill stores, spill "
                  f"loads)={r['registers']}: {r['ms'][0]:.4f} (hot "
                  f"{r['ms'][1]:.4f})", flush=True)
    print(f"registers: {ptxas}; SASS of the body: {sass}", flush=True)
    print(json.dumps(result), flush=True)
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    Path(out_path).write_text(json.dumps(result, indent=1))
    return 0


def main() -> int:
    import numpy as np
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/exp_ke_runs.json")
    ap.add_argument("--tiled", action="store_true",
                    help="the tiled mode's sweep alone")
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
    if args.tiled:
        return tiled_sweep(card, args.out)
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
