#!/usr/bin/env python3
"""KR digitize and KE mulmod_fma before and after their redesign, side by
side on one GPU, with KR mid and pack before and after the shared repack.

    python3 experiment_digitize_fma.py [--out build/exp_digitize_fma.json]

digitize at the int8 engine's call for k=8192: 16 rows of k elements,
read as (8, 16, k) planar limbs and as the engine's (16, k, 8) AoS rows
viewed as planes (limb stride 1, element stride 8).  Designs:

* the port's kernel (``csrc/renorm.cu``: ``canonical_to_packed`` as one
  256-bit add of 0x80 in every byte and a XOR, one element a thread,
  the AoS view's 32 bytes as two 16-byte loads, anything else word by
  word), through its entry point;
* the kernel it replaced (the byte-serial recoding, one element a thread,
  a grid-stride loop of 256-thread CTAs), kept only in the source string
  below (``exp_old_digitize``), on planar input;
* the port's element functions at 128 threads a CTA, and its word-by-word
  form on the AoS view too (element stride 8); and the alternatives of 2
  and 4 elements a thread at 128 or 256 threads, planar (each plane's
  words one 8- or 16-byte access) and on the AoS view (``exp_digitize``);
* the pair the engine ran before: the aten copy that made the rows planar
  (``rows.movedim(-1, 0).contiguous()``) and the replaced kernel; and,
  for what moving the same bytes costs, that copy alone and a plain copy
  of the planar limbs.

KR mid at both engine levels, (64, 131072) x tw1 and (64, 524288) x tw3,
and KR pack at (64, 524288), on real slots: the port's kernels beside the
same kernels with the byte-serial repack (``exp_old_repack``), in turns
(port, old, old, port).

mulmod_fma (z + x*y mod p) at (8, 16, 32768) with y a full plane and a
per-row scalar (8, 16, 1), on non-canonical operands with the edge
values.  Designs: the port's (``run_product_kernel`` in mode 5: the
carry-chain ``mulmod_cc``, runs of one row per CTA, single elements), the
kernel it replaced (``eltwise_kernel`` on ``mulmod``, one element a
thread; ``exp_fma`` design 0), the replaced geometry on ``mulmod_cc``
(1), the port's thread function in 16-byte units (2), the same with z
loaded before the product (3) and capped at 128 registers (4).  Every digitize and mulmod_fma design is timed twice, in
order and then in reverse.

Each design is checked against the plain version (max_abs_err 0) and
timed as ``chip_smoke.py`` times the port's kernels (L2-cold rotating
copies, the L2-hot time beside, the launch floor of an empty kernel at the
same grid).  Prints the card's name and power limit, each kernel's
registers and spills and its SASS per element by opcode class
(``cuobjdump``), one line per measurement, and one JSON object, also
written to ``--out``.  Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import chip_smoke as cs
from experiment_k1_kr import measure
from experiment_sha_absorb import opcode_classes

SOURCE = r"""
#include "planar.cu"
#include "renorm.cu"

#ifdef __CUDACC__

namespace exp_df {

using namespace ligero_fm;

// ---- digitize as it was (verbatim): the byte-serial signed recoding, one
// element a thread, a grid-stride loop of 256-thread CTAs

LIGERO_HD void old_canonical_to_packed(const uint32_t limbs[8],
                                       uint32_t out[8]) {
  uint32_t carry = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint32_t w = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t b = ((limbs[i] >> (8 * j)) & 0xFFu) + carry;
      carry = b > 127u ? 1u : 0u;
      w |= ((b - (carry << 8)) & 0xFFu) << (8 * j);
    }
    out[i] = w;
  }
}

LIGERO_HD void old_digitize_at(const uint32_t* x, uint32_t* out, uint32_t X,
                               uint32_t i) {
  uint32_t a[8], r[8];
#pragma unroll
  for (int l = 0; l < 8; ++l) a[l] = x[(uint32_t)l * X + i];
  old_canonical_to_packed(a, r);
#pragma unroll
  for (int l = 0; l < 8; ++l) out[(uint32_t)l * X + i] = r[l];
}

__global__ void __launch_bounds__(256)
old_digitize_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                    uint32_t X) {
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t i = blockIdx.x * blockDim.x + threadIdx.x; i < X; i += stride)
    old_digitize_at(x, out, X, i);
}

// ---- digitize at V elements a thread in two vector layouts (the
// alternatives to the port's one element a thread): planar (es = 1, each
// limb plane's V consecutive words one access; X and ls whole vectors, x
// and out at 4V-byte boundaries) and the AoS rows viewed as planes
// (ls = 1, es = 8: each element two 16-byte loads; out at 4V bytes)

enum { kVecPlanar = 1, kVecAos = 2 };

template <int V>
LIGERO_HD void load_words(const uint32_t* p, uint32_t v[V]) {
  if constexpr (V == 4) {
    const uint4 w = *(const uint4*)p;
    v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
  } else if constexpr (V == 2) {
    const uint2 w = *(const uint2*)p;
    v[0] = w.x; v[1] = w.y;
  } else {
    v[0] = *p;
  }
}

template <int V>
LIGERO_HD void store_words(uint32_t* p, const uint32_t v[V]) {
  if constexpr (V == 4)
    *(uint4*)p = make_uint4(v[0], v[1], v[2], v[3]);
  else if constexpr (V == 2)
    *(uint2*)p = make_uint2(v[0], v[1]);
  else
    *p = v[0];
}

template <int kLayout, int V>
LIGERO_HD void vec_digitize_at(const uint32_t* x, uint32_t ls,
                               uint32_t* out, uint32_t X, uint32_t u) {
  const uint32_t i = (uint32_t)V * u;
  uint32_t a[V][8], r[V][8], w[V];
  if (kLayout == kVecAos) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      load_words<4>(x + 8u * (i + j), a[j]);
      load_words<4>(x + 8u * (i + j) + 4u, a[j] + 4);
    }
  } else {
#pragma unroll
    for (int l = 0; l < 8; ++l) {
      load_words<V>(x + (uint32_t)l * ls + i, w);
#pragma unroll
      for (int j = 0; j < V; ++j) a[j][l] = w[j];
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j) ligero_rn::canonical_to_packed(a[j], r[j]);
#pragma unroll
  for (int l = 0; l < 8; ++l) {
#pragma unroll
    for (int j = 0; j < V; ++j) w[j] = r[j][l];
    store_words<V>(out + (uint32_t)l * X + i, w);
  }
}

template <int kLayout, int V, int kThreads>
__global__ void __launch_bounds__(kThreads)
vec_digitize_kernel(const uint32_t* __restrict__ x, uint32_t ls,
                    uint32_t* __restrict__ out, uint32_t X) {
  const uint32_t u = blockIdx.x * kThreads + threadIdx.x;
  if (u < X / (uint32_t)V) vec_digitize_at<kLayout, V>(x, ls, out, X, u);
}

// the port's element functions at 128 threads a CTA
template <bool kAos>
__global__ void __launch_bounds__(128)
digitize128_kernel(const uint32_t* __restrict__ x, uint32_t ls, uint32_t es,
                   uint32_t* __restrict__ out, uint32_t X) {
  const uint32_t i = blockIdx.x * 128u + threadIdx.x;
  if (i < X) ligero_rn::digitize_at<kAos>(x, ls, es, out, X, i);
}

// ---- KR mid and pack with the byte-serial repack, otherwise the port's
// renorm_at, at the port's launch bounds

template <int kMode>
LIGERO_HD void old_repack_at(const int32_t* slots, const uint32_t* tw,
                             uint32_t tw_ls, uint32_t tw_lbc, uint32_t tw_lc,
                             uint32_t* out, uint32_t X, uint32_t i) {
  uint32_t t[8], r[8];
  ligero_rn::slots_to_canonical(slots + i, X, t);
  if (kMode == ligero_rn::kMid) {
    const uint32_t ti = ligero_rn::twiddle_at(tw_lbc, tw_lc, i);
    uint32_t w[8], y[8];
#pragma unroll
    for (int l = 0; l < 8; ++l) w[l] = tw[(uint32_t)l * tw_ls + ti];
    mont_mul_cc(t, w, y);
    old_canonical_to_packed(y, r);
  } else {
    old_canonical_to_packed(t, r);
  }
#pragma unroll
  for (int l = 0; l < 8; ++l) out[(uint32_t)l * X + i] = r[l];
}

template <int kMode>
__global__ void __launch_bounds__(256, 4)
old_repack_kernel(const int32_t* __restrict__ slots,
                  const uint32_t* __restrict__ tw, uint32_t tw_ls,
                  uint32_t tw_lbc, uint32_t tw_lc, uint32_t* __restrict__ out,
                  uint32_t X) {
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t i = blockIdx.x * blockDim.x + threadIdx.x; i < X; i += stride)
    old_repack_at<kMode>(slots, tw, tw_ls, tw_lbc, tw_lc, out, X, i);
}

// ---- mulmod_fma as it was (verbatim but for kCC): eltwise_kernel's
// geometry (one element a thread, 256-thread CTAs, y read at i / y_div)
// on field.cuh's mulmod; kCC: the same on mulmod_cc

template <bool kCC>
LIGERO_HD void old_fma_at(const uint32_t* x, uint32_t x_ls,
                          const uint32_t* y, uint32_t y_ls, uint32_t y_div,
                          const uint32_t* z, uint32_t z_ls, uint32_t* out,
                          uint32_t n, uint32_t i) {
  uint32_t a[8], c[8], r[8];
#pragma unroll
  for (int l = 0; l < 8; ++l) a[l] = x[l * x_ls + i];
  const uint32_t yi = y_div == 1u ? i : i / y_div;
#pragma unroll
  for (int l = 0; l < 8; ++l) c[l] = y[l * y_ls + yi];
  uint32_t t[8], acc[8];
  if (kCC)
    mulmod_cc(a, c, t);
  else
    mulmod(a, c, t);
#pragma unroll
  for (int l = 0; l < 8; ++l) acc[l] = z[l * z_ls + i];
  add_mod(acc, t, r);
#pragma unroll
  for (int l = 0; l < 8; ++l) out[l * n + i] = r[l];
}

template <bool kCC>
__global__ void __launch_bounds__(256)
old_fma_kernel(const uint32_t* __restrict__ x, uint32_t x_ls,
               const uint32_t* __restrict__ y, uint32_t y_ls, uint32_t y_div,
               const uint32_t* __restrict__ z, uint32_t z_ls,
               uint32_t* __restrict__ out, uint32_t n) {
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    old_fma_at<kCC>(x, x_ls, y, y_ls, y_div, z, z_ls, out, n, i);
}

// ---- mulmod_fma on the port's run geometry in 16-byte units, z loaded
// with x before the product (the port loads it after)

template <bool kRow>
__global__ void __launch_bounds__(ligero_pl::kRunThreads,
                                  LIGERO_RUN_MIN_BLOCKS)
zfirst_fma_kernel(const uint32_t* __restrict__ x, uint32_t x_ls,
                  const uint32_t* __restrict__ y, uint32_t y_ls,
                  const uint32_t* __restrict__ z, uint32_t z_ls,
                  uint32_t* __restrict__ out, ligero_pl::RunGeom g) {
  using namespace ligero_pl;
  const uint32_t cta = blockIdx.x, t = threadIdx.x;
  const uint32_t run = cta / g.chunks, c = cta - run * g.chunks;
  const uint32_t start = run * g.len;
  const uint32_t end = g.n - start < g.len ? g.n : start + g.len;
  uint32_t s[8];
  if (kRow) {
#pragma unroll
    for (int l = 0; l < 8; ++l) s[l] = y[l * y_ls + run];
  }
  const uint32_t step = 4u * g.chunks * (uint32_t)kRunThreads;
  for (uint32_t i = start + 4u * (c * kRunThreads + t); i < end;
       i += step) {
    uint32_t a[4][8], b[4][8], w[4][8], r[4][8];
    load_planes<4>(x, x_ls, i, a);
    load_planes<4>(z, z_ls, i, w);
    if (!kRow) load_planes<4>(y, y_ls, i, b);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      mulmod_cc(a[j], kRow ? s : b[j], r[j]);
      add_mod(w[j], r[j], r[j]);
    }
    store_planes<4>(out, g.n, i, r);
  }
}

// ---- the port's mulmod_fma thread function in 16-byte units, its
// registers capped at 128 (at least 4 CTAs of 128 on an SM)

template <bool kRow>
__global__ void __launch_bounds__(ligero_pl::kRunThreads, 4)
capped_fma_kernel(const uint32_t* __restrict__ x, uint32_t x_ls,
                  const uint32_t* __restrict__ y, uint32_t y_ls,
                  const uint32_t* __restrict__ z, uint32_t z_ls,
                  uint32_t* __restrict__ out, ligero_pl::RunGeom g) {
  ligero_pl::run_product_at<ligero_pl::kFma, kRow, 4>(
      x, x_ls, y, y_ls, z, z_ls, out, g, blockIdx.x, threadIdx.x);
}

}  // namespace exp_df

extern "C" int exp_old_digitize(const void* x, void* out, long long X,
                                void* stream) {
  exp_df::old_digitize_kernel<<<ligero_rn::grid_for((unsigned long long)X),
                                256, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (uint32_t*)out, (uint32_t)X);
  return (int)cudaGetLastError();
}

// digitize at v elements a thread and `threads` a CTA: layout 0 the
// port's word-by-word element function at strides (ls, es), 3 its
// 16-byte AoS form (v = 1 only), 1 planar and 2 AoS vectors (the
// experiment's own, es implied); the caller checks that the alignment
// holds.
extern "C" int exp_digitize(const void* x, long long ls, long long es,
                            void* out, long long X, int layout, int v,
                            int threads, void* stream) {
  using namespace exp_df;
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* xp = (const uint32_t*)x;
  uint32_t* op = (uint32_t*)out;
  const uint32_t l = (uint32_t)ls, e = (uint32_t)es, xx = (uint32_t)X;
  const uint32_t blocks = (xx / v + threads - 1) / threads;
  if (v == 1 && (layout == 0 || layout == 3)) {
    const bool aos = layout == 3;
    if (threads == 128 && aos)
      digitize128_kernel<true><<<blocks, 128, 0, s>>>(xp, l, e, op, xx);
    else if (threads == 128)
      digitize128_kernel<false><<<blocks, 128, 0, s>>>(xp, l, e, op, xx);
    else if (aos)
      ligero_rn::digitize_kernel<true><<<blocks, 256, 0, s>>>(xp, l, e, op,
                                                              xx);
    else
      ligero_rn::digitize_kernel<false><<<blocks, 256, 0, s>>>(xp, l, e, op,
                                                               xx);
    return (int)cudaGetLastError();
  }
#define EXP_DIGIT(L, V, T)                                           \
  if (layout == L && v == V && threads == T) {                       \
    vec_digitize_kernel<L, V, T><<<blocks, T, 0, s>>>(xp, l, op, xx); \
    return (int)cudaGetLastError();                                  \
  }
  EXP_DIGIT(kVecPlanar, 2, 128) EXP_DIGIT(kVecPlanar, 4, 128)
  EXP_DIGIT(kVecPlanar, 2, 256) EXP_DIGIT(kVecPlanar, 4, 256)
  EXP_DIGIT(kVecAos, 2, 128) EXP_DIGIT(kVecAos, 4, 128)
  EXP_DIGIT(kVecAos, 2, 256) EXP_DIGIT(kVecAos, 4, 256)
#undef EXP_DIGIT
  return (int)cudaErrorInvalidValue;
}

// KR mid (mode 1) or pack (mode 2) with the byte-serial repack
extern "C" int exp_old_repack(const void* slots, const void* tw,
                              long long tw_ls, long long lbc, long long lc,
                              void* out, long long X, int mode,
                              void* stream) {
  const unsigned grid = ligero_rn::grid_for((unsigned long long)X);
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* sp = (const int32_t*)slots;
  const uint32_t* tp = (const uint32_t*)tw;
  uint32_t* op = (uint32_t*)out;
  if (mode == ligero_rn::kMid)
    exp_df::old_repack_kernel<ligero_rn::kMid><<<grid, 256, 0, s>>>(
        sp, tp, (uint32_t)tw_ls, (uint32_t)lbc, (uint32_t)lc, op,
        (uint32_t)X);
  else
    exp_df::old_repack_kernel<ligero_rn::kPack><<<grid, 256, 0, s>>>(
        sp, tp, 0u, 0u, 0u, op, (uint32_t)X);
  return (int)cudaGetLastError();
}

// mulmod_fma designs: 0 the replaced kernel (mulmod), 1 its geometry on
// mulmod_cc, 2 the port's thread function in 16-byte units (the port runs
// it in single elements), 3 the same with z loaded first, 4 the same
// capped at 128 registers.  x, z and out are
// (8, n) at limb strides x_ls, z_ls and n; y at y_ls, one element per
// y_div.
extern "C" int exp_fma(const void* x, long long x_ls, const void* y,
                       long long y_ls, long long y_div, const void* z,
                       long long z_ls, void* out, long long n, int design,
                       void* stream) {
  using namespace ligero_pl;
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t *xp = (const uint32_t*)x, *yp = (const uint32_t*)y,
                 *zp = (const uint32_t*)z;
  uint32_t* op = (uint32_t*)out;
  const uint32_t xl = (uint32_t)x_ls, yl = (uint32_t)y_ls,
                 yd = (uint32_t)y_div, zl = (uint32_t)z_ls,
                 nn = (uint32_t)n;
  const bool row = yd > 1u;
  if (design <= 1) {
    const unsigned grid = grid_for((unsigned long long)n);
    if (design == 0)
      exp_df::old_fma_kernel<false><<<grid, 256, 0, s>>>(xp, xl, yp, yl, yd,
                                                         zp, zl, op, nn);
    else
      exp_df::old_fma_kernel<true><<<grid, 256, 0, s>>>(xp, xl, yp, yl, yd,
                                                        zp, zl, op, nn);
    return (int)cudaGetLastError();
  }
  const RunGeom g = run_geom(nn, row ? yd : nn, true);
  const unsigned grid = run_ctas(g);
  if (design == 4 && row)
    exp_df::capped_fma_kernel<true><<<grid, kRunThreads, 0, s>>>(
        xp, xl, yp, yl, zp, zl, op, g);
  else if (design == 4)
    exp_df::capped_fma_kernel<false><<<grid, kRunThreads, 0, s>>>(
        xp, xl, yp, yl, zp, zl, op, g);
  else if (design == 2 && row)
    run_product_kernel<kFma, true, true><<<grid, kRunThreads, 0, s>>>(
        xp, xl, yp, yl, zp, zl, op, g);
  else if (design == 2)
    run_product_kernel<kFma, false, true><<<grid, kRunThreads, 0, s>>>(
        xp, xl, yp, yl, zp, zl, op, g);
  else if (row)
    exp_df::zfirst_fma_kernel<true><<<grid, kRunThreads, 0, s>>>(
        xp, xl, yp, yl, zp, zl, op, g);
  else
    exp_df::zfirst_fma_kernel<false><<<grid, kRunThreads, 0, s>>>(
        xp, xl, yp, yl, zp, zl, op, g);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
"""

# exp_digitize's layouts: the port's word-by-word and 16-byte AoS
# element functions, one element a thread; the vector alternatives
DIGIT_FORMS = {"word by word": 0, "16-byte aos": 3}
DIGIT_VEC = {"planar": 1, "aos": 2}
DIGIT_THREADS = (128, 256)
DIGIT_V = (2, 4)
FMA_DESIGNS = {0: "old: mulmod, one element a thread",
               1: "one element a thread on mulmod_cc",
               2: "run geometry, 16-byte units",
               3: "16-byte units, z loaded before the product",
               4: "16-byte units, 128 registers (4 CTAs an SM)"}
EXP_SASS = {
    "old digitize": "old_digitize_kernel",
    "digitize word by word t128": "digitize128_kernelILb0E",
    "digitize 16-byte aos t128": "digitize128_kernelILb1E",
    **{f"digitize {lay} v{v} t{t}":
       f"vec_digitize_kernelILi{code}ELi{v}ELi{t}EE"
       for lay, code in DIGIT_VEC.items() for v in DIGIT_V
       for t in DIGIT_THREADS},
    "old repack mid": "old_repack_kernelILi1E",
    "old repack pack": "old_repack_kernelILi2E",
    "old fma": "old_fma_kernelILb0E",
    "old fma on mulmod_cc": "old_fma_kernelILb1E",
    "fma 16-byte units, full": "run_product_kernelILi5ELi0ELb1EE",
    "fma 16-byte units, row": "run_product_kernelILi5ELi1ELb1EE",
    "fma z first, full": "zfirst_fma_kernelILb0E",
    "fma z first, row": "zfirst_fma_kernelILb1E",
    "fma capped, full": "capped_fma_kernelILb0E",
    "fma capped, row": "capped_fma_kernelILb1E",
}
# elements a pass of each kernel's body computes (SASS per element)
EXP_ELEMENTS = {**{f"digitize {lay} v{v} t{t}": v for lay in DIGIT_VEC
                   for v in DIGIT_V for t in DIGIT_THREADS},
                "fma 16-byte units, full": 4, "fma 16-byte units, row": 4,
                "fma z first, full": 4, "fma z first, row": 4,
                "fma capped, full": 4, "fma capped, row": 4}
PORT_NAMES = ("digitize", "digitize_planar", "renorm_mid", "renorm_pack",
              "mulmod_fma_planar", "mulmod_fma_planar_row")
PORT_SASS = {name: cs.SASS_NAME[name] for name in PORT_NAMES}


def start_build(work: Path):
    """Start nvcc on the experiment's source (runs beside the port's
    build); returns the process, the library path and the source."""
    from ligero_prover_tpu_torch import kernels
    work.mkdir(parents=True, exist_ok=True)
    src = work / "exp_digitize_fma.cu"
    src.write_text(SOURCE)
    so = work / "libexp_digitize_fma.so"
    proc = subprocess.Popen([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared",
                             f"-I{kernels.CSRC}", "-o", str(so), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, so


def finish_build(proc, so: Path):
    text, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{text}")
    lib = ctypes.CDLL(str(so))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.exp_old_digitize.argtypes = [p, p, i64, p]
    lib.exp_digitize.argtypes = [p, i64, i64, p, i64, i32, i32, i32, p]
    lib.exp_old_repack.argtypes = [p, p, i64, i64, i64, p, i64, i32, p]
    lib.exp_fma.argtypes = [p, i64, p, i64, i64, p, i64, p, i64, i32, p]
    return lib, text


def per_element(sass: dict, elements: dict) -> dict:
    return {name: {key: (v / elements.get(name, 1)
                         if isinstance(v, int) else v)
                   for key, v in row.items()}
            for name, row in sass.items()}


def log_row(name, row, bnd):
    print(f"  {name}: grid {row['grid'][0]}x{row['grid'][1]} max_abs_err="
          f"{row['max_abs_err']} ms={row['ms']:.4f} (L2-hot "
          f"{row['hot_ms']:.4f}) floor={row['floor_ms']:.4f} "
          f"bound%={100 * bnd[0] / row['ms']:.0f}", flush=True)


def in_turns(designs: dict) -> list:
    """Each design twice: in order, then in reverse."""
    return list(designs) + list(designs)[::-1]


def digitize_calls(device, gen, lib, elib, stream, result, k=cs.FULL_K):
    import torch
    from ligero_prover_tpu_torch import kernels
    from ligero_prover_tpu_torch.ops import mxu_renorm as mr
    bsz = 16
    size = bsz * k
    rows = cs.random_limbs(gen, (bsz, k), device, True)
    rows[0, :4] = cs.edge_limbs(device)[:4]
    rows[1, :4] = cs.digit_edges(device)
    view = rows.movedim(-1, 0)
    planar = view.contiguous()
    want = mr.digitize_plain(planar)
    out = torch.empty_like(planar)
    bnd = cs.bound("digitize", 64 * size, size)
    print(f"digitize (8,{bsz},{k}): bound {bnd[0]:.4f} ms ({bnd[1]})",
          flush=True)
    threads = cs.DIGIT_THREADS
    for layout, operand, strides in (("planar", planar, (size, 1)),
                                     ("aos", rows, (1, 8))):
        designs = {"port (entry point)": (
            lambda a, o, st=strides: lib.ligero_digitize(
                a.data_ptr(), *st, o.data_ptr(), size, stream),
            (-(-size // threads), threads))}
        if layout == "planar":
            designs["old (byte loop, 256 per CTA)"] = (
                lambda a, o: elib.exp_old_digitize(a.data_ptr(), o.data_ptr(),
                                                   size, stream),
                (-(-size // 256), 256))
        # (exp_digitize layout, elements a thread, threads a CTA) of the
        # port's forms other than the one it launches here, and of the
        # vector alternatives
        forms = [(DIGIT_FORMS["word by word"], 1, t) for t in DIGIT_THREADS]
        if layout == "aos":
            forms.append((DIGIT_FORMS["16-byte aos"], 1, 128))
        else:
            forms.remove((DIGIT_FORMS["word by word"], 1, threads))
        forms += [(DIGIT_VEC[layout], v, t) for v in DIGIT_V
                  for t in DIGIT_THREADS]
        label = {code: name for name, code in DIGIT_FORMS.items()}
        for code, v, t in forms:
            dname = f"{label.get(code, 'v' + str(v))} t{t}"
            designs[dname] = (
                lambda a, o, c=code, v=v, t=t, st=strides: elib.exp_digitize(
                    a.data_ptr(), *st, o.data_ptr(), size, c, v, t, stream),
                (-(-size // (v * t)), t))
        calls = result["digitize"][layout] = {"bound_ms": bnd[0],
                                              "bound_by": bnd[1],
                                              "designs": {}}
        print(f" layout {layout}, strides {strides}", flush=True)
        for name in in_turns(designs):
            launch, grid = designs[name]

            def run(a, o, launch=launch, name=name):
                kernels.check(launch(a, o), name)
            row = measure(lib, stream, name, run, (operand, out), want, out,
                          grid)
            calls["designs"].setdefault(name, []).append(row)
            log_row(name, row, bnd)
    # the engine's step before and after: copy the AoS rows to planes, then
    # the old kernel; or the port's kernel on the rows in place
    tmp = torch.empty_like(planar)

    def pair(r, t, o):
        t.copy_(r.movedim(-1, 0))
        kernels.check(elib.exp_old_digitize(t.data_ptr(), o.data_ptr(), size,
                                            stream), "old digitize")
    row = measure(lib, stream, "copy + old digitize", pair,
                  (rows, tmp, out), want, out, (-(-size // 256), 256))
    result["digitize"]["aos"]["designs"]["aten copy + old (the engine "
                                         "before)"] = [row]
    log_row("aten copy + old digitize (the engine before)", row, bnd)
    # what moving the same bytes costs: the permuting copy alone, and a
    # copy of the planar limbs (cudaMemcpyAsync device to device)
    for label, src in (("aten copy of the AoS rows to planes", rows),
                       ("copy of the planar limbs", planar)):
        def copy(r, t, planes=src is planar):
            t.copy_(r if planes else r.movedim(-1, 0))
        cold, hot = cs.launches_ms(copy, src, tmp)
        result["digitize"]["copies_ms"] = {
            **result["digitize"].get("copies_ms", {}), label: [cold, hot]}
        print(f"  {label}: ms={cold:.4f} (L2-hot {hot:.4f})", flush=True)


def kr_calls(device, gen, lib, elib, stream, result, k=cs.FULL_K):
    import torch
    from ligero_prover_tpu_torch import kernels
    from ligero_prover_tpu_torch.ops import mxu_ntt as mx, mxu_renorm as mr, \
        ntt
    n, bsz = 4 * k, 16
    tabs = ntt.RSCodec(k, n, device).mxu_tabs
    r1, c1 = tabs["geom"][:2]
    x = cs.random_limbs(gen, (bsz, k), device, True).movedim(-1, 0) \
        .contiguous()
    xp = mr.digitize(x).view(8, bsz, r1, c1)
    s1 = mx.level1_slots(xp, tabs).clone()
    b1 = mr.renorm_mid(s1, tabs["tw1"])
    s2 = mx.level2_slots(b1, tabs).clone()
    a2 = mr.renorm_mid(s2, tabs["tw3"])
    s3 = mx.level3_slots(a2, tabs).clone()
    for label, slots, tw in (("renorm_mid level 1", s1, tabs["tw1"]),
                             ("renorm_mid level 2", s2, tabs["tw3"]),
                             ("renorm_pack level 3", s3, None)):
        name = label.split()[0]
        xs = slots[0].numel()
        plain = getattr(mr, name + "_plain")
        want = plain(slots, tw) if tw is not None else plain(slots)
        out = torch.empty((8,) + slots.shape[1:], dtype=torch.int32,
                          device=device)
        ls = 0 if tw is None else tw[0].numel()
        shifts = (0, 0) if tw is None else mr.twiddle_shifts(
            name, xs, *mr.twiddle_index(name, slots.shape[1:],
                                        tw.shape[1:]))
        bnd = cs.bound(name, 288 * xs + (0 if tw is None else
                                         4 * tw.numel()), xs)
        twb = tw if tw is not None else torch.zeros(8, dtype=torch.int32,
                                                    device=device)
        mode = mr.RENORM_MODE[name]
        designs = {
            "port (entry point)": lambda s, t, o: lib.ligero_renorm(
                s.data_ptr(), None if tw is None else t.data_ptr(), ls,
                *shifts, o.data_ptr(), xs, mode, stream),
            "byte-serial repack": lambda s, t, o: elib.exp_old_repack(
                s.data_ptr(), t.data_ptr(), ls, *shifts, o.data_ptr(), xs,
                mode, stream)}
        row = result["kr"][label] = {"bound_ms": bnd[0], "bound_by": bnd[1],
                                     "designs": {}}
        print(f"KR {label} (64,{xs}): bound {bnd[0]:.4f} ms ({bnd[1]})",
              flush=True)
        # in turns: port, old, old, port
        for turn, dname in enumerate(("port (entry point)",
                                      "byte-serial repack",
                                      "byte-serial repack",
                                      "port (entry point)")):
            def run(s, t, o, launch=designs[dname], dname=dname):
                kernels.check(launch(s, t, o), dname)
            m = measure(lib, stream, dname, run, (slots, twb, out), want,
                        out, (-(-xs // 256), 256))
            row["designs"].setdefault(dname, []).append(m)
            log_row(f"{dname} (turn {turn + 1})", m, bnd)


def fma_calls(device, gen, lib, elib, stream, result, k=cs.FULL_K):
    import torch
    from ligero_prover_tpu_torch import kernels
    from ligero_prover_tpu_torch.ops import fieldmul as fm
    n, bsz = 4 * k, 16
    size = bsz * n

    def planes(shape, canonical):
        return cs.random_limbs(gen, shape, device, canonical) \
            .movedim(-1, 0).contiguous()
    x, z = planes((bsz, n), False), planes((bsz, n), False)
    x[:, 0, :6] = cs.edge_limbs(device).T
    z[:, 0, :6] = cs.edge_limbs(device, reverse=True).T
    z[:, 1] = planes((n,), True)                     # a canonical row
    for form, y, y_div in (("full", planes((bsz, n), False), 1),
                           ("row", planes((bsz, 1), False), n)):
        y.view(8, -1)[:, :6] = cs.edge_limbs(device).T
        want = fm.mulmod_fma_planar_plain(z, x, y)
        out = torch.empty_like(x)
        y_ls = y[0].numel()
        bnd = cs.bound(fm.FMA, 96 * size + 4 * y.numel(), size)
        length = n if y_div > 1 else size
        designs = {"port (entry point)": (
            lambda a, b, c, o, y_ls=y_ls, y_div=y_div:
            lib.ligero_planar_eltwise(
                a.data_ptr(), size, b.data_ptr(), y_ls, y_div, c.data_ptr(),
                size, o.data_ptr(), size, fm.FMA_MODE, stream),
            cs.run_grid(size, length, False))}
        for design, dname in FMA_DESIGNS.items():
            grid = (-(-size // 256), 256) if design <= 1 else \
                cs.run_grid(size, length, True)
            designs[dname] = (
                lambda a, b, c, o, d=design, y_ls=y_ls, y_div=y_div:
                elib.exp_fma(a.data_ptr(), size, b.data_ptr(), y_ls, y_div,
                             c.data_ptr(), size, o.data_ptr(), size, d,
                             stream), grid)
        row = result["fma"][form] = {"bound_ms": bnd[0], "bound_by": bnd[1],
                                     "designs": {}}
        print(f"mulmod_fma {form}: (8,{bsz},{n}) + same x "
              f"{tuple(y.shape)}: bound {bnd[0]:.4f} ms ({bnd[1]})",
              flush=True)
        for dname in in_turns(designs):
            launch, grid = designs[dname]

            def run(a, b, c, o, launch=launch, dname=dname):
                kernels.check(launch(a, b, c, o), dname)
            m = measure(lib, stream, dname, run, (x, y, z, out), want, out,
                        grid)
            row["designs"].setdefault(dname, []).append(m)
            log_row(dname, m, bnd)


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/exp_digitize_fma.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("experiment_digitize_fma: no CUDA device", file=sys.stderr)
        return 1
    import numpy as np
    from ligero_prover_tpu_torch import kernels

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    clk = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True,
                         check=True).stdout.split()[0]
    cs.CARD["clock_hz"] = float(clk) * 1e6
    print(card, flush=True)
    device = torch.device("cuda", 0)
    proc, eso = start_build(kernels.BUILD_DIR / "exp_digitize_fma")
    lib, stream = kernels.lib(), kernels.stream_handle(device)
    elib, elog = finish_build(proc, eso)
    port_so = Path(kernels.build_info["path"])
    result = {"card": card, "max_sm_clock_mhz": float(clk),
              "ptxas": {**cs.ptxas_report(kernels.build_info.get("log", ""),
                                          PORT_SASS),
                        **cs.ptxas_report(elog, EXP_SASS)},
              "sass_per_element": {
                  **per_element(opcode_classes(port_so, PORT_SASS),
                                cs.SASS_ELEMENTS),
                  **per_element(opcode_classes(eso, EXP_SASS),
                                EXP_ELEMENTS)},
              "digitize": {}, "kr": {}, "fma": {}}
    print(f"ptxas (registers, spill stores, spill loads): "
          f"{result['ptxas']}", flush=True)
    for name, row in result["sass_per_element"].items():
        print(f"SASS per element {name}: {row}", flush=True)
    gen = np.random.default_rng(cs.SEED)
    digitize_calls(device, gen, lib, elib, stream, result)
    fma_calls(device, gen, lib, elib, stream, result)
    kr_calls(device, gen, lib, elib, stream, result)
    print(json.dumps(result), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
