#!/usr/bin/env python3
"""K1 (AoS mont_mul) and KR (renorm_mid, final, pack) before and after their
move onto the carry-chain Montgomery product, side by side on one GPU.

    python3 experiment_k1_kr.py [--out build/exp_k1_kr.json]

K1 at the calls of its callers: the AoS DIT butterfly's (16*16384, 8) rows
times a (16384, 8) twiddle broadcast over the batch, and the vbn254fr
arena's (8192, 8) rows times the same shape (the invmod ladder's squares)
and times one (1, 8) constant (``mont_mul_const``, the ladder's last
step).  Designs:

* the port's kernel (``csrc/fieldmul.cu``: ``mont_mul_cc``, 32-bit index,
  blocks sized to the call), through its entry point and at 32 to 256
  threads per block;
* the kernel it replaced (``mont_mul`` with 64-bit accumulation, a 64-bit
  grid-stride index with ``%``, 256-thread blocks), kept only in the source
  string below (``exp_old_k1``);
* the port's element function with each warp's 1 KiB of x and of out
  moved as 16-byte chunks on consecutive lanes, staged through shared
  memory; capped at 32 registers (8 CTAs of 256 on an SM); and two
  elements per thread with both loads issued first (``exp_k1``'s designs),
  also only here.

KR at the engine's calls for k=8192 (real slots: a level product of random
canonical rows through the built tables): renorm_mid at level 1
(64, 131072) x tw1 and level 2 (64, 524288) x tw3, renorm_final and
renorm_pack at (64, 524288).  Designs (``exp_kr``): the replaced kernels
verbatim (``redc`` and ``mont_mul``, the twiddle index by divide); its
renorm_mid with ``mont_mul_cc`` and the shift index alone; the port's
element function (``redc_cc`` besides) with no register cap and at 3 or
4 CTAs of 256 per SM; and the port's entry point.

Each design is checked against the plain version (max_abs_err 0) and
timed as ``chip_smoke.py`` times the port's kernels (L2-cold rotating
copies, the L2-hot time beside, the launch floor of an empty kernel at the
same grid).  Prints the card's name and power limit, each kernel's
registers and spills, its SASS per element by opcode class
(``cuobjdump``) and where its global loads sit in it, one line per
measurement, and one JSON object, also
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
from experiment_sha_absorb import opcode_classes

SOURCE = r"""
#include "fieldmul.cu"
#include "renorm.cu"

#ifdef __CUDACC__

namespace exp_k1kr {

using namespace ligero_fm;

// K1 as it was: a grid-stride loop with a 64-bit index and `%`,
// field.cuh's mont_mul, 256-thread blocks
__global__ void __launch_bounds__(256)
old_mont_mul_kernel(const uint4* __restrict__ x, const uint4* __restrict__ y,
                    uint4* __restrict__ out, long long n, long long y_rows) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    uint32_t a[8], b[8], r[8];
    load_elem((const uint32_t*)(x + 2 * i), a);
    load_elem((const uint32_t*)(y + 2 * (i % y_rows)), b);
    mont_mul(a, b, r);
    store_elem((uint32_t*)(out + 2 * i), r);
  }
}

// The port's element work with x and out moved as 16-byte chunks on
// consecutive lanes: each warp's 32 elements (1 KiB) staged through shared
// memory.  n is a multiple of 32.
__global__ void __launch_bounds__(256)
staged_mont_mul_kernel(const uint4* __restrict__ x,
                       const uint32_t* __restrict__ y,
                       uint4* __restrict__ out, uint32_t n, uint32_t y_rows) {
  __shared__ uint4 buf[256 * 2];
  const uint32_t lane = threadIdx.x & 31u;
  uint4* wb = buf + 2u * (threadIdx.x & ~31u);
  const uint32_t base = blockIdx.x * blockDim.x + (threadIdx.x & ~31u);
  if (base >= n) return;
  const uint4* xw = x + 2ull * base;
  wb[lane] = xw[lane];
  wb[32 + lane] = xw[32 + lane];
  __syncwarp();
  const uint32_t i = base + lane;
  const uint4 a0 = wb[2 * lane], a1 = wb[2 * lane + 1];
  uint32_t a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  uint32_t b[8], r[8];
  load_elem(y + 8ull * mont_mul_row(n, y_rows, i), b);
  mont_mul_cc(a, b, r);
  __syncwarp();
  wb[2 * lane] = make_uint4(r[0], r[1], r[2], r[3]);
  wb[2 * lane + 1] = make_uint4(r[4], r[5], r[6], r[7]);
  __syncwarp();
  uint4* ow = out + 2ull * base;
  ow[lane] = wb[lane];
  ow[32 + lane] = wb[32 + lane];
}

// The port's kernel capped at 32 registers (8 CTAs of 256 on an SM)
__global__ void __launch_bounds__(256, 8)
capped_mont_mul_kernel(const uint32_t* __restrict__ x,
                       const uint32_t* __restrict__ y,
                       uint32_t* __restrict__ out, uint32_t n,
                       uint32_t y_rows) {
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) mont_mul_at(x, y, out, n, y_rows, i);
}

// Two elements per thread, i and i + n/2 (n even), both elements' loads
// issued before the first product
__global__ void __launch_bounds__(256)
pair_mont_mul_kernel(const uint32_t* __restrict__ x,
                     const uint32_t* __restrict__ y,
                     uint32_t* __restrict__ out, uint32_t n,
                     uint32_t y_rows) {
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x, h = n / 2u;
  if (i >= h) return;
  uint32_t a0[8], b0[8], a1[8], b1[8], r[8];
  load_elem(x + 8ull * i, a0);
  load_elem(y + 8ull * mont_mul_row(n, y_rows, i), b0);
  load_elem(x + 8ull * (i + h), a1);
  load_elem(y + 8ull * mont_mul_row(n, y_rows, i + h), b1);
  mont_mul_cc(a0, b0, r);
  store_elem(out + 8ull * i, r);
  mont_mul_cc(a1, b1, r);
  store_elem(out + 8ull * (i + h), r);
}

// KR as it was (field.cuh's redc and mont_mul, the twiddle index by
// divide), verbatim; with kCC, its renorm_mid takes mont_mul_cc and the
// port's shift index (tw_bc, tw_c then hold their log2).
LIGERO_HD void old_slots_to_canonical(const int32_t* s, uint32_t stride,
                                      uint32_t out[8]) {
  uint32_t u[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) u[i] = 0;
  uint32_t uh = 0;
  int32_t acc = 0;
#pragma unroll
  for (int e = 0; e < 66; ++e) {
    if (e < 64) acc += s[(uint32_t)e * stride];
    const uint32_t b = (uint32_t)acc & 0xFFu;
    acc = (acc - (int32_t)b) >> 8;          // arithmetic shift
    if (e < 63)
      u[e / 4] |= b << (8 * (e % 4));
    else
      uh |= b << (8 * (e - 63));
  }
  uint64_t carry = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t t = (uint64_t)uh * ligero_rn::kK504[i] + u[i] + carry;
    u[i] = (uint32_t)t;
    carry = t >> 32;
  }
#pragma unroll
  for (int i = 8; i < 16; ++i) {
    uint64_t t = (uint64_t)u[i] + carry;
    u[i] = (uint32_t)t;
    carry = t >> 32;
  }
  redc(u, out);
}

template <int kMode, bool kCC>
LIGERO_HD void old_renorm_at(const int32_t* slots, const uint32_t* tw,
                             uint32_t tw_ls, uint32_t tw_bc, uint32_t tw_c,
                             uint32_t* out, uint32_t X, uint32_t i) {
  uint32_t t[8], r[8];
  old_slots_to_canonical(slots + i, X, t);
  if (kMode == ligero_rn::kFinal) {
#pragma unroll
    for (int l = 0; l < 8; ++l) out[(uint32_t)l * X + i] = t[l];
    return;
  }
  if (kMode == ligero_rn::kMid) {
    const uint32_t ti = kCC ? ligero_rn::twiddle_at(tw_bc, tw_c, i)
                            : (i / tw_bc) * tw_c + i % tw_c;
    uint32_t w[8], y[8];
#pragma unroll
    for (int l = 0; l < 8; ++l) w[l] = tw[(uint32_t)l * tw_ls + ti];
    if (kCC) mont_mul_cc(t, w, y); else mont_mul(t, w, y);
    ligero_rn::canonical_to_packed(y, r);
  } else {
    ligero_rn::canonical_to_packed(t, r);
  }
#pragma unroll
  for (int l = 0; l < 8; ++l) out[(uint32_t)l * X + i] = r[l];
}

template <int kMode, bool kCC>
__global__ void __launch_bounds__(256)
old_renorm_kernel(const int32_t* __restrict__ slots,
                  const uint32_t* __restrict__ tw, uint32_t tw_ls,
                  uint32_t tw_bc, uint32_t tw_c, uint32_t* __restrict__ out,
                  uint32_t X) {
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t i = blockIdx.x * blockDim.x + threadIdx.x; i < X; i += stride)
    old_renorm_at<kMode, kCC>(slots, tw, tw_ls, tw_bc, tw_c, out, X, i);
}

// The port's renorm element function under other launch bounds: no
// register cap, or at least kMinBlocks CTAs of 256 on an SM.
template <int kMode>
__device__ __forceinline__ void port_renorm_loop(
    const int32_t* __restrict__ slots, const uint32_t* __restrict__ tw,
    uint32_t tw_ls, uint32_t lbc, uint32_t lc, uint32_t* __restrict__ out,
    uint32_t X) {
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t i = blockIdx.x * blockDim.x + threadIdx.x; i < X; i += stride)
    ligero_rn::renorm_at<kMode>(slots, tw, tw_ls, lbc, lc, out, X, i);
}

template <int kMode>
__global__ void __launch_bounds__(256)
port_renorm_kernel(const int32_t* __restrict__ slots,
                   const uint32_t* __restrict__ tw, uint32_t tw_ls,
                   uint32_t lbc, uint32_t lc, uint32_t* __restrict__ out,
                   uint32_t X) {
  port_renorm_loop<kMode>(slots, tw, tw_ls, lbc, lc, out, X);
}

template <int kMode, int kMinBlocks>
__global__ void __launch_bounds__(256, kMinBlocks)
capped_renorm_kernel(const int32_t* __restrict__ slots,
                     const uint32_t* __restrict__ tw, uint32_t tw_ls,
                     uint32_t lbc, uint32_t lc, uint32_t* __restrict__ out,
                     uint32_t X) {
  port_renorm_loop<kMode>(slots, tw, tw_ls, lbc, lc, out, X);
}

}  // namespace exp_k1kr

extern "C" int exp_old_k1(const void* x, const void* y, void* out,
                          long long n, long long y_rows, void* stream) {
  long long blocks = (n + 255) / 256;
  if (blocks > 1048576) blocks = 1048576;
  exp_k1kr::old_mont_mul_kernel<<<(unsigned)blocks, 256, 0,
                                  (cudaStream_t)stream>>>(
      (const uint4*)x, (const uint4*)y, (uint4*)out, n, y_rows);
  return (int)cudaGetLastError();
}

// A K1 design at `threads` per block, n < 2^31: 0 the port's kernel,
// 1 staged (n a multiple of 32), 2 capped at 32 registers, 3 two elements
// per thread (n even).
extern "C" int exp_k1(const void* x, const void* y, void* out, long long n,
                      long long y_rows, int threads, int design,
                      void* stream) {
  const long long work = design == 3 ? n / 2 : n;
  const unsigned blocks = (unsigned)((work + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* xp = (const uint32_t*)x;
  const uint32_t* yp = (const uint32_t*)y;
  uint32_t* op = (uint32_t*)out;
  const uint32_t nn = (uint32_t)n, yr = (uint32_t)y_rows;
  switch (design) {
    case 0:
      ligero_fm::mont_mul_kernel<uint32_t><<<blocks, threads, 0, s>>>(
          xp, yp, op, nn, yr);
      break;
    case 1:
      exp_k1kr::staged_mont_mul_kernel<<<blocks, threads, 0, s>>>(
          (const uint4*)x, yp, (uint4*)out, nn, yr);
      break;
    case 2:
      exp_k1kr::capped_mont_mul_kernel<<<blocks, threads, 0, s>>>(
          xp, yp, op, nn, yr);
      break;
    case 3:
      exp_k1kr::pair_mont_mul_kernel<<<blocks, threads, 0, s>>>(
          xp, yp, op, nn, yr);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// variant: see KR_VARIANTS in experiment_k1_kr.py
extern "C" int exp_kr(const void* slots, const void* tw, long long tw_ls,
                      long long a, long long b, void* out, long long X,
                      int variant, void* stream) {
  const unsigned grid = ligero_rn::grid_for((unsigned long long)X);
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* sp = (const int32_t*)slots;
  const uint32_t* tp = (const uint32_t*)tw;
  uint32_t* op = (uint32_t*)out;
  const uint32_t ls = (uint32_t)tw_ls, aa = (uint32_t)a, bb = (uint32_t)b,
                 xx = (uint32_t)X;
#define EXP_KR(...) __VA_ARGS__<<<grid, 256, 0, s>>>(sp, tp, ls, aa, bb, op, xx)
  using namespace exp_k1kr;
  using ligero_rn::kFinal;
  using ligero_rn::kMid;
  using ligero_rn::kPack;
  switch (variant) {
    case 0: EXP_KR(old_renorm_kernel<kMid, false>); break;
    case 1: EXP_KR(old_renorm_kernel<kMid, true>); break;
    case 2: EXP_KR(port_renorm_kernel<kMid>); break;
    case 3: EXP_KR(capped_renorm_kernel<kMid, 3>); break;
    case 4: EXP_KR(capped_renorm_kernel<kMid, 4>); break;
    case 5: EXP_KR(old_renorm_kernel<kFinal, false>); break;
    case 6: EXP_KR(port_renorm_kernel<kFinal>); break;
    case 7: EXP_KR(capped_renorm_kernel<kFinal, 4>); break;
    case 8: EXP_KR(old_renorm_kernel<kPack, false>); break;
    case 9: EXP_KR(port_renorm_kernel<kPack>); break;
    case 10: EXP_KR(capped_renorm_kernel<kPack, 4>); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef EXP_KR
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
"""

# exp_kr's variants: (mode, label, twiddle index by shifts)
KR_VARIANTS = {
    0: ("renorm_mid", "old: redc, mont_mul, divide index", False),
    1: ("renorm_mid", "old with mont_mul_cc and the shift index", True),
    2: ("renorm_mid", "port's function, no register cap", True),
    3: ("renorm_mid", "port's function, 3 CTAs/SM", True),
    4: ("renorm_mid", "port's function, 4 CTAs/SM (the port's)", True),
    5: ("renorm_final", "old: redc", False),
    6: ("renorm_final", "redc_cc, no register cap", False),
    7: ("renorm_final", "redc_cc, 4 CTAs/SM (the port's)", False),
    8: ("renorm_pack", "old: redc", False),
    9: ("renorm_pack", "redc_cc, no register cap", False),
    10: ("renorm_pack", "redc_cc, 4 CTAs/SM (the port's)", False),
}
_KR_SASS = {0: "old_renorm_kernelILi1ELb0E", 1: "old_renorm_kernelILi1ELb1E",
            2: "port_renorm_kernelILi1E", 3: "capped_renorm_kernelILi1ELi3E",
            4: "capped_renorm_kernelILi1ELi4E",
            5: "old_renorm_kernelILi0ELb0E", 6: "port_renorm_kernelILi0E",
            7: "capped_renorm_kernelILi0ELi4E",
            8: "old_renorm_kernelILi2ELb0E", 9: "port_renorm_kernelILi2E",
            10: "capped_renorm_kernelILi2ELi4E"}
EXP_SASS = {"old K1": "old_mont_mul_kernel",
            "staged K1": "staged_mont_mul_kernel",
            "capped K1": "capped_mont_mul_kernel",
            "pair K1": "pair_mont_mul_kernel",
            **{f"kr {v}": frag for v, frag in _KR_SASS.items()}}
PORT_SASS = {name: cs.SASS_NAME[name] for name in
             ("mont_mul", "renorm_mid", "renorm_final", "renorm_pack")}
K1_THREADS = (32, 64, 128, 256)
K1_DESIGNS = ("port", "staged", "capped at 32 registers",
              "two per thread")


def ldg_positions(so: Path, frags: dict) -> dict:
    """Per kernel: the positions of its global loads (LDG) in its SASS
    (instruction numbers from the top, NOPs left out) and its length, to
    show how far ahead of their use the loads are issued."""
    import os
    import re
    tool = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" \
        / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)", line)
        if cur is not None and m and m.group(1) != "NOP":
            cur.append(m.group(1))
    out = {}
    for name, frag in frags.items():
        ops = [v for f, v in funcs.items() if frag in f][0]
        out[name] = {"length": len(ops), "ldg": [i for i, op in
                                                 enumerate(ops)
                                                 if op.startswith("LDG")]}
    return out


def build(work: Path):
    from ligero_prover_tpu_torch import kernels
    work.mkdir(parents=True, exist_ok=True)
    src = work / "exp_k1_kr.cu"
    src.write_text(SOURCE)
    so = work / "libexp_k1_kr.so"
    proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared",
                           f"-I{kernels.CSRC}", "-o", str(so), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}\n{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.exp_old_k1.argtypes = [p, p, p, i64, i64, p]
    lib.exp_k1.argtypes = [p, p, p, i64, i64, i32, i32, p]
    lib.exp_kr.argtypes = [p, p, i64, i64, i64, p, i64, i32, p]
    return lib, so, proc.stdout + proc.stderr


def measure(lib, stream, name, run, buffers, want, out, grid):
    """Check `run` (a launch on `buffers`, writing `out`) against `want`,
    then time it L2-cold and L2-hot beside the floor at `grid`."""
    import torch
    out.fill_(-1)
    run(*buffers)
    torch.cuda.synchronize()
    err = cs.max_abs_err(out, want)
    cs.require(err == 0, f"{name} equals the plain version")
    cold, hot = cs.launches_ms(run, *buffers)
    floor = cs.floor_ms(lib, stream, *grid)
    return {"ms": cold, "hot_ms": hot, "floor_ms": floor, "grid": list(grid),
            "max_abs_err": err}


def k1_calls(device, gen, lib, elib, stream, result):
    import torch
    from ligero_prover_tpu_torch import kernels
    from ligero_prover_tpu_torch.ops import fieldmul as fm
    shapes = (("DIT (16*16384,8) x bcast (16384,8)", 16 * 16384, 16384),
              ("arena (8192,8) x (8192,8)", 8192, 8192),
              ("arena (8192,8) x (1,8)", 8192, 1))
    for label, n, y_rows in shapes:
        x = cs.random_limbs(gen, (n,), device, False)
        y = cs.random_limbs(gen, (y_rows,), device, False)
        x[:6], y[:min(6, y_rows)] = cs.edge_limbs(device), \
            cs.edge_limbs(device, reverse=True)[:y_rows]
        want = fm.mont_mul_plain(x.view(-1, y_rows, 8), y).view(n, 8)
        out = torch.empty_like(x)
        bnd = cs.bound("mont_mul", 64 * n + 32 * y_rows, n)
        calls = result["k1"][label] = {"bound_ms": bnd[0],
                                       "bound_by": bnd[1], "designs": {}}
        print(f"K1 {label}: bound {bnd[0]:.4f} ms ({bnd[1]})", flush=True)
        designs = {
            "port (entry point)": (lambda a, b, o: lib.ligero_mont_mul(
                a.data_ptr(), b.data_ptr(), o.data_ptr(), n, y_rows, 0,
                stream), cs.k2_grid(n)),
            "old (mont_mul, 64-bit index, 256 per CTA)": (
                lambda a, b, o: elib.exp_old_k1(
                    a.data_ptr(), b.data_ptr(), o.data_ptr(), n, y_rows,
                    stream), (min(-(-n // 256), 1048576), 256))}
        for threads in K1_THREADS:
            for design, dname in enumerate(K1_DESIGNS):
                work = n // 2 if design == 3 else n
                designs[f"{dname} ({threads} per CTA)"] = (
                    lambda a, b, o, t=threads, d=design: elib.exp_k1(
                        a.data_ptr(), b.data_ptr(), o.data_ptr(), n, y_rows,
                        t, d, stream), (-(-work // threads), threads))
        for name, (launch, grid) in designs.items():
            def run(a, b, o, launch=launch, name=name):
                kernels.check(launch(a, b, o), name)
            row = measure(lib, stream, name, run, (x, y, out), want, out,
                          grid)
            calls["designs"][name] = row
            print(f"  {name}: grid {grid[0]}x{grid[1]} max_abs_err="
                  f"{row['max_abs_err']} ms={row['ms']:.4f} (L2-hot "
                  f"{row['hot_ms']:.4f}) floor={row['floor_ms']:.4f} "
                  f"bound%={100 * bnd[0] / row['ms']:.0f}", flush=True)


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
    calls = (("renorm_mid level 1", s1, tabs["tw1"]),
             ("renorm_mid level 2", s2, tabs["tw3"]),
             ("renorm_final level 3", s3, None),
             ("renorm_pack level 3", s3, None))
    for label, slots, tw in calls:
        name = label.split()[0]
        xs = slots[0].numel()
        plain = getattr(mr, name + "_plain")
        want = plain(slots, tw) if tw is not None else plain(slots)
        out = torch.empty((8,) + slots.shape[1:], dtype=torch.int32,
                          device=device)
        ls = 0 if tw is None else tw[0].numel()
        bc, c = (1, 1) if tw is None else mr.twiddle_index(
            name, slots.shape[1:], tw.shape[1:])
        shifts = (0, 0) if tw is None else mr.twiddle_shifts(name, xs, bc, c)
        nbytes = 288 * xs + (0 if tw is None else 4 * tw.numel())
        bnd = cs.bound(name, nbytes, xs)
        row = result["kr"][label] = {"bound_ms": bnd[0], "bound_by": bnd[1],
                                     "designs": {}}
        print(f"KR {label} (64,{xs}): bound {bnd[0]:.4f} ms ({bnd[1]})",
              flush=True)
        grid = (-(-xs // 256), 256)
        twb = tw if tw is not None else torch.zeros(8, dtype=torch.int32,
                                                    device=device)
        designs = {"port (entry point)": lambda s, t, o: lib.ligero_renorm(
            s.data_ptr(), None if tw is None else t.data_ptr(), ls,
            *shifts, o.data_ptr(), xs, mr.RENORM_MODE[name], stream)}
        for v, (mode, vlabel, shift) in KR_VARIANTS.items():
            if mode == name:
                designs[vlabel] = (
                    lambda s, t, o, v=v, a=shifts if shift else (bc, c):
                    elib.exp_kr(s.data_ptr(), t.data_ptr(), ls, *a,
                                o.data_ptr(), xs, v, stream))
        for dname, launch in designs.items():
            def run(s, t, o, launch=launch, dname=dname):
                kernels.check(launch(s, t, o), dname)
            m = measure(lib, stream, dname, run, (slots, twb, out), want,
                        out, grid)
            row["designs"][dname] = m
            print(f"  {dname}: max_abs_err={m['max_abs_err']} "
                  f"ms={m['ms']:.4f} (L2-hot {m['hot_ms']:.4f}) "
                  f"floor={m['floor_ms']:.4f} "
                  f"bound%={100 * bnd[0] / m['ms']:.0f}", flush=True)


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/exp_k1_kr.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("experiment_k1_kr: no CUDA device", file=sys.stderr)
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
    lib, stream = kernels.lib(), kernels.stream_handle(device)
    elib, eso, elog = build(kernels.BUILD_DIR / "exp_k1_kr")
    result = {"card": card, "max_sm_clock_mhz": float(clk),
              "ptxas": {**cs.ptxas_report(kernels.build_info.get("log", ""),
                                          PORT_SASS),
                        **cs.ptxas_report(elog, EXP_SASS)},
              "sass": {**opcode_classes(Path(kernels.build_info["path"]),
                                        PORT_SASS),
                       **opcode_classes(eso, EXP_SASS)},
              "ldg": {**ldg_positions(Path(kernels.build_info["path"]),
                                      PORT_SASS),
                      **ldg_positions(eso, EXP_SASS)},
              "k1": {}, "kr": {}}
    print(f"ptxas (registers, spill stores, spill loads): "
          f"{result['ptxas']}", flush=True)
    for name, row in result["sass"].items():
        print(f"SASS {name}: {row}", flush=True)
    for name, row in result["ldg"].items():
        print(f"LDG positions {name} (of {row['length']}): {row['ldg']}",
              flush=True)
    gen = np.random.default_rng(cs.SEED)
    k1_calls(device, gen, lib, elib, stream, result)
    kr_calls(device, gen, lib, elib, stream, result)
    print(json.dumps(result), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
