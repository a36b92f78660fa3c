#!/usr/bin/env python3
"""K3, the column SHA-256 absorb, in three designs side by side on one GPU.

    python3 experiment_sha_absorb.py [--out build/exp_sha_absorb.json]

* the port's kernel (``csrc/sha256.cu``: a CTA per tile of 32 or 64
  columns, schedule warps expanding each block into a two-stage ring in
  shared memory, round warps holding the state), at both tile sizes;
* the kernel it replaced (one thread per column in CTAs of 256, each
  block's words loaded at the top of its iteration), kept only in the
  source string below (``exp_old_absorb``);
* a simpler redesign (one thread per column, the next block's words
  loaded into registers while the current block is compressed, CTAs of
  32 to 256 columns; ``exp_prefetch_absorb``), also only here, with its
  adds as written or, like the port's, as IMADs (``x * one + y``).

Each is checked against the plain version (state, pending element) and
timed as ``chip_smoke.py`` times the port's kernels (L2-cold rotating
copies, the L2-hot time beside, the launch floor of an empty kernel at the
same grid) at the three calls of the main path: the commit step's planar
flush (8, 16, 32768), an AoS flush (16, 32768, 8) and the verifier's
(16, 192, 8); every flush absorbs 16 rows (8 blocks).  Prints the card's
name and power limit, each kernel's registers and spills, its SASS per
compression and its opcodes by class (``cuobjdump``), one line per
measurement, and one JSON object, also written to ``--out``.  Needs a CUDA
device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

import chip_smoke as cs

SOURCE = r"""
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define LIGERO_HD __device__ __forceinline__
#define LIGERO_CONST __constant__
#else
#define LIGERO_HD static inline
#define LIGERO_CONST static const
#endif

namespace sha_old {

LIGERO_CONST uint32_t kK[64] = {
    0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu,
    0x59f111f1u, 0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u,
    0x243185beu, 0x550c7dc3u, 0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u,
    0xc19bf174u, 0xe49b69c1u, 0xefbe4786u, 0x0fc19dc6u, 0x240ca1ccu,
    0x2de92c6fu, 0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau, 0x983e5152u,
    0xa831c66du, 0xb00327c8u, 0xbf597fc7u, 0xc6e00bf3u, 0xd5a79147u,
    0x06ca6351u, 0x14292967u, 0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu,
    0x53380d13u, 0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u,
    0xa2bfe8a1u, 0xa81a664bu, 0xc24b8b70u, 0xc76c51a3u, 0xd192e819u,
    0xd6990624u, 0xf40e3585u, 0x106aa070u, 0x19a4c116u, 0x1e376c08u,
    0x2748774cu, 0x34b0bcb5u, 0x391c0cb3u, 0x4ed8aa4au, 0x5b9cca4fu,
    0x682e6ff3u, 0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u,
    0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u};

LIGERO_HD uint32_t rotr(uint32_t x, int r) {
  return (x >> r) | (x << (32 - r));
}

// One compression of `w` (16 message words, consumed) into `st`.
LIGERO_HD void transform(uint32_t st[8], uint32_t w[16]) {
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    if (i >= 16) {
      uint32_t x15 = w[(i - 15) & 15], x2 = w[(i - 2) & 15];
      uint32_t s0 = rotr(x15, 7) ^ rotr(x15, 18) ^ (x15 >> 3);
      uint32_t s1 = rotr(x2, 17) ^ rotr(x2, 19) ^ (x2 >> 10);
      w[i & 15] = w[i & 15] + s1 + w[(i - 7) & 15] + s0;
    }
    uint32_t t1 = h + (rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)) +
                  ((e & f) ^ (~e & g)) + kK[i] + w[i & 15];
    uint32_t t2 = (rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)) +
                  ((a & b) ^ (a & c) ^ (b & c));
    h = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + t2;
  }
  st[0] += a; st[1] += b; st[2] += c; st[3] += d;
  st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

// Element j of the stream [pending, rows...] for column c, as 8 words.
// rows is (B, C, 8) element-major, or (8, B, C) limb-major when kPlanar;
// pending is always (C, 8).
template <bool kPlanar>
LIGERO_HD void load_elem(const uint32_t* pend, const uint32_t* rows,
                         long long C, int B, long long c, int j,
                         uint32_t v[8]) {
  if (kPlanar && j > 0) {
    const uint32_t* p = rows + (long long)(j - 1) * C + c;
    const long long plane = (long long)B * C;
    for (int i = 0; i < 8; ++i) v[i] = p[i * plane];
    return;
  }
  const uint32_t* p =
      j == 0 ? pend + c * 8 : rows + ((long long)(j - 1) * C + c) * 8;
#ifdef __CUDACC__
  uint4 lo = ((const uint4*)p)[0], hi = ((const uint4*)p)[1];
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
#else
  for (int i = 0; i < 8; ++i) v[i] = p[i];
#endif
}

// Absorb one column's share of a flush: `st` (8 words) in and out; the
// new pending element goes to `pend_out` (8 words).
template <bool kPlanar>
LIGERO_HD void absorb_column(uint32_t st[8], const uint32_t* pend,
                             const uint32_t* rows, long long C, long long c,
                             int B, int has_pending, int valid_count,
                             uint32_t pend_out[8]) {
  int start = 1 - has_pending;
  int total = valid_count + has_pending;
  int pairs = total / 2;
  for (int i = 0; i < pairs; ++i) {
    uint32_t w[16];
    load_elem<kPlanar>(pend, rows, C, B, c, start + 2 * i, w);
    load_elem<kPlanar>(pend, rows, C, B, c, start + 2 * i + 1, w + 8);
    transform(st, w);
  }
  int idx = start + 2 * pairs;
  idx = idx < 0 ? 0 : (idx > B ? B : idx);
  load_elem<kPlanar>(pend, rows, C, B, c, idx, pend_out);
}

}  // namespace sha_old

#ifdef __CUDACC__

namespace sha_old {

template <bool kPlanar>
__global__ void __launch_bounds__(256)
absorb_kernel(const uint32_t* __restrict__ state_in,
              const uint32_t* __restrict__ pend_in,
              const uint32_t* __restrict__ rows,
              uint32_t* __restrict__ state_out,
              uint32_t* __restrict__ pend_out, long long C, int B,
              int has_pending, int valid_count) {
  long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  uint32_t st[8], v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) st[i] = state_in[i * C + c];
  absorb_column<kPlanar>(st, pend_in, rows, C, c, B, has_pending,
                         valid_count, v);
  uint4* po = (uint4*)(pend_out + c * 8);
  po[0] = make_uint4(v[0], v[1], v[2], v[3]);
  po[1] = make_uint4(v[4], v[5], v[6], v[7]);
#pragma unroll
  for (int i = 0; i < 8; ++i) state_out[i * C + c] = st[i];
}

}  // namespace sha_old

// state: (8, C) u32, pending: (C, 8) u32, rows: (B, C, 8) u32, or
// (8, B, C) when `planar` is 1 (the planar codec's codewords, read with no
// transpose); outputs must not alias inputs.  pending and AoS rows 16-byte
// aligned; 0 <= valid_count <= B.  Returns cudaGetLastError().
extern "C" int exp_old_absorb(const void* state_in,
                                    const void* pending_in, const void* rows,
                                    void* state_out, void* pending_out,
                                    long long C, int B, int has_pending,
                                    int valid_count, int planar,
                                    void* stream) {
  if (C <= 0) return 0;
  if (B < 0 || valid_count < 0 || valid_count > B ||
      (has_pending != 0 && has_pending != 1) || (planar != 0 && planar != 1))
    return (int)cudaErrorInvalidValue;
  const int threads = 256;
  unsigned blocks = (unsigned)((C + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* st = (const uint32_t*)state_in;
  const uint32_t* pe = (const uint32_t*)pending_in;
  const uint32_t* ro = (const uint32_t*)rows;
  if (planar)
    sha_old::absorb_kernel<true><<<blocks, threads, 0, s>>>(
        st, pe, ro, (uint32_t*)state_out, (uint32_t*)pending_out, C, B,
        has_pending, valid_count);
  else
    sha_old::absorb_kernel<false><<<blocks, threads, 0, s>>>(
        st, pe, ro, (uint32_t*)state_out, (uint32_t*)pending_out, C, B,
        has_pending, valid_count);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__

// ---- a second design: one thread per column, the next block's words
// loaded into registers while the current block is compressed, and a CTA
// of `threads` columns (the grid then covers every SM)
#ifdef __CUDACC__
namespace sha_old {

// transform() with every add x + y written as x * one + y (one = 1 from
// the kernel's arguments), so that it issues as an IMAD on the FMA pipe
__device__ __forceinline__ uint32_t add1(uint32_t x, uint32_t y,
                                         uint32_t one) {
  return x * one + y;
}

__device__ __forceinline__ void transform_fma(uint32_t st[8], uint32_t w[16],
                                              uint32_t one) {
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    if (i >= 16) {
      uint32_t x15 = w[(i - 15) & 15], x2 = w[(i - 2) & 15];
      uint32_t s0 = rotr(x15, 7) ^ rotr(x15, 18) ^ (x15 >> 3);
      uint32_t s1 = rotr(x2, 17) ^ rotr(x2, 19) ^ (x2 >> 10);
      w[i & 15] = add1(add1(add1(w[i & 15], s1, one), w[(i - 7) & 15], one),
                       s0, one);
    }
    const uint32_t s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    const uint32_t ch = (e & f) ^ (~e & g);
    const uint32_t s0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    const uint32_t t1 = add1(add1(add1(add1(h, kK[i], one), w[i & 15], one),
                                  ch, one), s1, one);
    const uint32_t t2 = add1(s0, maj, one);
    h = g; g = f; f = e; e = add1(d, t1, one);
    d = c; c = b; b = a; a = add1(t1, t2, one);
  }
  st[0] = add1(st[0], a, one); st[1] = add1(st[1], b, one);
  st[2] = add1(st[2], c, one); st[3] = add1(st[3], d, one);
  st[4] = add1(st[4], e, one); st[5] = add1(st[5], f, one);
  st[6] = add1(st[6], g, one); st[7] = add1(st[7], h, one);
}

template <bool kPlanar, bool kFma>
__global__ void __launch_bounds__(256)
prefetch_kernel(const uint32_t* __restrict__ state_in,
                const uint32_t* __restrict__ pend_in,
                const uint32_t* __restrict__ rows,
                uint32_t* __restrict__ state_out,
                uint32_t* __restrict__ pend_out, long long C, int B,
                int has_pending, int valid_count, uint32_t one) {
  long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const int start = 1 - has_pending;
  const int pairs = (valid_count + has_pending) / 2;
  int last = start + 2 * pairs;
  last = last < 0 ? 0 : (last > B ? B : last);
  uint32_t st[8], pend[8], w[16], next[16];
#pragma unroll
  for (int i = 0; i < 8; ++i) st[i] = state_in[i * C + c];
  load_elem<kPlanar>(pend_in, rows, C, B, c, last, pend);
  if (pairs > 0) {
    load_elem<kPlanar>(pend_in, rows, C, B, c, start, next);
    load_elem<kPlanar>(pend_in, rows, C, B, c, start + 1, next + 8);
  }
  for (int i = 0; i < pairs; ++i) {
#pragma unroll
    for (int k = 0; k < 16; ++k) w[k] = next[k];
    if (i + 1 < pairs) {
      load_elem<kPlanar>(pend_in, rows, C, B, c, start + 2 * i + 2, next);
      load_elem<kPlanar>(pend_in, rows, C, B, c, start + 2 * i + 3,
                         next + 8);
    }
    if (kFma) transform_fma(st, w, one);
    else transform(st, w);
  }
  uint4* po = (uint4*)(pend_out + c * 8);
  po[0] = make_uint4(pend[0], pend[1], pend[2], pend[3]);
  po[1] = make_uint4(pend[4], pend[5], pend[6], pend[7]);
#pragma unroll
  for (int i = 0; i < 8; ++i) state_out[i * C + c] = st[i];
}

}  // namespace sha_old

extern "C" int exp_prefetch_absorb(const void* state_in,
                                   const void* pending_in, const void* rows,
                                   void* state_out, void* pending_out,
                                   long long C, int B, int has_pending,
                                   int valid_count, int planar, int threads,
                                   int fma, void* stream) {
  if (C <= 0) return 0;
  unsigned blocks = (unsigned)((C + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* st = (const uint32_t*)state_in;
  const uint32_t* pe = (const uint32_t*)pending_in;
  const uint32_t* ro = (const uint32_t*)rows;
#define EXP_LAUNCH(P, F)                                                \
  sha_old::prefetch_kernel<P, F><<<blocks, threads, 0, s>>>(            \
      st, pe, ro, (uint32_t*)state_out, (uint32_t*)pending_out, C, B,   \
      has_pending, valid_count, 1u)
  if (planar && fma) EXP_LAUNCH(true, true);
  else if (planar) EXP_LAUNCH(true, false);
  else if (fma) EXP_LAUNCH(false, true);
  else EXP_LAUNCH(false, false);
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__
"""

# kernel -> fragment of its mangled name, in the port's library or here
PORT_SASS = {f"port {lay} tile {t}": f"absorb_tile_kernelILb{p}ELi{t}E"
             for lay, p in (("planar", 1), ("aos", 0)) for t in (32, 128)}
EXP_SASS = {"old planar": "sha_old13absorb_kernelILb1E",
            "old aos": "sha_old13absorb_kernelILb0E",
            **{f"prefetch {lay}{' imad' if f else ''}":
               f"prefetch_kernelILb{p}ELb{f}E"
               for lay, p in (("planar", 1), ("aos", 0)) for f in (0, 1)}}
# opcode classes: the integer pipe's (funnel shifts, shifts, LOP3, adds),
# IMAD forms (FMA pipe), memory and the rest
CLASSES = (("SHF", "SHF"), ("SHL/SHR", ("SHL", "SHR")), ("LOP3", "LOP3"),
           ("IADD3", "IADD3"), ("IMAD", "IMAD"), ("LEA", "LEA"),
           ("MOV", "MOV"), ("LDG", "LDG"), ("STG", "STG"), ("LDS", "LDS"),
           ("STS", "STS"), ("BAR", "BAR"), ("LDC/ULDC", ("LDC", "ULDC")))


def opcode_classes(so: Path, frags: dict) -> dict:
    """Per kernel: its SASS opcodes grouped by CLASSES (NOPs left out)."""
    tool = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" \
        / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), Counter())
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)", line)
        if cur is None or m is None or m.group(1) == "NOP":
            continue
        cur[m.group(1)] += 1
    out = {}
    for name, frag in frags.items():
        hits = [c for f, c in funcs.items() if frag in f]
        cs.require(len(hits) == 1, f"one SASS function for {name}")
        ops = hits[0]
        row = {"all": sum(ops.values())}
        for label, prefix in CLASSES:
            row[label] = sum(v for op, v in ops.items()
                             if op.startswith(prefix))
        row["other"] = row["all"] - sum(row[label] for label, _ in CLASSES)
        row["imad_forms"] = {op: v for op, v in ops.items()
                             if op.startswith("IMAD")}
        out[name] = row
    return out


def build(work: Path):
    from ligero_prover_tpu_torch import kernels
    work.mkdir(parents=True, exist_ok=True)
    src = work / "exp_sha_absorb.cu"
    src.write_text(SOURCE)
    so = work / "libexp_sha_absorb.so"
    proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared",
                           "-o", str(so), str(src)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}\n{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.exp_old_absorb.argtypes = [p] * 5 + [i64] + [i32] * 4 + [p]
    lib.exp_prefetch_absorb.argtypes = [p] * 5 + [i64] + [i32] * 6 + [p]
    return lib, so, proc.stdout + proc.stderr


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/exp_sha_absorb.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("experiment_sha_absorb: no CUDA device", file=sys.stderr)
        return 1
    import numpy as np
    from ligero_prover_tpu_torch import kernels
    from ligero_prover_tpu_torch.ops import sha256 as sha

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
    elib, eso, elog = build(kernels.BUILD_DIR / "exp_sha_absorb")
    result = {"card": card, "max_sm_clock_mhz": float(clk),
              "ptxas": {**cs.ptxas_report(kernels.build_info.get("log", ""),
                                          PORT_SASS),
                        **cs.ptxas_report(elog, EXP_SASS)},
              "sass": {**opcode_classes(Path(kernels.build_info["path"]),
                                        PORT_SASS),
                       **opcode_classes(eso, EXP_SASS)},
              "calls": {}}
    print(f"ptxas (registers, spill stores, spill loads): "
          f"{result['ptxas']}", flush=True)
    for name, row in result["sass"].items():
        print(f"SASS {name}: {row}", flush=True)

    gen = np.random.default_rng(cs.SEED)
    bsz = 16
    for label, planar, cols in (("planar (8,16,32768)", True, 32768),
                                ("aos (16,32768,8)", False, 32768),
                                ("aos verify (16,192,8)", False, 192)):
        rows = cs.random_limbs(gen, (bsz, cols), device, False)
        if planar:
            rows = rows.movedim(-1, 0).contiguous()
        state = cs.random_limbs(gen, (cols,), device, False).T.contiguous()
        pending = cs.random_limbs(gen, (cols,), device, False)
        plain = sha.absorb_stream_planar_plain if planar else \
            sha.absorb_stream_plain
        want = plain(state, pending, False, rows, bsz)
        designs = {f"port tile {t}": (
            lambda st, pe, rw, so, po, t=t: lib.ligero_sha256_absorb(
                st.data_ptr(), pe.data_ptr(), rw.data_ptr(), so.data_ptr(),
                po.data_ptr(), cols, bsz, 0, bsz, int(planar), t, stream),
            -(-cols // t), 2 * t) for t in sha.TILES}
        designs["old (256 per CTA)"] = (
            lambda st, pe, rw, so, po: elib.exp_old_absorb(
                st.data_ptr(), pe.data_ptr(), rw.data_ptr(), so.data_ptr(),
                po.data_ptr(), cols, bsz, 0, bsz, int(planar), stream),
            -(-cols // 256), 256)
        for threads in (32, 64, 128, 256):
            for fma in (0, 1):
                designs[f"prefetch{' imad' if fma else ''} ({threads} per "
                        f"CTA)"] = (
                    lambda st, pe, rw, so, po, n=threads, fma=fma:
                    elib.exp_prefetch_absorb(
                        st.data_ptr(), pe.data_ptr(), rw.data_ptr(),
                        so.data_ptr(), po.data_ptr(), cols, bsz, 0, bsz,
                        int(planar), n, fma, stream),
                    -(-cols // threads), threads)
        bnd = cs.bound("sha256_absorb", 32 * cols * (bsz + 3), cols, bsz // 2)
        calls = result["calls"][label] = {"bound_ms": bnd[0],
                                          "bound_by": bnd[1], "designs": {}}
        print(f"{label}: bound {bnd[0]:.4f} ms ({bnd[1]})", flush=True)
        for name, (launch, blocks, threads) in designs.items():
            st_out = torch.full_like(state, -1)
            pe_out = torch.full_like(pending, -1)

            def run(st, pe, rw, so, po, launch=launch, name=name):
                kernels.check(launch(st, pe, rw, so, po), name)
            run(state, pending, rows, st_out, pe_out)
            torch.cuda.synchronize()
            err = max(cs.max_abs_err(st_out, want[0]),
                      cs.max_abs_err(pe_out, want[1]))
            cs.require(err == 0, f"{name} at {label} equals the plain "
                       "version")
            cold, hot = cs.launches_ms(run, state, pending, rows, st_out,
                                       pe_out)
            floor = cs.floor_ms(lib, stream, blocks, threads)
            calls["designs"][name] = {"ms": cold, "hot_ms": hot,
                                      "floor_ms": floor, "grid": [blocks,
                                                                  threads],
                                      "max_abs_err": err}
            print(f"  {name}: grid {blocks}x{threads} max_abs_err={err} "
                  f"ms={cold:.4f} (L2-hot {hot:.4f}) floor={floor:.4f} "
                  f"bound%={100 * bnd[0] / cold:.0f}", flush=True)
    print(json.dumps(result), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
