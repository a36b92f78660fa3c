#!/usr/bin/env python3
"""Where K2's and KE mont_scalar's small calls spend their time, on one GPU.

    python3 experiment_k2_lanes.py [--out build/exp_k2_lanes.json]

K2 (``mulmod``) at the vbn254fr arena's 8,192 and the verifier's 3,072
elements runs one element per thread.  This script builds, beside the
port's kernels, three kernels that exist only here (the CUDA source is the
string below, compiled with nvcc against ``ligero_prover_tpu_torch/csrc``):

* ``lanes_kernel``: K2 with one element spread over a group of 8 lanes,
  lane l holding limb l, joined by warp shuffles (word-by-word Montgomery
  with 64-bit per-lane accumulators, the carries resolved at the end by
  ballots);
* ``k2_copy_kernel``: K2's loads and store, at K2's grid, without the
  product;
* ``scalar_copy_kernel``: KE mont_scalar's loads and stores, at its grid,
  without the product.

It checks the lane-group kernel against ``fm.mulmod_plain`` (canonical,
non-canonical and edge operands, one broadcast element) and times every
kernel as ``chip_smoke.py`` times the port's (L2-cold rotating copies, the
L2-hot time beside, the launch floor of an empty kernel at the same grid).
Prints the card's name and power limit, one line per measurement, and one
JSON object, also written to ``--out``.  Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import chip_smoke as cs

SOURCE = r"""
#include "fieldmul.cu"
#include "planar.cu"

namespace ligero_exp {

using namespace ligero_fm;
constexpr unsigned kAll = 0xffffffffu;

// x*y*2^-256 mod p on a group of 8 lanes, the reference's contract (t mod
// 2^256, one conditional subtract).  x: the whole row operand in every
// lane; yl, pl: this lane's limbs of y and p.  Returns this lane's limb.
__device__ __forceinline__ uint32_t mont_lanes(const uint32_t x[8],
                                               uint32_t yl, uint32_t pl,
                                               uint32_t lane, uint32_t base) {
  uint64_t a = 0;  // the value at word position `lane` (may pass 2^32)
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint64_t prod = (uint64_t)x[i] * yl;
    a += (uint32_t)prod;
    const uint32_t m = __shfl_sync(kAll, (uint32_t)a, 0, 8) * kJ0;
    const uint64_t q = (uint64_t)m * pl;
    a += (uint32_t)q;
    const uint64_t hs = (prod >> 32) + (q >> 32);  // to position lane+1
    const uint32_t dlo = __shfl_down_sync(kAll, (uint32_t)a, 1, 8);
    const uint32_t dhi = __shfl_down_sync(kAll, (uint32_t)(a >> 32), 1, 8);
    const uint64_t up = lane == 7u ? 0ull : ((uint64_t)dhi << 32 | dlo);
    // shift down one word; position 0's low word is 0, its carry stays
    a = up + hs + (lane == 0u ? a >> 32 : 0ull);
  }
  // carry each position's high part into the next, then the 1-bit carries
  const uint32_t hi = __shfl_up_sync(kAll, (uint32_t)(a >> 32), 1, 8);
  const uint64_t v = (uint64_t)(uint32_t)a + (lane == 0u ? 0u : hi);
  uint32_t w = (uint32_t)v;
  const uint32_t g = (__ballot_sync(kAll, (v >> 32) != 0) >> base) & 0xffu;
  const uint32_t pr = (__ballot_sync(kAll, w == 0xffffffffu) >> base) & 0xffu;
  w += ((((g << 1) + pr) ^ pr) >> lane) & 1u;  // carry out of lane 7 dropped
  // subtract p once unless it borrows
  const uint32_t gb = (__ballot_sync(kAll, w < pl) >> base) & 0xffu;
  const uint32_t pb = (__ballot_sync(kAll, w == pl) >> base) & 0xffu;
  const uint32_t bs = (gb << 1) + pb;
  const uint32_t d = w - pl - (((bs ^ pb) >> lane) & 1u);
  return (bs >> 8) & 1u ? w : d;
}

__global__ void __launch_bounds__(128)
lanes_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
             uint32_t* __restrict__ out, uint32_t n, uint32_t y_rows) {
  const uint32_t t = blockIdx.x * blockDim.x + threadIdx.x;
  const uint32_t lane = t & 7u, base = threadIdx.x & 24u;
  const uint32_t e = t >> 3 < n ? t >> 3 : n - 1;  // whole warps shuffle
  const uint32_t yi = y_rows == n ? e : y_rows == 1u ? 0u : e % y_rows;
  uint32_t xa[8];
  load_elem(x + 8ull * e, xa);
  const uint32_t pl = kP[lane];
  const uint32_t r = mont_lanes(xa, y[8ull * yi + lane], pl, lane, base);
  const uint32_t r2[8] = {0xae216da7u, 0x1bb8e645u, 0xe35c59e3u,
                          0x53fe3ab1u, 0x53bb8085u, 0x8c49833du,
                          0x7f4e44a5u, 0x0216d0b1u};
  const uint32_t s = mont_lanes(r2, r, pl, lane, base);
  if (t >> 3 < n) out[8ull * e + lane] = s;
}

__global__ void __launch_bounds__(256)
k2_copy_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
               uint32_t* __restrict__ out, uint32_t n, uint32_t y_rows) {
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t yi = y_rows == n ? i : y_rows == 1u ? 0u : i % y_rows;
  uint32_t a[8], b[8];
  load_elem(x + 8ull * i, a);
  load_elem(y + 8ull * yi, b);
#pragma unroll
  for (int l = 0; l < 8; ++l) a[l] ^= b[l];
  store_elem(out + 8ull * i, a);
}

__global__ void __launch_bounds__(256)
scalar_copy_kernel(const uint32_t* __restrict__ x, uint32_t x_ls,
                   const uint32_t* __restrict__ sc,
                   uint32_t* __restrict__ out, uint32_t n) {
  uint32_t s[8];
#pragma unroll
  for (int l = 0; l < 8; ++l) s[l] = sc[l];
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
#pragma unroll
    for (int l = 0; l < 8; ++l) out[l * n + i] = x[l * x_ls + i] ^ s[l];
  }
}

}  // namespace ligero_exp

extern "C" int exp_k2_lanes(const void* x, const void* y, void* out, int n,
                            int y_rows, void* stream) {
  const unsigned blocks = (8u * (unsigned)n + 127u) / 128u;
  ligero_exp::lanes_kernel<<<blocks, 128, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const uint32_t*)y, (uint32_t*)out, n, y_rows);
  return (int)cudaGetLastError();
}

extern "C" int exp_k2_copy(const void* x, const void* y, void* out, int n,
                           int y_rows, void* stream) {
  const uint32_t threads = ligero_fm::mulmod_threads((uint32_t)n);
  ligero_exp::k2_copy_kernel<<<((uint32_t)n + threads - 1) / threads,
                               threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const uint32_t*)y, (uint32_t*)out, n, y_rows);
  return (int)cudaGetLastError();
}

extern "C" int exp_scalar_copy(const void* x, int x_ls, const void* s,
                               void* out, int n, void* stream) {
  ligero_exp::scalar_copy_kernel<<<(n + 255) / 256, 256, 0,
                                   (cudaStream_t)stream>>>(
      (const uint32_t*)x, x_ls, (const uint32_t*)s, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}
"""


def build(work: Path):
    from ligero_prover_tpu_torch import kernels
    work.mkdir(parents=True, exist_ok=True)
    src, so = work / "exp_k2_lanes.cu", work / "libexp_k2_lanes.so"
    src.write_text(SOURCE)
    out = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared",
                          f"-I{kernels.CSRC}", "-o", str(so), str(src)],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{out.stdout}\n{out.stderr}")
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    for name in ("exp_k2_lanes", "exp_k2_copy"):
        getattr(lib, name).argtypes = [p, p, p, i, i, p]
    lib.exp_scalar_copy.argtypes = [p, i, p, p, i, p]
    regs = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"Function properties for \w*?(lanes_kernel|k2_copy_kernel|"
        r"scalar_copy_kernel)\w*\n.*\n.*Used (\d+) registers",
        out.stdout + out.stderr)}
    return lib, so, regs


def sass_total(so: Path, frag: str) -> int:
    tool = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" \
        / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    body = text.split(frag, 1)[1].split("Function :", 1)[0]
    return sum(1 for line in body.splitlines()
               if re.match(r"\s*/\*[0-9a-f]+\*/\s+(?!NOP)", line))


def main() -> int:
    import numpy as np
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/exp_k2_lanes.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("experiment_k2_lanes: no CUDA device", file=sys.stderr)
        return 1
    from ligero_prover_tpu_torch import kernels
    from ligero_prover_tpu_torch.ops import fieldmul as fm

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    device = torch.device("cuda", 0)
    lib, stream = kernels.lib(), kernels.stream_handle(device)
    exp, so, regs = build(kernels.BUILD_DIR / "exp")
    gen = np.random.default_rng(cs.SEED)
    result = {"card": card, "registers": regs,
              "sass": {k: sass_total(so, k) for k in
                       ("lanes_kernel", "k2_copy_kernel",
                        "scalar_copy_kernel")}}

    def limbs(shape, canonical=True):
        return cs.random_limbs(gen, shape, device, canonical)

    def check(rc, name):
        kernels.check(rc, name)

    for label, n in (("arena", 8192), ("verifier", 3072)):
        x, y = limbs((n,)), limbs((n,))
        xw, yw = limbs((n,), False), limbs((n,), False)
        xw[:6], yw[:6] = cs.edge_limbs(device), cs.edge_limbs(device, True)
        err = 0
        for a, b in ((x, y), (xw, yw), (xw, limbs((1,), False)),
                     (xw, cs.edge_limbs(device)[5:])):
            got = torch.empty_like(a)
            check(exp.exp_k2_lanes(a.data_ptr(), b.data_ptr(), got.data_ptr(),
                                   n, b.shape[0], stream), "lanes")
            torch.cuda.synchronize()
            err = max(err, cs.max_abs_err(got, fm.mulmod_plain(a, b)))
        out = torch.empty_like(x)
        times = {
            "k2": cs.launches_ms(lambda a, b, o: check(lib.ligero_mont_mul(
                a.data_ptr(), b.data_ptr(), o.data_ptr(), n, n,
                fm.MODE["mulmod"], stream), "mulmod"), x, y, out),
            "lanes": cs.launches_ms(lambda a, b, o: check(exp.exp_k2_lanes(
                a.data_ptr(), b.data_ptr(), o.data_ptr(), n, n, stream),
                "lanes"), x, y, out),
            "k2_copy": cs.launches_ms(lambda a, b, o: check(exp.exp_k2_copy(
                a.data_ptr(), b.data_ptr(), o.data_ptr(), n, n, stream),
                "copy"), x, y, out),
        }
        floors = {"k2": cs.floor_ms(lib, stream, *cs.k2_grid(n)),
                  "lanes": cs.floor_ms(lib, stream, -(-8 * n // 128), 128)}
        result[label] = {"n": n, "lanes_max_abs_err": err, "ms": times,
                         "floor_ms": floors}
        print(f"{label} n={n}: lane-group max_abs_err={err}; (cold, hot) ms "
              f"{ {k: tuple(round(t, 4) for t in v) for k, v in times.items()} }"
              f"; floors {floors}", flush=True)
        cs.require(err == 0, f"the lane-group K2 equals mulmod_plain at {n}")

    # KE mont_scalar at the encode's (8, 16, 8192), with and without the
    # product
    size = 16 * 8192
    x = limbs((size,)).movedim(-1, 0).contiguous()
    s = limbs(())
    out = torch.empty_like(x)
    mode = fm.PLANAR_MODE["mont_mul_scalar_planar"]
    times = {
        "mont_scalar": cs.launches_ms(lambda a, b, o: check(
            lib.ligero_planar_eltwise(a.data_ptr(), size, b.data_ptr(), 1,
                                      size, None, 0, o.data_ptr(), size,
                                      mode, stream), "scalar"), x, s, out),
        "scalar_copy": cs.launches_ms(lambda a, b, o: check(
            exp.exp_scalar_copy(a.data_ptr(), size, b.data_ptr(),
                                o.data_ptr(), size, stream), "scalar copy"),
            x, s, out),
    }
    floor = cs.floor_ms(lib, stream, -(-size // 256), 256)
    result["mont_scalar"] = {"n": size, "ms": times, "floor_ms": floor}
    print(f"mont_scalar n={size}: (cold, hot) ms "
          f"{ {k: tuple(round(t, 4) for t in v) for k, v in times.items()} }"
          f"; floor {floor:.4f}", flush=True)
    print(json.dumps(result), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
