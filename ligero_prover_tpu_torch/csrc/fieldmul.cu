// BN254-Fr Montgomery multiply for Hopper: kernels K1 (mont_mul) and K2
// (mulmod) over AoS (N, 8) little-endian u32 limbs.
//
// Replaces the Pallas TPU kernels _k_mont_mul and _k_mulmod
// (ligero_prover_tpu/ops/pallas/fieldmul.py:260,264, launched through
// mont_mul_aos / mulmod_aos :396-407).  The TPU kernels split limbs into
// 16-bit digits because the TPU VPU has no 32x32->64 multiply; here each
// thread does schoolbook 32-bit limb products with 64-bit accumulation
// (IMAD.WIDE), the natural shape on an SM.
//
// Result contract (bit identical to the reference on every input, not only
// canonical ones, e.g. a constant reduced only mod 2^256):
//   U = x*y (512 bits); m = U_lo * J mod 2^256 with J = -p^-1 mod 2^256;
//   t = U_hi + (m*p)_hi + [U_lo != 0] mod 2^256; t -= p if t >= p.
// mulmod(x, y) = mont_mul(mont_mul(x, y), R^2 mod p).
//
// What bounds it on this card: one mont_mul is ~200 32-bit multiply-adds
// for 64 bytes in and 32 out, so at the shapes of the main path (2^18..2^19
// elements) it is bound by integer multiply throughput and by occupancy
// (the unrolled limb arrays live in registers), not by HBM bandwidth.
// Design: one thread per element, everything in registers, 16-byte
// vector loads/stores (a thread's 32 bytes are contiguous, so a warp reads
// 1 KiB contiguously), the broadcast operand indexed as y[i % y_rows] so a
// (h, 8) twiddle is never expanded to (B*h, 8) in memory.

#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define LIGERO_HD __device__ __forceinline__
#define LIGERO_CONST __constant__
#else
#define LIGERO_HD static inline
#define LIGERO_CONST static const
#endif

namespace ligero_fm {

// p, J = -p^-1 mod 2^256, R^2 mod p; little-endian u32 limbs
LIGERO_CONST uint32_t kP[8] = {
    0xf0000001u, 0x43e1f593u, 0x79b97091u, 0x2833e848u,
    0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
LIGERO_CONST uint32_t kJ[8] = {
    0xefffffffu, 0xc2e1f593u, 0x4c6911b3u, 0x6586864bu,
    0x99062391u, 0xe39a9828u, 0x0d8341b2u, 0x73f82f1du};
LIGERO_CONST uint32_t kR2[8] = {
    0xae216da7u, 0x1bb8e645u, 0xe35c59e3u, 0x53fe3ab1u,
    0x53bb8085u, 0x8c49833du, 0x7f4e44a5u, 0x0216d0b1u};

LIGERO_HD void mont_mul(const uint32_t x[8], const uint32_t y[8],
                        uint32_t out[8]) {
  // U = x*y, 16 limbs
  uint32_t u[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) u[i] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t carry = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint64_t t = (uint64_t)x[i] * y[j] + u[i + j] + carry;
      u[i + j] = (uint32_t)t;
      carry = t >> 32;
    }
    u[i + 8] = (uint32_t)carry;
  }
  // m = U_lo * J mod 2^256
  uint32_t m[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) m[i] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t carry = 0;
#pragma unroll
    for (int j = 0; j + i < 8; ++j) {
      uint64_t t = (uint64_t)u[i] * kJ[j] + m[i + j] + carry;
      m[i + j] = (uint32_t)t;
      carry = t >> 32;
    }
  }
  // mp = m * p, 16 limbs (only the high half is used; the low half
  // carries into it)
  uint32_t mp[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) mp[i] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t carry = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint64_t t = (uint64_t)m[i] * kP[j] + mp[i + j] + carry;
      mp[i + j] = (uint32_t)t;
      carry = t >> 32;
    }
    mp[i + 8] = (uint32_t)carry;
  }
  // t = U_hi + mp_hi + [U_lo != 0], mod 2^256
  uint32_t nz = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) nz |= u[i];
  uint32_t t[8];
  uint64_t c = nz != 0u ? 1u : 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t s = (uint64_t)u[8 + i] + mp[8 + i] + c;
    t[i] = (uint32_t)s;
    c = s >> 32;
  }
  // one conditional subtract of p (taken iff t >= p, i.e. no borrow out)
  uint32_t d[8];
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t s = (uint64_t)t[i] - kP[i] - borrow;
    d[i] = (uint32_t)s;
    borrow = s >> 63;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = borrow ? t[i] : d[i];
}

LIGERO_HD void mulmod(const uint32_t x[8], const uint32_t y[8],
                      uint32_t out[8]) {
  uint32_t t[8];
  mont_mul(x, y, t);
  uint32_t r2[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) r2[i] = kR2[i];
  mont_mul(t, r2, out);
}

}  // namespace ligero_fm

#ifdef __CUDACC__

namespace ligero_fm {

__device__ __forceinline__ void load8(const uint4* p, uint32_t v[8]) {
  uint4 a = p[0], b = p[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(uint4* p, const uint32_t v[8]) {
  p[0] = make_uint4(v[0], v[1], v[2], v[3]);
  p[1] = make_uint4(v[4], v[5], v[6], v[7]);
}

template <int kMode>
__global__ void __launch_bounds__(256)
mont_mul_kernel(const uint4* __restrict__ x, const uint4* __restrict__ y,
                uint4* __restrict__ out, long long n, long long y_rows) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    uint32_t a[8], b[8], r[8];
    load8(x + 2 * i, a);
    load8(y + 2 * (i % y_rows), b);
    if (kMode == 0)
      mont_mul(a, b, r);
    else
      mulmod(a, b, r);
    store8(out + 2 * i, r);
  }
}

}  // namespace ligero_fm

// x: (n, 8) u32, y: (y_rows, 8) u32 with element i using y[i % y_rows],
// out: (n, 8) u32.  mode 0 = mont_mul (K1), 1 = mulmod (K2).  All three
// must be 16-byte aligned.  Returns cudaGetLastError().
extern "C" int ligero_mont_mul(const void* x, const void* y, void* out,
                               long long n, long long y_rows, int mode,
                               void* stream) {
  if (n <= 0) return 0;
  if (y_rows <= 0 || (mode != 0 && mode != 1)) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 1048576) blocks = 1048576;
  cudaStream_t s = (cudaStream_t)stream;
  const uint4* xp = (const uint4*)x;
  const uint4* yp = (const uint4*)y;
  uint4* op = (uint4*)out;
  if (mode == 0)
    ligero_fm::mont_mul_kernel<0><<<(unsigned)blocks, threads, 0, s>>>(
        xp, yp, op, n, y_rows);
  else
    ligero_fm::mont_mul_kernel<1><<<(unsigned)blocks, threads, 0, s>>>(
        xp, yp, op, n, y_rows);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
