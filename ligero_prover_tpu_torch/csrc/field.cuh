// BN254-Fr arithmetic on 8 little-endian u32 limbs, shared by the field
// kernels (fieldmul.cu: K1/K2 over AoS elements; planar.cu: the planar
// butterfly and element-wise kernels; renorm.cu: the int8 engine's
// renormalisation).  Outside nvcc every function here
// compiles as plain C++, so a g++ harness can include this header and
// test the arithmetic without a card.
//
// The results reproduce the reference's limb algorithms bit for bit on
// every input, including operands in [p, 2^256)
// (ligero_prover_tpu/ops/pallas/fieldmul.py:141-222):
//   add_mod:  s = x + y mod 2^256 (carry out dropped); s - p if s >= p.
//   sub_mod:  d = x - y mod 2^256; d + p (mod 2^256) if the subtract
//             borrowed.
//   mont_mul: U = x*y (512 bits); m = U_lo * J mod 2^256 with
//             J = -p^-1 mod 2^256; t = U_hi + (m*p)_hi + [U_lo != 0]
//             mod 2^256; t - p if t >= p.
//   mulmod:   mont_mul(mont_mul(x, y), R^2 mod p).
//   redc:     the reduction half of mont_mul on a given 512-bit U; the
//             renormalisation kernels (renorm.cu) enter here.
// The TPU kernels split limbs into 16-bit digits because the TPU VPU has
// no 32x32->64 multiply; here products are 32-bit limbs with 64-bit
// accumulation (IMAD.WIDE), the natural shape on an SM.

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define LIGERO_HD __device__ __forceinline__
#define LIGERO_CONST static __constant__
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

// out = t - p if t >= p else t (taken iff the subtract does not borrow)
LIGERO_HD void cond_sub_p(const uint32_t t[8], uint32_t out[8]) {
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

LIGERO_HD void add_mod(const uint32_t x[8], const uint32_t y[8],
                       uint32_t out[8]) {
  uint32_t s[8];
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t v = (uint64_t)x[i] + y[i] + c;
    s[i] = (uint32_t)v;
    c = v >> 32;
  }
  cond_sub_p(s, out);
}

LIGERO_HD void sub_mod(const uint32_t x[8], const uint32_t y[8],
                       uint32_t out[8]) {
  uint32_t d[8];
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t v = (uint64_t)x[i] - y[i] - borrow;
    d[i] = (uint32_t)v;
    borrow = v >> 63;
  }
  uint32_t mask = borrow ? 0xffffffffu : 0u;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t v = (uint64_t)d[i] + (kP[i] & mask) + c;
    out[i] = (uint32_t)v;
    c = v >> 32;
  }
}

// Montgomery reduction of a 512-bit U (16 limbs): m = U_lo*J mod 2^256;
// t = U_hi + (m*p)_hi + [U_lo != 0] mod 2^256; out = t - p if t >= p.
// For U < 2^256 * p this is U * 2^-256 mod p, canonical.
LIGERO_HD void redc(const uint32_t u[16], uint32_t out[8]) {
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
  cond_sub_p(t, out);
}

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
  redc(u, out);
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
