// Renormalisation kernels of the int8 four-step encode engine (KR):
// digitize, renorm_mid, renorm_final and renorm_pack.  They replace the
// Pallas TPU kernels _k_digitize, _k_renorm_mid, _k_renorm_final and
// _k_renorm_pack (ligero_prover_tpu/ops/pallas/mxu_renorm.py:146,130,124,
// 139) and, for renorm_mid, the (8, X) twiddle broadcast made before each
// call (ligero_prover_tpu/ops/mxu_ntt.py:250-251, 263-264).
//
// A level product leaves every output element as 64 int32 base-256 slot
// accumulators, slot e of element i at slots[e*X + i], with
// V = sum_e S_e * 256^e = R * sum_r W[s,r]*x[r]  (R = 2^256 mod p; the
// tables are premultiplied).  slots_to_canonical reduces V exactly to
// t = V * 2^-256 mod p in [0, p), as mxu_renorm.py:58-99 does:
//   1. signed byte sweep, 66 steps on int32 with an arithmetic shift:
//      acc += S_e; b = acc & 0xFF; acc = (acc - b) >> 8;
//   2. the 66 bytes are a 528-bit V;  uh = bits [504, 528);
//   3. U' = V mod 2^504 + uh * (2^504 mod p)   (< 2^256 * p);
//   4. redc_cc(U') (field.cuh: the reduction rows of the carry-chain
//      product over U', equal to redc on every U), one conditional
//      subtract inside it.
// Contract: 0 <= V < 2^516 and |S_e| < 2^28, which the level products
// keep (ops/mxu_ntt.py asserts the bound where the tables are built).
// canonical_to_packed re-emits a canonical value as 32 signed base-256
// digits (bytes above 127 become byte - 256 with a carry into the next
// byte; the top byte of a value < p is <= 0x30, so no carry escapes),
// packed four per word, little-endian: the next level's int8 operand.
//
//   final:    out = limbs of t
//   mid:      out = packed(mont_mul_cc(t, tw))   tw in Montgomery form
//   pack:     out = packed(t)
//   digitize: out = packed(x)                 x canonical limbs
//
// What bounds them on this card: an element is 256 bytes of slots in and
// 32 bytes out (plus 32 of twiddle for mid), against ~100 (final, pack)
// or ~264 (mid) 32x32->64-bit products and ~500 shift/mask operations of
// the sweep and the repack; at the main path's shapes (2^17..2^19
// elements) the bytes' time is the larger, so they are bound by HBM
// bandwidth.  Design: one thread per element, everything in registers;
// for every slot e and every limb l neighbouring threads read neighbouring
// words, so all loads and stores are coalesced; the sweep packs its bytes
// straight into 32-bit limbs; the products are field.cuh's carry chains
// (redc_cc, mont_mul_cc), which cut renorm_mid's instructions by about
// half.  renorm_mid reads the unbroadcast twiddle table (8, S, 1, C) by
// index, element i = (s, b, c) of (S, B, C) reading tw[:, s*C + c], with
// shifts: B*C and C are powers of two on every call of the engine (the
// entry point refuses others; the wrapper passes their log2), so no
// (8, X) copy of the table is made and no divide is run.  Blocks of 256
// are capped at 64 registers (4 CTAs on an SM): renorm_mid's level-1 call
// (X = 2^17, 512 CTAs) then runs in one wave of 528, and under this hint
// ptxas issues a thread's 64 slot loads first and schedules final and pack
// in fewer instructions (without it pack ran slower on redc_cc than on
// redc).  Index math is 32-bit: 64*X < 2^32.

#include "field.cuh"

namespace ligero_rn {

using namespace ligero_fm;

enum { kFinal = 0, kMid = 1, kPack = 2 };

// 2^504 mod p, little-endian u32 limbs
LIGERO_CONST uint32_t kK504[8] = {
    0xb41e216eu, 0x63b54746u, 0xe434d47cu, 0xe84e09fbu,
    0xb059b338u, 0x26a031bfu, 0xa1c98ef3u, 0x10d4f616u};

// 64 slot accumulators, slot e at s[e*stride] -> canonical limbs of
// V * 2^-256 mod p.
LIGERO_HD void slots_to_canonical(const int32_t* s, uint32_t stride,
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
  // U' = V mod 2^504 + uh * (2^504 mod p); the carry out of limb 15 is
  // zero inside the contract (U' < 2^505)
  uint64_t carry = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t t = (uint64_t)uh * kK504[i] + u[i] + carry;
    u[i] = (uint32_t)t;
    carry = t >> 32;
  }
#pragma unroll
  for (int i = 8; i < 16; ++i) {
    uint64_t t = (uint64_t)u[i] + carry;
    u[i] = (uint32_t)t;
    carry = t >> 32;
  }
  redc_cc(u, out);
}

// Canonical limbs -> 8 words of packed signed base-256 digits.
LIGERO_HD void canonical_to_packed(const uint32_t limbs[8], uint32_t out[8]) {
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

// The twiddle index of element i: (i / 2^lbc) * 2^lc + i mod 2^lc.
LIGERO_HD uint32_t twiddle_at(uint32_t lbc, uint32_t lc, uint32_t i) {
  return ((i >> lbc) << lc) | (i & ((1u << lc) - 1u));
}

// Element i of a renorm call over X elements.  In mode kMid the twiddle of
// element i is tw[:, twiddle_at(tw_lbc, tw_lc, i)] at limb stride tw_ls.
template <int kMode>
LIGERO_HD void renorm_at(const int32_t* slots, const uint32_t* tw,
                         uint32_t tw_ls, uint32_t tw_lbc, uint32_t tw_lc,
                         uint32_t* out, uint32_t X, uint32_t i) {
  uint32_t t[8], r[8];
  slots_to_canonical(slots + i, X, t);
  if (kMode == kFinal) {
#pragma unroll
    for (int l = 0; l < 8; ++l) out[(uint32_t)l * X + i] = t[l];
    return;
  }
  if (kMode == kMid) {
    const uint32_t ti = twiddle_at(tw_lbc, tw_lc, i);
    uint32_t w[8], y[8];
#pragma unroll
    for (int l = 0; l < 8; ++l) w[l] = tw[(uint32_t)l * tw_ls + ti];
    mont_mul_cc(t, w, y);
    canonical_to_packed(y, r);
  } else {
    canonical_to_packed(t, r);
  }
#pragma unroll
  for (int l = 0; l < 8; ++l) out[(uint32_t)l * X + i] = r[l];
}

// Whether a mid call over X > 0 elements reads only inside a table of
// tw_ls twiddles at shifts 0 <= lc <= lbc <= 31: the largest index read is
// the last row's, at its last column or at element X - 1.
static inline bool twiddles_fit(long long X, long long tw_ls, long long lbc,
                                long long lc) {
  if (lc < 0 || lbc < lc || lbc > 31 || tw_ls < 1) return false;
  const long long last = X - 1, cols = 1ll << lc;
  const long long in_row = last & ((1ll << lbc) - 1);
  return (last >> lbc) * cols + (in_row < cols ? in_row : cols - 1) < tw_ls;
}

LIGERO_HD void digitize_at(const uint32_t* x, uint32_t* out, uint32_t X,
                           uint32_t i) {
  uint32_t a[8], r[8];
#pragma unroll
  for (int l = 0; l < 8; ++l) a[l] = x[(uint32_t)l * X + i];
  canonical_to_packed(a, r);
#pragma unroll
  for (int l = 0; l < 8; ++l) out[(uint32_t)l * X + i] = r[l];
}

}  // namespace ligero_rn

#ifdef __CUDACC__

namespace ligero_rn {

// At least 4 CTAs of 256 on an SM: 64 registers a thread
template <int kMode>
__global__ void __launch_bounds__(256, 4)
renorm_kernel(const int32_t* __restrict__ slots,
              const uint32_t* __restrict__ tw, uint32_t tw_ls,
              uint32_t tw_lbc, uint32_t tw_lc, uint32_t* __restrict__ out,
              uint32_t X) {
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t i = blockIdx.x * blockDim.x + threadIdx.x; i < X; i += stride)
    renorm_at<kMode>(slots, tw, tw_ls, tw_lbc, tw_lc, out, X, i);
}

__global__ void __launch_bounds__(256)
digitize_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                uint32_t X) {
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t i = blockIdx.x * blockDim.x + threadIdx.x; i < X; i += stride)
    digitize_at(x, out, X, i);
}

inline unsigned grid_for(unsigned long long work) {
  unsigned long long blocks = (work + 255) / 256;
  return (unsigned)(blocks > 1048576ull ? 1048576ull : blocks);
}

}  // namespace ligero_rn

// Renormalise X elements (KR).  slots: (64, X) int32 contiguous; out:
// (8, X) contiguous, not aliasing slots.  mode 0 final (canonical limbs),
// 1 mid (packed digits of mont_mul(t, tw)), 2 pack (packed digits of t).
// Mode 1 reads tw, 8 planes at limb stride tw_ls, at index
// (i >> tw_lbc) << tw_lc | i & (2^tw_lc - 1), 0 <= tw_lc <= tw_lbc <= 31
// (the log2 of a row's elements and of its twiddles); the other modes
// ignore tw (may be null).  64*X < 2^32.  Returns cudaGetLastError().
extern "C" int ligero_renorm(const void* slots, const void* tw,
                             long long tw_ls, long long tw_lbc,
                             long long tw_lc, void* out, long long X,
                             int mode, void* stream) {
  if (X < 0 || 64 * X >= (1ll << 32) || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  if (mode == ligero_rn::kMid &&
      (tw == nullptr || 8 * tw_ls >= (1ll << 32) ||
       (X > 0 && !ligero_rn::twiddles_fit(X, tw_ls, tw_lbc, tw_lc))))
    return (int)cudaErrorInvalidValue;
  if (X == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned grid = ligero_rn::grid_for((unsigned long long)X);
  const int32_t* sp = (const int32_t*)slots;
  const uint32_t* tp = (const uint32_t*)tw;
  uint32_t* op = (uint32_t*)out;
  const uint32_t ls = (uint32_t)tw_ls, lbc = (uint32_t)tw_lbc,
                 lc = (uint32_t)tw_lc, xx = (uint32_t)X;
  switch (mode) {
    case ligero_rn::kFinal:
      ligero_rn::renorm_kernel<ligero_rn::kFinal><<<grid, 256, 0, s>>>(
          sp, tp, ls, 0u, 0u, op, xx);
      break;
    case ligero_rn::kMid:
      ligero_rn::renorm_kernel<ligero_rn::kMid><<<grid, 256, 0, s>>>(
          sp, tp, ls, lbc, lc, op, xx);
      break;
    default:
      ligero_rn::renorm_kernel<ligero_rn::kPack><<<grid, 256, 0, s>>>(
          sp, tp, ls, 0u, 0u, op, xx);
      break;
  }
  return (int)cudaGetLastError();
}

// Canonical limbs (8, X) -> packed signed base-256 digits (8, X), both
// contiguous, not aliasing.  8*X < 2^32.  Returns cudaGetLastError().
extern "C" int ligero_digitize(const void* x, void* out, long long X,
                               void* stream) {
  if (X < 0 || 8 * X >= (1ll << 32)) return (int)cudaErrorInvalidValue;
  if (X == 0) return 0;
  ligero_rn::digitize_kernel<<<ligero_rn::grid_for((unsigned long long)X),
                               256, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (uint32_t*)out, (uint32_t)X);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
