// Planar BN254-Fr kernels for Hopper: KB (one constant-geometry butterfly
// stage) and KE (element-wise add/sub/Montgomery products).  Operands are
// limb planes: element i of an (8, X) tensor has limb l at x[l*ls + i],
// with ls the plane's stride (X for a contiguous tensor).
//
// KB replaces the Pallas TPU kernels _k_butterfly_dit and _k_butterfly_dif
// (ligero_prover_tpu/ops/pallas/fieldmul.py:238,245) together with the
// reshapes, concatenate/stack and the (8, B*h) twiddle broadcast around
// each call in the constant-geometry stage loops
// (ligero_prover_tpu/ops/ntt.py:328-364).  One launch is one stage over
// the whole batch, out of place:
//   DIT: a = x[:, b, 2j], c = x[:, b, 2j+1], wc = mont(c, tw[:, j]);
//        y[:, b, j] = a + wc,  y[:, b, h+j] = a - wc.
//   DIF: a = x[:, b, j],  c = x[:, b, h+j];
//        y[:, b, 2j] = a + c,  y[:, b, 2j+1] = mont(a - c, tw[:, j]).
// A DIT input narrower than the stage (in_n < N) is read tiled, element i
// being x[:, b, i mod in_n]: that is the zero-extension of the encode
// (ntt.py:379-381), so no tiled copy is made.
//
// KE replaces _k_addmod, _k_submod, _k_mont_scalar and _k_mulmod_fma
// (fieldmul.py:252,256,269,278) and gives _k_mont_mul/_k_mulmod (:260,264)
// their planar entry.  mulmod_fma adds the product to a third operand z,
// a full plane read at element i.
// The second operand y is either a full plane (y_div = 1), a value per
// run of y_div consecutive elements (a per-row scalar over (8, B, n) rows
// has y_div = n), or, in mode kScalar, one element read once per thread.
//
// What bounds them on this card: a butterfly or a Montgomery product is
// ~200 32-bit multiply-adds per 96 bytes moved, so KB and KE's product
// modes are bound by the integer pipes at the main path's shapes (2^18..
// 2^19 elements), while KE's add/sub modes (~30 integer ops per 96 bytes)
// are bound by HBM bandwidth.  Design: one thread per butterfly or
// element, all arithmetic in registers (field.cuh); for every limb plane
// neighbouring threads touch neighbouring words, so each load and store
// is coalesced (KB's adjacent pair is one 8-byte access per limb); the
// twiddle is read from its (8, N/2) stage plane, never broadcast in
// memory.  Index math is 32-bit: the wrappers keep every plane offset
// below 2^32.

#include "field.cuh"

namespace ligero_pl {

using namespace ligero_fm;

enum { kAdd = 0, kSub = 1, kMont = 2, kMulmod = 3, kScalar = 4, kFma = 5 };

LIGERO_HD void load_pair(const uint32_t* p, uint32_t& a, uint32_t& b) {
#ifdef __CUDACC__
  uint2 v = *(const uint2*)p;
  a = v.x; b = v.y;
#else
  a = p[0]; b = p[1];
#endif
}

LIGERO_HD void store_pair(uint32_t* p, uint32_t a, uint32_t b) {
#ifdef __CUDACC__
  *(uint2*)p = make_uint2(a, b);
#else
  p[0] = a; p[1] = b;
#endif
}

// Butterfly i = b*h + j of one stage: x is (8, B, in_n) for DIT (in_n a
// power of two dividing N) and (8, B, N) for DIF; tw (8, h); y (8, B, N);
// h = 2^log2h, N = 2h.
template <bool kDit>
LIGERO_HD void stage_at(const uint32_t* x, const uint32_t* tw, uint32_t* y,
                        uint32_t B, int log2h, uint32_t in_n, uint32_t i) {
  const uint32_t h = 1u << log2h, n = 2u * h;
  const uint32_t b = i >> log2h, j = i & (h - 1u);
  const uint32_t y_plane = B * n, row = b * n;
  uint32_t u[8], v[8], w[8], r0[8], r1[8];
#pragma unroll
  for (int l = 0; l < 8; ++l) w[l] = tw[l * h + j];
  if (kDit) {
    const uint32_t x_plane = B * in_n;
    const uint32_t src = b * in_n + ((2u * j) & (in_n - 1u));
#pragma unroll
    for (int l = 0; l < 8; ++l) load_pair(x + l * x_plane + src, u[l], v[l]);
    uint32_t wv[8];
    mont_mul(v, w, wv);
    add_mod(u, wv, r0);
    sub_mod(u, wv, r1);
#pragma unroll
    for (int l = 0; l < 8; ++l) {
      y[l * y_plane + row + j] = r0[l];
      y[l * y_plane + row + h + j] = r1[l];
    }
  } else {
#pragma unroll
    for (int l = 0; l < 8; ++l) {
      u[l] = x[l * y_plane + row + j];
      v[l] = x[l * y_plane + row + h + j];
    }
    uint32_t d[8];
    add_mod(u, v, r0);
    sub_mod(u, v, d);
    mont_mul(d, w, r1);
#pragma unroll
    for (int l = 0; l < 8; ++l)
      store_pair(y + l * y_plane + row + 2u * j, r0[l], r1[l]);
  }
}

// Element i of KE.  `s` holds the scalar's limbs in mode kScalar (read
// once per thread by the caller); otherwise y is read at i / y_div.  z is
// read in mode kFma only.
template <int kMode>
LIGERO_HD void eltwise_at(const uint32_t* x, uint32_t x_ls,
                          const uint32_t* y, uint32_t y_ls, uint32_t y_div,
                          const uint32_t* z, uint32_t z_ls,
                          const uint32_t s[8], uint32_t* out, uint32_t n,
                          uint32_t i) {
  uint32_t a[8], c[8], r[8];
#pragma unroll
  for (int l = 0; l < 8; ++l) a[l] = x[l * x_ls + i];
  if (kMode == kScalar) {
#pragma unroll
    for (int l = 0; l < 8; ++l) c[l] = s[l];
  } else {
    const uint32_t yi = y_div == 1u ? i : i / y_div;
#pragma unroll
    for (int l = 0; l < 8; ++l) c[l] = y[l * y_ls + yi];
  }
  if (kMode == kAdd)
    add_mod(a, c, r);
  else if (kMode == kSub)
    sub_mod(a, c, r);
  else if (kMode == kMulmod)
    mulmod(a, c, r);
  else if (kMode == kFma) {
    uint32_t t[8], acc[8];
    mulmod(a, c, t);
#pragma unroll
    for (int l = 0; l < 8; ++l) acc[l] = z[l * z_ls + i];
    add_mod(acc, t, r);
  } else
    mont_mul(a, c, r);
#pragma unroll
  for (int l = 0; l < 8; ++l) out[l * n + i] = r[l];
}

}  // namespace ligero_pl

#ifdef __CUDACC__

namespace ligero_pl {

template <bool kDit>
__global__ void __launch_bounds__(256)
stage_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ tw,
             uint32_t* __restrict__ y, uint32_t B, int log2h,
             uint32_t in_n) {
  const uint32_t total = B << log2h;
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride)
    stage_at<kDit>(x, tw, y, B, log2h, in_n, i);
}

template <int kMode>
__global__ void __launch_bounds__(256)
eltwise_kernel(const uint32_t* __restrict__ x, uint32_t x_ls,
               const uint32_t* __restrict__ y, uint32_t y_ls, uint32_t y_div,
               const uint32_t* __restrict__ z, uint32_t z_ls,
               uint32_t* __restrict__ out, uint32_t n) {
  uint32_t s[8];
  if (kMode == kScalar) {
#pragma unroll
    for (int l = 0; l < 8; ++l) s[l] = y[l * y_ls];
  }
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    eltwise_at<kMode>(x, x_ls, y, y_ls, y_div, z, z_ls, s, out, n, i);
}

inline unsigned grid_for(unsigned long long work) {
  unsigned long long blocks = (work + 255) / 256;
  return (unsigned)(blocks > 1048576ull ? 1048576ull : blocks);
}

}  // namespace ligero_pl

// One constant-geometry stage (KB).  x: (8, B, in_n) for DIT, (8, B, 2h)
// for DIF; tw: (8, h); y: (8, B, 2h), not aliasing x.  All contiguous and
// 8-byte aligned; in_n a power of two in [2, 2h] (DIT); 8*B*2h < 2^32.
// Returns cudaGetLastError().
extern "C" int ligero_planar_stage(const void* x, const void* tw, void* y,
                                   int B, int log2h, int in_n, int dit,
                                   void* stream) {
  if (B < 0 || log2h < 0 || log2h > 24) return (int)cudaErrorInvalidValue;
  const unsigned long long n = 2ull << log2h;
  if (8ull * (unsigned long long)B * n >= (1ull << 32))
    return (int)cudaErrorInvalidValue;
  if (dit && (in_n < 2 || (in_n & (in_n - 1)) != 0 ||
              (unsigned long long)in_n > n))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const unsigned long long work = (unsigned long long)B << log2h;
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* xp = (const uint32_t*)x;
  const uint32_t* tp = (const uint32_t*)tw;
  uint32_t* yp = (uint32_t*)y;
  if (dit)
    ligero_pl::stage_kernel<true><<<ligero_pl::grid_for(work), 256, 0, s>>>(
        xp, tp, yp, (uint32_t)B, log2h, (uint32_t)in_n);
  else
    ligero_pl::stage_kernel<false><<<ligero_pl::grid_for(work), 256, 0, s>>>(
        xp, tp, yp, (uint32_t)B, log2h, (uint32_t)n);
  return (int)cudaGetLastError();
}

// Element-wise planar op (KE).  x: 8 planes of n words at limb stride
// x_ls; y: planes at limb stride y_ls, element i reading y[i / y_div]
// (mode 4 reads element 0 only); z: mode 5's addend, planes of n words at
// limb stride z_ls (ignored, may be null, in the other modes); out: (8, n)
// contiguous, not aliasing x, y or z.  mode 0 addmod, 1 submod, 2 mont_mul,
// 3 mulmod, 4 mont_scalar, 5 mulmod_fma (z + x*y).
// Every plane offset must stay below 2^32.  Returns cudaGetLastError().
extern "C" int ligero_planar_eltwise(const void* x, long long x_ls,
                                     const void* y, long long y_ls,
                                     long long y_div, const void* z,
                                     long long z_ls, void* out, long long n,
                                     int mode, void* stream) {
  if (n < 0 || x_ls < n || y_ls < 0 || y_div < 1 || mode < 0 || mode > 5 ||
      7 * x_ls + n >= (1ll << 32) || 8 * n >= (1ll << 32) ||
      7 * y_ls + (n + y_div - 1) / y_div >= (1ll << 32))
    return (int)cudaErrorInvalidValue;
  if (mode == ligero_pl::kFma &&
      (z == nullptr || z_ls < n || 7 * z_ls + n >= (1ll << 32)))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned grid = ligero_pl::grid_for((unsigned long long)n);
  const uint32_t* xp = (const uint32_t*)x;
  const uint32_t* yp = (const uint32_t*)y;
  const uint32_t* zp = (const uint32_t*)z;
  uint32_t* op = (uint32_t*)out;
  const uint32_t xl = (uint32_t)x_ls, yl = (uint32_t)y_ls;
  const uint32_t zl = (uint32_t)z_ls;
  const uint32_t yd = (uint32_t)(y_div < n ? y_div : n);  // i / n == 0
  const uint32_t nn = (uint32_t)n;
  switch (mode) {
    case ligero_pl::kAdd:
      ligero_pl::eltwise_kernel<ligero_pl::kAdd><<<grid, 256, 0, s>>>(
          xp, xl, yp, yl, yd, zp, zl, op, nn);
      break;
    case ligero_pl::kSub:
      ligero_pl::eltwise_kernel<ligero_pl::kSub><<<grid, 256, 0, s>>>(
          xp, xl, yp, yl, yd, zp, zl, op, nn);
      break;
    case ligero_pl::kMont:
      ligero_pl::eltwise_kernel<ligero_pl::kMont><<<grid, 256, 0, s>>>(
          xp, xl, yp, yl, yd, zp, zl, op, nn);
      break;
    case ligero_pl::kMulmod:
      ligero_pl::eltwise_kernel<ligero_pl::kMulmod><<<grid, 256, 0, s>>>(
          xp, xl, yp, yl, yd, zp, zl, op, nn);
      break;
    case ligero_pl::kFma:
      ligero_pl::eltwise_kernel<ligero_pl::kFma><<<grid, 256, 0, s>>>(
          xp, xl, yp, yl, yd, zp, zl, op, nn);
      break;
    default:
      ligero_pl::eltwise_kernel<ligero_pl::kScalar><<<grid, 256, 0, s>>>(
          xp, xl, yp, yl, yd, zp, zl, op, nn);
      break;
  }
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
