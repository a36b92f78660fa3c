// BN254-Fr Montgomery multiply for Hopper: kernels K1 (mont_mul) and K2
// (mulmod) over AoS (N, 8) little-endian u32 limbs.
//
// Replaces the Pallas TPU kernels _k_mont_mul and _k_mulmod
// (ligero_prover_tpu/ops/pallas/fieldmul.py:260,264, launched through
// mont_mul_aos / mulmod_aos :396-407).  The TPU kernels split limbs into
// 16-bit digits because the TPU VPU has no 32x32->64 multiply; here each
// thread does 32-bit limb products.
//
// Result contract (bit identical to the reference on every input, not only
// canonical ones, e.g. a constant reduced only mod 2^256):
//   U = x*y (512 bits); m = U_lo * J mod 2^256 with J = -p^-1 mod 2^256;
//   t = U_hi + (m*p)_hi + [U_lo != 0] mod 2^256; t -= p if t >= p.
// mulmod(x, y) = mont_mul(mont_mul(x, y), R^2 mod p).
//
// K1: at the AoS path's butterfly calls (16 x 16384 = 2^18 elements times
// a broadcast (16384, 8) twiddle) an element is 64 bytes in (the twiddle
// from L2) and 32 out against one Montgomery product, field.cuh's
// carry-chain mont_mul_cc (~230 instructions where mont_mul took ~740).
// At the bounds' product rate its bytes take the longer, but the card
// issues the product's ~120 wide multiply-adds (IMAD.WIDE) at about 15 per
// clock per SM, so it is bound by them: with its operands in L2 it takes
// about 1.5x the bytes' time (PERF.md).  The vbn254fr arena's (k, 8) rows
// (k = 8192: the invmod ladder's squares and multiplies, mont_mul_const's
// (1, 8) constant) are latency-bound: the launch, one load, one product's
// dependent chain, one store; the launch floor of an empty kernel at the
// same grid is the yardstick there.  So: one thread per element, 16-byte
// vector loads/stores (a warp reads 1 KiB contiguously), index math 32-bit
// below 2^31 elements (64-bit grid-stride above, which no caller reaches),
// the broadcast operand read at mont_mul_row (no general `%` on the main
// path's shapes, and a (h, 8) twiddle is never expanded to (B*h, 8) in
// memory), and blocks sized to the call as K2's are (mulmod_threads), so
// that the arena's small calls spread over the SMs (at 2^18 elements 32 to
// 256 threads a block measured alike: experiment_k1_kr.py).

// K2: its main-path calls are small (the vbn254fr arena's (8192, 8) rows
// and the verifier's (16, 192, 8) sums), where one launch is bound by its
// latency: the launch itself, one load, the dependent instructions of one
// thread's two Montgomery products, one store.  So K2 cuts the
// instructions of the product (field.cuh's carry-chain mulmod_cc), keeps
// index math 32-bit (no 64-bit `%`: y_rows == n reads element i, y_rows
// == 1 element 0, else a 32-bit `%`), and sizes its blocks so that small
// calls spread over the SMs (mulmod_threads).  At the AoS check's 2^19
// elements it takes 256-thread blocks; its ~460 instructions per element
// then take less time than its bytes.

#include "field.cuh"

namespace ligero_fm {

// One element's 8 limbs (32 contiguous bytes, 16-byte aligned).
LIGERO_HD void load_elem(const uint32_t* p, uint32_t v[8]) {
#ifdef __CUDACC__
  const uint4 a = ((const uint4*)p)[0], b = ((const uint4*)p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
#else
  for (int l = 0; l < 8; ++l) v[l] = p[l];
#endif
}

LIGERO_HD void store_elem(uint32_t* p, const uint32_t v[8]) {
#ifdef __CUDACC__
  ((uint4*)p)[0] = make_uint4(v[0], v[1], v[2], v[3]);
  ((uint4*)p)[1] = make_uint4(v[4], v[5], v[6], v[7]);
#else
  for (int l = 0; l < 8; ++l) p[l] = v[l];
#endif
}

// The row of y that element i of K1 reads, i mod y_rows: i when y_rows ==
// n, a mask for a power of two (0 for y_rows = 1; the AoS twiddles are
// 2^j rows), else `%`.  I is uint32_t below 2^31 elements, else uint64_t.
template <typename I>
LIGERO_HD I mont_mul_row(I n, I y_rows, I i) {
  if (y_rows == n) return i;
  if ((y_rows & (y_rows - 1u)) == 0u) return i & (y_rows - 1u);
  return i % y_rows;
}

// Element i < n of K1: out[i] = x[i] * y[i mod y_rows] * 2^-256 mod p.
template <typename I>
LIGERO_HD void mont_mul_at(const uint32_t* x, const uint32_t* y,
                           uint32_t* out, I n, I y_rows, I i) {
  uint32_t a[8], b[8], r[8];
  load_elem(x + 8ull * i, a);
  load_elem(y + 8ull * mont_mul_row(n, y_rows, i), b);
  mont_mul_cc(a, b, r);
  store_elem(out + 8ull * i, r);
}

// Element i < n of K2: out[i] = x[i] * y[i mod y_rows] mod p.
LIGERO_HD void mulmod_at(const uint32_t* x, const uint32_t* y, uint32_t* out,
                         uint32_t n, uint32_t y_rows, uint32_t i) {
  const uint32_t yi = y_rows == n ? i : y_rows == 1u ? 0u : i % y_rows;
  uint32_t a[8], b[8], r[8];
  load_elem(x + 8ull * i, a);
  load_elem(y + 8ull * yi, b);
  mulmod_cc(a, b, r);
  store_elem(out + 8ull * i, r);
}

// K2's and K1's threads per block: the largest of 256, 128, 64, 32 that
// still gives every SM of the card (132) a block, else one warp.
static inline uint32_t mulmod_threads(uint32_t n) {
  uint32_t t = 256u;
  while (t > 32u && (n + t - 1u) / t < 132u) t >>= 1;
  return t;
}

}  // namespace ligero_fm

#ifdef __CUDACC__

namespace ligero_fm {

// K1: one element per thread with a 32-bit index; with a 64-bit index
// (2^31 elements or more) a grid-stride loop.
template <typename I>
__global__ void __launch_bounds__(256)
mont_mul_kernel(const uint32_t* __restrict__ x,
                const uint32_t* __restrict__ y, uint32_t* __restrict__ out,
                I n, I y_rows) {
  I i = (I)blockIdx.x * blockDim.x + threadIdx.x;
  if (sizeof(I) == 4) {
    if (i < n) mont_mul_at(x, y, out, n, y_rows, i);
    return;
  }
  for (; i < n; i += (I)gridDim.x * blockDim.x)
    mont_mul_at(x, y, out, n, y_rows, i);
}

// K2: one element per thread
__global__ void __launch_bounds__(256)
mulmod_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
              uint32_t* __restrict__ out, uint32_t n, uint32_t y_rows) {
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) mulmod_at(x, y, out, n, y_rows, i);
}

// An empty kernel: the launch floor that chip_smoke.py times beside K2.
__global__ void empty_kernel() {}

}  // namespace ligero_fm

// x: (n, 8) u32, y: (y_rows, 8) u32 with element i using y[i % y_rows],
// out: (n, 8) u32.  mode 0 = mont_mul (K1), 1 = mulmod (K2; n and y_rows
// below 2^31, so that its 32-bit thread index cannot wrap).  All three
// must be 16-byte aligned.  Returns cudaGetLastError().
extern "C" int ligero_mont_mul(const void* x, const void* y, void* out,
                               long long n, long long y_rows, int mode,
                               void* stream) {
  if (n <= 0) return 0;
  if (y_rows <= 0 || (mode != 0 && mode != 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* xp = (const uint32_t*)x;
  const uint32_t* yp = (const uint32_t*)y;
  uint32_t* op = (uint32_t*)out;
  if (mode == 1) {
    if (n >= (1ll << 31) || y_rows >= (1ll << 31))
      return (int)cudaErrorInvalidValue;
    const uint32_t threads = ligero_fm::mulmod_threads((uint32_t)n);
    ligero_fm::mulmod_kernel<<<((uint32_t)n + threads - 1) / threads,
                               threads, 0, s>>>(xp, yp, op, (uint32_t)n,
                                                (uint32_t)y_rows);
    return (int)cudaGetLastError();
  }
  if (y_rows > n) y_rows = n;   // i mod y_rows = i for every i < n
  if (n < (1ll << 31)) {
    const uint32_t threads = ligero_fm::mulmod_threads((uint32_t)n);
    ligero_fm::mont_mul_kernel<uint32_t>
        <<<((uint32_t)n + threads - 1) / threads, threads, 0, s>>>(
            xp, yp, op, (uint32_t)n, (uint32_t)y_rows);
  } else {
    ligero_fm::mont_mul_kernel<unsigned long long><<<1048576, 256, 0, s>>>(
        xp, yp, op, (unsigned long long)n, (unsigned long long)y_rows);
  }
  return (int)cudaGetLastError();
}

// Launches the empty kernel as blocks x threads.  Returns
// cudaGetLastError().
extern "C" int ligero_empty(int blocks, int threads, void* stream) {
  ligero_fm::empty_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
