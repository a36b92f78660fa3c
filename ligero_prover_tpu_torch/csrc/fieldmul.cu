// BN254-Fr arithmetic for Hopper over AoS (N, 8) little-endian u32 limbs:
// kernels K1 (mont_mul), K2 (mulmod), KA (addmod/submod) and KF (the
// verifier's ordered fold, of given rows or of fresh products, below).
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

// KA (AoS add/sub) and KF (the ordered fold): replace the XLA ops that the
// reference fuses into its jitted bodies, fo.addmod/fo.submod
// (ligero_prover_tpu/ops/fieldops.py:100-111) and the verifier's
// _masked_sum fori_loop (ligero_prover_tpu/zkp/executor.py:108-112).
// Both run field.cuh's add_mod/sub_mod, which drop the carry out of 2^256
// exactly where the reference does, so non-canonical operands give the
// reference's bits.  Their main-path calls are small (the vbn254fr
// arena's (8192, 8) +- (1, 8) rows, the verifier's (192, 8) sums), bound
// by the launch and one dependent load; the AoS check's fold of
// (16, 32768, 8) rows is bound by its bytes.  KA: one element a thread,
// 16-byte loads, K2's block rule; each operand read through a two-level
// view (aos_elem), so broadcast constants, twiddles and the strided halves
// of the AoS codec are read in place and never expanded.  The arena's
// calls write their slot in place (the output may be an operand, element
// for element) and take a host constant by value, as a kernel argument
// (Elem): no copy into the slot, no upload of the constant, one load
// stream fewer.
//
// KF runs in two forms.  The fold of given rows (masked_sum_kernel, one
// column a thread) and, on every call of the main path, the fold of fresh
// products (masked_mulsum_kernel): out = acc + x[0]*y[0] + ... +
// x[B-1]*y[B-1] mod p, each product K2's mulmod_cc, added one at a time in
// the order b = 0 .. B-1 as the reference's loop adds its rows.  The order
// is part of the function: on non-canonical rows a reordered sum drops
// another carry out of 2^256.  At the verifier's (16, 192, 8) the fused
// form is bound by latency: one round trip to memory, one product's
// dependent chain, B dependent adds.  So a CTA of C columns x R row-lanes
// first computes its chunk's products, every (row, column) on a thread of
// its own with all loads in flight at once, into shared memory; then one
// thread a column adds them in order from there (mulsum_geom chooses C, R
// and the chunk; the whole row set is one chunk when it fits).  The
// products never travel through device memory.

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

// KA's view of one operand: element i of the (broadcast) result reads
// element (i / div) * outer + (i % div) * inner of the operand, in units
// of one 8-limb element.  div >= n: element i * inner (contiguous rows:
// inner 1; one broadcast element: inner 0); a (h, 8) twiddle over (B, h,
// 8) rows: div h, outer 0, inner 1; the half x[:, :h] of (B, n, 8) rows:
// div h, outer n, inner 1.
struct AosView {
  uint32_t div;
  unsigned long long outer, inner;
};

// The view that ligero_aos_eltwise hands its kernel for n elements (a div
// of n or more reads as n: element i of i < n is then i * inner).
static inline AosView make_aos_view(long long div, long long outer,
                                    long long inner, long long n) {
  return AosView{(uint32_t)(div < n ? div : n), (unsigned long long)outer,
                 (unsigned long long)inner};
}

LIGERO_HD unsigned long long aos_elem(const AosView& v, uint32_t i) {
  if (i < v.div) return (unsigned long long)i * v.inner;
  const uint32_t q = i / v.div;
  return (unsigned long long)q * v.outer
         + (unsigned long long)(i - q * v.div) * v.inner;
}

// One element's 8 limbs as a kernel argument: KA's host constant.
struct Elem {
  uint32_t w[8];
};

// Which operand of KA is its host constant: none, x or y.
enum { kNoConst = 0, kConstX = 1, kConstY = 2 };

// Element i < n of KA: out[i] = x + y mod p (kMode 0) or x - y mod p
// (kMode 1), x and y read through their views, or the one kConst names
// taken from c.  Both operands are loaded before the store, so out may be
// x or y element for element.
template <int kMode, int kConst>
LIGERO_HD void aos_eltwise_at(const uint32_t* x, const AosView& xv,
                              const uint32_t* y, const AosView& yv,
                              const Elem& c, uint32_t* out, uint32_t i) {
  uint32_t a[8], b[8], r[8];
  if (kConst == kConstX) {
    for (int l = 0; l < 8; ++l) a[l] = c.w[l];
  } else {
    load_elem(x + 8ull * aos_elem(xv, i), a);
  }
  if (kConst == kConstY) {
    for (int l = 0; l < 8; ++l) b[l] = c.w[l];
  } else {
    load_elem(y + 8ull * aos_elem(yv, i), b);
  }
  if (kMode == 0)
    add_mod(a, b, r);
  else
    sub_mod(a, b, r);
  store_elem(out + 8ull * i, r);
}

// Column i < n of KF: out[i] = acc[i] + terms[0, i] + ... + terms[B-1, i]
// mod p, one add_mod at a time in the order b = 0 .. B-1 (B = 0: acc[i]).
LIGERO_HD void masked_sum_at(const uint32_t* acc, const uint32_t* terms,
                             uint32_t* out, uint32_t n, uint32_t rows,
                             uint32_t i) {
  uint32_t a[8], t[8], r[8];
  load_elem(acc + 8ull * i, a);
#pragma unroll 4
  for (uint32_t b = 0; b < rows; ++b) {
    load_elem(terms + 8ull * ((unsigned long long)b * n + i), t);
    add_mod(a, t, r);
#pragma unroll
    for (int l = 0; l < 8; ++l) a[l] = r[l];
  }
  store_elem(out + 8ull * i, a);
}

// The fused KF's geometry: a CTA of `cols` columns x `lanes` row-lanes
// (blockDim (cols, lanes)); a phase holds the products of `chunk` rows in
// shared memory, lane r computing rows r, r + lanes, ... of the chunk.
struct MulsumGeom {
  uint32_t n, rows, cols, lanes, chunk;
};

enum {
  kMulsumLanes = 16,         // row-lanes a CTA, at most
  kMulsumLanesFull = 4,      // the same once 32-column CTAs fill the card
  kMulsumSmem = 48 * 1024,   // shared bytes a CTA, at most (no opt-in)
  kMulsumMaxThreads = 512
};

// The geometry of n columns and B = rows (experiment_kf_mulsum.py swept
// it at the main path's calls on an H100 SXM): the widest C of 32, 16, .., 1 that still
// gives every SM (132) a CTA; the whole row set as one chunk where its
// products fit in kMulsumSmem; min(chunk, 16) lanes, one product a thread
// at B <= 16, where a call is bound by its latency (the verifier's 192
// columns: 16 lanes 0.0050 ms, 8 lanes 0.0063), but 4 lanes where 32-column
// CTAs fill the card (the AoS check's 32,768 columns: 0.0267 ms, 16 lanes
// 0.0289).
static inline MulsumGeom mulsum_geom(uint32_t n, uint32_t rows) {
  MulsumGeom g{n, rows, 32u, 1u, 1u};
  while (g.cols > 1u && (n + g.cols - 1u) / g.cols < 132u) g.cols >>= 1;
  const uint32_t b = rows > 1u ? rows : 1u;
  const uint32_t fit = (uint32_t)kMulsumSmem / (32u * g.cols);
  const uint32_t lanes = g.cols == 32u ? (uint32_t)kMulsumLanesFull
                                        : (uint32_t)kMulsumLanes;
  g.chunk = b < fit ? b : fit;
  g.lanes = g.chunk < lanes ? g.chunk : lanes;
  return g;
}

// Phase 1 of the chunk from row b0 on thread (c, r) of a CTA, whose
// column is col: the products x[b, col] * y mod p of rows b0 + r,
// b0 + r + lanes, ... into shared memory s (field.cuh's store_prod
// layout).  y is (B, n, 8) (kFull) or one element a row, (B, 1, 8).
template <bool kFull>
LIGERO_HD void mulsum_products_at(const uint32_t* x, const uint32_t* y,
                                  const MulsumGeom& g, uint32_t b0,
                                  uint32_t c, uint32_t r, uint32_t col,
                                  uint32_t* s) {
  if (col >= g.n) return;
  const uint32_t end = g.rows - b0 < g.chunk ? g.rows : b0 + g.chunk;
  const uint32_t half = 4u * g.chunk * g.cols;
  for (uint32_t b = b0 + r; b < end; b += g.lanes) {
    const uint32_t e = b * g.n + col;
    uint32_t a[8], w[8], t[8];
    load_elem(x + 8ull * e, a);
    load_elem(y + 8ull * (kFull ? e : b), w);
    mulmod_cc(a, w, t);
    store_prod(s, half, (b - b0) * g.cols + c, t);
  }
}

// Phase 2 of the chunk from row b0 for column slot c: its products added
// to acc one at a time, in row order.
LIGERO_HD void mulsum_fold_at(const MulsumGeom& g, uint32_t b0, uint32_t c,
                              const uint32_t* s, uint32_t acc[8]) {
  const uint32_t end = g.rows - b0 < g.chunk ? g.rows : b0 + g.chunk;
  const uint32_t half = 4u * g.chunk * g.cols;
#pragma unroll 4
  for (uint32_t b = b0; b < end; ++b) {
    uint32_t t[8], r[8];
    load_prod(s, half, (b - b0) * g.cols + c, t);
    add_mod(acc, t, r);
#pragma unroll
    for (int l = 0; l < 8; ++l) acc[l] = r[l];
  }
}

// K2's, K1's, KA's and the fold-only KF's threads per block: the largest
// of 256, 128, 64, 32 that still gives every SM of the card (132) a block,
// else one warp.
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

// KA: one element per thread.  No __restrict__: out may be x or y,
// element for element (each thread loads both operands before its store).
template <int kMode, int kConst>
__global__ void __launch_bounds__(256)
addsub_kernel(const uint32_t* x, AosView xv, const uint32_t* y, AosView yv,
              Elem c, uint32_t* out, uint32_t n) {
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) aos_eltwise_at<kMode, kConst>(x, xv, y, yv, c, out, i);
}

template <int kMode>
static void launch_addsub(int c_side, uint32_t blocks, uint32_t threads,
                          cudaStream_t s, const uint32_t* x, AosView xv,
                          const uint32_t* y, AosView yv, const Elem& c,
                          uint32_t* out, uint32_t n) {
  if (c_side == kConstX)
    addsub_kernel<kMode, kConstX><<<blocks, threads, 0, s>>>(x, xv, y, yv,
                                                            c, out, n);
  else if (c_side == kConstY)
    addsub_kernel<kMode, kConstY><<<blocks, threads, 0, s>>>(x, xv, y, yv,
                                                            c, out, n);
  else
    addsub_kernel<kMode, kNoConst><<<blocks, threads, 0, s>>>(x, xv, y, yv,
                                                             c, out, n);
}

// KF, the fold of given rows: one column per thread
__global__ void __launch_bounds__(256)
masked_sum_kernel(const uint32_t* __restrict__ acc,
                  const uint32_t* __restrict__ terms,
                  uint32_t* __restrict__ out, uint32_t n, uint32_t rows) {
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) masked_sum_at(acc, terms, out, n, rows, i);
}

// KF, the fold of fresh products: per chunk, every thread's products into
// shared memory, then thread (c, 0) adds them to column c's sum in order.
template <bool kFull>
__global__ void __launch_bounds__(kMulsumMaxThreads)
masked_mulsum_kernel(const uint32_t* __restrict__ acc,
                     const uint32_t* __restrict__ x,
                     const uint32_t* __restrict__ y,
                     uint32_t* __restrict__ out, MulsumGeom g) {
  extern __shared__ uint4 mulsum_smem[];
  uint32_t* s = (uint32_t*)mulsum_smem;
  const uint32_t c = threadIdx.x, r = threadIdx.y;
  const uint32_t col = blockIdx.x * g.cols + c;
  const bool folds = r == 0u && col < g.n;
  uint32_t a[8];
  if (folds) load_elem(acc + 8ull * col, a);
  for (uint32_t b0 = 0; b0 < g.rows; b0 += g.chunk) {
    mulsum_products_at<kFull>(x, y, g, b0, c, r, col, s);
    __syncthreads();
    if (folds) mulsum_fold_at(g, b0, c, s, a);
    if (g.rows - b0 > g.chunk) __syncthreads();   // the buffer is reused
  }
  if (folds) store_elem(out + 8ull * col, a);
}

// Launches the fused KF with geometry g (mulsum_geom's, or a sweep's).
static inline int launch_mulsum(const void* acc, const void* x,
                                const void* y, void* out, MulsumGeom g,
                                int y_full, cudaStream_t s) {
  const dim3 block(g.cols, g.lanes);
  const uint32_t blocks = (g.n + g.cols - 1u) / g.cols;
  const size_t smem = 32ull * g.chunk * g.cols;
  const uint32_t* ap = (const uint32_t*)acc;
  const uint32_t* xp = (const uint32_t*)x;
  const uint32_t* yp = (const uint32_t*)y;
  uint32_t* op = (uint32_t*)out;
  if (y_full)
    masked_mulsum_kernel<true><<<blocks, block, smem, s>>>(ap, xp, yp, op, g);
  else
    masked_mulsum_kernel<false><<<blocks, block, smem, s>>>(ap, xp, yp, op,
                                                            g);
  return (int)cudaGetLastError();
}

// An empty kernel: the launch floor that chip_smoke.py times beside K2.
__global__ void empty_kernel() {}

// The wide multiply-add probe (chip_smoke.py phase 2): each thread runs
// `iters` rounds of kChains independent accumulators, each taking one of
// mont_mul_cc's even chains a round (4 mad.lo.cc/madc.hi.cc pairs, each
// pair one IMAD.WIDE.U32(.X) in SASS, then two carry adds), and writes one
// word so that nothing is dropped.  A chain's first product waits only for
// its accumulator's first word from the round before, as in mont_mul_cc.
template <int kChains>
__global__ void __launch_bounds__(256)
imad_probe_kernel(uint32_t iters, uint32_t* __restrict__ out) {
  const uint32_t t = blockIdx.x * blockDim.x + threadIdx.x;
  const uint32_t x = t * 0x9e3779b9u + 1u, b0 = x ^ 0x85ebca6bu,
                 b2 = x ^ 0xc2b2ae35u, b4 = x + 0x27d4eb2fu,
                 b6 = x + 0x165667b1u;
  uint32_t e[kChains][9], o[kChains][9];
#pragma unroll
  for (int k = 0; k < kChains; ++k)
#pragma unroll
    for (int j = 0; j < 9; ++j) e[k][j] = o[k][j] = x + 9u * k + j;
#pragma unroll 1
  for (uint32_t it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < kChains; ++k)
      LIGERO_CC(LIGERO_EVEN_CHAIN("%11", "%12", "%13", "%14"),
                LIGERO_E9(e[k], o[k]),
                (LIGERO_R(x), LIGERO_R(b0), LIGERO_R(b2), LIGERO_R(b4),
                 LIGERO_R(b6)));
  }
  uint32_t acc = 0u;
#pragma unroll
  for (int k = 0; k < kChains; ++k) {
#pragma unroll
    for (int j = 0; j < 9; ++j) acc ^= e[k][j];
    acc ^= o[k][8];
  }
  out[t] = acc;
}

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

// KA: out (n, 8) = x + y mod p (mode 0) or x - y mod p (mode 1), element
// i of x at element (i / x_div) * x_outer + (i % x_div) * x_inner of x
// (AosView), and y alike; c_side 1 (2) takes x (y) as the host constant
// c, 8 words copied here into the kernel's argument (its pointer and
// view unused).  out may be x or y element for element.  n below 2^31 (a
// 32-bit thread index), divs positive, strides not negative; every
// element 16-byte aligned.  Returns cudaGetLastError().
extern "C" int ligero_aos_eltwise(const void* x, long long x_div,
                                  long long x_outer, long long x_inner,
                                  const void* y, long long y_div,
                                  long long y_outer, long long y_inner,
                                  const void* c, int c_side, void* out,
                                  long long n, int mode, void* stream) {
  if (n <= 0) return 0;
  if (n >= (1ll << 31) || (mode != 0 && mode != 1) || x_div <= 0
      || y_div <= 0 || x_outer < 0 || x_inner < 0 || y_outer < 0
      || y_inner < 0 || c_side < 0 || c_side > 2
      || (c_side != 0 && c == nullptr))
    return (int)cudaErrorInvalidValue;
  const ligero_fm::AosView xv =
      ligero_fm::make_aos_view(x_div, x_outer, x_inner, n);
  const ligero_fm::AosView yv =
      ligero_fm::make_aos_view(y_div, y_outer, y_inner, n);
  ligero_fm::Elem cv{};
  if (c_side != 0)
    for (int l = 0; l < 8; ++l) cv.w[l] = ((const uint32_t*)c)[l];
  const uint32_t threads = ligero_fm::mulmod_threads((uint32_t)n);
  const uint32_t blocks = ((uint32_t)n + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* xp = (const uint32_t*)x;
  const uint32_t* yp = (const uint32_t*)y;
  uint32_t* op = (uint32_t*)out;
  if (mode == 0)
    ligero_fm::launch_addsub<0>(c_side, blocks, threads, s, xp, xv, yp, yv,
                                cv, op, (uint32_t)n);
  else
    ligero_fm::launch_addsub<1>(c_side, blocks, threads, s, xp, xv, yp, yv,
                                cv, op, (uint32_t)n);
  return (int)cudaGetLastError();
}

// KF: out (n, 8) = acc (n, 8) + terms[0] + ... + terms[B-1] mod p, terms
// (B, n, 8), added in that order column by column; B = 0 copies acc.  n
// and B below 2^31; all three contiguous and 16-byte aligned.  Returns
// cudaGetLastError().
extern "C" int ligero_masked_sum(const void* acc, const void* terms,
                                 void* out, long long n, long long rows,
                                 void* stream) {
  if (n <= 0) return 0;
  if (n >= (1ll << 31) || rows < 0 || rows >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const uint32_t threads = ligero_fm::mulmod_threads((uint32_t)n);
  ligero_fm::masked_sum_kernel<<<((uint32_t)n + threads - 1) / threads,
                                 threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)acc, (const uint32_t*)terms, (uint32_t*)out,
      (uint32_t)n, (uint32_t)rows);
  return (int)cudaGetLastError();
}

// KF fused: out (n, 8) = acc (n, 8) + x[0]*y[0] + ... + x[B-1]*y[B-1] mod
// p, x (B, n, 8), y (B, n, 8) (y_full) or (B, 1, 8), the products added in
// that order column by column; B = 0 copies acc.  B * n below 2^31; all
// four contiguous and 16-byte aligned.  Returns cudaGetLastError().
extern "C" int ligero_masked_mulsum(const void* acc, const void* x,
                                    const void* y, void* out, long long n,
                                    long long rows, int y_full,
                                    void* stream) {
  if (n <= 0) return 0;
  if (n >= (1ll << 31) || rows < 0 || rows * n >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  return ligero_fm::launch_mulsum(
      acc, x, y, out, ligero_fm::mulsum_geom((uint32_t)n, (uint32_t)rows),
      y_full, (cudaStream_t)stream);
}

// Launches the empty kernel as blocks x threads.  Returns
// cudaGetLastError().
extern "C" int ligero_empty(int blocks, int threads, void* stream) {
  ligero_fm::empty_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

// Launches the wide multiply-add probe with chains (1 or 4) accumulators a
// thread and `iters` rounds, as many 256-thread CTAs as fit the card at
// once (every SM full, one wave); sets *blocks to that count.  out: blocks
// * 256 words.  Returns cudaGetLastError() (or the occupancy query's
// error).
extern "C" int ligero_imad_probe(int chains, int iters, void* out,
                                 int* blocks, void* stream) {
  if ((chains != 1 && chains != 4) || iters < 1)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm,
        chains == 1 ? ligero_fm::imad_probe_kernel<1>
                    : ligero_fm::imad_probe_kernel<4>,
        256, 0);
  if (err != cudaSuccess) return (int)err;
  *blocks = sms * per_sm;
  cudaStream_t s = (cudaStream_t)stream;
  uint32_t* op = (uint32_t*)out;
  if (chains == 1)
    ligero_fm::imad_probe_kernel<1><<<*blocks, 256, 0, s>>>(iters, op);
  else
    ligero_fm::imad_probe_kernel<4><<<*blocks, 256, 0, s>>>(iters, op);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
