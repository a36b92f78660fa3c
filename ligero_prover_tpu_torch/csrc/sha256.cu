// Column SHA-256 absorb for Hopper: kernel K3, in two layouts.
//
// Replaces the column absorb of the JAX package, which is XLA code, not a
// Pallas kernel: _absorb_stream (ligero_prover_tpu/zkp/executor.py:43-65)
// with sha256.transform (ligero_prover_tpu/ops/sha256.py:57-121), and its
// planar twin _absorb_stream_planar (executor.py:68-105), which reads
// (8, B, C) limb-major codewords.  Each of
// the C codeword columns carries its own SHA-256 state; a flush absorbs the
// batch's rows in order, two 32-byte elements per 64-byte block.  A block's
// 16 message words are the raw limbs of the two elements, no byte swap
// (sha256.py:7-11).  An element left unpaired at the end of a flush is
// carried to the next one (`pending`), exactly as the reference does:
//   stream = [pending, rows[0..B)]; start = 1 - has_pending;
//   total = valid_count + has_pending; pairs = total / 2;
//   blocks = (stream[start+2i], stream[start+2i+1]) for i < pairs;
//   new pending = stream[clamp(start + 2*pairs, 0, B)];
//   new has_pending = total odd.
//
// What bounds it on this card: one compression is ~2,000 32-bit integer
// operations per 64 bytes read, so with a column per thread it is bound by
// the integer pipes once enough columns are in flight (n = 32768 columns
// fill 128 blocks of 256 threads, about one block per SM).  Design: one
// thread per column, the 8-word state in registers across all of a flush's
// blocks (so state never round-trips through memory between blocks), the
// 64-round loop fully unrolled with a rotating 16-word schedule.  AoS rows
// are read as 16-byte vectors (a thread's element is 32 contiguous bytes);
// planar rows as one word per limb plane, coalesced across the warp.

#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define LIGERO_HD __device__ __forceinline__
#define LIGERO_CONST __constant__
#else
#define LIGERO_HD static inline
#define LIGERO_CONST static const
#endif

namespace ligero_sha {

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

}  // namespace ligero_sha

#ifdef __CUDACC__

namespace ligero_sha {

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

}  // namespace ligero_sha

// state: (8, C) u32, pending: (C, 8) u32, rows: (B, C, 8) u32, or
// (8, B, C) when `planar` is 1 (the planar codec's codewords, read with no
// transpose); outputs must not alias inputs.  pending and AoS rows 16-byte
// aligned; 0 <= valid_count <= B.  Returns cudaGetLastError().
extern "C" int ligero_sha256_absorb(const void* state_in,
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
    ligero_sha::absorb_kernel<true><<<blocks, threads, 0, s>>>(
        st, pe, ro, (uint32_t*)state_out, (uint32_t*)pending_out, C, B,
        has_pending, valid_count);
  else
    ligero_sha::absorb_kernel<false><<<blocks, threads, 0, s>>>(
        st, pe, ro, (uint32_t*)state_out, (uint32_t*)pending_out, C, B,
        has_pending, valid_count);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
