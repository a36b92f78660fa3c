// Column SHA-256 absorb for Hopper: kernel K3, in two layouts.
//
// Replaces the column absorb of the JAX package, which is XLA code, not a
// Pallas kernel: absorb_tile_kernel<false, kTile> replaces _absorb_stream
// (ligero_prover_tpu/zkp/executor.py:43-65) with sha256.transform
// (ligero_prover_tpu/ops/sha256.py:57-121), over (B, C, 8) rows;
// absorb_tile_kernel<true, kTile> its planar twin _absorb_stream_planar
// (executor.py:68-105), over (8, B, C) limb-major codewords, read in place.
// Each of the C codeword columns carries its own SHA-256 state; a flush
// absorbs the batch's rows in order, two 32-byte elements per 64-byte
// block.  A block's 16 message words are the raw limbs of the two
// elements, no byte swap (sha256.py:7-11).  An element left unpaired at
// the end of a flush is carried to the next one (`pending`), exactly as
// the reference does:
//   stream = [pending, rows[0..B)]; start = 1 - has_pending;
//   total = valid_count + has_pending; pairs = total / 2;
//   blocks = (stream[start+2i], stream[start+2i+1]) for i < pairs;
//   new pending = stream[clamp(start + 2*pairs, 0, B)];
//   new has_pending = total odd.
//
// What bounds it on this card: one compression is 1,384 32-bit integer
// operations (64 rounds of 14, 48 schedule words of 10, 8 state adds) per
// 64 bytes read.  1,024 of them (every rotate and shift, every xor,
// choose and majority: SHF and LOP3) run only on the integer pipe, at 64
// per clock per SM on compute capability 9.0 (16 lanes per SM
// sub-partition beside 32 FP32 lanes); the 360 adds can also issue as
// IMAD on the FMA pipe, and the SM issues 128 instructions per clock in
// all.  So a compression takes at least max(1024/64, 1384/128) = 16
// SM-clocks: 0.0160 ms for the commit step's 32,768 columns x 8 blocks on
// 132 SMs at 1,980 MHz, far above the 0.0033 ms its 11 MB take at HBM
// rate.  At the verifier's 192 columns the bound is the chain of 64
// dependent rounds per block in each column: latency, not throughput.
//
// Design.  A CTA owns a tile of kTile columns and runs two warp roles on
// it, one thread per column in each:
//   - schedule warps load each block's 16 message words, expand
//     W[16..63], fold K[i] into every word and write the 64 words
//     W[i] + K[i] into a two-stage ring in shared memory
//     (ring[stage][i][column]: consecutive columns are consecutive banks);
//     the loads of block i+1 go out, into registers, before block i is
//     expanded, so with the ring one block ahead the rows arrive two
//     blocks before the rounds need them;
//   - round warps hold the 8-word state in registers across the whole
//     flush and run the 64 rounds of each block on the ring's words: 10
//     integer-pipe operations, 6 adds and one shared load per round, none
//     of the schedule's 480 operations.
// The roles are different warps (lanes of one warp that diverge would
// serialise) and hand stages over with named barriers: FULL[s] (the
// schedule warps arrive, the round warps wait) and EMPTY[s] (the reverse).
// Every add is written as a multiply-add by a run-time 1 (add()), so it
// issues on the FMA pipe: the integer pipe, the bound above, then runs
// only the rotates, shifts and LOP3s and the few address and loop
// operations.  That raises the instruction count (a 3-input IADD3 becomes
// two IMADs) and lowers the integer pipe's share, which is what binds.
// The tile follows C (tile_for in ops/sha256.py):
//   - kTile = 128 for the commit step's 32,768 columns: 256 CTAs of 8
//     warps, about two per SM; warps 0-3 (rounds) and 4-7 (schedule) put
//     one warp of each role on each of the SM's four sub-partitions, so
//     that every sub-partition's integer pipe has both kinds of work (with
//     4-warp CTAs the round warps all sit on two sub-partitions);
//   - kTile = 32 for the verifier's 192 sampled columns: 6 CTAs of one
//     round warp and one schedule warp, on 6 SMs, so that each column's
//     chain of rounds has a sub-partition to itself and no schedule work
//     in its issue slots.
// The state loads and the new pending element's load go out before the
// first block.  A column past C (the ragged last tile) reads column C-1
// and stores nothing, so every thread of the CTA meets every barrier.
// Planar rows are read one limb plane at a time, a warp's 32 columns one
// 128-byte run; AoS rows as two 16-byte vectors per element.  The old
// design (one thread per column in CTAs of 256, each block loaded at the
// top of its iteration) and a simpler redesign (one thread per column,
// the next block prefetched into registers) are timed beside this one by
// experiment_sha_absorb.py; the measurements are in PERF.md.

#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define LIGERO_HD __device__ __forceinline__
#define LIGERO_HOST_HD __host__ __device__ inline
#define LIGERO_CONST __constant__
#else
#define LIGERO_HD static inline
#define LIGERO_HOST_HD static inline
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

enum { kWords = 64 };   // ring words per block and column: W[i] + K[i]

LIGERO_HD uint32_t rotr(uint32_t x, int r) {
  return (x >> r) | (x << (32 - r));
}

// x + y, written as the multiply-add x * one + y with one = 1 read from the
// kernel's arguments: ptxas cannot fold it into an add, so it issues as an
// IMAD on the FMA pipe and leaves the integer pipe to the rotates, shifts
// and LOP3s, which only it runs.
LIGERO_HD uint32_t add(uint32_t x, uint32_t y, uint32_t one) {
  return x * one + y;
}

// One flush of one tile: the arguments of the C entry point, and the
// flush's block count and new pending element, as every thread computes
// them.
struct Flush {
  const uint32_t* state_in;   // (8, C)
  const uint32_t* pend_in;    // (C, 8)
  const uint32_t* rows;       // (B, C, 8), or (8, B, C) when planar
  uint32_t* state_out;        // (8, C)
  uint32_t* pend_out;         // (C, 8)
  long long C;
  int B, start, pairs, last;  // last: the new pending element's index
  uint32_t one;               // 1, for add()
};

LIGERO_HOST_HD Flush make_flush(const uint32_t* state_in,
                                const uint32_t* pend_in,
                                const uint32_t* rows, uint32_t* state_out,
                                uint32_t* pend_out, long long C, int B,
                                int has_pending, int valid_count) {
  const int start = 1 - has_pending, pairs = (valid_count + has_pending) / 2;
  int last = start + 2 * pairs;
  last = last < 0 ? 0 : (last > B ? B : last);
  return {state_in, pend_in, rows, state_out, pend_out, C, B, start, pairs,
          last, 1u};
}

// Column `lane` of tile `tile`, clamped into [0, C) for loads.
template <int kTile>
LIGERO_HD long long column_of(const Flush& f, long long tile, int lane,
                              bool* live) {
  const long long c = tile * kTile + lane;
  *live = c < f.C;
  return *live ? c : f.C - 1;
}

// Element j of the stream [pending, rows...] for column c, as 8 words.
template <bool kPlanar>
LIGERO_HD void load_elem(const Flush& f, long long c, int j, uint32_t v[8]) {
  if (kPlanar && j > 0) {
    const uint32_t* p = f.rows + (long long)(j - 1) * f.C + c;
    const long long plane = (long long)f.B * f.C;
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = p[i * plane];
    return;
  }
  const uint32_t* p =
      j == 0 ? f.pend_in + c * 8 : f.rows + ((long long)(j - 1) * f.C + c) * 8;
#ifdef __CUDACC__
  const uint4 lo = ((const uint4*)p)[0], hi = ((const uint4*)p)[1];
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
#else
  for (int i = 0; i < 8; ++i) v[i] = p[i];
#endif
}

// ---- the schedule role: one thread per column ---------------------------

// Before the first block: load the new pending element into `pend` and
// block 0's 16 words into `next`.
template <bool kPlanar, int kTile>
LIGERO_HD void sched_begin_at(const Flush& f, long long tile, int lane,
                              uint32_t pend[8], uint32_t next[16]) {
  bool live;
  const long long c = column_of<kTile>(f, tile, lane, &live);
  load_elem<kPlanar>(f, c, f.last, pend);
  if (f.pairs > 0) {
    load_elem<kPlanar>(f, c, f.start, next);
    load_elem<kPlanar>(f, c, f.start + 1, next + 8);
  }
}

// After the last block: store the new pending element.
template <int kTile>
LIGERO_HD void sched_end_at(const Flush& f, long long tile, int lane,
                            const uint32_t pend[8]) {
  bool live;
  const long long c = column_of<kTile>(f, tile, lane, &live);
  if (!live) return;
  uint32_t* p = f.pend_out + c * 8;
#ifdef __CUDACC__
  ((uint4*)p)[0] = make_uint4(pend[0], pend[1], pend[2], pend[3]);
  ((uint4*)p)[1] = make_uint4(pend[4], pend[5], pend[6], pend[7]);
#else
  for (int i = 0; i < 8; ++i) p[i] = pend[i];
#endif
}

// Block i: take its words from `next` into `w` and load block i+1's into
// `next`, before block i is expanded.
template <bool kPlanar, int kTile>
LIGERO_HD void sched_fetch_at(const Flush& f, long long tile, int lane, int i,
                              uint32_t w[16], uint32_t next[16]) {
#pragma unroll
  for (int k = 0; k < 16; ++k) w[k] = next[k];
  if (i + 1 < f.pairs) {
    bool live;
    const long long c = column_of<kTile>(f, tile, lane, &live);
    load_elem<kPlanar>(f, c, f.start + 2 * i + 2, next);
    load_elem<kPlanar>(f, c, f.start + 2 * i + 3, next + 8);
  }
}

// Expand one block's 16 words (consumed) into W[i] + K[i] for i < 64, at
// stage[i * kTile] (the column's slot of a ring stage).
template <int kTile>
LIGERO_HD void sched_expand_at(uint32_t w[16], uint32_t* stage,
                               uint32_t one) {
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    if (i >= 16) {
      const uint32_t x15 = w[(i - 15) & 15], x2 = w[(i - 2) & 15];
      const uint32_t s0 = rotr(x15, 7) ^ rotr(x15, 18) ^ (x15 >> 3);
      const uint32_t s1 = rotr(x2, 17) ^ rotr(x2, 19) ^ (x2 >> 10);
      w[i & 15] = add(add(add(w[i & 15], s1, one), w[(i - 7) & 15], one),
                      s0, one);
    }
    stage[i * kTile] = add(w[i & 15], kK[i], one);
  }
}

// ---- the round role: one thread per column ------------------------------

template <int kTile>
LIGERO_HD void round_begin_at(const Flush& f, long long tile, int lane,
                              uint32_t st[8]) {
  bool live;
  const long long c = column_of<kTile>(f, tile, lane, &live);
#pragma unroll
  for (int i = 0; i < 8; ++i) st[i] = f.state_in[i * f.C + c];
}

// The 64 rounds of one block on the words W[i] + K[i] at stage[i * kTile].
template <int kTile>
LIGERO_HD void round_block_at(const uint32_t* stage, uint32_t st[8],
                              uint32_t one) {
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    const uint32_t s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    const uint32_t ch = (e & f) ^ (~e & g);
    const uint32_t s0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    // h + W[i] + K[i] does not wait for this round's e
    const uint32_t t1 = add(add(add(h, stage[i * kTile], one), ch, one), s1,
                            one);
    const uint32_t t2 = add(s0, maj, one);
    h = g; g = f; f = e; e = add(d, t1, one);
    d = c; c = b; b = a; a = add(t1, t2, one);
  }
  st[0] = add(st[0], a, one); st[1] = add(st[1], b, one);
  st[2] = add(st[2], c, one); st[3] = add(st[3], d, one);
  st[4] = add(st[4], e, one); st[5] = add(st[5], f, one);
  st[6] = add(st[6], g, one); st[7] = add(st[7], h, one);
}

template <int kTile>
LIGERO_HD void round_end_at(const Flush& f, long long tile, int lane,
                            const uint32_t st[8]) {
  bool live;
  const long long c = column_of<kTile>(f, tile, lane, &live);
  if (live)
    for (int i = 0; i < 8; ++i) f.state_out[i * f.C + c] = st[i];
}

// The tile sizes the wrapper may pick; a CTA is 2 * kTile threads.
LIGERO_HOST_HD bool tile_ok(int tile) { return tile == 32 || tile == 128; }

// Named barriers 1..4 (0 is __syncthreads): the schedule warps arrive at
// FULL[s] = 1 + s when ring stage s holds a block, the round warps at
// EMPTY[s] = 3 + s when they have read it; every thread of the CTA counts.
enum { kFull = 1, kEmpty = 3 };

// Thread t of the CTA of tile `tile`: threads [0, kTile) are the round
// warps, [kTile, 2 kTile) the schedule warps.  `ring` is the CTA's
// 2 * kWords * kTile words of shared memory; `bar` gives bar.sync and
// bar.arrive (a host harness may run the threads with its own).
template <bool kPlanar, int kTile, class Bar>
LIGERO_HD void absorb_thread(const Flush& f, long long tile, int t,
                             uint32_t* ring, Bar& bar) {
  const int threads = 2 * kTile;
  if (t < kTile) {                                 // round warps
    uint32_t st[8];
    round_begin_at<kTile>(f, tile, t, st);
    for (int i = 0; i < f.pairs; ++i) {
      const int s = i & 1;
      bar.sync(kFull + s, threads);
      round_block_at<kTile>(ring + s * kWords * kTile + t, st, f.one);
      if (i + 2 < f.pairs) bar.arrive(kEmpty + s, threads);
    }
    round_end_at<kTile>(f, tile, t, st);
  } else {                                         // schedule warps
    const int lane = t - kTile;
    uint32_t pend[8], w[16], next[16];
    sched_begin_at<kPlanar, kTile>(f, tile, lane, pend, next);
    for (int i = 0; i < f.pairs; ++i) {
      const int s = i & 1;
      sched_fetch_at<kPlanar, kTile>(f, tile, lane, i, w, next);
      if (i >= 2) bar.sync(kEmpty + s, threads);
      sched_expand_at<kTile>(w, ring + s * kWords * kTile + lane, f.one);
      bar.arrive(kFull + s, threads);
    }
    sched_end_at<kTile>(f, tile, lane, pend);
  }
}

}  // namespace ligero_sha

#ifdef __CUDACC__

namespace ligero_sha {

struct DeviceBar {
  __device__ __forceinline__ void sync(int id, int threads) {
    asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
  }
  __device__ __forceinline__ void arrive(int id, int threads) {
    asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
  }
};

template <bool kPlanar, int kTile>
__global__ void __launch_bounds__(2 * kTile)
absorb_tile_kernel(Flush f) {
  extern __shared__ uint32_t ring[];               // 2 * kWords * kTile
  DeviceBar bar;
  absorb_thread<kPlanar, kTile>(f, blockIdx.x, threadIdx.x, ring, bar);
}

template <bool kPlanar, int kTile>
int launch_tile(const Flush& f, cudaStream_t s) {
  const int smem = 2 * kWords * kTile * (int)sizeof(uint32_t);
  // above 48 KB (kTile = 128: 64 KB) only after this attribute, which
  // belongs to the current device
  const cudaError_t rc = cudaFuncSetAttribute(
      absorb_tile_kernel<kPlanar, kTile>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return (int)rc;
  const long long tiles = (f.C + kTile - 1) / kTile;
  absorb_tile_kernel<kPlanar, kTile><<<(unsigned)tiles, 2 * kTile, smem, s>>>(
      f);
  return (int)cudaGetLastError();
}

template <bool kPlanar>
int launch_absorb(const Flush& f, int tile, cudaStream_t s) {
  return tile == 32 ? launch_tile<kPlanar, 32>(f, s)
                    : launch_tile<kPlanar, 128>(f, s);
}

}  // namespace ligero_sha

// state: (8, C) u32, pending: (C, 8) u32, rows: (B, C, 8) u32, or
// (8, B, C) when `planar` is 1 (the planar codec's codewords, read with no
// transpose); outputs must not alias inputs.  pending and AoS rows 16-byte
// aligned; 0 <= valid_count <= B; `tile` (columns per CTA) 32 or 128.
// Returns cudaGetLastError().
extern "C" int ligero_sha256_absorb(const void* state_in,
                                    const void* pending_in, const void* rows,
                                    void* state_out, void* pending_out,
                                    long long C, int B, int has_pending,
                                    int valid_count, int planar, int tile,
                                    void* stream) {
  if (C <= 0) return 0;
  if (B < 0 || valid_count < 0 || valid_count > B ||
      (has_pending != 0 && has_pending != 1) ||
      (planar != 0 && planar != 1) || !ligero_sha::tile_ok(tile) ||
      (C + tile - 1) / tile > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const ligero_sha::Flush f = ligero_sha::make_flush(
      (const uint32_t*)state_in, (const uint32_t*)pending_in,
      (const uint32_t*)rows, (uint32_t*)state_out, (uint32_t*)pending_out, C,
      B, has_pending, valid_count);
  cudaStream_t s = (cudaStream_t)stream;
  return planar ? ligero_sha::launch_absorb<true>(f, tile, s)
                : ligero_sha::launch_absorb<false>(f, tile, s);
}

#endif  // __CUDACC__
