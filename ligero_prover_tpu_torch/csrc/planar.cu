// Planar BN254-Fr kernels for Hopper: KB (a pass of constant-geometry
// butterfly stages), KE (element-wise add/sub/Montgomery products) and KQ
// (the check's whole quadratic-test accumulation; its note is below).
// Operands are limb planes: element i of an (8, X) tensor has limb l at
// x[l*ls + i], with ls the plane's stride (X for a contiguous tensor).
//
// KB replaces the Pallas TPU kernels _k_butterfly_dit and _k_butterfly_dif
// (ligero_prover_tpu/ops/pallas/fieldmul.py:238,245) together with the
// reshapes, concatenate/stack and the (8, B*h) twiddle broadcast around
// each call in the constant-geometry stage loops
// (ligero_prover_tpu/ops/ntt.py:328-364).  One stage over (8, B, N) rows,
// N = 2h, L = log2 N:
//   DIT: a = x[:, b, 2j], c = x[:, b, 2j+1], wc = mont(c, tw[:, j]);
//        y[:, b, j] = a + wc,  y[:, b, h+j] = a - wc.
//   DIF: a = x[:, b, j],  c = x[:, b, h+j];
//        y[:, b, 2j] = a + c,  y[:, b, 2j+1] = mont(a - c, tw[:, j]).
// A DIT stage moves the butterfly's pair from the positions differing in
// bit 0 to those differing in bit L-1: it rotates the position's bits
// right by one.  So s consecutive DIT stages t0..t0+s-1 split into closed
// groups of M = 2^s elements: group g (of R = N/M per row) reads the
// contiguous positions g*M + m and, after s stages, writes position
// m*R + g.  Inside the group the s stages are a constant-geometry
// transform of size M: after r of them local slot q sits at global
// position (q >> (s-r))*2^(L-r) + g*2^(s-r) + (q mod 2^(s-r)), so local
// butterfly jl of local stage r is global butterfly
//   j = ((jl >> c) << (L-r-1)) | (g << c) | (jl mod 2^c),  c = s-r-1,
// and takes twiddle tw[t0+r][:, j].  A DIF pass is the transpose: group g
// reads positions m*R + g, runs local DIF steps for r = s-1 down to 0
// (stage t0+r, the same j) and writes the contiguous g*M + m.  Every
// butterfly applies the same add_mod/sub_mod/mont_mul to the same
// operands as the stage loop; only the order of independent butterflies
// changes, so a pass equals its s one-stage launches bit for bit.
//
// One launch is one pass over the whole batch, out of place.  A CTA owns
// a tile of kTile elements, G = kTile/M whole groups: it loads the tile
// into shared memory as eight limb planes (each group padded by one word,
// so that the strided side's accesses, consecutive groups at one local
// index, fall in distinct banks), runs the s stages there with one
// butterfly per thread per stage and a barrier between stages (ping-pong
// buffers; the next stage's twiddles are read before the barrier), and
// writes the tile back.  Global accesses: on the contiguous
// side (DIT read, DIF write) a thread moves 4 consecutive words of a plane
// (16-byte vectors); on the strided side consecutive groups are
// consecutive addresses, also moved 4 at a time where a row holds at
// least 4 groups.  A DIT input narrower than N (in_n < N) is read tiled,
// element i being x[:, b, i mod in_n]: that is the zero-extension of the
// encode (ntt.py:379-381), so no tiled copy is made.  With s = 1 a pass
// is exactly one stage.
//
// KE replaces _k_addmod, _k_submod, _k_mont_scalar and _k_mulmod_fma
// (fieldmul.py:252,256,269,278) and gives _k_mont_mul/_k_mulmod (:260,264)
// their planar entry.  mulmod_fma adds the product to a third operand z,
// a full plane read as x is.
// The second operand y is either a full plane (y_div = 1) or a value per
// run of y_div consecutive elements (a per-row scalar over (8, B, n) rows
// has y_div = n).  Mode kTiled (mont_mul only) reads y as one row of
// y_div = w elements tiled over x: element i reads y[i mod w].  It is the
// sharded encode's coset twist (ops/ntt.py, encode_rows_coset_planar_core):
// (8, B, w) coefficient rows times one (8, w) table of 1/w times the
// shard's powers, the 1/w scaling and the twist in one launch; it is a
// kernel of its own (tiled_kernel, with its note below).  Mode kScalar
// (mont_scalar) is a kernel of its own too: one
// element s, read once per thread into registers, and field.cuh's
// carry-chain product mont_mul_cc, about a third of mont_mul's
// instructions: at the encode's (8, 16, k) call the product is then a
// small part of its time, the launch and its loads and stores the rest
// (PERF.md); its other calls (the check's prescales of 16 and T+P
// elements) are bound by the launch.
// Modes kMont, kMulmod and kFma (run_product_kernel) and quad-terms
// (quad_terms_kernel, _k_mulmod's planar entry redesigned around the
// check's one call, which took the terms x*y - z and x - y from rows
// gathered by index: executor.py:233-250) share one geometry: each CTA
// covers part of one row (a run), so a per-row scalar is read once per
// thread into registers and quad-terms picks its form and its three row
// indices once per CTA; a thread moves 4 consecutive elements of each
// limb plane as one 16-byte access where the plane and run starts allow,
// and multiplies with the carry-chain mont_mul_cc/mulmod_cc (mulmod_fma:
// mulmod_cc, then add_mod of z, a full plane read as x is, in single
// elements: see launch_fma).  quad-terms
// reads the rows of the encoded batch in place (it fits the 50 MB L2)
// and writes the (8, T+P, n) terms: one launch where the check made five
// row gathers, a mulmod, two submods and a concatenation.  KQ, which also
// takes the products, the fold and the add into acc, has replaced it on
// the main path.
//
// What bounds them on this card: a butterfly or a Montgomery product is
// ~200 32-bit multiply-adds per 96 bytes moved, so KB and KE's product
// modes are bound by the integer pipes at the main path's shapes (2^18..
// 2^19 elements), while KE's add/sub modes (~30 integer ops per 96 bytes)
// are bound by HBM bandwidth.  mulmod_fma at its (8, 16, 32768) shape
// moves 128 bytes per element for two Montgomery products (328 wide
// multiply-adds): its bytes' time (0.020 ms) is the larger at the
// published rates, but the carry chains issue at about a third of the
// multiply-add rate (PERF.md), so, as KE mulmod on two thirds of its
// bytes, it runs at the pace of its products, its 32 more bytes of z per
// element overlapping them; in single elements (2,048 CTAs of about 52
// registers) the SM holds enough warps to hide both.  A one-stage KB
// launch moves 64 bytes per
// butterfly through L2/HBM; a pass of s stages moves them once for s
// butterflies, so a whole transform (13-15 stages in 3 passes) is bound
// by the integer instructions of field.cuh's mont_mul, issued at about
// half the SM's rate as in KE (PERF.md has the times).  Design: one thread per butterfly or element,
// all arithmetic in registers (field.cuh); the twiddle is read from its
// (8, N/2) stage plane, never broadcast in memory.  Index math is 32-bit:
// the wrappers keep every plane offset below 2^32.

#include "field.cuh"

namespace ligero_pl {

using namespace ligero_fm;

enum { kAdd = 0, kSub = 1, kMont = 2, kMulmod = 3, kScalar = 4, kFma = 5,
       kTiled = 6 };

// ---- KB: a pass of s constant-geometry stages ------------------------------

// The pass geometry helpers are also called by the host entry point.
#ifdef __CUDACC__
#define LIGERO_HHD __host__ __device__ __forceinline__
#else
#define LIGERO_HHD static inline
#endif

// A tile of 256 elements, one thread per butterfly: 128 threads.  At the
// main path's 5-stage passes that is 8 groups per tile, so the strided
// side moves 32-byte runs, one DRAM sector.
enum { kLog2Tile = 8, kTile = 1 << kLog2Tile, kPassThreads = kTile / 2,
       kMaxPass = kLog2Tile };

// One pass over (8, B, N) rows: s stages, N = 2^log2n; x has rows of
// in_n elements (a power of two <= N, read tiled, for DIT; N for DIF);
// vec: move 4 words per global access (see pass_vec).
struct PassGeom {
  uint32_t B, log2n, s, in_n, vec;
};

// Words per limb plane of a tile in shared memory: kTile plus one pad
// word per group.
LIGERO_HHD uint32_t pass_plane(uint32_t s) { return kTile + (kTile >> s); }

// Whether 4-word global accesses are valid on both sides: the contiguous
// side needs groups and the read width of at least 4 elements, the strided
// side at least 4 groups per tile and per row (s <= L-2), and both sides
// 16-byte aligned planes (the caller checks the pointers).
LIGERO_HHD uint32_t pass_vec(uint32_t log2n, uint32_t s, uint32_t in_n) {
  return s >= 2u && s + 2u <= log2n && s + 2u <= (uint32_t)kLog2Tile &&
         in_n >= 4u;
}

// I/O unit u of tile `tile` (u < kTile/V, V = 4 if pg.vec else 1): V
// elements of one limb plane that are consecutive in global memory.  On the
// contiguous side (`contig`: the DIT read, the DIF write) they are V local
// slots of one group; on the strided side the same local slot of V
// consecutive groups.  Sets the global offset of the first element inside
// its limb plane (rows of in_n elements on the contiguous side, of N on
// the strided side), the first shared-memory slot and the slot step; false
// past the last group.
LIGERO_HD bool pass_unit(const PassGeom& pg, uint32_t tile, uint32_t u,
                         bool contig, uint32_t& off, uint32_t& slot,
                         uint32_t& step) {
  const uint32_t s = pg.s, m = 1u << s, lg_g = (uint32_t)kLog2Tile - s;
  const uint32_t lg_r = pg.log2n - s;
  const uint32_t e = pg.vec ? u << 2 : u;
  uint32_t gl, q;
  if (contig) {
    gl = e >> s;
    q = e & (m - 1u);
  } else {
    gl = e & ((1u << lg_g) - 1u);
    q = e >> lg_g;
  }
  const uint32_t gi = (tile << lg_g) + gl;
  if (gi >= (pg.B << lg_r)) return false;
  const uint32_t b = gi >> lg_r, g = gi & ((1u << lg_r) - 1u);
  if (contig) {
    const uint32_t p = (g << s) | q;
    off = b * pg.in_n + (p & (pg.in_n - 1u));
    step = 1u;
  } else {
    off = (b << pg.log2n) + (q << lg_r) + g;
    step = m + 1u;
  }
  slot = gl * (m + 1u) + q;
  return true;
}

LIGERO_HD void load4(const uint32_t* p, uint32_t v[4]) {
#ifdef __CUDACC__
  const uint4 w = *(const uint4*)p;
  v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
#else
  for (int i = 0; i < 4; ++i) v[i] = p[i];
#endif
}

LIGERO_HD void store4(uint32_t* p, const uint32_t v[4]) {
#ifdef __CUDACC__
  *(uint4*)p = make_uint4(v[0], v[1], v[2], v[3]);
#else
  for (int i = 0; i < 4; ++i) p[i] = v[i];
#endif
}

// Load I/O unit u of a tile from x into the shared planes sm.  DIT reads
// the contiguous side (tiled at width in_n), DIF the strided side.
template <bool kDit>
LIGERO_HD void pass_load_at(const uint32_t* x, uint32_t* sm,
                            const PassGeom& pg, uint32_t tile, uint32_t u) {
  uint32_t off, slot, step;
  if (!pass_unit(pg, tile, u, kDit, off, slot, step)) return;
  const uint32_t plane = pg.B * pg.in_n;
  const uint32_t sp = pass_plane(pg.s);
  if (pg.vec) {
#pragma unroll
    for (int l = 0; l < 8; ++l) {
      uint32_t v[4];
      load4(x + l * plane + off, v);
#pragma unroll
      for (int i = 0; i < 4; ++i) sm[l * sp + slot + i * step] = v[i];
    }
  } else {
#pragma unroll
    for (int l = 0; l < 8; ++l) sm[l * sp + slot] = x[l * plane + off];
  }
}

// Store I/O unit u of a tile from the shared planes sm into y (8, B, N).
// DIT writes the strided side, DIF the contiguous side.
template <bool kDit>
LIGERO_HD void pass_store_at(const uint32_t* sm, uint32_t* y,
                             const PassGeom& pg, uint32_t tile, uint32_t u) {
  uint32_t off, slot, step;
  if (!pass_unit(pg, tile, u, !kDit, off, slot, step)) return;
  const uint32_t plane = pg.B << pg.log2n;
  const uint32_t sp = pass_plane(pg.s);
  if (pg.vec) {
#pragma unroll
    for (int l = 0; l < 8; ++l) {
      uint32_t v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = sm[l * sp + slot + i * step];
      store4(y + l * plane + off, v);
    }
  } else {
#pragma unroll
    for (int l = 0; l < 8; ++l) y[l * plane + off] = sm[l * sp + slot];
  }
}

// Butterfly bf (< kTile/2) of local stage r of a tile: its group gl in the
// tile, its local index jl and its global twiddle index j; false past the
// last group.  Threads take butterflies in the order of j: the c = s-r-1
// low bits of jl fastest, then the group, then the high bits of jl, so a
// warp's twiddle reads are runs of 2^c * G consecutive words (G groups
// per tile) at every stage instead of 32 scattered words at the last.
LIGERO_HD bool pass_butterfly(const PassGeom& pg, uint32_t tile, uint32_t r,
                              uint32_t bf, uint32_t& gl, uint32_t& jl,
                              uint32_t& j) {
  const uint32_t s = pg.s, c = s - r - 1u;
  const uint32_t lg_g = (uint32_t)kLog2Tile - s, lg_r = pg.log2n - s;
  const uint32_t lo = bf & ((1u << c) - 1u), rest = bf >> c;
  gl = rest & ((1u << lg_g) - 1u);
  jl = ((rest >> lg_g) << c) | lo;
  const uint32_t gi = (tile << lg_g) + gl;
  if (gi >= (pg.B << lg_r)) return false;
  const uint32_t g = gi & ((1u << lg_r) - 1u);
  j = ((jl >> c) << (pg.log2n - r - 1u)) | (g << c) | lo;
  return true;
}

// The twiddle of butterfly bf of local stage r: tw points at stage t0's
// (8, N/2) twiddle plane, the pass's stages following at a stride of
// 8*N/2 words.  Left unread past the last group.
LIGERO_HD void pass_twiddle_at(const uint32_t* tw, const PassGeom& pg,
                               uint32_t tile, uint32_t r, uint32_t bf,
                               uint32_t w[8]) {
  uint32_t gl, jl, j;
  if (!pass_butterfly(pg, tile, r, bf, gl, jl, j)) return;
  const uint32_t h = 1u << (pg.log2n - 1u);
  const uint32_t* tws = tw + r * 8u * h;
#pragma unroll
  for (int l = 0; l < 8; ++l) w[l] = tws[l * h + j];
}

// Butterfly bf of local stage r, twiddle w: from the shared planes cur
// into nxt.
template <bool kDit>
LIGERO_HD void pass_step_at(const uint32_t* cur, uint32_t* nxt,
                            const PassGeom& pg, uint32_t tile, uint32_t r,
                            uint32_t bf, const uint32_t w[8]) {
  uint32_t gl, jl, j;
  if (!pass_butterfly(pg, tile, r, bf, gl, jl, j)) return;
  const uint32_t s = pg.s, half = 1u << (s - 1u);
  const uint32_t sp = pass_plane(s), base = gl * ((1u << s) + 1u);
  uint32_t u[8], v[8], r0[8], r1[8];
  if (kDit) {
#pragma unroll
    for (int l = 0; l < 8; ++l) {
      u[l] = cur[l * sp + base + 2u * jl];
      v[l] = cur[l * sp + base + 2u * jl + 1u];
    }
    uint32_t wv[8];
    mont_mul(v, w, wv);
    add_mod(u, wv, r0);
    sub_mod(u, wv, r1);
#pragma unroll
    for (int l = 0; l < 8; ++l) {
      nxt[l * sp + base + jl] = r0[l];
      nxt[l * sp + base + half + jl] = r1[l];
    }
  } else {
#pragma unroll
    for (int l = 0; l < 8; ++l) {
      u[l] = cur[l * sp + base + jl];
      v[l] = cur[l * sp + base + half + jl];
    }
    uint32_t d[8];
    add_mod(u, v, r0);
    sub_mod(u, v, d);
    mont_mul(d, w, r1);
#pragma unroll
    for (int l = 0; l < 8; ++l) {
      nxt[l * sp + base + 2u * jl] = r0[l];
      nxt[l * sp + base + 2u * jl + 1u] = r1[l];
    }
  }
}

// Element i of KE in modes add and sub: y is read at i / y_div.
template <int kMode>
LIGERO_HD void eltwise_at(const uint32_t* x, uint32_t x_ls,
                          const uint32_t* y, uint32_t y_ls, uint32_t y_div,
                          uint32_t* out, uint32_t n, uint32_t i) {
  uint32_t a[8], c[8], r[8];
#pragma unroll
  for (int l = 0; l < 8; ++l) a[l] = x[l * x_ls + i];
  const uint32_t yi = y_div == 1u ? i : i / y_div;
#pragma unroll
  for (int l = 0; l < 8; ++l) c[l] = y[l * y_ls + yi];
  if (kMode == kAdd)
    add_mod(a, c, r);
  else
    sub_mod(a, c, r);
#pragma unroll
  for (int l = 0; l < 8; ++l) out[l * n + i] = r[l];
}

// Element i of KE mont_scalar: x[i] * s * 2^-256 mod p by field.cuh's
// carry-chain product, the scalar's limbs `s` in registers (read once per
// thread by the caller).
LIGERO_HD void mont_scalar_at(const uint32_t* x, uint32_t x_ls,
                              const uint32_t s[8], uint32_t* out, uint32_t n,
                              uint32_t i) {
  uint32_t a[8], r[8];
#pragma unroll
  for (int l = 0; l < 8; ++l) a[l] = x[l * x_ls + i];
  mont_mul_cc(a, s, r);
#pragma unroll
  for (int l = 0; l < 8; ++l) out[l * n + i] = r[l];
}

// ---- KE mont_mul, mulmod and quad-terms: runs of one row per CTA ----------

// Threads per CTA and units per thread of these kernels, and the least
// CTAs per SM their registers are sized for; experiment_ke_runs.py
// builds other values with -D to sweep them.  128 threads of two units
// came out 2-11% faster than 256 threads of one at the check's calls.
// With the operands in L2 these kernels run at about a third of the SM's
// instruction rate, and a design staged through shared memory (one
// element per thread, 36-48 registers; in that script) came within 10%
// either way: most likely the rate of the carry chains' wide
// multiply-adds holds them (PERF.md).
#ifndef LIGERO_RUN_THREADS
#define LIGERO_RUN_THREADS 128
#endif
#ifndef LIGERO_RUN_UNITS
#define LIGERO_RUN_UNITS 2
#endif
#ifndef LIGERO_RUN_MIN_BLOCKS
#define LIGERO_RUN_MIN_BLOCKS 1
#endif
enum { kRunThreads = LIGERO_RUN_THREADS, kRunUnits = LIGERO_RUN_UNITS };

// A launch over (8, n) output planes: runs of `len` consecutive elements
// (a row; the last run may be shorter), each split over `chunks` CTAs of
// kRunThreads threads, so that no CTA, and no warp, spans two rows.  A
// thread moves units of 4 consecutive elements of each limb plane, one
// 16-byte access per plane (vec), or of 1; CTA c of a run takes the
// units c*kRunThreads + t, then every (chunks*kRunThreads)-th.
struct RunGeom {
  uint32_t n, len, chunks, vec;
};

LIGERO_HHD RunGeom run_geom(uint32_t n, uint32_t len, uint32_t vec) {
  const uint32_t per_cta = (uint32_t)kRunThreads * (uint32_t)kRunUnits *
                           (vec ? 4u : 1u);
  const RunGeom g = {n, len, (len + per_cta - 1u) / per_cta, vec};
  return g;
}

// CTAs of a launch: runs times chunks.
LIGERO_HHD uint32_t run_ctas(const RunGeom& g) {
  return (g.n + g.len - 1u) / g.len * g.chunks;
}

// Whether a mont_mul or mulmod launch over n elements moves 16-byte
// units: every plane start (x, out, a full-plane y) and every run start
// (n, a row's y_div) at a 16-byte boundary; the `aligned` flags say
// whether the pointers are.
LIGERO_HHD bool run_vec(uint32_t n, uint32_t x_ls, bool x_aligned,
                        bool out_aligned, bool row, uint32_t y_div,
                        uint32_t y_ls, bool y_aligned) {
  return n % 4u == 0 && x_ls % 4u == 0 && x_aligned && out_aligned &&
         (row ? y_div % 4u == 0 : y_ls % 4u == 0 && y_aligned);
}

// V elements (4 or 1) of the 8 limb planes at element offset i.
template <int V>
LIGERO_HD void load_planes(const uint32_t* p, uint32_t ls, uint32_t i,
                           uint32_t v[V][8]) {
#pragma unroll
  for (int l = 0; l < 8; ++l) {
    if (V == 4) {
      uint32_t w[4];
      load4(p + l * ls + i, w);
#pragma unroll
      for (int j = 0; j < V; ++j) v[j][l] = w[j];
    } else {
      v[0][l] = p[l * ls + i];
    }
  }
}

template <int V>
LIGERO_HD void store_planes(uint32_t* p, uint32_t ls, uint32_t i,
                            uint32_t v[V][8]) {
#pragma unroll
  for (int l = 0; l < 8; ++l) {
    if (V == 4) {
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < V; ++j) w[j] = v[j][l];
      store4(p + l * ls + i, w);
    } else {
      p[l * ls + i] = v[0][l];
    }
  }
}

// How the run products read y: a full plane read as x is (kYFull), or one
// element per run read once into registers (kYRow: a per-row scalar, runs
// of y_div elements).
enum { kYFull = 0, kYRow = 1 };

// Thread t of CTA `cta` of KE mont_mul (kMode kMont: x*y*2^-256 mod p),
// mulmod (kMulmod: x*y mod p) or mulmod_fma (kFma: z + x*y mod p, as the
// reference's addmod(acc, mulmod(x, y))), by field.cuh's carry-chain
// products, y read as kY says.  z (kFma only) is a full plane, read as x
// is after the product.
template <int kMode, int kY, int V>
LIGERO_HD void run_product_at(const uint32_t* x, uint32_t x_ls,
                              const uint32_t* y, uint32_t y_ls,
                              const uint32_t* z, uint32_t z_ls,
                              uint32_t* out, const RunGeom& g, uint32_t cta,
                              uint32_t t) {
  const uint32_t run = cta / g.chunks, c = cta - run * g.chunks;
  const uint32_t start = run * g.len;
  const uint32_t end = g.n - start < g.len ? g.n : start + g.len;
  constexpr bool kRow = kY == kYRow;
  uint32_t s[8];
  if (kRow) {
#pragma unroll
    for (int l = 0; l < 8; ++l) s[l] = y[l * y_ls + run];
  }
  const uint32_t step = (uint32_t)V * g.chunks * (uint32_t)kRunThreads;
  for (uint32_t i = start + (uint32_t)V * (c * kRunThreads + t); i < end;
       i += step) {
    uint32_t a[V][8], b[V][8], r[V][8];
    load_planes<V>(x, x_ls, i, a);
    if (kY == kYFull) load_planes<V>(y, y_ls, i, b);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (kMode == kMont)
        mont_mul_cc(a[j], kRow ? s : b[j], r[j]);
      else
        mulmod_cc(a[j], kRow ? s : b[j], r[j]);
    }
    if (kMode == kFma) {
      load_planes<V>(z, z_ls, i, a);
#pragma unroll
      for (int j = 0; j < V; ++j) add_mod(a[j], r[j], r[j]);
    }
    store_planes<V>(out, g.n, i, r);
  }
}

// Thread t of CTA `cta` of quad-terms.  Run r is row r of the (8, T+P,
// len) output: for r < T, sub_mod(mulmod_cc(e[x], e[y]), e[z]) with
// (x, y, z) = tri[3r..3r+2]; for r >= T, sub_mod(e[x], e[y]) with
// (x, y) = pair[2(r-T)..2(r-T)+1].  Row b of e starts at element b*len
// of its planes (limb stride e_ls); the indices are checked by the
// caller.  The branch is taken per CTA.
template <int V>
LIGERO_HD void quad_terms_at(const uint32_t* e, uint32_t e_ls,
                             const int32_t* tri, uint32_t T,
                             const int32_t* pair, uint32_t* out,
                             const RunGeom& g, uint32_t cta, uint32_t t) {
  const uint32_t row = cta / g.chunks, c = cta - row * g.chunks;
  const bool triple = row < T;
  const int32_t* ix = triple ? tri + 3u * row : pair + 2u * (row - T);
  const uint32_t* ex = e + (uint32_t)ix[0] * g.len;
  const uint32_t* ey = e + (uint32_t)ix[1] * g.len;
  const uint32_t* ez = triple ? e + (uint32_t)ix[2] * g.len : ex;
  uint32_t* o = out + row * g.len;
  const uint32_t step = (uint32_t)V * g.chunks * (uint32_t)kRunThreads;
  for (uint32_t i = (uint32_t)V * (c * kRunThreads + t); i < g.len;
       i += step) {
    uint32_t a[V][8], b[V][8], r[V][8];
    load_planes<V>(ex, e_ls, i, a);
    load_planes<V>(ey, e_ls, i, b);
    if (triple) {
      uint32_t m[V][8];
#pragma unroll
      for (int j = 0; j < V; ++j) mulmod_cc(a[j], b[j], m[j]);
      load_planes<V>(ez, e_ls, i, a);
#pragma unroll
      for (int j = 0; j < V; ++j) sub_mod(m[j], a[j], r[j]);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) sub_mod(a[j], b[j], r[j]);
    }
    store_planes<V>(o, g.n, i, r);
  }
}

// ---- KE mont_mul's tiled mode (mode 6): one element a thread ---------------
//
// Replaces _k_mont_mul's planar entry with y one row tiled over x
// (ligero_prover_tpu/ops/pallas/fieldmul.py:260): out[:, b, i] =
// x[:, b, i] * y[:, i] * 2^-256 mod p over (8, B, w) rows, by field.cuh's
// mont_mul_cc.  Its calls are the sharded encode's twist, (8, 16, k) rows
// times one (8, k) row, and the 2k mask rows, (8, 1 or 2, 2k) times
// (8, 2k).  What bounds it on this card: the twist at k = 8192 moves
// 8.65 MB, 0.0026 ms at HBM's rate, and makes 131,072 products of 144
// wide multiply-adds (IMAD.WIDE.U32(.X), SASS), which chip_smoke.py's
// probe (phase 2) measures at 20-24 per clock per SM in the carry chains:
// 3.0-3.6 us over 132 SMs at 1.98 GHz, longer than the bytes.  Each chain
// is serial, so only many warps per SM keep the multipliers busy; the mask
// row's 16,384 products are too few for that and are bound by the latency
// of one load, one product and one store.  The run geometry that mode 6
// took before gave 128 CTAs of 4 warps at the twist and 16 at the mask
// row, each thread 8 products in turn, and re-read y's row for every row
// of x.  Design: one element and one row a thread, y's element read once
// into registers, and a grid of as many warps as the call has elements
// over 32; tiled_geom sizes the CTA so that every SM holds at least one.
//
// Chosen by measurement (experiment_ke_runs.py --tiled: L2-cold, NVIDIA
// H100 80GB HBM3 at 700 W; each the best over 32-256 threads a CTA).
// Twist: 0.0068 ms on tiled_geom's grid (512 CTAs of 256, 31 warps per
// SM), against 0.0094 on the run geometry; 4 elements a thread in 16-byte
// units 0.0076, y's element kept in registers over 2 rows a thread 0.0073
// and over 4 rows 0.0086; the operands in L2 take 0.0052, within 5% of
// the 2.0 us launch floor plus the multiply-adds' 3.0 us.  Mask row
// (8, 1, 16384): 0.0038 (256 CTAs of 64) against 0.0076; 4 elements a
// thread 0.0050.  More elements or rows a thread put its products behind
// one another and leave fewer warps to hide the chains, which costs more
// than the y re-reads they save (those variants are in the experiment's
// source only).

// H100 SXM's SMs and the most threads a CTA of the tiled mode.
enum { kSms = 132, kTiledMaxThreads = 256 };

// A launch over B rows of w elements: `threads` a CTA, `slices` CTAs
// across a row; CTA c takes column slice c mod slices of row c / slices.
struct TiledGeom {
  uint32_t B, w, threads, slices;
};

// The grid rule: the most threads a CTA (256 down to 32) that still give
// every SM a CTA, as K1 and K2 size their blocks (mulmod_threads).
LIGERO_HHD TiledGeom tiled_geom(uint32_t B, uint32_t w) {
  TiledGeom g = {B, w, kTiledMaxThreads, 0u};
  while (g.threads > 32u && (w + g.threads - 1u) / g.threads * B < kSms)
    g.threads >>= 1;
  g.slices = (w + g.threads - 1u) / g.threads;
  return g;
}

LIGERO_HHD uint32_t tiled_ctas(const TiledGeom& g) { return g.slices * g.B; }

// Thread t of CTA `cta`: its row and column i; false past the row's end.
LIGERO_HD bool tiled_span(const TiledGeom& g, uint32_t cta, uint32_t t,
                          uint32_t& row, uint32_t& i) {
  row = cta / g.slices;
  i = (cta - row * g.slices) * g.threads + t;
  return i < g.w;
}

// Thread t of CTA `cta` of the tiled mode: x's rows at limb stride x_ls,
// y's one row at limb stride y_ls, out (8, B*w) contiguous.
LIGERO_HD void tiled_at(const uint32_t* x, uint32_t x_ls, const uint32_t* y,
                        uint32_t y_ls, uint32_t* out, const TiledGeom& g,
                        uint32_t cta, uint32_t t) {
  uint32_t row, i;
  if (!tiled_span(g, cta, t, row, i)) return;
  uint32_t a[1][8], b[1][8], r[1][8];
  load_planes<1>(y, y_ls, i, b);
  load_planes<1>(x, x_ls, row * g.w + i, a);
  mont_mul_cc(a[0], b[0], r[0]);
  store_planes<1>(out, g.B * g.w, row * g.w + i, r);
}


// ---- KQ: the quadratic test's accumulation in one launch -------------------
//
// Replaces _k_mulmod's planar entry (ligero_prover_tpu/ops/pallas/
// fieldmul.py:264) together with all that the check wraps around it for
// the quadratic test (ligero_prover_tpu/zkp/executor.py:230-250).  For
// each column j of the encoded batch e (8, B, n), with N = T + P terms:
//   term_t = sub_mod(mulmod_cc(e[x_t], e[y_t]), e[z_t])    t <  T (triples)
//   term_t = sub_mod(e[x_t], e[y_t])                        t >= T (pairs)
//   p_t    = mont_mul_cc(term_t, s_t),  s_t = mont_mul_cc(r_t, R^2 mod p)
//   out[j] = add_mod(acc[j], tree_fold(p_0, ..., p_{N-1}))
// where tree_fold is _tree_sum_mod_planar's association (zkp/executor.py):
// fold rows i and i + h of the b rows left, and when b is odd carry the
// first row (the head) to the next level.  acc and out are (n, 8) AoS, as
// the contexts hold them.  This is the reference's composition on every
// input, non-canonical limbs included; a reordered sum, or algebra equal
// only on canonical values, is another function there.  Before KQ the
// check made 13 device ops here (quad-terms; the scalars' cat, transpose
// and prescale; a second product pass; five addmod folds; the transposes
// and the addmod around acc), and the (8, T+P, n) terms and products each
// travelled through device memory.
//
// What bounds it on this card: at the check's call (8, 16, 32768), T = P =
// 16, the products are 344 M wide multiply-adds (a triple: a mulmod and a
// mont_mul, 492; a pair: a mont_mul, 164), 0.021 ms at chip_smoke.bound's
// 64 per clock per SM but 0.055-0.066 ms at the 20-24 that the carry
// chains reach (chip_smoke phase 2); its bytes (e read once, acc read and
// out written) take 0.0056 ms.  So it runs at the pace of its products,
// and the design keeps all else off their path: terms and products stay
// in shared memory.  A CTA of C columns x R row-lanes (blockDim (C, R);
// a warp reads 32 consecutive columns of a row, 128 bytes a limb plane):
//   1. threads 0..N-1 prescale the scalars into shared memory; thread
//      (c, r) computes the terms t = r, r + R, ... of its column, from the
//      rows of e read by index (in place; e fits the 50 MB L2), into
//      shared memory (field.cuh's store_prod layout);
//   2. after a barrier, it multiplies the same terms by their s_t;
//   3. the tree's levels, each level's folds spread over the R lanes, a
//      barrier after each (ceil(log2 N) levels);
//   4. lane 0 adds the column's sum to acc and stores it.
// The shared memory, 32 (N + N*C) bytes, takes the dynamic opt-in above
// 48 KB (a geometry of 32 columns at N = 64 would).
//
// The geometry, chosen by measurement (experiment_kq.py, three rounds in
// turns, L2-cold, NVIDIA H100 80GB HBM3 at 700 W; every (C, R) of C in
// 2..32 and R in 1..32 up to 512 threads): at the single-device call
// 16 x 8 took 0.0540 ms, 32 x 4 0.0551, 8 x 16 0.0562, 32 x 16 0.0579;
// at a shard's (8, 16, 8192) 8 x 16 0.0179, 32 x 16 0.0181, 16 x 8
// 0.0188.  KQ runs at 62 registers, so an SM holds 8 CTAs of 128 threads
// (32 warps): the fast geometries are 128-thread CTAs with enough of them
// to give every SM 7 or more; wider CTAs repeat the prescale for fewer
// columns, so the widest C that still does.  Rounds agreed to 0.0002 ms.

enum {
  kQuadCols = 16,           // columns a CTA, at most
  kQuadThreads = 128,       // threads a CTA, C x R, where T + P allows
  kQuadMinCtas = 7 * kSms,  // CTAs a launch, where the columns allow
  kQuadMaxThreads = 512,    // the kernel's bound (the sweep's largest)
  kQuadSmem = 100 * 1024,   // shared bytes a CTA, at most
  kQuadMaxTerms = 1024      // T + P, at most
};

// A launch over n columns with T triples and P pairs (N = T + P >= 1):
// `cols` columns x `lanes` row-lanes a CTA, CTA k taking columns k*cols..
struct QuadGeom {
  uint32_t n, T, P, cols, lanes;
};

// Shared bytes of a CTA: the N terms of each of its columns, then the N
// prescaled scalars.
LIGERO_HHD uint32_t quad_smem(const QuadGeom& g) {
  return 32u * (g.T + g.P) * (g.cols + 1u);
}

// The grid rule: the widest C of 16, 8, .., 1 that still gives the card
// kQuadMinCtas CTAs and whose terms fit kQuadSmem; R = 128 / C lanes, at
// most N.
LIGERO_HHD QuadGeom quad_geom(uint32_t n, uint32_t T, uint32_t P) {
  const uint32_t N = T + P;
  QuadGeom g = {n, T, P, kQuadCols, 0u};
  while (g.cols > 1u && ((n + g.cols - 1u) / g.cols < kQuadMinCtas ||
                         quad_smem(g) > kQuadSmem))
    g.cols >>= 1;
  g.lanes = kQuadThreads / g.cols < N ? kQuadThreads / g.cols : N;
  return g;
}

// Whether ligero_planar_quad_acc takes a call: B rows of n columns at
// limb stride e_ls (every plane offset below 2^32, 32-bit index math),
// (n, 8) accumulators (8n below 2^32) and 1 <= T + P <= kQuadMaxTerms.
LIGERO_HHD bool quad_acc_ok(long long e_ls, long long B, long long n,
                            long long T, long long P) {
  return B >= 1 && n >= 0 && T >= 0 && P >= 0 && T + P >= 1 &&
         T + P <= kQuadMaxTerms && e_ls >= B * n &&
         7 * e_ls + B * n < (1ll << 32) && 8 * n < (1ll << 32);
}

LIGERO_HHD uint32_t quad_ctas(const QuadGeom& g) {
  return (g.n + g.cols - 1u) / g.cols;
}

// Words of each half of the terms' buffer (store_prod's `half`); the
// scalars follow the second half.
LIGERO_HD uint32_t quad_half(const QuadGeom& g) {
  return 4u * (g.T + g.P) * g.cols;
}

// Phase 1, thread `tid` (r*C + c) of a CTA: the prescaled scalars s_t =
// r_t * R^2 * 2^-256 mod p (KE mont_scalar's product, x = r_t) for t =
// tid, tid + C*R, ... into shared memory.  args: the 3T + 2P row indices,
// then the (T+P, 8) scalars r_t.
LIGERO_HD void quad_scale_at(const int32_t* args, const QuadGeom& g,
                             uint32_t tid, uint32_t* sm) {
  const uint32_t* rs = (const uint32_t*)(args + 3u * g.T + 2u * g.P);
  uint32_t* sc = sm + 2u * quad_half(g);
  uint32_t r2[8];
#pragma unroll
  for (int l = 0; l < 8; ++l) r2[l] = kR2[l];
  for (uint32_t t = tid; t < g.T + g.P; t += g.cols * g.lanes) {
    uint32_t a[8], s[8];
#pragma unroll
    for (int l = 0; l < 8; ++l) a[l] = rs[8u * t + l];
    mont_mul_cc(a, r2, s);
#pragma unroll
    for (int l = 0; l < 8; ++l) sc[8u * t + l] = s[l];
  }
}

// Phase 1, thread (c, r) of CTA `cta`: the terms t = r, r + R, ... of its
// column into shared memory.  Row b of e starts at element b*n of its
// planes (limb stride e_ls); args holds the T (x, y, z) and then the P
// (x, y), each checked by the caller.
LIGERO_HD void quad_acc_terms_at(const uint32_t* e, uint32_t e_ls,
                                 const int32_t* args, const QuadGeom& g,
                                 uint32_t cta, uint32_t c, uint32_t r,
                                 uint32_t* sm) {
  const uint32_t col = cta * g.cols + c;
  if (col >= g.n) return;
  const uint32_t half = quad_half(g);
  for (uint32_t t = r; t < g.T + g.P; t += g.lanes) {
    const bool triple = t < g.T;
    const int32_t* ix =
        triple ? args + 3u * t : args + 3u * g.T + 2u * (t - g.T);
    uint32_t a[1][8], b[1][8], v[8];
    load_planes<1>(e + (uint32_t)ix[0] * g.n, e_ls, col, a);
    load_planes<1>(e + (uint32_t)ix[1] * g.n, e_ls, col, b);
    if (triple) {
      uint32_t m[8];
      mulmod_cc(a[0], b[0], m);
      load_planes<1>(e + (uint32_t)ix[2] * g.n, e_ls, col, a);
      sub_mod(m, a[0], v);
    } else {
      sub_mod(a[0], b[0], v);
    }
    store_prod(sm, half, t * g.cols + c, v);
  }
}

// Phase 2, thread (c, r): its terms times their prescaled scalars, in
// place (KE mont_mul's product, x = the term).
LIGERO_HD void quad_acc_products_at(const QuadGeom& g, uint32_t cta,
                                    uint32_t c, uint32_t r, uint32_t* sm) {
  if (cta * g.cols + c >= g.n) return;
  const uint32_t half = quad_half(g);
  const uint32_t* sc = sm + 2u * half;
  for (uint32_t t = r; t < g.T + g.P; t += g.lanes) {
    uint32_t v[8], s[8], p[8];
    load_prod(sm, half, t * g.cols + c, v);
#pragma unroll
    for (int l = 0; l < 8; ++l) s[l] = sc[8u * t + l];
    mont_mul_cc(v, s, p);
    store_prod(sm, half, t * g.cols + c, p);
  }
}

// Phase 3, one level of the tree over the b >= 2 sums left in slots
// 0..b-1 of a column: slot off + i becomes slot off + i plus slot
// off + h + i (add_mod in that order) for i < h = b/2, with off = 1 when b
// is odd (slot 0, the head, is carried); lane r takes i = r, r + R, ....
// The (b + 1)/2 sums left are then slots 0.. .  No slot that one thread
// writes is read by another in the same level.
LIGERO_HD void quad_acc_fold_at(const QuadGeom& g, uint32_t b, uint32_t cta,
                                uint32_t c, uint32_t r, uint32_t* sm) {
  if (cta * g.cols + c >= g.n) return;
  const uint32_t off = b & 1u, h = b >> 1, half = quad_half(g);
  for (uint32_t i = r; i < h; i += g.lanes) {
    uint32_t x[8], y[8], s[8];
    load_prod(sm, half, (off + i) * g.cols + c, x);
    load_prod(sm, half, (off + h + i) * g.cols + c, y);
    add_mod(x, y, s);
    store_prod(sm, half, (off + i) * g.cols + c, s);
  }
}

// Phase 4, lane 0 of column c: out = acc + the column's sum (slot 0),
// (n, 8) AoS; acc is read before out is written, so out may be acc.
LIGERO_HD void quad_acc_store_at(const uint32_t* acc, uint32_t* out,
                                 const QuadGeom& g, uint32_t cta, uint32_t c,
                                 uint32_t r, const uint32_t* sm) {
  const uint32_t col = cta * g.cols + c;
  if (r != 0u || col >= g.n) return;
  uint32_t a[8], s[8], o[8];
  load4(acc + 8u * col, a);
  load4(acc + 8u * col + 4u, a + 4);
  load_prod(sm, quad_half(g), c, s);
  add_mod(a, s, o);
  store4(out + 8u * col, o);
  store4(out + 8u * col + 4u, o + 4);
}

}  // namespace ligero_pl

#ifdef __CUDACC__

namespace ligero_pl {

// One tile per CTA: load, s stages with a barrier after each, store.
template <bool kDit>
__global__ void __launch_bounds__(kPassThreads)
pass_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ tw,
            uint32_t* __restrict__ y, PassGeom pg) {
  extern __shared__ uint32_t sm[];
  uint32_t* cur = sm;
  uint32_t* nxt = sm + 8u * pass_plane(pg.s);
  const uint32_t tile = blockIdx.x, units = pg.vec ? kTile / 4 : kTile;
  for (uint32_t u = threadIdx.x; u < units; u += kPassThreads)
    pass_load_at<kDit>(x, cur, pg, tile, u);
  // each stage's twiddle is read before the barrier that ends the stage
  // before it, so its L2 latency overlaps the wait
  uint32_t w[8];
  pass_twiddle_at(tw, pg, tile, kDit ? 0u : pg.s - 1u, threadIdx.x, w);
  __syncthreads();
  for (uint32_t i = 0; i < pg.s; ++i) {
    const uint32_t r = kDit ? i : pg.s - 1u - i;
    pass_step_at<kDit>(cur, nxt, pg, tile, r, threadIdx.x, w);
    if (i + 1u < pg.s)
      pass_twiddle_at(tw, pg, tile, kDit ? r + 1u : r - 1u, threadIdx.x, w);
    __syncthreads();
    uint32_t* t = cur;
    cur = nxt;
    nxt = t;
  }
  for (uint32_t u = threadIdx.x; u < units; u += kPassThreads)
    pass_store_at<kDit>(cur, y, pg, tile, u);
}

template <int kMode>
__global__ void __launch_bounds__(256)
eltwise_kernel(const uint32_t* __restrict__ x, uint32_t x_ls,
               const uint32_t* __restrict__ y, uint32_t y_ls, uint32_t y_div,
               uint32_t* __restrict__ out, uint32_t n) {
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    eltwise_at<kMode>(x, x_ls, y, y_ls, y_div, out, n, i);
}

// KE mont_scalar: the scalar (limbs at stride s_ls) read once per thread.
__global__ void __launch_bounds__(256)
mont_scalar_kernel(const uint32_t* __restrict__ x, uint32_t x_ls,
                   const uint32_t* __restrict__ sc, uint32_t s_ls,
                   uint32_t* __restrict__ out, uint32_t n) {
  uint32_t s[8];
#pragma unroll
  for (int l = 0; l < 8; ++l) s[l] = sc[l * s_ls];
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    mont_scalar_at(x, x_ls, s, out, n, i);
}

template <int kMode, int kY, bool kVec>
__global__ void __launch_bounds__(kRunThreads, LIGERO_RUN_MIN_BLOCKS)
run_product_kernel(const uint32_t* __restrict__ x, uint32_t x_ls,
                   const uint32_t* __restrict__ y, uint32_t y_ls,
                   const uint32_t* __restrict__ z, uint32_t z_ls,
                   uint32_t* __restrict__ out, RunGeom g) {
  run_product_at<kMode, kY, kVec ? 4 : 1>(x, x_ls, y, y_ls, z, z_ls, out, g,
                                          blockIdx.x, threadIdx.x);
}

template <bool kVec>
__global__ void __launch_bounds__(kRunThreads, LIGERO_RUN_MIN_BLOCKS)
quad_terms_kernel(const uint32_t* __restrict__ e, uint32_t e_ls,
                  const int32_t* __restrict__ tri, uint32_t T,
                  const int32_t* __restrict__ pair,
                  uint32_t* __restrict__ out, RunGeom g) {
  quad_terms_at<kVec ? 4 : 1>(e, e_ls, tri, T, pair, out, g, blockIdx.x,
                              threadIdx.x);
}

// The tiled mode; registers capped at 64 (4 CTAs of kTiledMaxThreads an
// SM), so that the twist's 31 warps per SM fit beside each other.
__global__ void __launch_bounds__(kTiledMaxThreads, 4)
tiled_kernel(const uint32_t* __restrict__ x, uint32_t x_ls,
             const uint32_t* __restrict__ y, uint32_t y_ls,
             uint32_t* __restrict__ out, TiledGeom g) {
  tiled_at(x, x_ls, y, y_ls, out, g, blockIdx.x, threadIdx.x);
}

// KQ: the phases of quad_acc_*_at with a barrier between them; registers
// capped at 64 (two CTAs of the sweep's 512 threads, or eight of
// quad_geom's 128, fit an SM).  No __restrict__ on acc and out: out may be
// acc.
__global__ void __launch_bounds__(kQuadMaxThreads, 2)
quad_acc_kernel(const uint32_t* __restrict__ e, uint32_t e_ls,
                const int32_t* __restrict__ args, const uint32_t* acc,
                uint32_t* out, QuadGeom g) {
  extern __shared__ uint4 quad_buf[];
  uint32_t* sm = (uint32_t*)quad_buf;
  const uint32_t c = threadIdx.x, r = threadIdx.y, cta = blockIdx.x;
  quad_scale_at(args, g, r * g.cols + c, sm);
  quad_acc_terms_at(e, e_ls, args, g, cta, c, r, sm);
  __syncthreads();
  quad_acc_products_at(g, cta, c, r, sm);
  __syncthreads();
  for (uint32_t b = g.T + g.P; b > 1u; b = (b + 1u) >> 1) {
    quad_acc_fold_at(g, b, cta, c, r, sm);
    __syncthreads();
  }
  quad_acc_store_at(acc, out, g, cta, c, r, sm);
}

inline bool aligned16(const void* p) {
  return (unsigned long long)p % 16 == 0;
}

// Launches KQ with geometry g (quad_geom's, or a sweep's), the shared
// memory's opt-in set first where it passes 48 KB (the attribute belongs
// to the current device).
inline int launch_quad_acc(const uint32_t* e, uint32_t e_ls,
                           const int32_t* args, const uint32_t* acc,
                           uint32_t* out, const QuadGeom& g,
                           cudaStream_t s) {
  const uint32_t smem = quad_smem(g);
  if (smem > 48u * 1024u) {
    const cudaError_t rc = cudaFuncSetAttribute(
        quad_acc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  const dim3 block(g.cols, g.lanes);
  quad_acc_kernel<<<quad_ctas(g), block, smem, s>>>(e, e_ls, args, acc, out,
                                                   g);
  return (int)cudaGetLastError();
}

// KE mont_mul's tiled mode over n = B*w elements, y one row of w
// elements, on tiled_geom's grid.
inline void launch_tiled(const uint32_t* x, uint32_t x_ls, const uint32_t* y,
                         uint32_t y_ls, uint32_t w, uint32_t* out,
                         uint32_t n, cudaStream_t s) {
  const TiledGeom g = tiled_geom(n / w, w);
  tiled_kernel<<<tiled_ctas(g), g.threads, 0, s>>>(x, x_ls, y, y_ls, out, g);
}

template <int kMode, int kY>
void launch_runs(const uint32_t* x, uint32_t x_ls, const uint32_t* y,
                 uint32_t y_ls, uint32_t* out, const RunGeom& g,
                 cudaStream_t s) {
  const unsigned grid = run_ctas(g);
  if (g.vec)
    run_product_kernel<kMode, kY, true><<<grid, kRunThreads, 0, s>>>(
        x, x_ls, y, y_ls, nullptr, 0u, out, g);
  else
    run_product_kernel<kMode, kY, false><<<grid, kRunThreads, 0, s>>>(
        x, x_ls, y, y_ls, nullptr, 0u, out, g);
}

// KE mont_mul or mulmod (kMode) over n elements: y one element per run
// of y_div > 1 elements (read once per thread), or a full plane.  16-byte
// accesses where run_vec allows them.
template <int kMode>
void launch_product(const uint32_t* x, uint32_t x_ls, const uint32_t* y,
                    uint32_t y_ls, uint32_t y_div, uint32_t* out, uint32_t n,
                    cudaStream_t s) {
  const bool row = y_div > 1u;
  const bool vec = run_vec(n, x_ls, aligned16(x), aligned16(out), row,
                           y_div, y_ls, aligned16(y));
  const RunGeom g = run_geom(n, row ? y_div : n, vec);
  if (row)
    launch_runs<kMode, kYRow>(x, x_ls, y, y_ls, out, g, s);
  else
    launch_runs<kMode, kYFull>(x, x_ls, y, y_ls, out, g, s);
}

// KE mulmod_fma (z + x*y) over n elements on the same geometry, y as in
// launch_product, z a full plane, in single elements: in 16-byte units
// its thread takes 136 registers (3 CTAs of 128 on an SM, so the 512 CTAs
// of its (8, 16, 32768) call run in 1.3 waves), and capped at 128
// registers it ran 0-6% slower than in single elements
// (experiment_digitize_fma.py).
inline void launch_fma(const uint32_t* x, uint32_t x_ls, const uint32_t* y,
                       uint32_t y_ls, uint32_t y_div, const uint32_t* z,
                       uint32_t z_ls, uint32_t* out, uint32_t n,
                       cudaStream_t s) {
  const bool row = y_div > 1u;
  const RunGeom g = run_geom(n, row ? y_div : n, false);
  const unsigned grid = run_ctas(g);
  if (row)
    run_product_kernel<kFma, kYRow, false><<<grid, kRunThreads, 0, s>>>(
        x, x_ls, y, y_ls, z, z_ls, out, g);
  else
    run_product_kernel<kFma, kYFull, false><<<grid, kRunThreads, 0, s>>>(
        x, x_ls, y, y_ls, z, z_ls, out, g);
}

inline unsigned grid_for(unsigned long long work) {
  unsigned long long blocks = (work + 255) / 256;
  return (unsigned)(blocks > 1048576ull ? 1048576ull : blocks);
}

}  // namespace ligero_pl

// One pass of KB: s constant-geometry stages.  x: (8, B, in_n) for DIT
// (in_n a power of two in [2, N]), (8, B, N) for DIF; tw: the (8, N/2)
// twiddle plane of stage t0, the planes of stages t0+1..t0+s-1 following
// it contiguously; y: (8, B, N), not aliasing x.  N = 2^log2n; 1 <= s <=
// min(log2n, 8); a DIT pass runs stages t0..t0+s-1, a DIF pass stages
// t0+s-1 down to t0.  Contiguous, 4-byte aligned; 8*B*N < 2^32.
// Returns cudaGetLastError().
extern "C" int ligero_planar_pass(const void* x, const void* tw, void* y,
                                  int B, int log2n, int in_n, int s, int dit,
                                  void* stream) {
  if (B < 0 || log2n < 1 || log2n > 24 || s < 1 || s > log2n ||
      s > ligero_pl::kMaxPass)
    return (int)cudaErrorInvalidValue;
  const unsigned long long n = 1ull << log2n;
  if (8ull * (unsigned long long)B * n >= (1ull << 32))
    return (int)cudaErrorInvalidValue;
  if (!dit) in_n = (int)n;
  if (in_n < 2 || (in_n & (in_n - 1)) != 0 || (unsigned long long)in_n > n)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const bool aligned =
      ((unsigned long long)x % 16 == 0) && ((unsigned long long)y % 16 == 0);
  const ligero_pl::PassGeom pg = {
      (uint32_t)B, (uint32_t)log2n, (uint32_t)s, (uint32_t)in_n,
      aligned ? ligero_pl::pass_vec(log2n, s, in_n) : 0u};
  const unsigned tiles =
      (unsigned)(((unsigned long long)B * n + ligero_pl::kTile - 1) /
                 ligero_pl::kTile);
  const size_t smem = 2 * 8 * sizeof(uint32_t) * ligero_pl::pass_plane(s);
  cudaStream_t st = (cudaStream_t)stream;
  const uint32_t* xp = (const uint32_t*)x;
  const uint32_t* tp = (const uint32_t*)tw;
  uint32_t* yp = (uint32_t*)y;
  if (dit)
    ligero_pl::pass_kernel<true><<<tiles, ligero_pl::kPassThreads, smem, st>>>(
        xp, tp, yp, pg);
  else
    ligero_pl::pass_kernel<false><<<tiles, ligero_pl::kPassThreads, smem,
                                    st>>>(xp, tp, yp, pg);
  return (int)cudaGetLastError();
}

// Element-wise planar op (KE).  x: 8 planes of n words at limb stride
// x_ls; y: planes at limb stride y_ls, element i reading y[i / y_div]
// (mode 4 reads element 0 only; mode 6 reads y[i mod y_div], y_ls >=
// y_div, n a multiple of y_div); z: mode 5's addend, planes of n words
// at limb stride z_ls (ignored, may be null, in the other modes); out:
// (8, n) contiguous, not
// aliasing x, y or z.  mode 0 addmod, 1 submod, 2 mont_mul, 3 mulmod, 4
// mont_scalar, 5 mulmod_fma (z + x*y), 6 mont_mul with y tiled.
// Every plane offset must stay below 2^32.  Returns cudaGetLastError().
extern "C" int ligero_planar_eltwise(const void* x, long long x_ls,
                                     const void* y, long long y_ls,
                                     long long y_div, const void* z,
                                     long long z_ls, void* out, long long n,
                                     int mode, void* stream) {
  const bool tiled = mode == ligero_pl::kTiled;
  if (n < 0 || x_ls < n || y_ls < 0 || y_div < 1 || mode < 0 || mode > 6 ||
      7 * x_ls + n >= (1ll << 32) || 8 * n >= (1ll << 32) ||
      7 * y_ls + (tiled ? y_div : (n + y_div - 1) / y_div) >= (1ll << 32) ||
      (tiled && (y_ls < y_div || n % y_div != 0)))
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
          xp, xl, yp, yl, yd, op, nn);
      break;
    case ligero_pl::kSub:
      ligero_pl::eltwise_kernel<ligero_pl::kSub><<<grid, 256, 0, s>>>(
          xp, xl, yp, yl, yd, op, nn);
      break;
    case ligero_pl::kMont:
      ligero_pl::launch_product<ligero_pl::kMont>(xp, xl, yp, yl, yd, op,
                                                  nn, s);
      break;
    case ligero_pl::kTiled:
      ligero_pl::launch_tiled(xp, xl, yp, yl, yd, op, nn, s);
      break;
    case ligero_pl::kMulmod:
      ligero_pl::launch_product<ligero_pl::kMulmod>(xp, xl, yp, yl, yd,
                                                    op, nn, s);
      break;
    case ligero_pl::kFma:
      ligero_pl::launch_fma(xp, xl, yp, yl, yd, zp, zl, op, nn, s);
      break;
    default:
      ligero_pl::mont_scalar_kernel<<<grid, 256, 0, s>>>(xp, xl, yp, yl, op,
                                                         nn);
      break;
  }
  return (int)cudaGetLastError();
}

// Quad-terms (the quadratic test's terms, KE mulmod redesigned around
// the check's call): e (8, B, n) limb planes at limb stride e_ls >= B*n;
// tri (T, 3) and pair (P, 2) int32 row indices of e, each in [0, B)
// (checked by the caller; tri may be null when T = 0, pair when P = 0);
// out (8, T+P, n) contiguous, not aliasing e:
//   out[:, t]     = sub_mod(mulmod(e[:, x_t], e[:, y_t]), e[:, z_t]),
//   out[:, T + p] = sub_mod(e[:, x_p], e[:, y_p]).
// Every plane offset must stay below 2^32.  Returns cudaGetLastError().
extern "C" int ligero_planar_quad_terms(const void* e, long long e_ls,
                                        long long B, long long n,
                                        const void* tri, long long T,
                                        const void* pair, long long P,
                                        void* out, void* stream) {
  if (B < 0 || n < 0 || T < 0 || P < 0 || e_ls < B * n ||
      7 * e_ls + B * n >= (1ll << 32) || 8 * (T + P) * n >= (1ll << 32) ||
      (T + P > 0 && B == 0) || (T > 0 && tri == nullptr) ||
      (P > 0 && pair == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((T + P) * n == 0) return 0;
  const uint32_t nn = (uint32_t)n, el = (uint32_t)e_ls;
  const bool vec = nn % 4u == 0 && el % 4u == 0 &&
                   ligero_pl::aligned16(e) && ligero_pl::aligned16(out);
  const ligero_pl::RunGeom g =
      ligero_pl::run_geom((uint32_t)(T + P) * nn, nn, vec);
  const unsigned grid = ligero_pl::run_ctas(g);
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* ep = (const uint32_t*)e;
  const int32_t* tp = (const int32_t*)tri;
  const int32_t* pp = (const int32_t*)pair;
  uint32_t* op = (uint32_t*)out;
  if (vec)
    ligero_pl::quad_terms_kernel<true>
        <<<grid, ligero_pl::kRunThreads, 0, s>>>(ep, el, tp, (uint32_t)T, pp,
                                                 op, g);
  else
    ligero_pl::quad_terms_kernel<false>
        <<<grid, ligero_pl::kRunThreads, 0, s>>>(ep, el, tp, (uint32_t)T, pp,
                                                 op, g);
  return (int)cudaGetLastError();
}


// KQ (the quadratic test's accumulation, above): e (8, B, n) limb planes
// at limb stride e_ls >= B*n; args: T (x, y, z) then P (x, y) int32 row
// indices of e, each in [0, B) (checked by the caller), then the (T+P, 8)
// scalars r_t, triples first; acc and out (n, 8) AoS, 16-byte aligned, out
// either acc or apart from it and from e:
//   out[j] = acc[j] + tree_fold_t(term_t[j] * s_t * 2^-256),
//   s_t = r_t * R^2 * 2^-256.
// 1 <= T + P <= 1024; every plane offset must stay below 2^32.  Returns
// cudaGetLastError() (or the shared-memory opt-in's error).
extern "C" int ligero_planar_quad_acc(const void* e, long long e_ls,
                                      long long B, long long n,
                                      const void* args, long long T,
                                      long long P, const void* acc,
                                      void* out, void* stream) {
  if (!ligero_pl::quad_acc_ok(e_ls, B, n, T, P) || e == nullptr ||
      args == nullptr || acc == nullptr || out == nullptr ||
      !ligero_pl::aligned16(acc) || !ligero_pl::aligned16(out))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  return ligero_pl::launch_quad_acc(
      (const uint32_t*)e, (uint32_t)e_ls, (const int32_t*)args,
      (const uint32_t*)acc, (uint32_t*)out,
      ligero_pl::quad_geom((uint32_t)n, (uint32_t)T, (uint32_t)P),
      (cudaStream_t)stream);
}

#endif  // __CUDACC__
