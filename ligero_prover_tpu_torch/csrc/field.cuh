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
//
// mont_mul_cc / mulmod_cc (at the end of the file) compute the same
// results as mont_mul / mulmod with PTX carry chains instead of 64-bit
// C++ accumulation; K2, KE mont_scalar, KE mont_mul and mulmod and
// quad-terms use them.

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define LIGERO_HD __device__ __forceinline__
#define LIGERO_CONST static __constant__
#else
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
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

// ---- the carry-chain Montgomery product ------------------------------------
//
// mont_mul_cc(x, y) equals mont_mul(x, y) on every input (x, y < 2^256):
// word-by-word Montgomery (CIOS).  Row i adds x[i]*y to the accumulator t,
// takes m_i = t[0]*J0 mod 2^32 (J0 = -p^-1 mod 2^32), adds m_i*p and
// shifts t down one word.  m = sum m_i 2^(32i) is the reference's
// U_lo*J mod 2^256 (the one m < 2^256 with U + m*p = 0 mod 2^256), so
// after 8 rows t = (U + m*p) / 2^256 exactly, which is the reference's
// U_hi + (m*p)_hi + [U_lo != 0] before its mod 2^256.  Like the reference
// this keeps t mod 2^256, dropping the carry out of limb 7 (t reaches
// 2^256 for some operands in [p, 2^256)), and subtracts p once if t >= p.
// Between rows t < 2^256 + p, and inside a row below 2^288 + 2^286: nine
// words and one bit, all kept.
//
// The accumulator is two arrays, so that the low and high words of each
// 32x32 product land on a pair of words that no other product of the row
// touches, and one carry chain of mad.lo.cc/madc.hi.cc pairs adds a whole
// row; ptxas issues each pair as one IMAD.WIDE.U32.X (64-bit multiply-add
// with carry in and out), about 230 SASS instructions per product against
// ~740 for mont_mul (PERF.md):
//   e[0..8] at word positions 0..8: the products of even limbs y[j]
//           (words j, j+1) and of even p limbs;
//   o[0..8] at word positions 1..9: the products of odd limbs.
// The shift moves o to e (positions 1..9 become 0..8) and e to o (2..8
// become 1..7); e's word at position 1 becomes `f` at position 0, added
// into e[0] at the head of the next row's odd chain, whose carry goes on
// into position 1.  Every carry chain ends in a register (the top word
// o[8], at position 9, never overflows: the sum is below 2^289), so each
// chain is one asm statement and no carry flag lives from one asm
// statement to the next.
//
// Outside nvcc the same PTX text runs through cc_run, an interpreter of
// the instructions used here with an explicit carry flag, which starts
// undefined in every asm statement; so the g++ harness
// (tests/test_torch_mont_core.py) runs the schedule and the PTX of the
// card.

#define LIGERO_CC_LIST(...) __VA_ARGS__
#ifdef __CUDACC__
#define LIGERO_W(v) "+r"(v)
#define LIGERO_O(v) "=r"(v)
#define LIGERO_R(v) "r"(v)
#define LIGERO_CC(text, outs, ins) \
  asm volatile(text : LIGERO_CC_LIST outs : LIGERO_CC_LIST ins)
#else
#define LIGERO_W(v) &(v)
#define LIGERO_O(v) &(v)
#define LIGERO_R(v) const_cast<uint32_t*>(&(v))
#define LIGERO_CC(text, outs, ins)                                      \
  do {                                                                  \
    uint32_t* const cc_outs_[] = {LIGERO_CC_LIST outs};                 \
    uint32_t* const cc_ops_[] = {LIGERO_CC_LIST outs, LIGERO_CC_LIST ins}; \
    cc_run(text, cc_ops_, (int)(sizeof cc_outs_ / sizeof cc_outs_[0]),  \
           (int)(sizeof cc_ops_ / sizeof cc_ops_[0]));                  \
  } while (0)

[[noreturn]] static void cc_fail(const char* what, const char* at) {
  fprintf(stderr, "cc_run: %s at \"%.40s\"\n", what, at);
  abort();
}

// Runs the PTX `text`: add/sub/mad with .lo/.hi, a `c` for carry in and
// .cc for carry out, on .u32; operands %N (ops[N], the first n_outs
// writable) or integer literals.  Reading the carry before an instruction
// of this statement set it fails, as does writing an input.
static void cc_run(const char* text, uint32_t* const* ops, int n_outs,
                   int n_ops) {
  int cf = -1;
  const char* s = text;
  for (;;) {
    while (*s == ' ' || *s == '\n' || *s == '\t') ++s;
    if (*s == 0) return;
    const char* op = s;
    while (*s && *s != ' ' && *s != '\t') ++s;
    const size_t len = (size_t)(s - op);
    char name[32];
    if (len >= sizeof name) cc_fail("opcode too long", op);
    memcpy(name, op, len);
    name[len] = 0;
    const bool add = !strncmp(name, "add", 3), sub = !strncmp(name, "sub", 3),
               mad = !strncmp(name, "mad", 3);
    if (!(add || sub || mad) || len < 8 || strcmp(name + len - 4, ".u32"))
      cc_fail("unknown instruction", op);
    const bool cin = name[3] == 'c', cout = strstr(name, ".cc") != nullptr;
    const bool hi = strstr(name, ".hi") != nullptr;
    if (mad != (hi || strstr(name, ".lo") != nullptr))
      cc_fail("mad needs .lo or .hi, add/sub neither", op);
    uint32_t* dst = nullptr;
    uint64_t src[3];
    const int nsrc = mad ? 3 : 2;
    for (int k = 0; k <= nsrc; ++k) {
      while (*s == ' ' || *s == '\t' || *s == ',') ++s;
      char* end;
      if (*s == '%') {
        const long idx = strtol(s + 1, &end, 10);
        if (end == s + 1 || idx < 0 || idx >= n_ops)
          cc_fail("bad operand", s);
        if (k == 0 && idx >= n_outs) cc_fail("writes an input", s);
        if (k == 0)
          dst = ops[idx];
        else
          src[k - 1] = *ops[idx];
      } else {
        if (k == 0) cc_fail("destination must be a register", s);
        src[k - 1] = strtoull(s, &end, 0);
        if (end == s || src[k - 1] > 0xffffffffull)
          cc_fail("bad literal", s);
      }
      s = end;
    }
    while (*s == ' ' || *s == '\t') ++s;
    if (*s != ';') cc_fail("expected ;", s);
    ++s;
    if (cin && cf < 0) cc_fail("carry read before it was set", op);
    const uint64_t c = cin ? (uint64_t)cf : 0u;
    uint64_t v;
    if (sub) {
      v = src[0] - src[1] - c;
      if (cout) cf = (int)(v >> 63);
    } else {
      uint64_t a = src[0], b = src[1];
      if (mad) {
        const uint64_t prod = a * b;
        a = hi ? prod >> 32 : prod & 0xffffffffull;
        b = src[2];
      }
      v = a + b + c;
      if (cout) cf = (int)(v >> 32);
    }
    *dst = (uint32_t)v;
  }
}
#endif

// p's limbs as PTX literals
#define LIGERO_P0 "0xf0000001"
#define LIGERO_P1 "0x43e1f593"
#define LIGERO_P2 "0x79b97091"
#define LIGERO_P3 "0x2833e848"
#define LIGERO_P4 "0x8181585d"
#define LIGERO_P5 "0xb85045b6"
#define LIGERO_P6 "0xe131a029"
#define LIGERO_P7 "0x30644e72"
static constexpr uint32_t kJ0 = 0xefffffffu;  // -p^-1 mod 2^32 = kJ[0]

// e += x times the even limbs b0, b2, b4, b6 (registers %11..%14 or p's
// literals); the carry goes to e[8], then to o[8].
#define LIGERO_EVEN_CHAIN(b0, b2, b4, b6)           \
  "mad.lo.cc.u32 %0, %10, " b0 ", %0;\n\t"          \
  "madc.hi.cc.u32 %1, %10, " b0 ", %1;\n\t"         \
  "madc.lo.cc.u32 %2, %10, " b2 ", %2;\n\t"         \
  "madc.hi.cc.u32 %3, %10, " b2 ", %3;\n\t"         \
  "madc.lo.cc.u32 %4, %10, " b4 ", %4;\n\t"         \
  "madc.hi.cc.u32 %5, %10, " b4 ", %5;\n\t"         \
  "madc.lo.cc.u32 %6, %10, " b6 ", %6;\n\t"         \
  "madc.hi.cc.u32 %7, %10, " b6 ", %7;\n\t"         \
  "addc.cc.u32 %8, %8, 0;\n\t"                      \
  "addc.u32 %9, %9, 0;"
#define LIGERO_E9(e, o)                                                  \
  (LIGERO_W(e[0]), LIGERO_W(e[1]), LIGERO_W(e[2]), LIGERO_W(e[3]),       \
   LIGERO_W(e[4]), LIGERO_W(e[5]), LIGERO_W(e[6]), LIGERO_W(e[7]),       \
   LIGERO_W(e[8]), LIGERO_W(o[8]))

// One row, t += x*y: e[0] += f with the odd limbs' chain behind it (the
// fold's carry enters at position 1), then the even limbs' chain.
LIGERO_HD void cc_row(uint32_t e[9], uint32_t o[9], uint32_t f,
                      const uint32_t y[8], uint32_t x) {
  LIGERO_CC("add.cc.u32 %0, %0, %10;\n\t"
            "madc.lo.cc.u32 %1, %11, %12, %1;\n\t"
            "madc.hi.cc.u32 %2, %11, %12, %2;\n\t"
            "madc.lo.cc.u32 %3, %11, %13, %3;\n\t"
            "madc.hi.cc.u32 %4, %11, %13, %4;\n\t"
            "madc.lo.cc.u32 %5, %11, %14, %5;\n\t"
            "madc.hi.cc.u32 %6, %11, %14, %6;\n\t"
            "madc.lo.cc.u32 %7, %11, %15, %7;\n\t"
            "madc.hi.cc.u32 %8, %11, %15, %8;\n\t"
            "addc.u32 %9, %9, 0;",
            (LIGERO_W(e[0]), LIGERO_W(o[0]), LIGERO_W(o[1]), LIGERO_W(o[2]),
             LIGERO_W(o[3]), LIGERO_W(o[4]), LIGERO_W(o[5]), LIGERO_W(o[6]),
             LIGERO_W(o[7]), LIGERO_W(o[8])),
            (LIGERO_R(f), LIGERO_R(x), LIGERO_R(y[1]), LIGERO_R(y[3]),
             LIGERO_R(y[5]), LIGERO_R(y[7])));
  LIGERO_CC(LIGERO_EVEN_CHAIN("%11", "%12", "%13", "%14"), LIGERO_E9(e, o),
            (LIGERO_R(x), LIGERO_R(y[0]), LIGERO_R(y[2]), LIGERO_R(y[4]),
             LIGERO_R(y[6])));
}

// The even half of t += m*p (the products of p's even limbs, positions
// 0..8; the carry goes on to o[8]), then the shift down one word: f is
// the word that lands at position 0 outside e.
LIGERO_HD void cc_even_shift(uint32_t e[9], uint32_t o[9], uint32_t m,
                             uint32_t& f) {
  LIGERO_CC(LIGERO_EVEN_CHAIN(LIGERO_P0, LIGERO_P2, LIGERO_P4, LIGERO_P6),
            LIGERO_E9(e, o), (LIGERO_R(m)));
  // e[0] is now 0 (t + m*p = 0 mod 2^32)
  f = e[1];
  uint32_t t[7];
#pragma unroll
  for (int k = 0; k < 7; ++k) t[k] = e[k + 2];
#pragma unroll
  for (int k = 0; k < 9; ++k) e[k] = o[k];
#pragma unroll
  for (int k = 0; k < 7; ++k) o[k] = t[k];
  o[7] = o[8] = 0u;
}

// t += m*p with m = t[0]*J0, then the shift down one word: f is the word
// that lands at position 0 outside e.
LIGERO_HD void cc_reduce(uint32_t e[9], uint32_t o[9], uint32_t& f) {
  const uint32_t m = e[0] * kJ0;
  LIGERO_CC("mad.lo.cc.u32 %0, %9, " LIGERO_P1 ", %0;\n\t"
            "madc.hi.cc.u32 %1, %9, " LIGERO_P1 ", %1;\n\t"
            "madc.lo.cc.u32 %2, %9, " LIGERO_P3 ", %2;\n\t"
            "madc.hi.cc.u32 %3, %9, " LIGERO_P3 ", %3;\n\t"
            "madc.lo.cc.u32 %4, %9, " LIGERO_P5 ", %4;\n\t"
            "madc.hi.cc.u32 %5, %9, " LIGERO_P5 ", %5;\n\t"
            "madc.lo.cc.u32 %6, %9, " LIGERO_P7 ", %6;\n\t"
            "madc.hi.cc.u32 %7, %9, " LIGERO_P7 ", %7;\n\t"
            "addc.u32 %8, %8, 0;",
            (LIGERO_W(o[0]), LIGERO_W(o[1]), LIGERO_W(o[2]), LIGERO_W(o[3]),
             LIGERO_W(o[4]), LIGERO_W(o[5]), LIGERO_W(o[6]), LIGERO_W(o[7]),
             LIGERO_W(o[8])),
            (LIGERO_R(m)));
  cc_even_shift(e, o, m, f);
}

// cc_reduce with f, the word at position 0 outside e, still to add: the
// odd chain first adds f into e[0] and carries into position 1, where its
// products start (m is taken from e[0] + f mod 2^32).
LIGERO_HD void cc_reduce_folding(uint32_t e[9], uint32_t o[9], uint32_t& f) {
  const uint32_t m = (e[0] + f) * kJ0;
  LIGERO_CC("add.cc.u32 %0, %0, %11;\n\t"
            "madc.lo.cc.u32 %1, %10, " LIGERO_P1 ", %1;\n\t"
            "madc.hi.cc.u32 %2, %10, " LIGERO_P1 ", %2;\n\t"
            "madc.lo.cc.u32 %3, %10, " LIGERO_P3 ", %3;\n\t"
            "madc.hi.cc.u32 %4, %10, " LIGERO_P3 ", %4;\n\t"
            "madc.lo.cc.u32 %5, %10, " LIGERO_P5 ", %5;\n\t"
            "madc.hi.cc.u32 %6, %10, " LIGERO_P5 ", %6;\n\t"
            "madc.lo.cc.u32 %7, %10, " LIGERO_P7 ", %7;\n\t"
            "madc.hi.cc.u32 %8, %10, " LIGERO_P7 ", %8;\n\t"
            "addc.u32 %9, %9, 0;",
            (LIGERO_W(e[0]), LIGERO_W(o[0]), LIGERO_W(o[1]), LIGERO_W(o[2]),
             LIGERO_W(o[3]), LIGERO_W(o[4]), LIGERO_W(o[5]), LIGERO_W(o[6]),
             LIGERO_W(o[7]), LIGERO_W(o[8])),
            (LIGERO_R(m), LIGERO_R(f)));
  cc_even_shift(e, o, m, f);
}

// t mod 2^256 = e + f + o at positions 0..7 (the carry out is dropped),
// then out = t - p if t >= p else t.
LIGERO_HD void cc_finish(uint32_t e[9], const uint32_t o[9], uint32_t f,
                         uint32_t out[8]) {
  LIGERO_CC("add.cc.u32 %0, %0, %8;\n\t"
            "addc.cc.u32 %1, %1, %9;\n\t"
            "addc.cc.u32 %2, %2, %10;\n\t"
            "addc.cc.u32 %3, %3, %11;\n\t"
            "addc.cc.u32 %4, %4, %12;\n\t"
            "addc.cc.u32 %5, %5, %13;\n\t"
            "addc.cc.u32 %6, %6, %14;\n\t"
            "addc.u32 %7, %7, %15;",
            (LIGERO_W(e[0]), LIGERO_W(e[1]), LIGERO_W(e[2]), LIGERO_W(e[3]),
             LIGERO_W(e[4]), LIGERO_W(e[5]), LIGERO_W(e[6]), LIGERO_W(e[7])),
            (LIGERO_R(f), LIGERO_R(o[0]), LIGERO_R(o[1]), LIGERO_R(o[2]),
             LIGERO_R(o[3]), LIGERO_R(o[4]), LIGERO_R(o[5]), LIGERO_R(o[6])));
  // t - p, and whether it borrowed (bw = all ones): keep t then
  uint32_t d[8], bw = 0u;
  LIGERO_CC("sub.cc.u32 %0, %9, " LIGERO_P0 ";\n\t"
            "subc.cc.u32 %1, %10, " LIGERO_P1 ";\n\t"
            "subc.cc.u32 %2, %11, " LIGERO_P2 ";\n\t"
            "subc.cc.u32 %3, %12, " LIGERO_P3 ";\n\t"
            "subc.cc.u32 %4, %13, " LIGERO_P4 ";\n\t"
            "subc.cc.u32 %5, %14, " LIGERO_P5 ";\n\t"
            "subc.cc.u32 %6, %15, " LIGERO_P6 ";\n\t"
            "subc.cc.u32 %7, %16, " LIGERO_P7 ";\n\t"
            "subc.u32 %8, %8, %8;",
            (LIGERO_O(d[0]), LIGERO_O(d[1]), LIGERO_O(d[2]), LIGERO_O(d[3]),
             LIGERO_O(d[4]), LIGERO_O(d[5]), LIGERO_O(d[6]), LIGERO_O(d[7]),
             LIGERO_W(bw)),
            (LIGERO_R(e[0]), LIGERO_R(e[1]), LIGERO_R(e[2]), LIGERO_R(e[3]),
             LIGERO_R(e[4]), LIGERO_R(e[5]), LIGERO_R(e[6]), LIGERO_R(e[7])));
#pragma unroll
  for (int l = 0; l < 8; ++l) out[l] = bw ? e[l] : d[l];
}

LIGERO_HD void mont_mul_cc(const uint32_t x[8], const uint32_t y[8],
                           uint32_t out[8]) {
  uint32_t e[9], o[9], f = 0u;
  // row 0 into empty arrays: plain products, no carries
#pragma unroll
  for (int j = 0; j < 8; j += 2) {
    const uint64_t pe = (uint64_t)y[j] * x[0], po = (uint64_t)y[j + 1] * x[0];
    e[j] = (uint32_t)pe;
    e[j + 1] = (uint32_t)(pe >> 32);
    o[j] = (uint32_t)po;
    o[j + 1] = (uint32_t)(po >> 32);
  }
  e[8] = o[8] = 0u;
  cc_reduce(e, o, f);
#pragma unroll
  for (int i = 1; i < 8; ++i) {
    cc_row(e, o, f, y, x[i]);
    cc_reduce(e, o, f);
  }
  cc_finish(e, o, f, out);
}

// x*y mod p: mont_mul_cc(mont_mul_cc(x, y), R^2 mod p).
LIGERO_HD void mulmod_cc(const uint32_t x[8], const uint32_t y[8],
                         uint32_t out[8]) {
  const uint32_t r2[8] = {0xae216da7u, 0x1bb8e645u, 0xe35c59e3u, 0x53fe3ab1u,
                          0x53bb8085u, 0x8c49833du, 0x7f4e44a5u, 0x0216d0b1u};
  uint32_t t[8];
  mont_mul_cc(x, y, t);
  mont_mul_cc(t, r2, out);
}

// redc_cc(u) equals redc(u) on every 512-bit U: the reduction rows of
// mont_mul_cc over U itself.  U_lo starts in e; each row takes m_i from
// position 0, adds m_i*p and shifts, so m = sum m_i 2^(32i) is the
// reference's U_lo*J mod 2^256, and after 8 rows t = (U + m*p) / 2^256,
// which is U_hi + (m*p)_hi + [U_lo != 0] (U_lo + (m*p)_lo is 0 or
// 2^256).  U_hi enters the window word by word where the shift frees
// position 8: U[8] before the first row (e[8]), U[9 + i] after row i
// (o[7]); a word never changes the m_i of a row below it.  Between rows t
// < 2^288 + p, inside a row below 2^289: the ten positions hold it.  As in
// the reference t is kept mod 2^256, then p is subtracted once if t >= p.
LIGERO_HD void redc_cc(const uint32_t u[16], uint32_t out[8]) {
  uint32_t e[9], o[9], f = 0u;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    e[k] = u[k];
    o[k] = 0u;
  }
  cc_reduce(e, o, f);
#pragma unroll
  for (int i = 1; i < 8; ++i) {
    o[7] = u[8 + i];
    cc_reduce_folding(e, o, f);
  }
  cc_finish(e, o, f, out);
}

}  // namespace ligero_fm
