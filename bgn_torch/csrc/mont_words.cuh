// The Montgomery product a*b*R^-1 mod p on 32-bit words, and mod add and
// mod sub of canonical values, for mont_mul.cu and the two digit-domain
// Miller step kernels (miller_dbl_digits.cu, miller_add_digits.cu, through
// digits.cuh).
//
// A value of L 16-bit limbs is held as W = ceil(L/2) 32-bit words (limb
// pairs packed), R = 2^(16L).  CIOS runs on 32 x 32 -> 64-bit products:
// -p^-1 mod 2^32 comes from Newton steps on p's low word.  Per word step i:
// T += a_i * b (one carry chain), m = T_0 * (-p^-1) mod 2^32, T += m * p (a
// second chain), T >>= 32; T < 2p throughout (each step adds less than
// 2^32 * 2p before the shift), and one conditional subtraction of p ends
// it.
//
//  - Register form (bgn_mont_words<W, G, S>), L = 2W: fully unrolled, so
//    a lane's words live in registers.  G threads share a lane, thread t
//    holding words t*S .. t*S + S - 1 of every value, S = ceil((W + 1) /
//    G); a_i comes from the thread that holds it by a shuffle, m from
//    thread 0.  A thread's two chains end in a carry word E of position
//    (t + 1) S, which after the shift is its own top word; the word that
//    shifts in from thread t + 1 plus E overflows by at most 2, and that
//    carry P goes to thread t + 1 by a shuffle and starts its next chain.
//    After the last step the pending carries are rippled (at most G - 1
//    rounds), and the borrow of T - p crosses the threads by G - 1 rounds
//    of bin' = bin ? (slice <= p's) : (slice < p's).  Mod add and mod sub
//    pass their carries and borrows across the threads the same way: each
//    slice computes its carry (borrow) out for a carry in of 0 and of 1,
//    then G - 1 shuffle rounds pick.  Every shuffle is outside a branch
//    that differs between lanes, so a warp's lanes may take different
//    values down the same code.
//  - Loop form (bgn_mont_loop_steps, bgn_loop_sub_p), any L, odd included
//    (R = 2^(16L) is then not a power of 2^32: W - 1 word steps and a last
//    half step on 16 bits, m = T_0 * (-p^-1) mod 2^16, T >>= 16): one
//    thread per lane, the same chains with S = W + 1 over a runtime W.
//
// tests/test_torch_mont_words.py and tests/test_torch_digits_words.py
// emulate both forms word for word.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#define BGN_MONT_FULL 0xffffffffu

typedef unsigned long long bgn_u64;

// 32-bit word w of a lane's operand of L int64 limbs: limbs 2w and 2w + 1
// (0 past L); half(): limb L - 1 alone, the operand of odd L's half step
struct BgnWords {
  const int64_t* v;
  long long stride;
  int L;
  __device__ __forceinline__ unsigned operator()(int w) const {
    const unsigned lo = (unsigned)v[(long long)(2 * w) * stride];
    const unsigned hi =
        2 * w + 1 < L ? (unsigned)v[(long long)(2 * w + 1) * stride] : 0u;
    return lo | (hi << 16);
  }
  __device__ __forceinline__ unsigned half() const {
    return (unsigned)v[(long long)(L - 1) * stride];
  }
};

// -p^-1 mod 2^32 for odd p0: Newton steps x <- x (2 - p0 x) double the
// correct low bits of p0^-1 (3, 6, 12, 24, 48)
static __device__ __forceinline__ unsigned bgn_neg_inv32(unsigned p0) {
  unsigned x = p0;
#pragma unroll
  for (int r = 0; r < 4; r++) x *= 2u - p0 * x;
  return 0u - x;
}

// T[0..S) += x * y[0..S) + c; returns the carry word out
template <int S>
static __device__ __forceinline__ unsigned bgn_mad_chain(unsigned* T,
                                                         unsigned x,
                                                         const unsigned* y,
                                                         unsigned c) {
  bgn_u64 carry = c;
#pragma unroll
  for (int j = 0; j < S; j++) {
    const bgn_u64 v = (bgn_u64)x * y[j] + T[j] + carry;
    T[j] = (unsigned)v;
    carry = v >> 32;
  }
  return (unsigned)carry;
}

// ---------------------------------------------------------------------------
// Register form: thread t of the lane's G holds words t*S .. t*S + S - 1
// ---------------------------------------------------------------------------

// Word step i of CIOS: T <- (T + a_i b + m p) / 2^32 with the pending
// carry P into this thread's word 0 (from thread t - 1's last step)
template <int S, int G>
static __device__ __forceinline__ void bgn_cios_word_step(
    unsigned* T, const unsigned* av, int i, const unsigned* bv,
    const unsigned* pv, unsigned pinv, unsigned& P, int t) {
  unsigned ai = av[i % S];
  if constexpr (G > 1) ai = __shfl_sync(BGN_MONT_FULL, ai, i / S, G);
  const unsigned cA = bgn_mad_chain<S>(T, ai, bv, P);
  unsigned m = T[0] * pinv;
  if constexpr (G > 1) m = __shfl_sync(BGN_MONT_FULL, m, 0, G);
  const unsigned cB = bgn_mad_chain<S>(T, m, pv, 0u);
  unsigned up = 0;                     // thread t + 1's word 0
  if constexpr (G > 1) {
    up = __shfl_down_sync(BGN_MONT_FULL, T[0], 1, G);
    if (t == G - 1) up = 0;
  }
#pragma unroll
  for (int j = 0; j + 1 < S; j++) T[j] = T[j + 1];
  const bgn_u64 y = (bgn_u64)up + cA + cB;
  T[S - 1] = (unsigned)y;
  if constexpr (G > 1) {
    P = __shfl_up_sync(BGN_MONT_FULL, (unsigned)(y >> 32), 1, G);
    if (t == 0) P = 0;
  }
}

// The pending carries P of the last step rippled up the threads (at most
// G - 1 rounds; the warp stops when no lane has one left)
template <int S, int G>
static __device__ __forceinline__ void bgn_carry_ripple(unsigned* T,
                                                        unsigned P, int t) {
  if constexpr (G > 1) {
#pragma unroll 1
    for (int r = 0; r < G; r++) {
      bgn_u64 carry = P;
#pragma unroll
      for (int j = 0; j < S; j++) {
        const bgn_u64 v = (bgn_u64)T[j] + carry;
        T[j] = (unsigned)v;
        carry = v >> 32;
      }
      P = __shfl_up_sync(BGN_MONT_FULL, (unsigned)carry, 1, G);
      if (t == 0) P = 0;
      if (!__any_sync(BGN_MONT_FULL, P)) break;
    }
  }
}

// T < 2p: subtract p if T >= p.  b0 / b1: this slice's borrow out for a
// borrow in of 0 / 1 (b1 = slice <= p's slice)
template <int S, int G>
static __device__ __forceinline__ void bgn_sub_p_if_ge(unsigned* T,
                                                       const unsigned* pv,
                                                       int t) {
  int b0 = 0, eq = 1;
#pragma unroll
  for (int j = 0; j < S; j++) {
    const long long s = (long long)T[j] - pv[j] - b0;
    b0 = s < 0;
    eq &= (unsigned)s == 0u;
  }
  const int b1 = b0 | eq;
  int bin = 0;
  if constexpr (G > 1) {
#pragma unroll
    for (int r = 0; r + 1 < G; r++) {
      bin = __shfl_up_sync(BGN_MONT_FULL, bin ? b1 : b0, 1, G);
      if (t == 0) bin = 0;
    }
  }
  int ge = !(bin ? b1 : b0);           // T >= p: the top slice's borrow
  if constexpr (G > 1) ge = __shfl_sync(BGN_MONT_FULL, ge, G - 1, G);
  if (ge) {
#pragma unroll
    for (int j = 0; j < S; j++) {
      const long long s = (long long)T[j] - pv[j] - bin;
      bin = s < 0;
      T[j] = (unsigned)s;
    }
  }
}

// T <- a*b*R^-1 mod p, R = 2^(32W), for a < R, b < p; T: S words a thread
template <int W, int G, int S>
static __device__ __forceinline__ void bgn_mont_words(unsigned* T,
                                                      const unsigned* av,
                                                      const unsigned* bv,
                                                      const unsigned* pv,
                                                      unsigned pinv, int t) {
#pragma unroll
  for (int j = 0; j < S; j++) T[j] = 0u;
  unsigned P = 0;                      // carry into word 0 from below
#pragma unroll
  for (int i = 0; i < W; i++)
    bgn_cios_word_step<S, G>(T, av, i, bv, pv, pinv, P, t);
  bgn_carry_ripple<S, G>(T, P, t);
  bgn_sub_p_if_ge<S, G>(T, pv, t);
}

// s <- a + y over the lane's G * S words, the carry out of the top word
// dropped: c0 / c1 are this slice's carry out for a carry in of 0 / 1
// (c1 = c0, or the slice's sum is all ones)
template <int S, int G>
static __device__ __forceinline__ void bgn_add_split(unsigned* s,
                                                     const unsigned* a,
                                                     const unsigned* y,
                                                     int t) {
  bgn_u64 c = 0;
  int ones = 1;
#pragma unroll
  for (int j = 0; j < S; j++) {
    const bgn_u64 v = (bgn_u64)a[j] + y[j] + c;
    s[j] = (unsigned)v;
    c = v >> 32;
    ones &= s[j] == BGN_MONT_FULL;
  }
  const int c0 = (int)c, c1 = c0 | ones;
  int cin = 0;
  if constexpr (G > 1) {
#pragma unroll
    for (int r = 0; r + 1 < G; r++) {
      cin = __shfl_up_sync(BGN_MONT_FULL, cin ? c1 : c0, 1, G);
      if (t == 0) cin = 0;
    }
#pragma unroll
    for (int j = 0; j < S; j++) {
      const bgn_u64 v = (bgn_u64)s[j] + cin;
      s[j] = (unsigned)v;
      cin = (int)(v >> 32);
    }
  }
}

// o <- a + b mod p for canonical a, b (p < 2^(32W), so a + b < 2p fits
// the W words and a carry word W): subtract p when the sum is >= p, equal
// counting as >=.  o may alias a or b.
template <int S, int G>
static __device__ __forceinline__ void bgn_mod_add_words(unsigned* o,
                                                         const unsigned* a,
                                                         const unsigned* b,
                                                         const unsigned* pv,
                                                         int t) {
  unsigned s[S];
  bgn_add_split<S, G>(s, a, b, t);
  bgn_sub_p_if_ge<S, G>(s, pv, t);
#pragma unroll
  for (int j = 0; j < S; j++) o[j] = s[j];
}

// o <- a - b mod p for canonical a, b: add p back on a borrow.  b0 / b1:
// this slice's borrow out for a borrow in of 0 / 1 (b1 = slice <= b's
// slice).  p is added as p & -borrow, so every thread runs the same
// shuffles.  o may alias a or b.
template <int S, int G>
static __device__ __forceinline__ void bgn_mod_sub_words(unsigned* o,
                                                         const unsigned* a,
                                                         const unsigned* b,
                                                         const unsigned* pv,
                                                         int t) {
  unsigned d[S], q[S];
  int b0 = 0, eq = 1;
#pragma unroll
  for (int j = 0; j < S; j++) {
    const long long s = (long long)a[j] - b[j] - b0;
    b0 = s < 0;
    d[j] = (unsigned)s;
    eq &= d[j] == 0u;
  }
  const int b1 = b0 | eq;
  int bin = 0;
  if constexpr (G > 1) {
#pragma unroll
    for (int r = 0; r + 1 < G; r++) {
      bin = __shfl_up_sync(BGN_MONT_FULL, bin ? b1 : b0, 1, G);
      if (t == 0) bin = 0;
    }
  }
  int neg = bin ? b1 : b0;             // a < b: the top slice's borrow
  if constexpr (G > 1) {
    neg = __shfl_sync(BGN_MONT_FULL, neg, G - 1, G);
#pragma unroll
    for (int j = 0; j < S; j++) {
      const long long s = (long long)d[j] - bin;
      bin = s < 0;
      d[j] = (unsigned)s;
    }
  }
  const unsigned mask = 0u - (unsigned)neg;
#pragma unroll
  for (int j = 0; j < S; j++) q[j] = pv[j] & mask;
  bgn_add_split<S, G>(o, d, q, t);
}

// ---------------------------------------------------------------------------
// Loop form: one thread per lane, S = W + 1 words over a runtime W
// ---------------------------------------------------------------------------

// T[0..S) += x * y[0..S) over a runtime S; returns the carry word out
static __device__ __forceinline__ unsigned bgn_mad_loop(unsigned* T,
                                                        unsigned x,
                                                        const unsigned* y,
                                                        int S) {
  bgn_u64 carry = 0;
  for (int j = 0; j < S; j++) {
    const bgn_u64 v = (bgn_u64)x * y[j] + T[j] + carry;
    T[j] = (unsigned)v;
    carry = v >> 32;
  }
  return (unsigned)carry;
}

// T (S = W + 1 zero words on entry) <- a*b*R^-1 (mod p, < 2p), R =
// 2^(16L): L / 2 word steps and, for odd L, the half step on limb L - 1
// (a.half()).  a(i): word i of a; b, p: W words and a zero word W.
template <class A>
static __device__ __forceinline__ void bgn_mont_loop_steps(
    unsigned* T, const A& a, const unsigned* bv, const unsigned* ps,
    unsigned pinv, int L, int S) {
  for (int i = 0; i < L / 2; i++) {    // full word steps
    const unsigned cA = bgn_mad_loop(T, a(i), bv, S);
    const unsigned cB = bgn_mad_loop(T, T[0] * pinv, ps, S);
    for (int j = 0; j + 1 < S; j++) T[j] = T[j + 1];
    T[S - 1] = cA + cB;                // < 2: T < 2^32 * 2p before the shift
  }
  if (L & 1) {                         // the half step on limb L - 1
    const unsigned cA = bgn_mad_loop(T, a.half(), bv, S);
    const unsigned cB =
        bgn_mad_loop(T, (T[0] * pinv) & 0xFFFFu, ps, S);
    for (int j = 0; j + 1 < S; j++) T[j] = (T[j] >> 16) | (T[j + 1] << 16);
    T[S - 1] = (T[S - 1] >> 16) | ((cA + cB) << 16);
  }
}

// d <- T - p over S words; returns the borrow out (1: T < p, keep T)
static __device__ __forceinline__ int bgn_loop_sub_p(const unsigned* T,
                                                     const unsigned* ps,
                                                     int S, unsigned* d) {
  int borrow = 0;
  for (int j = 0; j < S; j++) {
    const long long s = (long long)T[j] - ps[j] - borrow;
    borrow = s < 0;
    d[j] = (unsigned)s;
  }
  return borrow;
}
