// The CIOS Montgomery product on 16-bit limbs, one thread per lane: the
// device functions shared by mont_mul.cu and the two digit-domain Miller
// step kernels (miller_dbl_digits.cu, miller_add_digits.cu).
//
// bgn_cios runs the CIOS loop of bgn_tpu/fieldcore/montgomery.py over a
// flat, lazily carried uint32 accumulator T[0..2L]: per outer step i every
// position gains less than 4 * 2^16 plus the shifted carry of position i,
// and a position lives for at most L + 1 steps, so T < 2^32 for L < 16000
// (the audit in bgn_tpu/fieldcore/montgomery.py).  m is taken before the
// inner loop from the low 16 bits of T[i] + a_i*b_0, so one pass adds both
// a_i*b and m*p.  It leaves a*b*R^-1 (< 2p for a < R, b < p) as 16-bit
// limbs in T[L..2L]; bgn_cond_sub_p makes them canonical.  R = 2^(16L)
// for every L, odd L included.
//
// The field helpers (bgn_mont_mul, bgn_mod_add, bgn_mod_sub, and BgnField
// that binds them to one modulus) work on canonical limb arrays in local
// memory; an output may alias an input.
#pragma once
#include <stdint.h>

#define BGN_MONT_MASK 0xFFFFu

// a(i) -> limb i of the first operand (a plain array, or a strided
// global read in mont_mul.cu)
struct BgnLimbs {
  const unsigned* v;
  __device__ __forceinline__ unsigned operator()(int i) const { return v[i]; }
};

template <class LoadA>
__device__ __forceinline__ void bgn_cios(LoadA a, const unsigned* b,
                                         const unsigned* p, unsigned pinv,
                                         int L, unsigned* T) {
  for (int j = 0; j <= 2 * L; j++) T[j] = 0;
  for (int i = 0; i < L; i++) {
    const unsigned ai = a(i);
    const unsigned m = (((T[i] + ai * b[0]) & BGN_MONT_MASK) * pinv)
                       & BGN_MONT_MASK;
    unsigned hi = 0;                   // high halves owed to position i+j
    for (int j = 0; j < L; j++) {
      const unsigned x = ai * b[j], y = m * p[j];
      T[i + j] += (x & BGN_MONT_MASK) + (y & BGN_MONT_MASK) + hi;
      hi = (x >> 16) + (y >> 16);
    }
    T[i + L] += hi;
    T[i + 1] += T[i] >> 16;            // the low 16 bits of T[i] are zero
  }
  // T[L..2L] -> 16-bit limbs of a value < 2p (carries < 2^16)
  unsigned c = 0;
  for (int j = 0; j <= L; j++) {
    const unsigned s = T[L + j] + c;
    T[L + j] = s & BGN_MONT_MASK;
    c = s >> 16;
  }
}

// out <- t - p if t >= p, else t; t: L + 1 limbs of a value < 2p
__device__ __forceinline__ void bgn_cond_sub_p(const unsigned* t,
                                               const unsigned* p, int L,
                                               unsigned* out) {
  int borrow = 0;
  for (int j = 0; j <= L; j++) {
    const int s = (int)t[j] - (j < L ? (int)p[j] : 0) - borrow;
    borrow = s < 0;
    if (j < L) out[j] = (unsigned)(s + (borrow << 16));
  }
  if (borrow)
    for (int j = 0; j < L; j++) out[j] = t[j];
}

// out <- a*b*R^-1 mod p (canonical); T: scratch of 2L + 1 words
__device__ __forceinline__ void bgn_mont_mul(unsigned* out, const unsigned* a,
                                             const unsigned* b,
                                             const unsigned* p,
                                             unsigned pinv, int L,
                                             unsigned* T) {
  bgn_cios(BgnLimbs{a}, b, p, pinv, L, T);
  bgn_cond_sub_p(T + L, p, L, out);
}

// out <- a + b mod p for canonical a, b
__device__ __forceinline__ void bgn_mod_add(unsigned* out, const unsigned* a,
                                            const unsigned* b,
                                            const unsigned* p, int L) {
  unsigned c = 0;
  for (int j = 0; j < L; j++) {
    const unsigned s = a[j] + b[j] + c;
    out[j] = s & BGN_MONT_MASK;
    c = s >> 16;
  }
  // subtract p when the sum carried out or is >= p
  int geq = c;
  if (!geq) {
    geq = 1;                           // equal counts as >= p
    for (int j = L - 1; j >= 0; j--) {
      if (out[j] != p[j]) {
        geq = out[j] > p[j];
        break;
      }
    }
  }
  if (geq) {
    int borrow = 0;
    for (int j = 0; j < L; j++) {
      const int s = (int)out[j] - (int)p[j] - borrow;
      borrow = s < 0;
      out[j] = (unsigned)(s + (borrow << 16));
    }
  }
}

// out <- a - b mod p for canonical a, b
__device__ __forceinline__ void bgn_mod_sub(unsigned* out, const unsigned* a,
                                            const unsigned* b,
                                            const unsigned* p, int L) {
  int borrow = 0;
  for (int j = 0; j < L; j++) {
    const int s = (int)a[j] - (int)b[j] - borrow;
    borrow = s < 0;
    out[j] = (unsigned)(s + (borrow << 16));
  }
  if (borrow) {                        // a < b: add p back
    unsigned c = 0;
    for (int j = 0; j < L; j++) {
      const unsigned s = out[j] + p[j] + c;
      out[j] = s & BGN_MONT_MASK;
      c = s >> 16;
    }
  }
}

// F_p for one lane: p (shared memory), pinv = -p^-1 mod 2^16, L limbs,
// and the CIOS accumulator T (2L + 1 words of local memory)
struct BgnField {
  const unsigned* p;
  unsigned pinv;
  int L;
  unsigned* T;
  __device__ __forceinline__ void mul(unsigned* o, const unsigned* a,
                                      const unsigned* b) const {
    bgn_mont_mul(o, a, b, p, pinv, L, T);
  }
  __device__ __forceinline__ void add(unsigned* o, const unsigned* a,
                                      const unsigned* b) const {
    bgn_mod_add(o, a, b, p, L);
  }
  __device__ __forceinline__ void sub(unsigned* o, const unsigned* a,
                                      const unsigned* b) const {
    bgn_mod_sub(o, a, b, p, L);
  }
};

// float32 8-bit digits [2L, n] (lane `lane`) <-> 16-bit limbs
__device__ __forceinline__ void bgn_load_digits(unsigned* out, const float* d,
                                                int L, int n, int lane) {
  for (int j = 0; j < L; j++)
    out[j] = (unsigned)d[(size_t)(2 * j) * n + lane]
             + ((unsigned)d[(size_t)(2 * j + 1) * n + lane] << 8);
}

__device__ __forceinline__ void bgn_store_digits(float* d, const unsigned* v,
                                                 int L, int n, int lane) {
  for (int j = 0; j < L; j++) {
    d[(size_t)(2 * j) * n + lane] = (float)(v[j] & 0xFFu);
    d[(size_t)(2 * j + 1) * n + lane] = (float)(v[j] >> 8);
  }
}
