// F_p of one lane for the two digit-domain Miller step kernels
// (miller_dbl_digits.cu, miller_add_digits.cu), on the 32-bit words of
// mont_words.cuh.
//
// A step's inputs and outputs are float32 [2L, n] arrays of canonical
// 8-bit digits (exact: every digit < 256).  load() reads digit rows
// 4w .. 4w + 3 of the lane into word w (rows past 2L are 0: odd L), and
// store() writes them back.  A field: Elem (one value of the lane), load,
// store, mul (Montgomery product, R = 2^(16L)), add and sub (mod p); an
// output may alias either input, since every op finishes its result
// before it writes it.
//
//  - BgnWordField<W, G>, L = 2W: the register form, the lane's words
//    split over G threads of a warp, S = ceil((W + 1) / G) words each;
//    lanes past n compute on lane 0's digits and store nothing (they
//    take part in the shuffles, so no thread returns early).
//  - BgnLoopField: any other L <= 64, odd L included: the loop form, one
//    thread per lane, S = W + 1 words of local memory per value, p in
//    shared memory (bgn_load_p_shared).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "mont_words.cuh"

#define BGN_DIGITS_THREADS 128         // threads per block, both forms
#define BGN_DIGITS_LMAX 64             // 2L + 1 <= 129: the fused dispatch
#define BGN_DIGITS_SMAX (BGN_DIGITS_LMAX / 2 + 1)

// word w of lane `lane`: digit rows 4w .. 4w + 3 of d [2L, n]
static __device__ __forceinline__ unsigned bgn_digit_word(const float* d,
                                                          int w, int L,
                                                          int n, int lane) {
  unsigned v = 0;
#pragma unroll
  for (int k = 0; k < 4; k++)
    if (4 * w + k < 2 * L)
      v |= (unsigned)d[(size_t)(4 * w + k) * n + lane] << (8 * k);
  return v;
}

static __device__ __forceinline__ void bgn_store_digit_word(float* d,
                                                            unsigned v,
                                                            int w, int L,
                                                            int n, int lane) {
#pragma unroll
  for (int k = 0; k < 4; k++)
    if (4 * w + k < 2 * L)
      d[(size_t)(4 * w + k) * n + lane] = (float)((v >> (8 * k)) & 0xFFu);
}

template <int W, int G>
struct BgnWordField {
  static constexpr int S = (W + G) / G;  // ceil((W + 1) / G) words a thread
  static constexpr int L = 2 * W;
  struct Elem {
    unsigned w[S];
  };
  unsigned pv[S];                      // this thread's words of p
  unsigned pinv;                       // -p^-1 mod 2^32
  int t, n, lane;                      // lane: the lane whose digits it reads
  bool live;                           // lane < n: store

  __device__ __forceinline__ BgnWordField(const int64_t* p, int n_) {
    const int tid = blockIdx.x * BGN_DIGITS_THREADS + threadIdx.x;
    t = tid % G;
    n = n_;
    live = tid / G < n;
    lane = live ? tid / G : 0;
    const BgnWords pw{p, 1, L};
#pragma unroll
    for (int j = 0; j < S; j++) {
      const int w = t * S + j;
      pv[j] = w < W ? pw(w) : 0u;
    }
    pinv = bgn_neg_inv32(pw(0));
  }
  __device__ __forceinline__ void load(Elem& x, const float* d) const {
#pragma unroll
    for (int j = 0; j < S; j++) {
      const int w = t * S + j;
      x.w[j] = w < W ? bgn_digit_word(d, w, L, n, lane) : 0u;
    }
  }
  __device__ __forceinline__ void store(float* d, const Elem& x) const {
    if (!live) return;
#pragma unroll
    for (int j = 0; j < S; j++) {
      const int w = t * S + j;
      if (w < W) bgn_store_digit_word(d, x.w[j], w, L, n, lane);
    }
  }
  __device__ __forceinline__ void mul(Elem& o, const Elem& a,
                                      const Elem& b) const {
    unsigned T[S];
    bgn_mont_words<W, G, S>(T, a.w, b.w, pv, pinv, t);
#pragma unroll
    for (int j = 0; j < S; j++) o.w[j] = T[j];
  }
  __device__ __forceinline__ void add(Elem& o, const Elem& a,
                                      const Elem& b) const {
    bgn_mod_add_words<S, G>(o.w, a.w, b.w, pv, t);
  }
  __device__ __forceinline__ void sub(Elem& o, const Elem& a,
                                      const Elem& b) const {
    bgn_mod_sub_words<S, G>(o.w, a.w, b.w, pv, t);
  }
};

// p's W words and a zero word W into shared memory (every thread of the
// block, then a barrier)
static __device__ __forceinline__ void bgn_load_p_shared(unsigned* ps,
                                                         const int64_t* p,
                                                         int L) {
  const int W = (L + 1) / 2;
  const BgnWords pw{p, 1, L};
  for (int j = threadIdx.x; j <= W; j += blockDim.x)
    ps[j] = j < W ? pw(j) : 0u;
  __syncthreads();
}

struct BgnLoopField {
  struct Elem {
    unsigned w[BGN_DIGITS_SMAX];
  };
  // a(i) -> word i of a value; half(): word W - 1, limb L - 1 alone
  // (canonical, so its high limb is 0 for odd L)
  struct Words {
    const unsigned* v;
    int W;
    __device__ __forceinline__ unsigned operator()(int i) const {
      return v[i];
    }
    __device__ __forceinline__ unsigned half() const { return v[W - 1]; }
  };
  const unsigned* ps;                  // p's words in shared memory
  unsigned pinv;
  int L, W, S, n, lane;

  __device__ __forceinline__ BgnLoopField(const unsigned* ps_, int L_,
                                          int n_, int lane_)
      : ps(ps_), pinv(bgn_neg_inv32(ps_[0])), L(L_), W((L_ + 1) / 2),
        S((L_ + 1) / 2 + 1), n(n_), lane(lane_) {}
  __device__ __forceinline__ void load(Elem& x, const float* d) const {
    for (int w = 0; w < S; w++)        // word W: rows past 2L, 0
      x.w[w] = bgn_digit_word(d, w, L, n, lane);
  }
  __device__ __forceinline__ void store(float* d, const Elem& x) const {
    for (int w = 0; w < W; w++) bgn_store_digit_word(d, x.w[w], w, L, n, lane);
  }
  __device__ __forceinline__ void mul(Elem& o, const Elem& a,
                                      const Elem& b) const {
    unsigned T[BGN_DIGITS_SMAX];
    for (int j = 0; j < S; j++) T[j] = 0u;
    bgn_mont_loop_steps(T, Words{a.w, W}, b.w, ps, pinv, L, S);
    if (bgn_loop_sub_p(T, ps, S, o.w))   // T < p: keep T
      for (int j = 0; j < S; j++) o.w[j] = T[j];
  }
  // o <- a + b mod p: subtract p when the sum is >= p (equal counts)
  __device__ __forceinline__ void add(Elem& o, const Elem& a,
                                      const Elem& b) const {
    unsigned s[BGN_DIGITS_SMAX];
    bgn_u64 c = 0;
    for (int j = 0; j < S; j++) {
      const bgn_u64 v = (bgn_u64)a.w[j] + b.w[j] + c;
      s[j] = (unsigned)v;
      c = v >> 32;
    }
    if (bgn_loop_sub_p(s, ps, S, o.w))   // s < p: keep s
      for (int j = 0; j < S; j++) o.w[j] = s[j];
  }
  // o <- a - b mod p: add p back on a borrow
  __device__ __forceinline__ void sub(Elem& o, const Elem& a,
                                      const Elem& b) const {
    int borrow = 0;
    for (int j = 0; j < S; j++) {
      const long long s = (long long)a.w[j] - b.w[j] - borrow;
      borrow = s < 0;
      o.w[j] = (unsigned)s;
    }
    if (borrow) {
      bgn_u64 c = 0;
      for (int j = 0; j < S; j++) {
        const bgn_u64 v = (bgn_u64)o.w[j] + ps[j] + c;
        o.w[j] = (unsigned)v;
        c = v >> 32;
      }
    }
  }
};
