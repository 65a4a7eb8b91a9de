// Batched Montgomery product a*b*R^-1 mod p on 16-bit limbs, R = 2^(16L),
// computed on 32-bit words.
//
// Replaces bgn_tpu/fieldcore/pallas_mont.py:mont_mul_pallas_f32
// (_cios_kernel_f32, CIOS over 8-bit digits in fp32) and :mont_mul_pallas
// (_cios_kernel, CIOS over 16-bit limbs in uint32).  The two TPU kernels
// compute the same function with the same contract; they differ only
// because the TPU's vector unit emulates 32-bit integer multiplies.  Hopper
// multiplies 32-bit integers natively, so one integer kernel serves both.
//
// Contract (fieldcore/montgomery.py mont_mul): a, b int64 [L, n] limbs,
// a < R and b < p (canonical), p odd, 1 <= L <= 264; out [L, n] canonical
// limbs < p.  The operands are read through (limb, lane) element strides,
// so a broadcast operand (lane stride 0, e.g. R^2 in to_mont) needs no
// copy, and neighbouring lanes read neighbouring addresses.
//
// The limbs are packed in pairs into W = ceil(L/2) 32-bit words on load,
// and CIOS runs on 32 x 32 -> 64-bit products: a quarter of the products
// of 16-bit limbs, with no mask or shift per product.  -p^-1 mod 2^32 comes
// from Newton steps on p's low word.  Per word step i: T += a_i * b (one
// carry chain), m = T_0 * (-p^-1) mod 2^32, T += m * p (a second chain),
// T >>= 32; T < 2p throughout (each step adds less than 2^32 * 2p before
// the shift), and one conditional subtraction of p ends it.
//
//  - bgn_mont_words_kernel<W, G>: the widths of the keys, L = 2W = 34, 66,
//    130, 258 (512- to 4096-bit keys), fully unrolled, so a lane's words
//    live in registers.  G threads share a lane, thread t holding words
//    t*S .. t*S + S - 1 of b, p and T, S = ceil((W + 1) / G); a_i comes
//    from the thread that loaded it by a
//    shuffle, m from thread 0.  A thread's two chains end in a carry word
//    E of position (t + 1) S, which after the shift is its own top word;
//    the word that shifts in from thread t + 1 plus E overflows by at most
//    2, and that carry P goes to thread t + 1 by a shuffle and starts its
//    next chain.  After the last step the pending carries are rippled
//    (at most G - 1 rounds), and the borrow of T - p crosses the threads
//    by G - 1 rounds of bin' = bin ? (slice <= p's) : (slice < p's).
//  - bgn_mont_loop_kernel: every other L, odd L included (R = 2^(16L) is
//    then not a power of 2^32: W - 1 word steps and a last half step on
//    16 bits, m = T_0 * (-p^-1) mod 2^16, T >>= 16).  One thread per
//    lane, the same chains with S = W + 1 over runtime W, b and T in local
//    memory, p in shared memory.  bgn_mont_mul_loop runs it at any L, so
//    chip_smoke.py can time it beside the register kernels.
// tests/test_torch_mont_words.py emulates both kernels word for word.
//
// Bound on the H100: at L = 34 and n = 8192 the bytes (3 * 8 * L per
// lane) take ~2 us and the 2 W^2 products per lane (a low and a high
// multiply-add each) ~0.6 us: the least time is the bytes'.  One thread
// per lane and 32 threads per block put 256 blocks on the 132 SMs; what
// is left is the dependent carry chains and the launch.  The 512-lane
// calls of the wider keys fill the card only with more threads per lane,
// and their chains get shorter: G = 1 at W = 17 (one thread per lane
// won against 2 and 4), 8 at 33, 32 at 65 and 129 (PERF.md §6, the
// sweep of scripts/kernel_variants.py; the local-memory loop lost at
// every key width).
#include <cuda_runtime.h>
#include <stdint.h>

#define BGN_MONT_LMAX 264              // 4096-bit keys have L = 258
#define BGN_MONT_WMAX 132              // words of BGN_MONT_LMAX limbs
#define BGN_MONT_THREADS 32            // threads per block
#define BGN_MONT_FULL 0xffffffffu

typedef unsigned long long bgn_u64;

// 32-bit word w of a lane's operand: limbs 2w and 2w + 1 (0 past L)
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

template <int W, int G>
__global__ void __launch_bounds__(BGN_MONT_THREADS)
bgn_mont_words_kernel(const int64_t* __restrict__ a, long long a_sl,
                      long long a_sn, const int64_t* __restrict__ b,
                      long long b_sl, long long b_sn,
                      const int64_t* __restrict__ p,
                      int64_t* __restrict__ out, int n) {
  constexpr int S = (W + G) / G;       // ceil((W + 1) / G) words a thread
  constexpr int L = 2 * W;
  const int tid = blockIdx.x * BGN_MONT_THREADS + threadIdx.x;
  const int t = tid % G, lane = tid / G;
  const bool live = lane < n;          // lanes >= n run lane 0, store none
  const int ln = live ? lane : 0;
  const BgnWords aw{a + ln * a_sn, a_sl, L}, bw{b + ln * b_sn, b_sl, L},
      pw{p, 1, L};
  unsigned av[S], bv[S], pv[S], T[S];
#pragma unroll
  for (int j = 0; j < S; j++) {
    const int w = t * S + j;
    av[j] = w < W ? aw(w) : 0u;
    bv[j] = w < W ? bw(w) : 0u;
    pv[j] = w < W ? pw(w) : 0u;
    T[j] = 0u;
  }
  const unsigned pinv = bgn_neg_inv32(pw(0));
  unsigned P = 0;                      // carry into word 0 from below
#pragma unroll
  for (int i = 0; i < W; i++) {
    unsigned ai = av[i % S];
    if constexpr (G > 1) ai = __shfl_sync(BGN_MONT_FULL, ai, i / S, G);
    const unsigned cA = bgn_mad_chain<S>(T, ai, bv, P);
    unsigned m = T[0] * pinv;
    if constexpr (G > 1) m = __shfl_sync(BGN_MONT_FULL, m, 0, G);
    const unsigned cB = bgn_mad_chain<S>(T, m, pv, 0u);
    unsigned up = 0;                   // thread t + 1's word 0
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
  if constexpr (G > 1) {               // ripple the pending carries
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
  // T < 2p: subtract p if T >= p.  b0 / b1: this slice's borrow out for
  // a borrow in of 0 / 1 (b1 = slice <= p's slice)
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
  if (!live) return;
#pragma unroll
  for (int j = 0; j < S; j++) {
    const int w = t * S + j;
    if (w < W) {
      out[(size_t)(2 * w) * n + lane] = (int64_t)(T[j] & 0xFFFFu);
      out[(size_t)(2 * w + 1) * n + lane] = (int64_t)(T[j] >> 16);
    }
  }
}

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

__global__ void __launch_bounds__(BGN_MONT_THREADS)
bgn_mont_loop_kernel(const int64_t* __restrict__ a, long long a_sl,
                     long long a_sn, const int64_t* __restrict__ b,
                     long long b_sl, long long b_sn,
                     const int64_t* __restrict__ p, int L,
                     int64_t* __restrict__ out, int n) {
  __shared__ unsigned ps[BGN_MONT_WMAX + 1];
  const int W = (L + 1) / 2, S = W + 1;
  const BgnWords pw{p, 1, L};
  for (int j = threadIdx.x; j < S; j += blockDim.x) ps[j] = j < W ? pw(j) : 0u;
  __syncthreads();
  const int lane = blockIdx.x * BGN_MONT_THREADS + threadIdx.x;
  if (lane >= n) return;
  const BgnWords aw{a + lane * a_sn, a_sl, L}, bw{b + lane * b_sn, b_sl, L};
  const unsigned pinv = bgn_neg_inv32(ps[0]);
  unsigned bv[BGN_MONT_WMAX + 1], T[BGN_MONT_WMAX + 1];
  for (int j = 0; j < S; j++) {
    bv[j] = j < W ? bw(j) : 0u;
    T[j] = 0u;
  }
  for (int i = 0; i < L / 2; i++) {    // full word steps
    const unsigned cA = bgn_mad_loop(T, aw(i), bv, S);
    const unsigned cB = bgn_mad_loop(T, T[0] * pinv, ps, S);
    for (int j = 0; j + 1 < S; j++) T[j] = T[j + 1];
    T[S - 1] = cA + cB;                // < 2: T < 2^32 * 2p before the shift
  }
  if (L & 1) {                         // the half step on limb L - 1
    const unsigned cA =
        bgn_mad_loop(T, (unsigned)aw.v[(long long)(L - 1) * a_sl], bv, S);
    const unsigned cB =
        bgn_mad_loop(T, (T[0] * pinv) & 0xFFFFu, ps, S);
    for (int j = 0; j + 1 < S; j++) T[j] = (T[j] >> 16) | (T[j + 1] << 16);
    T[S - 1] = (T[S - 1] >> 16) | ((cA + cB) << 16);
  }
  int borrow = 0;                      // T < 2p: subtract p if T >= p
  for (int j = 0; j < S; j++) {
    const long long s = (long long)T[j] - ps[j] - borrow;
    borrow = s < 0;
    bv[j] = (unsigned)s;
  }
  const unsigned* r = borrow ? T : bv;
  for (int l = 0; l < L; l++) {
    const unsigned v = r[l >> 1];
    out[(size_t)l * n + lane] = (int64_t)((l & 1 ? v >> 16 : v) & 0xFFFFu);
  }
}

template <int W, int G>
static int bgn_mont_words_launch(const int64_t* a, long long a_sl,
                                 long long a_sn, const int64_t* b,
                                 long long b_sl, long long b_sn,
                                 const int64_t* p, int64_t* out, int n,
                                 cudaStream_t stream) {
  const long long threads = (long long)n * G;
  const int grid = (int)((threads + BGN_MONT_THREADS - 1) / BGN_MONT_THREADS);
  bgn_mont_words_kernel<W, G><<<grid, BGN_MONT_THREADS, 0, stream>>>(
      a, a_sl, a_sn, b, b_sl, b_sn, p, out, n);
  return (int)cudaGetLastError();
}

extern "C" int bgn_mont_mul_loop(const int64_t* a, long long a_sl,
                                 long long a_sn, const int64_t* b,
                                 long long b_sl, long long b_sn,
                                 const int64_t* p, int L, int64_t* out,
                                 int n, cudaStream_t stream) {
  if (L < 1 || L > BGN_MONT_LMAX || n < 1) return (int)cudaErrorInvalidValue;
  const int grid = (n + BGN_MONT_THREADS - 1) / BGN_MONT_THREADS;
  bgn_mont_loop_kernel<<<grid, BGN_MONT_THREADS, 0, stream>>>(
      a, a_sl, a_sn, b, b_sl, b_sn, p, L, out, n);
  return (int)cudaGetLastError();
}

// The kernel for L: a register kernel at the keys' widths (threads per
// lane G), the local-memory loop at every other L.
extern "C" int bgn_mont_mul(const int64_t* a, long long a_sl, long long a_sn,
                            const int64_t* b, long long b_sl, long long b_sn,
                            const int64_t* p, int L, int64_t* out, int n,
                            cudaStream_t stream) {
  if (L < 1 || L > BGN_MONT_LMAX || n < 1) return (int)cudaErrorInvalidValue;
  switch (L) {
    case 34:
      return bgn_mont_words_launch<17, 1>(a, a_sl, a_sn, b, b_sl, b_sn, p,
                                          out, n, stream);
    case 66:
      return bgn_mont_words_launch<33, 8>(a, a_sl, a_sn, b, b_sl, b_sn, p,
                                          out, n, stream);
    case 130:
      return bgn_mont_words_launch<65, 32>(a, a_sl, a_sn, b, b_sl, b_sn, p,
                                           out, n, stream);
    case 258:
      return bgn_mont_words_launch<129, 32>(a, a_sl, a_sn, b, b_sl, b_sn, p,
                                            out, n, stream);
    default:
      return bgn_mont_mul_loop(a, a_sl, a_sn, b, b_sl, b_sn, p, L, out, n,
                               stream);
  }
}
