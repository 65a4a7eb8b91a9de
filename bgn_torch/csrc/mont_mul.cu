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
// and CIOS runs on 32 x 32 -> 64-bit products (mont_words.cuh, shared with
// the two digit-domain Miller step kernels): a quarter of the products of
// 16-bit limbs, with no mask or shift per product.
//
//  - bgn_mont_words_kernel<W, G>: the widths of the keys, L = 2W = 34, 66,
//    130, 258 (512- to 4096-bit keys), the register form of
//    mont_words.cuh: fully unrolled, a lane's words in registers, G
//    threads per lane.
//  - bgn_mont_loop_kernel: every other L, odd L included, the loop form of
//    mont_words.cuh (one thread per lane, b and T in local memory, p in
//    shared memory).  bgn_mont_mul_loop runs it at any L, so chip_smoke.py
//    can time it beside the register kernels.
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

#include "mont_words.cuh"

#define BGN_MONT_LMAX 264              // 4096-bit keys have L = 258
#define BGN_MONT_WMAX 132              // words of BGN_MONT_LMAX limbs
#define BGN_MONT_THREADS 32            // threads per block

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
  }
  const unsigned pinv = bgn_neg_inv32(pw(0));
  bgn_mont_words<W, G, S>(T, av, bv, pv, pinv, t);
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
  bgn_mont_loop_steps(T, aw, bv, ps, pinv, L, S);
  // T < 2p: subtract p if T >= p
  const unsigned* r = bgn_loop_sub_p(T, ps, S, bv) ? T : bv;
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
