// The exit of the RNS path as one kernel: RNS Montgomery residues
// [2k, N] -> canonical limb Montgomery form, int64 [L, N] < p, for one
// or two halves (an F_p^2 element's real and imaginary parts) in one
// launch.  Specification: fieldcore/rns.py from_rns_mont, the plain
// version (ops/cuda_rns.py rns_exit_plain: r_mul by c_out, then
// rns_to_limbs).
//
// It replaces no TPU kernel: the JAX package leaves the exit to XLA.
// As torch ops it was ~530 launches a call at 512 bits and ~900 at 1024
// (a float64 matmul, a Python carry loop over the 8-bit rows, two limb
// subtractions), each a few microseconds of the card and 10-20 of the
// host; at the end of a Mult nothing is queued behind them, so the card
// idled while the host issued them (PERF.md §5).
//
// Per lane, what the plain version computes:
//  1. r = x * c_out / A (c_out: residues of R mod p) by the RNS Montgomery
//     product r_mul_tc (rns_tc.cuh): the value x*R/A mod-ish p, below 3p;
//  2. xhat_i = r_i * (A/a_i)^-1 mod a_i over base A;
//  3. alpha = floor(sum_i xhat_i / a_i + 1/2): for k <= 64 an int32 sum of
//     the weights round(2^19/a_i) times xhat_i, scaled in double; above,
//     a double sum against the fp32 reciprocals (rns.cuh's audit: exact
//     in any order); both are the plain version's integer;
//  4. T_d = sum_i xhat_i * byte_d(A/a_i) - alpha * byte_d(A) for the d8
//     8-bit rows (int32: |T_d| < k * 255 * 4095 + 256 k);
//  5. the signed carry ripple over the rows, the digits packed two to a
//     16-bit limb (L + 1 limbs, rows past them dropped), and two
//     conditional subtractions of p.
// The value is exact and below 3p, so the result is its unique canonical
// form: the plain version's limbs bit for bit.
//
// Shape: blocks of G lanes, a warp per lane, as every RNS kernel (the
// product's base extensions run on the tensor cores for the block);
// grid.y is the half.  Step 4 spreads the rows over the warp's threads
// (the rows' bytes through the read-only cache, xhat broadcast from
// shared memory); step 5 carries from row to row and runs on one thread
// of the warp.  Steps 2-5 keep their scratch where the product's matrix
// planes were, once every warp of the block is past its product, so the
// block needs no more shared memory than the product.  The block stores
// its lanes' limbs together: G consecutive int64 a limb row.
//
// On the H100 (PERF.md §6 row 18): 0.090 ms for both halves of a 512-bit
// Mult of 8,192 lanes against 0.0031 ms for its bytes, 0.071 ms at the
// 1024-bit key's 2,112 lanes, 0.016 ms for one lane at S = 4 and 0.074 at
// S = 12, where every block first copies ~200 KB of constants and planes
// into shared memory.  Which of the per-block copy (26 KB for 8 lanes at
// S = 4) and the carry on one thread a lane holds the wide batches was not
// measured: against the ~25 ms of issue it replaces the time is small.
#include "rns_tc.cuh"

// Word offsets of the exit blob (cuda_rns.exit_blob), mirrored by
// cuda_rns.exit_layout: c_out and crt_inv_a as float bits, the rest as
// ints; crt holds byte d of A/a_i at byte i * crt_stride + d.
struct ExitLayout {
  int d8;                      // 8-bit rows of the CRT sum
  int c_out, crt_inv_a, w_alpha, a_rows, p_limbs, crt, crt_stride, words;
};

static __host__ __device__ inline ExitLayout bgn_exit_layout(int k, int L) {
  ExitLayout e;
  int o = 0;
  e.d8 = (12 * k + 7) / 8 + 1;
  e.c_out = o; o += 2 * k;
  e.crt_inv_a = o; o += k;
  e.w_alpha = o; o += k;
  e.a_rows = o; o += e.d8;
  e.p_limbs = o; o += L + 1;
  e.crt_stride = (e.d8 + 3) / 4 * 4;
  e.crt = o; o += k * e.crt_stride / 4;
  e.words = o;
  return e;
}

// Words of one warp's scratch: xhat [k], T [d8], limbs [L + 1].
static __host__ __device__ inline int bgn_exit_scratch(int k, int L) {
  return k + bgn_exit_layout(k, L).d8 + L + 1;
}

template <int S>
__global__ void __launch_bounds__(32 * TcLanes<S>::G, TcPow<S>::min_blocks)
bgn_rns_exit_kernel(const float* blob, const uint4* planes, int k,
                    const int* xb, int L, const float* x0, const float* x1,
                    long long* out, int n) {
  constexpr int G = TcLanes<S>::G;
  const RnsConsts c = bgn_tc_load_consts<S>(blob, planes, k);
  const ExitLayout e = bgn_exit_layout(k, L);
  const float* xf = reinterpret_cast<const float*>(xb);
  const int warp = threadIdx.x >> 5;
  const int lane = blockIdx.x * G + warp;
  Fe<S> X, C;
  if (lane < n)
    fe_load(c, X, blockIdx.y ? x1 : x0, n, lane);
  else
    fe_zero(X);
  fe_gather(c, C, xf + e.c_out);
  X = r_mul_tc<S>(k, X, C);
  __syncthreads();             // every warp has read its sums: planes free
  const int sw = bgn_exit_scratch(k, L);
  int* const scratch =
      reinterpret_cast<int*>(bgn_tc_smem + bgn_tc_layout(k, G).planes);
  int* const xh = scratch + warp * sw;
  int* const T = xh + k;
  int* const lim = T + e.d8;
  const bool wide = S > 4 && k > BGN_KNARROW;
  int s1 = 0;
  double w1 = 0.0;
#pragma unroll
  for (int s = 0; s < S; s++) {
    const int ch = BGN_CH(c, s);
    if (ch < k) {
      const float r = BGN_F(c.recip + ch);
      const int q = (int)bgn_red(__fmul_rn(X.v[s], xf[e.crt_inv_a + ch]),
                                 BGN_F(c.m + ch), r);
      xh[ch] = q;
      if (wide)
        w1 += (double)q * (double)r;
      else
        s1 += xb[e.w_alpha + ch] * q;
    }
  }
  const int alpha = wide ? (int)floor(warp_sum(w1) + 0.5)
                         : bgn_alpha(warp_sum(s1), 0.5);
  __syncwarp();
  const unsigned char* crt =
      reinterpret_cast<const unsigned char*>(xb + e.crt);
  for (int d = c.lid; d < e.d8; d += 32) {
    int acc = 0;
    for (int i = 0; i < k; i++)
      acc += (int)__ldg(crt + i * e.crt_stride + d) * xh[i];
    T[d] = acc - alpha * xb[e.a_rows + d];
  }
  __syncwarp();
  if (c.lid == 0) {
    const int n16 = L + 1;
    for (int i = 0; i < n16; i++) lim[i] = 0;
    int carry = 0;
    for (int j = 0; j < e.d8; j++) {
      const int t = T[j] + carry;
      carry = t >> 8;                          // arithmetic: floor(t / 256)
      if (j < 2 * n16) lim[j >> 1] += (t - carry * 256) << (8 * (j & 1));
    }
    const int* p = xb + e.p_limbs;
    for (int round = 0; round < 2; round++) {
      int borrow = 0;                          // lim < p?
      for (int i = 0; i < n16; i++) borrow = lim[i] - p[i] - borrow < 0;
      if (borrow) break;                       // and so in the next round
      for (int i = 0; i < n16; i++) {
        const int t = lim[i] - p[i] - borrow;
        borrow = t < 0;
        lim[i] = t + borrow * 65536;
      }
    }
  }
  __syncthreads();
  long long* o = out + (size_t)blockIdx.y * L * n;
  const int* limbs = scratch + k + e.d8;
  for (int idx = threadIdx.x; idx < L * G; idx += blockDim.x) {
    const int i = idx / G, w = idx % G, ln = blockIdx.x * G + w;
    if (ln < n) o[(size_t)i * n + ln] = limbs[w * sw + i];
  }
}

template <int S>
static int rns_exit_launch(const float* blob, const uint4* planes, int k,
                           const int* xb, int L, const float* x0,
                           const float* x1, long long* out, int n,
                           int halves, cudaStream_t stream) {
  constexpr int G = TcLanes<S>::G;
  const TcLayout t = bgn_tc_layout(k, G);
  const int need = t.planes + 4 * G * bgn_exit_scratch(k, L);
  const int smem = need > t.bytes ? need : t.bytes;
  cudaError_t err = cudaFuncSetAttribute(
      bgn_rns_exit_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + G - 1) / G, halves);
  bgn_rns_exit_kernel<S><<<grid, 32 * G, smem, stream>>>(
      blob, planes, k, xb, L, x0, x1, out, n);
  return (int)cudaGetLastError();
}

// x1 is read only with halves == 2; out is [halves, L, n].
extern "C" int bgn_rns_exit(const float* blob, const void* planes, int k,
                            int slots, const int* xb, int L, const float* x0,
                            const float* x1, long long* out, int n,
                            int halves, cudaStream_t stream) {
  if (halves < 1 || halves > 2) return (int)cudaErrorInvalidValue;
  const uint4* pl = static_cast<const uint4*>(planes);
  return BGN_DISPATCH(slots, k, rns_exit_launch, blob, pl, k, xb, L, x0, x1,
                      out, n, halves, stream);
}
