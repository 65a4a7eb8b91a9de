// One Miller doubling step of the limb-domain pairing per launch.
//
// Replaces bgn_tpu/ops/pallas_pairing.py:dbl_step (_dbl_step_kernel).  The
// fused Miller loop (ops/pairing.py miller_loop_fused, selected by
// config.BGNParams(rns_miller="0") for 2L + 1 <= 129) keeps its state in
// the TPU kernels' digit domain: each F_p element is a float32 array
// [2L, n] of canonical 8-bit digits of its Montgomery form, R = 2^(16L).
// A launch computes the Jacobian doubling of V = (X, Y, Z), the tangent
// line at phi(B) = (-xb, i yb) and f <- f^2 * line with the formulas of
// _dbl_step_kernel (21 Montgomery products, the Karatsuba f-update and the
// scale factors that die in the final exponentiation included), and
// writes the five outputs as canonical digits, so it equals the JAX kernel
// and ops/cuda_pairing.py dbl_step_plain bit for bit.
//
// Design: one thread per lane.  The digits are read once and paired into
// 16-bit limbs (exact: every digit < 256); the state lives as limbs in
// local memory, 14 field elements of LC limbs plus the CIOS accumulator
// (mont.cuh); p sits in shared memory.  The kernel is a template on the
// limb cap LC (40 for 512-bit keys, L = 34; 64 for the widest L the fused
// dispatch sends), so the 512-bit path does not pay for L = 64 in local
// memory.  The TPU kernel's fp32 digit CIOS, its [8, 128] tiling and its
// padding of the batch to 1024 lanes are not carried over.
//
// Bound on the H100: the 21 products are 21 * L^2 32-bit multiply-adds
// per lane, the least a CIOS on L/2 32-bit limbs needs for the same R
// (2 (L/2)^2 wide products, each a low and a high multiply-add; at L = 34,
// n = 8192: 199 M, 11.9 us at 16.7e12 per s); the bytes (12 arrays of 2L
// floats per lane) take 8 us.  The kernel runs far
// above both: every limb of every product goes through local memory.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mont.cuh"

#define BGN_DIGITS_MAX_THREADS 128

template <int LC>
__global__ void __launch_bounds__(BGN_DIGITS_MAX_THREADS)
bgn_miller_dbl_digits_kernel(
    const float* __restrict__ vx, const float* __restrict__ vy,
    const float* __restrict__ vz, const float* __restrict__ fr,
    const float* __restrict__ fi, const float* __restrict__ bx,
    const float* __restrict__ by, float* __restrict__ ox,
    float* __restrict__ oy, float* __restrict__ oz, float* __restrict__ ofr,
    float* __restrict__ ofi, const int64_t* __restrict__ p, unsigned pinv,
    int L, int n) {
  __shared__ unsigned ps[LC];
  for (int j = threadIdx.x; j < L; j += blockDim.x) ps[j] = (unsigned)p[j];
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  unsigned T[2 * LC + 1];
  const BgnField F{ps, pinv, L, T};
  unsigned X[LC], Y[LC], Z[LC], FR[LC], FI[LC], XB[LC], YB[LC];
  unsigned t0[LC], t1[LC], t2[LC], t3[LC], t4[LC], t5[LC], t6[LC];
  bgn_load_digits(X, vx, L, n, lane);
  bgn_load_digits(Y, vy, L, n, lane);
  bgn_load_digits(Z, vz, L, n, lane);
  bgn_load_digits(FR, fr, L, n, lane);
  bgn_load_digits(FI, fi, L, n, lane);
  bgn_load_digits(XB, bx, L, n, lane);
  bgn_load_digits(YB, by, L, n, lane);

  // doubling; the temporaries are reused as each value dies
  F.mul(t0, X, X);                     // XX
  F.mul(t1, Z, Z);                     // ZZ
  F.mul(t2, Z, t1);                    // ZZZ
  F.mul(t1, t1, t1);                   // ZZZZ
  F.mul(t3, Y, Y);                     // YY
  F.mul(t4, t3, t3);                   // YYYY
  F.add(t5, t0, t0);
  F.add(t5, t0, t5);
  F.add(t5, t5, t1);                   // M = 3 XX + ZZZZ
  F.mul(t0, X, t3);                    // X YY
  F.add(t0, t0, t0);
  F.add(t0, t0, t0);                   // S = 4 X YY
  F.mul(t1, t5, t5);                   // MM
  F.sub(t1, t1, t0);
  F.sub(t1, t1, t0);                   // X3 = MM - 2S
  F.add(t4, t4, t4);
  F.add(t4, t4, t4);
  F.add(t4, t4, t4);                   // Y8 = 8 YYYY
  F.sub(t3, t0, t1);                   // S - X3
  F.mul(t3, t5, t3);
  F.sub(t3, t3, t4);                   // Y3 = M (S - X3) - Y8
  F.mul(t0, Y, Z);
  F.add(t0, t0, t0);                   // Z3 = 2 Y Z
  // tangent line at phi(B): re = M (ZZZ xb + X Z) - Z3 Y, im = Z3 ZZZ yb
  F.mul(t4, t2, XB);
  F.mul(t6, X, Z);
  F.add(t4, t4, t6);
  F.mul(t4, t5, t4);
  F.mul(t6, t0, Y);
  F.sub(t4, t4, t6);                   // l_re
  F.mul(t6, t0, t2);
  F.mul(t6, t6, YB);                   // l_im
  bgn_store_digits(ox, t1, L, n, lane);
  bgn_store_digits(oy, t3, L, n, lane);
  bgn_store_digits(oz, t0, L, n, lane);

  // f <- f^2 * line: the square (a + b)(a - b) + 2ab i, then Karatsuba
  F.add(t2, FR, FI);
  F.sub(t5, FR, FI);
  F.mul(t2, t2, t5);                   // sq_re
  F.mul(t5, FR, FI);
  F.add(t5, t5, t5);                   // sq_im
  F.mul(X, t2, t4);                    // m0 = sq_re l_re
  F.mul(Y, t5, t6);                    // m1 = sq_im l_im
  F.add(t2, t2, t5);
  F.add(t4, t4, t6);
  F.mul(Z, t2, t4);                    // m2
  F.sub(FR, X, Y);                     // f_re = m0 - m1
  F.sub(FI, Z, X);
  F.sub(FI, FI, Y);                    // f_im = m2 - m0 - m1
  bgn_store_digits(ofr, FR, L, n, lane);
  bgn_store_digits(ofi, FI, L, n, lane);
}

template <int LC>
static int dbl_launch(const float* vx, const float* vy, const float* vz,
                      const float* fr, const float* fi, const float* bx,
                      const float* by, float* ox, float* oy, float* oz,
                      float* ofr, float* ofi, const int64_t* p, int pinv,
                      int L, int n, int threads, cudaStream_t stream) {
  const int grid = (n + threads - 1) / threads;
  bgn_miller_dbl_digits_kernel<LC><<<grid, threads, 0, stream>>>(
      vx, vy, vz, fr, fi, bx, by, ox, oy, oz, ofr, ofi, p, (unsigned)pinv,
      L, n);
  return (int)cudaGetLastError();
}

extern "C" int bgn_miller_dbl_digits(
    const float* vx, const float* vy, const float* vz, const float* fr,
    const float* fi, const float* bx, const float* by, float* ox, float* oy,
    float* oz, float* ofr, float* ofi, const int64_t* p, int pinv, int L,
    int n, int threads, cudaStream_t stream) {
  if (L < 1 || L > 64 || n < 1 || threads < 32
      || threads > BGN_DIGITS_MAX_THREADS || threads % 32)
    return (int)cudaErrorInvalidValue;
  if (L <= 40)
    return dbl_launch<40>(vx, vy, vz, fr, fi, bx, by, ox, oy, oz, ofr, ofi,
                          p, pinv, L, n, threads, stream);
  return dbl_launch<64>(vx, vy, vz, fr, fi, bx, by, ox, oy, oz, ofr, ofi, p,
                        pinv, L, n, threads, stream);
}
