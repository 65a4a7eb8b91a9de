// One Miller addition step of the limb-domain pairing per launch.
//
// Replaces bgn_tpu/ops/pallas_pairing.py:add_step (_add_step_kernel).  On
// each 1-bit of n the fused Miller loop (ops/pairing.py miller_loop_fused)
// adds the affine A to V = (X, Y, Z), evaluates the line through V and A
// at phi(B) and sets f <- f * line, with the formulas of _add_step_kernel
// (17 Montgomery products, the Karatsuba f-update included).  Inputs and
// outputs are float32 [2L, n] arrays of canonical 8-bit digits of
// Montgomery-form values (R = 2^(16L)), as in miller_dbl_digits.cu, whose
// note on the design (one thread per lane, the state as 16-bit limbs in
// local memory, the CIOS of mont.cuh, a template on the limb cap) holds
// here too.  No completeness selects: the only degenerate addition of the
// loop, the last one, is elided by the caller.
//
// Bound on the H100: 17 * L^2 32-bit multiply-adds per lane (counted as in
// miller_dbl_digits.cu; at L = 34, n = 8192: 161 M, 9.6 us); the 14 arrays
// move 31 MB (9.3 us).
#include <cuda_runtime.h>
#include <stdint.h>

#include "mont.cuh"

#define BGN_DIGITS_MAX_THREADS 128

template <int LC>
__global__ void __launch_bounds__(BGN_DIGITS_MAX_THREADS)
bgn_miller_add_digits_kernel(
    const float* __restrict__ vx, const float* __restrict__ vy,
    const float* __restrict__ vz, const float* __restrict__ fr,
    const float* __restrict__ fi, const float* __restrict__ ax,
    const float* __restrict__ ay, const float* __restrict__ bx,
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
  unsigned X1[LC], Y1[LC], Z1[LC], XA[LC], YA[LC];
  unsigned t0[LC], t1[LC], t2[LC], t3[LC], t4[LC], t5[LC];
  bgn_load_digits(X1, vx, L, n, lane);
  bgn_load_digits(Y1, vy, L, n, lane);
  bgn_load_digits(Z1, vz, L, n, lane);
  bgn_load_digits(XA, ax, L, n, lane);
  bgn_load_digits(YA, ay, L, n, lane);

  // mixed addition; the temporaries are reused as each value dies
  F.mul(t0, Z1, Z1);                   // ZZ
  F.mul(t1, XA, t0);                   // U2
  F.mul(t0, Z1, t0);                   // ZZZ
  F.mul(t0, YA, t0);                   // S2
  F.sub(t1, t1, X1);                   // H = U2 - X1
  F.sub(t0, t0, Y1);                   // R = S2 - Y1
  F.mul(t2, t1, t1);                   // HH
  F.mul(t3, t1, t2);                   // HHH
  F.mul(t2, X1, t2);                   // V = X1 HH
  F.mul(t4, t0, t0);                   // RR
  F.sub(t4, t4, t3);
  F.sub(t4, t4, t2);
  F.sub(t4, t4, t2);                   // X3 = RR - HHH - 2V
  F.sub(t2, t2, t4);                   // V - X3
  F.mul(t2, t0, t2);
  F.mul(t3, Y1, t3);
  F.sub(t2, t2, t3);                   // Y3 = R (V - X3) - Y1 HHH
  F.mul(t1, Z1, t1);                   // Z3 = Z1 H
  bgn_store_digits(ox, t4, L, n, lane);
  bgn_store_digits(oy, t2, L, n, lane);
  bgn_store_digits(oz, t1, L, n, lane);

  // the line through V and A at phi(B): re = R (xb + xa) - Z3 ya,
  // im = Z3 yb (X1, Y1 and Z1 are dead: their arrays take xb, yb, f)
  bgn_load_digits(X1, bx, L, n, lane);
  bgn_load_digits(Y1, by, L, n, lane);
  F.add(t3, X1, XA);
  F.mul(t3, t0, t3);
  F.mul(t5, t1, YA);
  F.sub(t3, t3, t5);                   // l_re
  F.mul(t5, t1, Y1);                   // l_im

  // f <- f * line (Karatsuba)
  bgn_load_digits(Z1, fr, L, n, lane);
  bgn_load_digits(XA, fi, L, n, lane);
  F.mul(t0, Z1, t3);                   // m0 = f_re l_re
  F.mul(t1, XA, t5);                   // m1 = f_im l_im
  F.add(t2, Z1, XA);
  F.add(t4, t3, t5);
  F.mul(t2, t2, t4);                   // m2
  F.sub(t4, t0, t1);                   // f_re = m0 - m1
  F.sub(t2, t2, t0);
  F.sub(t2, t2, t1);                   // f_im = m2 - m0 - m1
  bgn_store_digits(ofr, t4, L, n, lane);
  bgn_store_digits(ofi, t2, L, n, lane);
}

template <int LC>
static int add_launch(const float* vx, const float* vy, const float* vz,
                      const float* fr, const float* fi, const float* ax,
                      const float* ay, const float* bx, const float* by,
                      float* ox, float* oy, float* oz, float* ofr, float* ofi,
                      const int64_t* p, int pinv, int L, int n, int threads,
                      cudaStream_t stream) {
  const int grid = (n + threads - 1) / threads;
  bgn_miller_add_digits_kernel<LC><<<grid, threads, 0, stream>>>(
      vx, vy, vz, fr, fi, ax, ay, bx, by, ox, oy, oz, ofr, ofi, p,
      (unsigned)pinv, L, n);
  return (int)cudaGetLastError();
}

extern "C" int bgn_miller_add_digits(
    const float* vx, const float* vy, const float* vz, const float* fr,
    const float* fi, const float* ax, const float* ay, const float* bx,
    const float* by, float* ox, float* oy, float* oz, float* ofr, float* ofi,
    const int64_t* p, int pinv, int L, int n, int threads,
    cudaStream_t stream) {
  if (L < 1 || L > 64 || n < 1 || threads < 32
      || threads > BGN_DIGITS_MAX_THREADS || threads % 32)
    return (int)cudaErrorInvalidValue;
  if (L <= 40)
    return add_launch<40>(vx, vy, vz, fr, fi, ax, ay, bx, by, ox, oy, oz, ofr,
                          ofi, p, pinv, L, n, threads, stream);
  return add_launch<64>(vx, vy, vz, fr, fi, ax, ay, bx, by, ox, oy, oz, ofr,
                        ofi, p, pinv, L, n, threads, stream);
}
