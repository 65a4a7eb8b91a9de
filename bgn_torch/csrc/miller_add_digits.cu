// One Miller addition step of the limb-domain pairing per launch.
//
// Replaces bgn_tpu/ops/pallas_pairing.py:add_step (_add_step_kernel).  On
// each 1-bit of n the fused Miller loop (ops/pairing.py miller_loop_fused)
// adds the affine A to V = (X, Y, Z), evaluates the line through V and A
// at phi(B) and sets f <- f * line, with the formulas of _add_step_kernel
// (17 Montgomery products, the Karatsuba f-update included).  Inputs and
// outputs are float32 [2L, n] arrays of canonical 8-bit digits of
// Montgomery-form values (R = 2^(16L)), as in miller_dbl_digits.cu, whose
// note on the design (the fields of digits.cuh on the 32-bit words of
// mont_words.cuh: the register form at L = 34 and 64, G threads per lane,
// the loop form at every other L) holds here too.  No completeness
// selects: the only degenerate addition of the loop, the last one, is
// elided by the caller.
//
// Bound on the H100: 17 * 4 (L/2)^2 32-bit multiply-adds per lane
// (counted as in miller_dbl_digits.cu; at L = 34, n = 8192: 161 M,
// 9.6 us); the 14 arrays move 31 MB (9.3 us).
#include <cuda_runtime.h>
#include <stdint.h>

#include "digits.cuh"

// The step on one lane, one field op a statement, as in
// miller_dbl_digits.cu (tests/test_torch_digits_words.py reads them).
template <class Field>
static __device__ __forceinline__ void bgn_miller_add_body(
    const Field& F, const float* vx, const float* vy, const float* vz,
    const float* fr, const float* fi, const float* ax, const float* ay,
    const float* bx, const float* by, float* ox, float* oy, float* oz,
    float* ofr, float* ofi) {
  typename Field::Elem X1, Y1, Z1, XA, YA, t0, t1, t2, t3, t4, t5;
  F.load(X1, vx);
  F.load(Y1, vy);
  F.load(Z1, vz);
  F.load(XA, ax);
  F.load(YA, ay);

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
  F.store(ox, t4);
  F.store(oy, t2);
  F.store(oz, t1);

  // the line through V and A at phi(B): re = R (xb + xa) - Z3 ya,
  // im = Z3 yb (X1, Y1 and Z1 are dead: their arrays take xb, yb, f)
  F.load(X1, bx);
  F.load(Y1, by);
  F.add(t3, X1, XA);
  F.mul(t3, t0, t3);
  F.mul(t5, t1, YA);
  F.sub(t3, t3, t5);                   // l_re
  F.mul(t5, t1, Y1);                   // l_im

  // f <- f * line (Karatsuba)
  F.load(Z1, fr);
  F.load(XA, fi);
  F.mul(t0, Z1, t3);                   // m0 = f_re l_re
  F.mul(t1, XA, t5);                   // m1 = f_im l_im
  F.add(t2, Z1, XA);
  F.add(t4, t3, t5);
  F.mul(t2, t2, t4);                   // m2
  F.sub(t4, t0, t1);                   // f_re = m0 - m1
  F.sub(t2, t2, t0);
  F.sub(t2, t2, t1);                   // f_im = m2 - m0 - m1
  F.store(ofr, t4);
  F.store(ofi, t2);
}

#define BGN_ADD_ARGS                                                         \
  const float *__restrict__ vx, const float *__restrict__ vy,                \
      const float *__restrict__ vz, const float *__restrict__ fr,            \
      const float *__restrict__ fi, const float *__restrict__ ax,            \
      const float *__restrict__ ay, const float *__restrict__ bx,            \
      const float *__restrict__ by, float *__restrict__ ox,                  \
      float *__restrict__ oy, float *__restrict__ oz,                        \
      float *__restrict__ ofr, float *__restrict__ ofi,                      \
      const int64_t *__restrict__ p
#define BGN_ADD_PASS vx, vy, vz, fr, fi, ax, ay, bx, by, ox, oy, oz, ofr, ofi

template <int W, int G>
__global__ void __launch_bounds__(BGN_DIGITS_THREADS)
bgn_miller_add_digits_kernel(BGN_ADD_ARGS, int n) {
  const BgnWordField<W, G> F(p, n);
  bgn_miller_add_body(F, BGN_ADD_PASS);
}

__global__ void __launch_bounds__(BGN_DIGITS_THREADS)
bgn_miller_add_digits_loop_kernel(BGN_ADD_ARGS, int L, int n) {
  __shared__ unsigned ps[BGN_DIGITS_SMAX];
  bgn_load_p_shared(ps, p, L);
  const int lane = blockIdx.x * BGN_DIGITS_THREADS + threadIdx.x;
  if (lane >= n) return;
  bgn_miller_add_body(BgnLoopField(ps, L, n, lane), BGN_ADD_PASS);
}

template <int W, int G>
static int add_launch(BGN_ADD_ARGS, int n, cudaStream_t stream) {
  const long long threads = (long long)n * G;
  const int grid =
      (int)((threads + BGN_DIGITS_THREADS - 1) / BGN_DIGITS_THREADS);
  bgn_miller_add_digits_kernel<W, G><<<grid, BGN_DIGITS_THREADS, 0, stream>>>(
      BGN_ADD_PASS, p, n);
  return (int)cudaGetLastError();
}

// The kernel for L: the register form at L = 34 and 64 (G threads per
// lane), the loop form at every other L.
extern "C" int bgn_miller_add_digits(BGN_ADD_ARGS, int L, int n,
                                     cudaStream_t stream) {
  if (L < 1 || L > BGN_DIGITS_LMAX || n < 1)
    return (int)cudaErrorInvalidValue;
  switch (L) {
    case 34: return add_launch<17, 8>(BGN_ADD_PASS, p, n, stream);
    case 64: return add_launch<32, 32>(BGN_ADD_PASS, p, n, stream);
    default: {
      const int grid = (n + BGN_DIGITS_THREADS - 1) / BGN_DIGITS_THREADS;
      bgn_miller_add_digits_loop_kernel<<<grid, BGN_DIGITS_THREADS, 0,
                                          stream>>>(BGN_ADD_PASS, p, L, n);
      return (int)cudaGetLastError();
    }
  }
}
