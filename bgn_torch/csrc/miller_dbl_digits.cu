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
// Design (digits.cuh, mont_words.cuh): the digits are read once, four rows
// to a 32-bit word, and every product is CIOS on 32-bit words.  The
// kernel is a template on the field: at L = 34 (512-bit keys) and L = 64
// (the widest L the fused dispatch sends) the register form
// bgn_miller_dbl_digits_kernel<W, G>, fully unrolled, each live value of
// the lane held as S = ceil((W + 1) / G) words in each of G threads'
// registers; at every other L <= 64, odd L included,
// bgn_miller_dbl_digits_loop_kernel, one thread per lane with its values
// in local memory.  G and the threads per block come from the sweep of
// scripts/kernel_variants.py --kernels digits (PERF.md §6): G = 8 at
// L = 34 and 32 at L = 64 (more threads per lane shorten each lane's
// dependent chains, which set the time; fewer spilled or waited), 128
// threads per block (64 and 256 were within the noise).  The TPU
// kernel's fp32 digit CIOS, its [8, 128] tiling and its padding of the
// batch to 1024 lanes are not carried over.
//
// Bound on the H100: the 21 products are 21 * 4 (L/2)^2 32-bit
// multiply-adds per lane (2 (L/2)^2 wide products, a low and a high
// multiply-add each; at L = 34, n = 8192: 199 M, 11.9 us at 16.7e12 per
// s); the bytes (12 arrays of 2L floats per lane, 26.7 MB) take 8 us.
#include <cuda_runtime.h>
#include <stdint.h>

#include "digits.cuh"

// The step on one lane; F: BgnWordField<W, G> or BgnLoopField.  Each
// statement is one field op (F.load, F.mul, F.add, F.sub, F.store), in
// the order of the TPU kernel; tests/test_torch_digits_words.py reads
// them from here and runs them on its emulation of the field.
template <class Field>
static __device__ __forceinline__ void bgn_miller_dbl_body(
    const Field& F, const float* vx, const float* vy, const float* vz,
    const float* fr, const float* fi, const float* bx, const float* by,
    float* ox, float* oy, float* oz, float* ofr, float* ofi) {
  typename Field::Elem X, Y, Z, FR, FI, XB, YB, t0, t1, t2, t3, t4, t5, t6;
  F.load(X, vx);
  F.load(Y, vy);
  F.load(Z, vz);

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
  F.load(XB, bx);
  F.load(YB, by);
  F.mul(t4, t2, XB);
  F.mul(t6, X, Z);
  F.add(t4, t4, t6);
  F.mul(t4, t5, t4);
  F.mul(t6, t0, Y);
  F.sub(t4, t4, t6);                   // l_re
  F.mul(t6, t0, t2);
  F.mul(t6, t6, YB);                   // l_im
  F.store(ox, t1);
  F.store(oy, t3);
  F.store(oz, t0);

  // f <- f^2 * line: the square (a + b)(a - b) + 2ab i, then Karatsuba
  F.load(FR, fr);
  F.load(FI, fi);
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
  F.store(ofr, FR);
  F.store(ofi, FI);
}

#define BGN_DBL_ARGS                                                         \
  const float *__restrict__ vx, const float *__restrict__ vy,                \
      const float *__restrict__ vz, const float *__restrict__ fr,            \
      const float *__restrict__ fi, const float *__restrict__ bx,            \
      const float *__restrict__ by, float *__restrict__ ox,                  \
      float *__restrict__ oy, float *__restrict__ oz,                        \
      float *__restrict__ ofr, float *__restrict__ ofi,                      \
      const int64_t *__restrict__ p
#define BGN_DBL_PASS vx, vy, vz, fr, fi, bx, by, ox, oy, oz, ofr, ofi

template <int W, int G>
__global__ void __launch_bounds__(BGN_DIGITS_THREADS)
bgn_miller_dbl_digits_kernel(BGN_DBL_ARGS, int n) {
  const BgnWordField<W, G> F(p, n);
  bgn_miller_dbl_body(F, BGN_DBL_PASS);
}

__global__ void __launch_bounds__(BGN_DIGITS_THREADS)
bgn_miller_dbl_digits_loop_kernel(BGN_DBL_ARGS, int L, int n) {
  __shared__ unsigned ps[BGN_DIGITS_SMAX];
  bgn_load_p_shared(ps, p, L);
  const int lane = blockIdx.x * BGN_DIGITS_THREADS + threadIdx.x;
  if (lane >= n) return;
  bgn_miller_dbl_body(BgnLoopField(ps, L, n, lane), BGN_DBL_PASS);
}

template <int W, int G>
static int dbl_launch(BGN_DBL_ARGS, int n, cudaStream_t stream) {
  const long long threads = (long long)n * G;
  const int grid =
      (int)((threads + BGN_DIGITS_THREADS - 1) / BGN_DIGITS_THREADS);
  bgn_miller_dbl_digits_kernel<W, G><<<grid, BGN_DIGITS_THREADS, 0, stream>>>(
      BGN_DBL_PASS, p, n);
  return (int)cudaGetLastError();
}

// The kernel for L: the register form at L = 34 and 64 (G threads per
// lane), the loop form at every other L.
extern "C" int bgn_miller_dbl_digits(BGN_DBL_ARGS, int L, int n,
                                     cudaStream_t stream) {
  if (L < 1 || L > BGN_DIGITS_LMAX || n < 1)
    return (int)cudaErrorInvalidValue;
  switch (L) {
    case 34: return dbl_launch<17, 8>(BGN_DBL_PASS, p, n, stream);
    case 64: return dbl_launch<32, 32>(BGN_DBL_PASS, p, n, stream);
    default: {
      const int grid = (n + BGN_DIGITS_THREADS - 1) / BGN_DIGITS_THREADS;
      bgn_miller_dbl_digits_loop_kernel<<<grid, BGN_DIGITS_THREADS, 0,
                                          stream>>>(BGN_DBL_PASS, p, L, n);
      return (int)cudaGetLastError();
    }
  }
}
