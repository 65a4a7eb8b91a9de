// One F_p square-and-multiply step per launch: acc <- acc^2 * x^bit.
//
// Replaces bgn_tpu/ops/pallas_rns.py:pow_step_pallas (_pow_kernel).  In
// the per-step configuration (config.BGNParams(rns_pallas="1"))
// rns_pairing._rns_pow runs every Fermat inversion x^(p-2) (the norm of
// the final exponentiation, N = batch; the batch product of
// normalize_rns and mont_inv_rns, N = 1) as a host loop over the bits
// with one launch per bit.  The bit is a kernel argument, uniform over
// the launch; the TPU kernel computes both products and selects, this
// one skips the multiplication on a 0 bit (the same value).  x bound
// <= 16, acc and the result bound 3, the residues pow_loop.cu keeps in
// registers.
//
// Bound on the H100: at N = batch, instruction issue of the one or two
// r_muls plus the constants' copy to shared memory in every block; at
// N = 1, one warp's latency and the launch itself (host time).
#include "rns.cuh"

template <int S>
__global__ void __launch_bounds__(BGN_THREADS)
bgn_pow_step_kernel(const float* blob, int k, const float* acc,
                    const float* x, int bit, float* out, int n) {
  const RnsConsts c = bgn_load_consts<S>(blob, k);
  const int lane = bgn_lane();
  if (lane >= n) return;
  Fe<S> ACC;
  fe_load(c, ACC, acc, n, lane);
  r_mul(c, ACC, ACC, ACC);
  if (bit > 0) {
    Fe<S> X;
    fe_load(c, X, x, n, lane);
    r_mul(c, ACC, ACC, X);
  }
  fe_store(c, out, ACC, n, lane);
}

template <int S>
static int pow_step_launch(const float* blob, int k, const float* acc,
                           const float* x, int bit, float* out, int n,
                           cudaStream_t stream) {
  dim3 grid;
  size_t smem;
  cudaError_t err = bgn_prepare(bgn_pow_step_kernel<S>, k, n, &grid, &smem);
  if (err != cudaSuccess) return (int)err;
  bgn_pow_step_kernel<S><<<grid, BGN_THREADS, smem, stream>>>(blob, k, acc, x,
                                                              bit, out, n);
  return (int)cudaGetLastError();
}

extern "C" int bgn_pow_step(const float* blob, int k, int slots,
                            const float* acc, const float* x, int bit,
                            float* out, int n, cudaStream_t stream) {
  return BGN_DISPATCH(slots, k, pow_step_launch, blob, k, acc, x, bit, out, n,
                      stream);
}
