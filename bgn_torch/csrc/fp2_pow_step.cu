// One F_p^2 square-and-multiply step per launch:
// (ar, ai) <- (ar + ai i)^2 * (xr + xi i)^bit.
//
// Replaces bgn_tpu/ops/pallas_rns.py:fp2_pow_step_pallas
// (_fp2_pow_kernel).  In the per-step configuration
// (config.BGNParams(rns_pallas="1")) rns_pairing._fp2_pow_bits runs the
// ^l of the final exponentiation and z^q1 of the L2 decrypt as a host
// loop over the digits (ops/cuda_rns.py _fp2_chain) with one launch per
// digit; for a -1 digit of a unitary x the caller passes conj(x)'s
// imaginary part, 10p - xi, as xi.  The bit is a kernel argument, uniform
// over the launch.  Bounds: acc (9, 9), xr 9, xi 10, the residues that
// fp2_pow_loop.cu keeps in registers.
//
// Bound on the H100: instruction issue of the 2 or 5 r_muls plus the
// constants' copy to shared memory in every block (host launch time at
// the decrypt's small batches).
#include "rns.cuh"

template <int S>
__global__ void __launch_bounds__(BGN_THREADS)
bgn_fp2_pow_step_kernel(const float* blob, int k, const float* ar,
                        const float* ai, const float* xr, const float* xi,
                        int bit, float* owr, float* owi, int n) {
  const RnsConsts c = bgn_load_consts<S>(blob, k);
  const int lane = bgn_lane();
  if (lane >= n) return;
  Fe<S> AR, AI;
  fe_load(c, AR, ar, n, lane);
  fe_load(c, AI, ai, n, lane);
  fp2_sqr(c, AR, AI);
  if (bit > 0) {
    Fe<S> XR, XI;
    fe_load(c, XR, xr, n, lane);
    fe_load(c, XI, xi, n, lane);
    fp2_mul(c, AR, AI, XR, XI);
  }
  fe_store(c, owr, AR, n, lane);
  fe_store(c, owi, AI, n, lane);
}

template <int S>
static int fp2_pow_step_launch(const float* blob, int k, const float* ar,
                               const float* ai, const float* xr,
                               const float* xi, int bit, float* owr,
                               float* owi, int n, cudaStream_t stream) {
  dim3 grid;
  size_t smem;
  cudaError_t err =
      bgn_prepare(bgn_fp2_pow_step_kernel<S>, k, n, &grid, &smem);
  if (err != cudaSuccess) return (int)err;
  bgn_fp2_pow_step_kernel<S><<<grid, BGN_THREADS, smem, stream>>>(
      blob, k, ar, ai, xr, xi, bit, owr, owi, n);
  return (int)cudaGetLastError();
}

extern "C" int bgn_fp2_pow_step(const float* blob, int k, int slots,
                                const float* ar, const float* ai,
                                const float* xr, const float* xi, int bit,
                                float* owr, float* owi, int n,
                                cudaStream_t stream) {
  return BGN_DISPATCH(slots, k, fp2_pow_step_launch, blob, k, ar, ai, xr, xi,
                      bit, owr, owi, n, stream);
}
