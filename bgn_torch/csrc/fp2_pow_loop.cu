// (xr + xi i)^e in F_p^2 over shared MSB-first digits, one kernel.
//
// Replaces bgn_tpu/ops/pallas_rns.py:fp2_pow_loop_pallas
// (_fp2_pow_loop_kernel): the ^l of the final exponentiation (plain bits)
// and z^q1 of the L2 decrypt (signed NAF; a negative digit multiplies by
// conj(x), valid because x is unitary).  One warp per lane, the
// accumulator pair in registers, uniform branches on shared digits.
//
// Bound on the H100: instruction issue (2 r_muls per squaring, 3 per
// multiplication).
#include "rns.cuh"

template <int S>
__global__ void __launch_bounds__(BGN_THREADS)
bgn_fp2_pow_loop_kernel(const float* blob, int k, const float* xr,
                        const float* xi, const int* digits, int nd,
                        float* owr, float* owi, int n) {
  const RnsConsts c = bgn_load_consts<S>(blob, k);
  const int lane = bgn_lane();
  if (lane >= n) return;
  Fe<S> XR, XI, NXI, AR, AI;
  fe_load(c, XR, xr, n, lane);
  fe_load(c, XI, xi, n, lane);
  fe_neg(c, NXI, XI, 10);            // conj: 10p - xi, bound 10
  fe_one(c, AR);
  fe_zero(AI);
  for (int i = 0; i < nd; i++) {
    fp2_sqr(c, AR, AI);
    const int d = digits[i];
    if (d != 0) {
      Fe<S> YI;
      fe_pick(YI, d > 0, XI, NXI);
      fp2_mul(c, AR, AI, XR, YI);
    }
  }
  fe_store(c, owr, AR, n, lane);
  fe_store(c, owi, AI, n, lane);
}

template <int S>
static int fp2_pow_loop_launch(const float* blob, int k, const float* xr,
                               const float* xi, const int* digits, int nd,
                               float* owr, float* owi, int n,
                               cudaStream_t stream) {
  dim3 grid;
  size_t smem;
  cudaError_t err =
      bgn_prepare(bgn_fp2_pow_loop_kernel<S>, k, n, &grid, &smem);
  if (err != cudaSuccess) return (int)err;
  bgn_fp2_pow_loop_kernel<S><<<grid, BGN_THREADS, smem, stream>>>(
      blob, k, xr, xi, digits, nd, owr, owi, n);
  return (int)cudaGetLastError();
}

extern "C" int bgn_fp2_pow_loop(const float* blob, int k, int slots,
                                const float* xr, const float* xi,
                                const int* digits, int nd, float* owr,
                                float* owi, int n, cudaStream_t stream) {
  return BGN_DISPATCH(slots, k, fp2_pow_loop_launch, blob, k, xr, xi, digits,
                      nd, owr, owi, n, stream);
}
