// One F_p^2 square-and-multiply step per launch:
// (ar, ai) <- (ar + ai i)^2 * (xr + xi i)^bit.
//
// Replaces bgn_tpu/ops/pallas_rns.py:fp2_pow_step_pallas
// (_fp2_pow_kernel).  In the per-step configuration
// (config.BGNParams(rns_pallas="1")) rns_pairing._fp2_pow_bits runs the
// ^l of the final exponentiation (N = the Mult batch) and z^q1 of the L2
// decrypt (N = the decrypt batch) as a host loop over the digits
// (ops/cuda_rns.py _fp2_chain) with one launch per digit; for a -1 digit
// of a unitary x the caller passes conj(x)'s imaginary part, 10p - xi, as
// xi.  The bit is a kernel argument, uniform over the launch.  Bounds:
// acc (9, 9), xr 9, xi 10, the residues that fp2_pow_loop.cu keeps in
// registers, so a chain of launches equals that kernel bit for bit.
//
// The design is fp2_pow_loop.cu's for one digit: one warp per lane, a
// block of G lanes whose base extensions run on the tensor cores
// (rns_tc.cuh r_mul_tc, through fp2_sqr's and fp2_mul's product policy),
// the constants' small vectors and the u8 matrix planes in shared memory.
// The bit is uniform, so every warp runs the same two or five products,
// and lanes >= n of the last block run them on zeros (all four inputs)
// and store nothing: r_mul_tc's four __syncthreads per product admit no
// early return.  It takes fp2_pow_loop's blocks per SM (TcFp2Pow, the
// same state): 1,312 of its 1,344 launches on the per-step paths run at
// the decrypt's N = 2048, where two blocks beat the four of TcLanes and
// TcPow by 3-9 %; four would win by 10-20 % at N = 8192, where 32 run
// (PERF.md §6, the step sweep).
//
// Bound on the H100: at N = batch, the two or five products (their
// barriers and channelwise work) and the constants' copy to shared
// memory in every block; at small N, the launch and that copy.
#include "rns_tc.cuh"

template <int S>
__global__ void __launch_bounds__(32 * TcLanes<S>::G, TcFp2Pow<S>::min_blocks)
bgn_fp2_pow_step_kernel(const float* blob, const uint4* planes, int k,
                        const float* ar, const float* ai, const float* xr,
                        const float* xi, int bit, float* owr, float* owi,
                        int n) {
  const RnsConsts c = bgn_tc_load_consts<S>(blob, planes, k);
  const int lane = blockIdx.x * TcLanes<S>::G + (threadIdx.x >> 5);
  const bool live = lane < n;
  Fe<S> AR, AI;
  if (live) {
    fe_load(c, AR, ar, n, lane);
    fe_load(c, AI, ai, n, lane);
  } else {
    fe_zero(AR);
    fe_zero(AI);
  }
  fp2_sqr<S, MulTc<S>>(c, AR, AI);
  if (bit > 0) {
    Fe<S> XR, XI;
    if (live) {
      fe_load(c, XR, xr, n, lane);
      fe_load(c, XI, xi, n, lane);
    } else {
      fe_zero(XR);
      fe_zero(XI);
    }
    fp2_mul<S, MulTc<S>>(c, AR, AI, XR, XI);
  }
  if (live) {
    fe_store(c, owr, AR, n, lane);
    fe_store(c, owi, AI, n, lane);
  }
}

template <int S>
static int fp2_pow_step_launch(const float* blob, const uint4* planes, int k,
                               const float* ar, const float* ai,
                               const float* xr, const float* xi, int bit,
                               float* owr, float* owi, int n,
                               cudaStream_t stream) {
  constexpr int G = TcLanes<S>::G;
  const int smem = bgn_tc_layout(k, G).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      bgn_fp2_pow_step_kernel<S>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  bgn_fp2_pow_step_kernel<S><<<(n + G - 1) / G, 32 * G, smem, stream>>>(
      blob, planes, k, ar, ai, xr, xi, bit, owr, owi, n);
  return (int)cudaGetLastError();
}

extern "C" int bgn_fp2_pow_step(const float* blob, const void* planes, int k,
                                int slots, const float* ar, const float* ai,
                                const float* xr, const float* xi, int bit,
                                float* owr, float* owi, int n,
                                cudaStream_t stream) {
  const uint4* pl = static_cast<const uint4*>(planes);
  return BGN_DISPATCH(slots, k, fp2_pow_step_launch, blob, pl, k, ar, ai, xr,
                      xi, bit, owr, owi, n, stream);
}
