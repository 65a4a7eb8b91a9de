// (xr + xi i)^e in F_p^2 over shared MSB-first digits, one kernel.
//
// Replaces bgn_tpu/ops/pallas_rns.py:fp2_pow_loop_pallas
// (_fp2_pow_loop_kernel): the ^l of the final exponentiation (plain bits,
// N = the Mult batch) and z^q1 of the L2 decrypt (signed NAF, N = the
// decrypt batch; a negative digit multiplies by conj(x), valid because x
// is unitary).  One warp runs one lane's chain with the accumulator pair
// in registers, and a block of G lanes runs the base extensions of every
// product on the tensor cores (rns_tc.cuh r_mul_tc, through fp2_sqr's and
// fp2_mul's product policy), as pow_loop.cu does.  The digits are shared
// by every lane, so the branches are uniform and every warp of a block
// runs the same products; lanes >= n of the last block run on zeros and
// store nothing.
//
// Bound on the H100: instruction issue of the products (2 per squaring,
// 3 per multiplication) and their four barriers each; at small batches
// the dependent chain's latency.
#include "rns_tc.cuh"

template <int S>
__global__ void __launch_bounds__(32 * TcLanes<S>::G, TcFp2Pow<S>::min_blocks)
bgn_fp2_pow_loop_kernel(const float* blob, const uint4* planes, int k,
                        const float* xr, const float* xi, const int* digits,
                        int nd, float* owr, float* owi, int n) {
  const RnsConsts c = bgn_tc_load_consts<S>(blob, planes, k);
  const int lane = blockIdx.x * TcLanes<S>::G + (threadIdx.x >> 5);
  const bool live = lane < n;
  Fe<S> XR, XI, NXI, AR, AI;
  if (live) {
    fe_load(c, XR, xr, n, lane);
    fe_load(c, XI, xi, n, lane);
  } else {
    fe_zero(XR);
    fe_zero(XI);
  }
  fe_neg(c, NXI, XI, 10);            // conj: 10p - xi, bound 10
  fe_one(c, AR);
  fe_zero(AI);
  for (int i = 0; i < nd; i++) {
    fp2_sqr<S, MulTc<S>>(c, AR, AI);
    const int d = digits[i];
    if (d != 0) {
      Fe<S> YI;
      fe_pick(YI, d > 0, XI, NXI);
      fp2_mul<S, MulTc<S>>(c, AR, AI, XR, YI);
    }
  }
  if (live) {
    fe_store(c, owr, AR, n, lane);
    fe_store(c, owi, AI, n, lane);
  }
}

template <int S>
static int fp2_pow_loop_launch(const float* blob, const uint4* planes, int k,
                               const float* xr, const float* xi,
                               const int* digits, int nd, float* owr,
                               float* owi, int n, cudaStream_t stream) {
  constexpr int G = TcLanes<S>::G;
  const int smem = bgn_tc_layout(k, G).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      bgn_fp2_pow_loop_kernel<S>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  bgn_fp2_pow_loop_kernel<S><<<(n + G - 1) / G, 32 * G, smem, stream>>>(
      blob, planes, k, xr, xi, digits, nd, owr, owi, n);
  return (int)cudaGetLastError();
}

extern "C" int bgn_fp2_pow_loop(const float* blob, const void* planes, int k,
                                int slots, const float* xr, const float* xi,
                                const int* digits, int nd, float* owr,
                                float* owi, int n, cudaStream_t stream) {
  const uint4* pl = static_cast<const uint4*>(planes);
  return BGN_DISPATCH(slots, k, fp2_pow_loop_launch, blob, pl, k, xr, xi,
                      digits, nd, owr, owi, n, stream);
}
