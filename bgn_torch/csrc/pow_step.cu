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
// registers, so a chain of launches equals that kernel bit for bit.
//
// The design is pow_loop.cu's for one bit: one warp per lane, a block of
// G lanes whose base extensions run on the tensor cores (rns_tc.cuh
// r_mul_tc), the constants' small vectors and the u8 matrix planes in
// shared memory.  The bit is uniform, so every warp runs the same one or
// two products, and lanes >= n of the last block (seven of eight at
// N = 1) run them on zeros and store nothing: r_mul_tc's four
// __syncthreads per product admit no early return.
//
// Bound on the H100: at N = batch, the one or two products (their
// barriers and channelwise work) and the constants' copy to shared
// memory in every block; at N = 1, the launch itself, that copy and one
// warp's dependent chain of two products.
#include "rns_tc.cuh"

template <int S>
__global__ void __launch_bounds__(32 * TcLanes<S>::G, TcPow<S>::min_blocks)
bgn_pow_step_kernel(const float* blob, const uint4* planes, int k,
                    const float* acc, const float* x, int bit, float* out,
                    int n) {
  const RnsConsts c = bgn_tc_load_consts<S>(blob, planes, k);
  const int lane = blockIdx.x * TcLanes<S>::G + (threadIdx.x >> 5);
  const bool live = lane < n;
  Fe<S> ACC;
  if (live)
    fe_load(c, ACC, acc, n, lane);
  else
    fe_zero(ACC);
  MulTc<S>::mul(c, ACC, ACC, ACC);
  if (bit > 0) {
    Fe<S> X;
    if (live)
      fe_load(c, X, x, n, lane);
    else
      fe_zero(X);
    MulTc<S>::mul(c, ACC, ACC, X);
  }
  if (live) fe_store(c, out, ACC, n, lane);
}

template <int S>
static int pow_step_launch(const float* blob, const uint4* planes, int k,
                           const float* acc, const float* x, int bit,
                           float* out, int n, cudaStream_t stream) {
  constexpr int G = TcLanes<S>::G;
  const int smem = bgn_tc_layout(k, G).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      bgn_pow_step_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  bgn_pow_step_kernel<S><<<(n + G - 1) / G, 32 * G, smem, stream>>>(
      blob, planes, k, acc, x, bit, out, n);
  return (int)cudaGetLastError();
}

extern "C" int bgn_pow_step(const float* blob, const void* planes, int k,
                            int slots, const float* acc, const float* x,
                            int bit, float* out, int n,
                            cudaStream_t stream) {
  const uint4* pl = static_cast<const uint4*>(planes);
  return BGN_DISPATCH(slots, k, pow_step_launch, blob, pl, k, acc, x, bit,
                      out, n, stream);
}
