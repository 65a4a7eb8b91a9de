// One incomplete mixed addition per launch.
//
// Replaces bgn_tpu/ops/pallas_rns.py:pt_add_pallas (_pt_add_kernel).  In
// the per-step configuration (config.BGNParams(rns_pallas="1")) it is the
// addition of two host loops: the G1 ladder of the L1 decrypt
// (ops/cuda_rns.py _ladder_chain, after the doubling of a nonzero digit,
// with A or -A) and the fixed-base window chains of Encrypt and
// EncryptDeterministic (_window_chain, once per window, computed for
// every lane and selected by the caller).  V + A without line math or
// completeness selects (rns.cuh add_pt, 11 products).  The point crosses
// device memory between launches as the same fp32 residues that
// ladder_loop.cu and the window kernels keep in registers.
//
// The design is dbl_step.cu's: one warp per lane, a block of G lanes
// whose base extensions run on the tensor cores (rns_tc.cuh r_mul_tc,
// through add_pt's product policy, as ladder_loop.cu calls it), the
// constants' small vectors and the u8 matrix planes in shared memory.
// r_mul_tc holds four __syncthreads per product, so no warp may leave
// early: lanes >= n of the last block load zeros for all five inputs,
// run all 11 products and store nothing.  Both callers add for every
// lane (the ladder's digit is shared, the window chain selects after the
// launch), so no lane needs a flag.
//
// Bound on the H100: the 11 products, each held by its four barriers and
// the channelwise work between them; besides, per launch every block
// copies the constants to shared memory, and the 8 residue rows of a
// lane cross device memory (about 24 MB at N = 8192, 512 bits: ~7 us at
// 3.35 TB/s).
#include "rns_tc.cuh"

template <int S>
__global__ void __launch_bounds__(32 * TcLanes<S>::G, TcLanes<S>::min_blocks)
bgn_pt_add_kernel(const float* blob, const uint4* planes, int k,
                  const float* x, const float* y, const float* z,
                  const float* ax, const float* ay, float* ox, float* oy,
                  float* oz, int n) {
  const RnsConsts c = bgn_tc_load_consts<S>(blob, planes, k);
  const int lane = blockIdx.x * TcLanes<S>::G + (threadIdx.x >> 5);
  const bool live = lane < n;
  Fe<S> X, Y, Z, AX, AY;
  if (live) {
    fe_load(c, X, x, n, lane);
    fe_load(c, Y, y, n, lane);
    fe_load(c, Z, z, n, lane);
    fe_load(c, AX, ax, n, lane);
    fe_load(c, AY, ay, n, lane);
  } else {
    fe_zero(X);
    fe_zero(Y);
    fe_zero(Z);
    fe_zero(AX);
    fe_zero(AY);
  }
  add_pt<S, MulTc<S>>(c, X, Y, Z, AX, AY);
  if (live) {
    fe_store(c, ox, X, n, lane);
    fe_store(c, oy, Y, n, lane);
    fe_store(c, oz, Z, n, lane);
  }
}

template <int S>
static int pt_add_launch(const float* blob, const uint4* planes, int k,
                         const float* x, const float* y, const float* z,
                         const float* ax, const float* ay, float* ox,
                         float* oy, float* oz, int n, cudaStream_t stream) {
  constexpr int G = TcLanes<S>::G;
  const int smem = bgn_tc_layout(k, G).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      bgn_pt_add_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  bgn_pt_add_kernel<S><<<(n + G - 1) / G, 32 * G, smem, stream>>>(
      blob, planes, k, x, y, z, ax, ay, ox, oy, oz, n);
  return (int)cudaGetLastError();
}

extern "C" int bgn_pt_add(const float* blob, const void* planes, int k,
                          int slots, const float* x, const float* y,
                          const float* z, const float* ax, const float* ay,
                          float* ox, float* oy, float* oz, int n,
                          cudaStream_t stream) {
  const uint4* pl = static_cast<const uint4*>(planes);
  return BGN_DISPATCH(slots, k, pt_add_launch, blob, pl, k, x, y, z, ax, ay,
                      ox, oy, oz, n, stream);
}
