// One Jacobian doubling per launch.
//
// Replaces bgn_tpu/ops/pallas_rns.py:pt_dbl_pallas (_pt_dbl_kernel).  In
// the per-step configuration (config.BGNParams(rns_pallas="1")) the G1
// ladder of the L1 decrypt (csk = C^q1, rns_pairing.scalar_mul_rns) runs
// as a host loop over the digits (ops/cuda_rns.py _ladder_chain) with one
// launch of this kernel per digit: rns.cuh dbl_pt, 9 products, result
// bounds (27, 27, 6).  The point crosses device memory between launches
// as the same fp32 residues that ladder_loop.cu keeps in registers, so a
// chain of launches equals that kernel bit for bit.
//
// The design is dbl_step.cu's: one warp per lane, a block of G lanes
// whose base extensions run on the tensor cores (rns_tc.cuh r_mul_tc,
// through dbl_pt's product policy, as ladder_loop.cu calls it), the
// constants' small vectors and the u8 matrix planes in shared memory.
// Every launch runs the ladder's lanes (2048 at the 512-bit decrypt), so
// it takes ladder_loop.cu's blocks per SM, rns_tc.cuh TcLadder.
// r_mul_tc holds four __syncthreads per product, so no warp may leave
// early: lanes >= n of the last block (seven of eight at N = 1) load
// zeros, run all 9 products and store nothing.  Every lane of the ladder
// doubles, so no lane needs a flag.
//
// Bound on the H100: the 9 products, each held by its four barriers and
// the channelwise work between them; besides, per launch every block
// copies the constants to shared memory, and the 6 residue rows of a
// lane cross device memory (about 4.4 MB at N = 2048, 512 bits: ~1.3 us
// at 3.35 TB/s).
#include "rns_tc.cuh"

template <int S>
__global__ void __launch_bounds__(32 * TcLanes<S>::G, TcLadder<S>::min_blocks)
bgn_pt_dbl_kernel(const float* blob, const uint4* planes, int k,
                  const float* x, const float* y, const float* z, float* ox,
                  float* oy, float* oz, int n) {
  const RnsConsts c = bgn_tc_load_consts<S>(blob, planes, k);
  const int lane = blockIdx.x * TcLanes<S>::G + (threadIdx.x >> 5);
  const bool live = lane < n;
  Fe<S> X, Y, Z;
  if (live) {
    fe_load(c, X, x, n, lane);
    fe_load(c, Y, y, n, lane);
    fe_load(c, Z, z, n, lane);
  } else {
    fe_zero(X);
    fe_zero(Y);
    fe_zero(Z);
  }
  dbl_pt<S, MulTc<S>>(c, X, Y, Z);
  if (live) {
    fe_store(c, ox, X, n, lane);
    fe_store(c, oy, Y, n, lane);
    fe_store(c, oz, Z, n, lane);
  }
}

template <int S>
static int pt_dbl_launch(const float* blob, const uint4* planes, int k,
                         const float* x, const float* y, const float* z,
                         float* ox, float* oy, float* oz, int n,
                         cudaStream_t stream) {
  constexpr int G = TcLanes<S>::G;
  const int smem = bgn_tc_layout(k, G).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      bgn_pt_dbl_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  bgn_pt_dbl_kernel<S><<<(n + G - 1) / G, 32 * G, smem, stream>>>(
      blob, planes, k, x, y, z, ox, oy, oz, n);
  return (int)cudaGetLastError();
}

extern "C" int bgn_pt_dbl(const float* blob, const void* planes, int k,
                          int slots, const float* x, const float* y,
                          const float* z, float* ox, float* oy, float* oz,
                          int n, cudaStream_t stream) {
  const uint4* pl = static_cast<const uint4*>(planes);
  return BGN_DISPATCH(slots, k, pt_dbl_launch, blob, pl, k, x, y, z, ox, oy,
                      oz, n, stream);
}
