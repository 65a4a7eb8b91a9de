// One Miller addition step per launch.
//
// Replaces bgn_tpu/ops/pallas_rns.py:add_step_pallas (_add_kernel).  In
// the per-step configuration (config.BGNParams(rns_pallas="1")) the host
// loop over the Miller digits (ops/cuda_rns.py _miller_chain) launches it
// after the doubling of every nonzero digit but the last: the mixed
// addition V + A (A = (ax, ay), or its negation for a -1 digit, which the
// caller passes as ay), the line through V and A at phi(B) and
// f <- f * line (rns.cuh add_step, 17 products).  The state crosses
// device memory between steps as the same fp32 residues that
// miller_loop.cu keeps in registers, so a chain of launches equals that
// kernel bit for bit.
//
// The design is dbl_step.cu's: one warp per lane, a block of G lanes
// whose base extensions run on the tensor cores (rns_tc.cuh r_mul_tc,
// through add_step's product policy), the constants' small vectors and
// the u8 matrix planes in shared memory.  r_mul_tc holds four
// __syncthreads per product, so no warp may leave early: lanes >= n of
// the last block load zeros, run all 17 products and store nothing.
//
// Bound on the H100: the 17 products, each held by its four barriers and
// the channelwise work between them, as in the Miller kernel; besides,
// per launch every block copies the constants to shared memory, and the
// 14 residue rows of a lane cross device memory (about 41 MB at
// N = 8192, 512 bits: ~12 us at 3.35 TB/s).
#include "rns_tc.cuh"

template <int S>
__global__ void __launch_bounds__(32 * TcLanes<S>::G, TcLanes<S>::min_blocks)
bgn_add_step_kernel(const float* blob, const uint4* planes, int k,
                    const float* x, const float* y, const float* z,
                    const float* fr, const float* fi, const float* ax,
                    const float* ay, const float* xb, const float* yb,
                    float* ox, float* oy, float* oz, float* ofr, float* ofi,
                    int n) {
  const RnsConsts c = bgn_tc_load_consts<S>(blob, planes, k);
  const int lane = blockIdx.x * TcLanes<S>::G + (threadIdx.x >> 5);
  const bool live = lane < n;
  Fe<S> X, Y, Z, FR, FI, AX, AY, XB, YB;
  if (live) {
    fe_load(c, X, x, n, lane);
    fe_load(c, Y, y, n, lane);
    fe_load(c, Z, z, n, lane);
    fe_load(c, FR, fr, n, lane);
    fe_load(c, FI, fi, n, lane);
    fe_load(c, AX, ax, n, lane);
    fe_load(c, AY, ay, n, lane);
    fe_load(c, XB, xb, n, lane);
    fe_load(c, YB, yb, n, lane);
  } else {
    fe_zero(X);
    fe_zero(Y);
    fe_zero(Z);
    fe_zero(FR);
    fe_zero(FI);
    fe_zero(AX);
    fe_zero(AY);
    fe_zero(XB);
    fe_zero(YB);
  }
  add_step<S, MulTc<S>>(c, X, Y, Z, FR, FI, AX, AY, XB, YB);
  if (live) {
    fe_store(c, ox, X, n, lane);
    fe_store(c, oy, Y, n, lane);
    fe_store(c, oz, Z, n, lane);
    fe_store(c, ofr, FR, n, lane);
    fe_store(c, ofi, FI, n, lane);
  }
}

template <int S>
static int add_step_launch(const float* blob, const uint4* planes, int k,
                           const float* x, const float* y, const float* z,
                           const float* fr, const float* fi, const float* ax,
                           const float* ay, const float* xb, const float* yb,
                           float* ox, float* oy, float* oz, float* ofr,
                           float* ofi, int n, cudaStream_t stream) {
  constexpr int G = TcLanes<S>::G;
  const int smem = bgn_tc_layout(k, G).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      bgn_add_step_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  bgn_add_step_kernel<S><<<(n + G - 1) / G, 32 * G, smem, stream>>>(
      blob, planes, k, x, y, z, fr, fi, ax, ay, xb, yb, ox, oy, oz, ofr, ofi,
      n);
  return (int)cudaGetLastError();
}

extern "C" int bgn_add_step(const float* blob, const void* planes, int k,
                            int slots, const float* x, const float* y,
                            const float* z, const float* fr, const float* fi,
                            const float* ax, const float* ay, const float* xb,
                            const float* yb, float* ox, float* oy, float* oz,
                            float* ofr, float* ofi, int n,
                            cudaStream_t stream) {
  const uint4* pl = static_cast<const uint4*>(planes);
  return BGN_DISPATCH(slots, k, add_step_launch, blob, pl, k, x, y, z, fr,
                      fi, ax, ay, xb, yb, ox, oy, oz, ofr, ofi, n, stream);
}
