// One incomplete mixed addition per launch.
//
// Replaces bgn_tpu/ops/pallas_rns.py:pt_add_pallas (_pt_add_kernel).  In
// the per-step configuration (config.BGNParams(rns_pallas="1")) it is the
// addition of two host loops: the G1 ladder of the L1 decrypt
// (ops/cuda_rns.py _ladder_chain, after the doubling of a nonzero digit,
// with A or -A) and the fixed-base window chains of Encrypt and
// EncryptDeterministic (_window_chain, once per window, computed for
// every lane and selected by the caller).  V + A without line math or
// completeness selects (rns.cuh add_pt, 11 r_muls).  One warp per lane
// loads X, Y, Z and A, calls add_pt once and stores the result in fresh
// outputs, the same fp32 residues that ladder_loop.cu and the window
// kernels keep in registers.
//
// Bound on the H100: instruction issue of the r_muls, plus per launch the
// constants' copy to shared memory and 8 residue rows of the lane through
// device memory.
#include "rns.cuh"

template <int S>
__global__ void __launch_bounds__(BGN_THREADS)
bgn_pt_add_kernel(const float* blob, int k, const float* x, const float* y,
                  const float* z, const float* ax, const float* ay, float* ox,
                  float* oy, float* oz, int n) {
  const RnsConsts c = bgn_load_consts<S>(blob, k);
  const int lane = bgn_lane();
  if (lane >= n) return;
  Fe<S> X, Y, Z, AX, AY;
  fe_load(c, X, x, n, lane);
  fe_load(c, Y, y, n, lane);
  fe_load(c, Z, z, n, lane);
  fe_load(c, AX, ax, n, lane);
  fe_load(c, AY, ay, n, lane);
  add_pt(c, X, Y, Z, AX, AY);
  fe_store(c, ox, X, n, lane);
  fe_store(c, oy, Y, n, lane);
  fe_store(c, oz, Z, n, lane);
}

template <int S>
static int pt_add_launch(const float* blob, int k, const float* x,
                         const float* y, const float* z, const float* ax,
                         const float* ay, float* ox, float* oy, float* oz,
                         int n, cudaStream_t stream) {
  dim3 grid;
  size_t smem;
  cudaError_t err = bgn_prepare(bgn_pt_add_kernel<S>, k, n, &grid, &smem);
  if (err != cudaSuccess) return (int)err;
  bgn_pt_add_kernel<S><<<grid, BGN_THREADS, smem, stream>>>(
      blob, k, x, y, z, ax, ay, ox, oy, oz, n);
  return (int)cudaGetLastError();
}

extern "C" int bgn_pt_add(const float* blob, int k, int slots, const float* x,
                          const float* y, const float* z, const float* ax,
                          const float* ay, float* ox, float* oy, float* oz,
                          int n, cudaStream_t stream) {
  return BGN_DISPATCH(slots, k, pt_add_launch, blob, k, x, y, z, ax, ay, ox,
                      oy, oz, n, stream);
}
