// One Jacobian doubling per launch.
//
// Replaces bgn_tpu/ops/pallas_rns.py:pt_dbl_pallas (_pt_dbl_kernel).  In
// the per-step configuration (config.BGNParams(rns_pallas="1")) the G1
// ladder of the L1 decrypt (csk = C^q1, rns_pairing.scalar_mul_rns) runs
// as a host loop over the digits (ops/cuda_rns.py _ladder_chain) with one
// launch of this kernel per digit (rns.cuh dbl_pt, 9 r_muls, result
// bounds (27, 27, 6)).  One warp per lane loads X, Y, Z, calls dbl_pt once
// and stores the result in fresh outputs, the same fp32 residues that
// ladder_loop.cu keeps in registers.
//
// Bound on the H100: instruction issue of the r_muls, plus per launch the
// constants' copy to shared memory and 6 residue rows of the lane through
// device memory.
#include "rns.cuh"

template <int S>
__global__ void __launch_bounds__(BGN_THREADS)
bgn_pt_dbl_kernel(const float* blob, int k, const float* x, const float* y,
                  const float* z, float* ox, float* oy, float* oz, int n) {
  const RnsConsts c = bgn_load_consts<S>(blob, k);
  const int lane = bgn_lane();
  if (lane >= n) return;
  Fe<S> X, Y, Z;
  fe_load(c, X, x, n, lane);
  fe_load(c, Y, y, n, lane);
  fe_load(c, Z, z, n, lane);
  dbl_pt(c, X, Y, Z);
  fe_store(c, ox, X, n, lane);
  fe_store(c, oy, Y, n, lane);
  fe_store(c, oz, Z, n, lane);
}

template <int S>
static int pt_dbl_launch(const float* blob, int k, const float* x,
                         const float* y, const float* z, float* ox, float* oy,
                         float* oz, int n, cudaStream_t stream) {
  dim3 grid;
  size_t smem;
  cudaError_t err = bgn_prepare(bgn_pt_dbl_kernel<S>, k, n, &grid, &smem);
  if (err != cudaSuccess) return (int)err;
  bgn_pt_dbl_kernel<S><<<grid, BGN_THREADS, smem, stream>>>(blob, k, x, y, z,
                                                            ox, oy, oz, n);
  return (int)cudaGetLastError();
}

extern "C" int bgn_pt_dbl(const float* blob, int k, int slots, const float* x,
                          const float* y, const float* z, float* ox,
                          float* oy, float* oz, int n, cudaStream_t stream) {
  return BGN_DISPATCH(slots, k, pt_dbl_launch, blob, k, x, y, z, ox, oy, oz, n,
                      stream);
}
