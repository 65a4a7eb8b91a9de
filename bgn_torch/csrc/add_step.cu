// One Miller addition step per launch.
//
// Replaces bgn_tpu/ops/pallas_rns.py:add_step_pallas (_add_kernel).  In
// the per-step configuration (config.BGNParams(rns_pallas="1")) the host
// loop over the Miller digits (ops/cuda_rns.py _miller_chain) launches it
// after the doubling of every nonzero digit but the last: the mixed
// addition V + A (A = (ax, ay), or its negation for a -1 digit, which the
// caller passes as ay), the line through V and A at phi(B) and
// f <- f * line (rns.cuh add_step, 17 r_muls).  One warp per lane loads
// the state, calls add_step once and stores the new state in fresh
// outputs, the same fp32 residues that miller_loop.cu keeps in
// registers.
//
// Bound on the H100: instruction issue of the r_muls, plus per launch
// the constants' copy to shared memory and 14 residue rows of the lane
// through device memory.
#include "rns.cuh"

template <int S>
__global__ void __launch_bounds__(BGN_THREADS)
bgn_add_step_kernel(const float* blob, int k, const float* x, const float* y,
                    const float* z, const float* fr, const float* fi,
                    const float* ax, const float* ay, const float* xb,
                    const float* yb, float* ox, float* oy, float* oz,
                    float* ofr, float* ofi, int n) {
  const RnsConsts c = bgn_load_consts<S>(blob, k);
  const int lane = bgn_lane();
  if (lane >= n) return;
  Fe<S> X, Y, Z, FR, FI, AX, AY, XB, YB;
  fe_load(c, X, x, n, lane);
  fe_load(c, Y, y, n, lane);
  fe_load(c, Z, z, n, lane);
  fe_load(c, FR, fr, n, lane);
  fe_load(c, FI, fi, n, lane);
  fe_load(c, AX, ax, n, lane);
  fe_load(c, AY, ay, n, lane);
  fe_load(c, XB, xb, n, lane);
  fe_load(c, YB, yb, n, lane);
  add_step(c, X, Y, Z, FR, FI, AX, AY, XB, YB);
  fe_store(c, ox, X, n, lane);
  fe_store(c, oy, Y, n, lane);
  fe_store(c, oz, Z, n, lane);
  fe_store(c, ofr, FR, n, lane);
  fe_store(c, ofi, FI, n, lane);
}

template <int S>
static int add_step_launch(const float* blob, int k, const float* x,
                           const float* y, const float* z, const float* fr,
                           const float* fi, const float* ax, const float* ay,
                           const float* xb, const float* yb, float* ox,
                           float* oy, float* oz, float* ofr, float* ofi,
                           int n, cudaStream_t stream) {
  dim3 grid;
  size_t smem;
  cudaError_t err = bgn_prepare(bgn_add_step_kernel<S>, k, n, &grid, &smem);
  if (err != cudaSuccess) return (int)err;
  bgn_add_step_kernel<S><<<grid, BGN_THREADS, smem, stream>>>(
      blob, k, x, y, z, fr, fi, ax, ay, xb, yb, ox, oy, oz, ofr, ofi, n);
  return (int)cudaGetLastError();
}

extern "C" int bgn_add_step(const float* blob, int k, int slots,
                            const float* x, const float* y, const float* z,
                            const float* fr, const float* fi, const float* ax,
                            const float* ay, const float* xb, const float* yb,
                            float* ox, float* oy, float* oz, float* ofr,
                            float* ofi, int n, cudaStream_t stream) {
  return BGN_DISPATCH(slots, k, add_step_launch, blob, k, x, y, z, fr, fi, ax,
                      ay, xb, yb, ox, oy, oz, ofr, ofi, n, stream);
}
