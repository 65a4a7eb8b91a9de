// One Miller doubling step per launch.
//
// Replaces bgn_tpu/ops/pallas_rns.py:dbl_step_pallas (_dbl_kernel).  The
// per-step configuration (config.BGNParams(rns_pallas="1")) runs the
// Miller loop as a host loop over the digits (ops/cuda_rns.py
// _miller_chain) with one launch of this kernel per step: Jacobian
// doubling of V = (X, Y, Z), the tangent line at phi(B) and
// f <- f^2 * line (rns.cuh dbl_step, 21 r_muls).  One warp per lane loads
// the state, calls dbl_step once and stores the new state in fresh
// outputs.  The state crosses device memory between steps as the same
// fp32 residues (bounds X, Y < 27p, Z < 6p, f < 9p) that miller_loop.cu
// keeps in registers, so a chain of launches equals that kernel bit for
// bit.
//
// Bound on the H100: instruction issue of the r_muls; per launch each
// block also copies the constants to shared memory and the lane's 12
// residue rows move through device memory.
#include "rns.cuh"

template <int S>
__global__ void __launch_bounds__(BGN_THREADS)
bgn_dbl_step_kernel(const float* blob, int k, const float* x, const float* y,
                    const float* z, const float* fr, const float* fi,
                    const float* xb, const float* yb, float* ox, float* oy,
                    float* oz, float* ofr, float* ofi, int n) {
  const RnsConsts c = bgn_load_consts<S>(blob, k);
  const int lane = bgn_lane();
  if (lane >= n) return;
  Fe<S> X, Y, Z, FR, FI, XB, YB;
  fe_load(c, X, x, n, lane);
  fe_load(c, Y, y, n, lane);
  fe_load(c, Z, z, n, lane);
  fe_load(c, FR, fr, n, lane);
  fe_load(c, FI, fi, n, lane);
  fe_load(c, XB, xb, n, lane);
  fe_load(c, YB, yb, n, lane);
  dbl_step(c, X, Y, Z, FR, FI, XB, YB);
  fe_store(c, ox, X, n, lane);
  fe_store(c, oy, Y, n, lane);
  fe_store(c, oz, Z, n, lane);
  fe_store(c, ofr, FR, n, lane);
  fe_store(c, ofi, FI, n, lane);
}

template <int S>
static int dbl_step_launch(const float* blob, int k, const float* x,
                           const float* y, const float* z, const float* fr,
                           const float* fi, const float* xb, const float* yb,
                           float* ox, float* oy, float* oz, float* ofr,
                           float* ofi, int n, cudaStream_t stream) {
  dim3 grid;
  size_t smem;
  cudaError_t err = bgn_prepare(bgn_dbl_step_kernel<S>, k, n, &grid, &smem);
  if (err != cudaSuccess) return (int)err;
  bgn_dbl_step_kernel<S><<<grid, BGN_THREADS, smem, stream>>>(
      blob, k, x, y, z, fr, fi, xb, yb, ox, oy, oz, ofr, ofi, n);
  return (int)cudaGetLastError();
}

extern "C" int bgn_dbl_step(const float* blob, int k, int slots,
                            const float* x, const float* y, const float* z,
                            const float* fr, const float* fi, const float* xb,
                            const float* yb, float* ox, float* oy, float* oz,
                            float* ofr, float* ofi, int n,
                            cudaStream_t stream) {
  return BGN_DISPATCH(slots, k, dbl_step_launch, blob, k, x, y, z, fr, fi, xb,
                      yb, ox, oy, oz, ofr, ofi, n, stream);
}
