// Whole Miller loop f_{n,A}(phi(B)) in one kernel.
//
// Replaces bgn_tpu/ops/pallas_rns.py:miller_loop_whole_pallas
// (_miller_loop_kernel).  The TPU kernel keeps 512-lane tiles of the five
// loop arrays in VMEM scratch; here one warp runs one lane's whole loop
// with X, Y, Z, f_re, f_im in registers (rns.cuh), so nothing is carried
// between blocks and the ragged edge is masked instead of padded.
//
// The digits (signed NAF of n) are shared by every lane, so the branch
// on a digit is uniform.  Leading zero digits are skipped by the start
// index, and the final addition (the vertical line V = -A) is elided, as
// in the TPU kernel.
//
// Bound on the H100: instruction issue of the base extensions (21 r_muls
// per doubling, 17 per addition; see rns.cuh).
#include "rns.cuh"

template <int S>
__global__ void __launch_bounds__(BGN_THREADS)
bgn_miller_loop_kernel(const float* blob, int k, const float* ax,
                       const float* ay, const float* xb, const float* yb,
                       const int* digits, int nd, float* ofr, float* ofi,
                       int n) {
  const RnsConsts c = bgn_load_consts<S>(blob, k);
  const int lane = bgn_lane();
  if (lane >= n) return;
  Fe<S> AX, AY, NAY, XB, YB, X, Y, Z, FR, FI;
  fe_load(c, AX, ax, n, lane);
  fe_load(c, AY, ay, n, lane);
  fe_load(c, XB, xb, n, lane);
  fe_load(c, YB, yb, n, lane);
  fe_neg(c, NAY, AY, 3);             // -A for negative digits
  fe_copy(X, AX);
  fe_copy(Y, AY);
  fe_one(c, Z);
  fe_one(c, FR);
  fe_zero(FI);
  int start = 0;
  while (start < nd && digits[start] == 0) start++;
  if (start == nd) start = 0;
  for (int i = start + 1; i < nd; i++) {
    dbl_step(c, X, Y, Z, FR, FI, XB, YB);
    const int d = digits[i];
    if (i < nd - 1 && d != 0) {
      Fe<S> YA;
      fe_pick(YA, d > 0, AY, NAY);
      add_step(c, X, Y, Z, FR, FI, AX, YA, XB, YB);
    }
  }
  fe_store(c, ofr, FR, n, lane);
  fe_store(c, ofi, FI, n, lane);
}

template <int S>
static int miller_loop_launch(const float* blob, int k, const float* ax,
                              const float* ay, const float* xb,
                              const float* yb, const int* digits, int nd,
                              float* ofr, float* ofi, int n,
                              cudaStream_t stream) {
  dim3 grid;
  size_t smem;
  cudaError_t err = bgn_prepare(bgn_miller_loop_kernel<S>, k, n, &grid, &smem);
  if (err != cudaSuccess) return (int)err;
  bgn_miller_loop_kernel<S><<<grid, BGN_THREADS, smem, stream>>>(
      blob, k, ax, ay, xb, yb, digits, nd, ofr, ofi, n);
  return (int)cudaGetLastError();
}

extern "C" int bgn_miller_loop(const float* blob, int k, int slots,
                               const float* ax, const float* ay,
                               const float* xb, const float* yb,
                               const int* digits, int nd, float* ofr,
                               float* ofi, int n, cudaStream_t stream) {
  return BGN_DISPATCH(slots, k, miller_loop_launch, blob, k, ax, ay, xb, yb,
                      digits, nd, ofr, ofi, n, stream);
}
