// Whole Miller loop f_{n,A}(phi(B)) in one kernel.
//
// Replaces bgn_tpu/ops/pallas_rns.py:miller_loop_whole_pallas
// (_miller_loop_kernel).  The TPU kernel keeps 512-lane tiles of the five
// loop arrays in VMEM scratch and runs the base extensions of every
// product on its matrix unit.  Here one warp runs one lane's whole loop
// with X, Y, Z, f_re, f_im in registers (rns.cuh), so nothing is carried
// between blocks, and a block of G lanes runs the base extensions of
// every product on the tensor cores (rns_tc.cuh r_mul_tc).
//
// The digits (signed NAF of n) are shared by every lane, so the branch
// on a digit is uniform and all warps of a block run the same products.
// Leading zero digits are skipped by the start index, and the final
// addition (the vertical line V = -A) is elided, as in the TPU kernel.
// Lanes >= n of the last block run on zeros and store nothing, so every
// warp reaches every barrier of r_mul_tc.
//
// Bound on the H100: see rns_tc.cuh (21 products per doubling, 17 per
// addition).
#include "rns_tc.cuh"

template <int S>
__global__ void __launch_bounds__(32 * TcLanes<S>::G, TcLanes<S>::min_blocks)
bgn_miller_loop_kernel(const float* blob, const uint4* planes, int k,
                       const float* ax, const float* ay, const float* xb,
                       const float* yb, const int* digits, int nd,
                       float* ofr, float* ofi, int n) {
  const RnsConsts c = bgn_tc_load_consts<S>(blob, planes, k);
  const int lane = blockIdx.x * TcLanes<S>::G + (threadIdx.x >> 5);
  const bool live = lane < n;
  Fe<S> AX, AY, NAY, XB, YB, X, Y, Z, FR, FI;
  if (live) {
    fe_load(c, AX, ax, n, lane);
    fe_load(c, AY, ay, n, lane);
    fe_load(c, XB, xb, n, lane);
    fe_load(c, YB, yb, n, lane);
  } else {
    fe_zero(AX);
    fe_zero(AY);
    fe_zero(XB);
    fe_zero(YB);
  }
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
    dbl_step<S, MulTc<S>>(c, X, Y, Z, FR, FI, XB, YB);
    const int d = digits[i];
    if (i < nd - 1 && d != 0) {
      Fe<S> YA;
      fe_pick(YA, d > 0, AY, NAY);
      add_step<S, MulTc<S>>(c, X, Y, Z, FR, FI, AX, YA, XB, YB);
    }
  }
  if (live) {
    fe_store(c, ofr, FR, n, lane);
    fe_store(c, ofi, FI, n, lane);
  }
}

// Dynamic shared memory of one block of the S-slot kernel.
template <int S>
static int miller_loop_smem(int k) {
  return bgn_tc_layout(k, TcLanes<S>::G).bytes;
}

template <int S>
static int miller_loop_launch(const float* blob, const uint4* planes, int k,
                              const float* ax, const float* ay,
                              const float* xb, const float* yb,
                              const int* digits, int nd, float* ofr,
                              float* ofi, int n, cudaStream_t stream) {
  constexpr int G = TcLanes<S>::G;
  const int smem = miller_loop_smem<S>(k);
  cudaError_t err = cudaFuncSetAttribute(
      bgn_miller_loop_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  bgn_miller_loop_kernel<S><<<(n + G - 1) / G, 32 * G, smem, stream>>>(
      blob, planes, k, ax, ay, xb, yb, digits, nd, ofr, ofi, n);
  return (int)cudaGetLastError();
}

extern "C" int bgn_miller_loop(const float* blob, const void* planes, int k,
                               int slots, const float* ax, const float* ay,
                               const float* xb, const float* yb,
                               const int* digits, int nd, float* ofr,
                               float* ofi, int n, cudaStream_t stream) {
  const uint4* pl = static_cast<const uint4*>(planes);
  return BGN_DISPATCH(slots, k, miller_loop_launch, blob, pl, k, ax, ay, xb,
                      yb, digits, nd, ofr, ofi, n, stream);
}

// The dynamic shared memory of a launch at k channels per base and
// slots = slots_for(k), for the build report.
extern "C" int bgn_miller_loop_smem(int k, int slots) {
  return BGN_DISPATCH(slots, k, miller_loop_smem, k);
}
