// G1 double-and-add ladder base^e over shared MSB-first digits, one kernel.
//
// Replaces bgn_tpu/ops/pallas_rns.py:ladder_loop_pallas
// (_ladder_loop_kernel): csk = C^q1 of the L1 decrypt
// (rns_pairing.scalar_mul_rns).  The TPU kernel keeps 512-lane tiles of
// X, Y, Z in VMEM scratch across a fori_loop; here one warp runs one
// lane's whole ladder with X, Y, Z and the base in registers (rns.cuh).
// It is miller_loop.cu without the line functions and without elision of
// the final addition: every digit is consumed (the caller strips the
// leading +1 and passes the start state), a negative digit adds -A
// (3p - y), and a final-step V == -A gives Z = 0, the identity, which the
// caller reads as such.  Identity-base lanes carry garbage residues that
// the caller masks; the kernel branches only on the shared digits, so it
// stays exact on them.
//
// Bound on the H100: instruction issue (9 r_muls per doubling, 11 per
// addition; see rns.cuh).
#include "rns.cuh"

template <int S>
__global__ void __launch_bounds__(BGN_THREADS)
bgn_ladder_loop_kernel(const float* blob, int k, const float* x,
                       const float* y, const float* z, const float* ax,
                       const float* ay, const int* digits, int nd, float* ox,
                       float* oy, float* oz, int n) {
  const RnsConsts c = bgn_load_consts<S>(blob, k);
  const int lane = bgn_lane();
  if (lane >= n) return;
  Fe<S> AX, AY, NAY, X, Y, Z;
  fe_load(c, AX, ax, n, lane);
  fe_load(c, AY, ay, n, lane);
  fe_neg(c, NAY, AY, 3);             // -A for negative digits
  fe_load(c, X, x, n, lane);
  fe_load(c, Y, y, n, lane);
  fe_load(c, Z, z, n, lane);
  for (int i = 0; i < nd; i++) {
    dbl_pt(c, X, Y, Z);
    const int d = digits[i];
    if (d != 0) {
      Fe<S> YA;
      fe_pick(YA, d > 0, AY, NAY);
      add_pt(c, X, Y, Z, AX, YA);
    }
  }
  fe_store(c, ox, X, n, lane);
  fe_store(c, oy, Y, n, lane);
  fe_store(c, oz, Z, n, lane);
}

template <int S>
static int ladder_loop_launch(const float* blob, int k, const float* x,
                              const float* y, const float* z,
                              const float* ax, const float* ay,
                              const int* digits, int nd, float* ox,
                              float* oy, float* oz, int n,
                              cudaStream_t stream) {
  dim3 grid;
  size_t smem;
  cudaError_t err = bgn_prepare(bgn_ladder_loop_kernel<S>, k, n, &grid, &smem);
  if (err != cudaSuccess) return (int)err;
  bgn_ladder_loop_kernel<S><<<grid, BGN_THREADS, smem, stream>>>(
      blob, k, x, y, z, ax, ay, digits, nd, ox, oy, oz, n);
  return (int)cudaGetLastError();
}

extern "C" int bgn_ladder_loop(const float* blob, int k, int slots,
                               const float* x, const float* y,
                               const float* z, const float* ax,
                               const float* ay, const int* digits, int nd,
                               float* ox, float* oy, float* oz, int n,
                               cudaStream_t stream) {
  return BGN_DISPATCH(slots, k, ladder_loop_launch, blob, k, x, y, z, ax, ay,
                      digits, nd, ox, oy, oz, n, stream);
}
