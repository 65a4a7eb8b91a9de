// G1 double-and-add ladder base^e over shared MSB-first digits, one kernel.
//
// Replaces bgn_tpu/ops/pallas_rns.py:ladder_loop_pallas
// (_ladder_loop_kernel): csk = C^q1 of the L1 decrypt
// (rns_pairing.scalar_mul_rns).  The TPU kernel keeps 512-lane tiles of
// X, Y, Z in VMEM scratch across a fori_loop and runs the base extensions
// of every product on its matrix unit.  Here one warp runs one lane's
// whole ladder with X, Y, Z and the base in registers (rns.cuh), and a
// block of G lanes runs the base extensions of every product on the
// tensor cores (rns_tc.cuh r_mul_tc), as miller_loop.cu does.  It is
// miller_loop.cu without the line functions and without elision of the
// final addition: every digit is consumed (the caller strips the leading
// +1 and passes the start state), a negative digit adds -A (3p - y), and
// a final-step V == -A gives Z = 0, the identity, which the caller reads
// as such.
//
// The digits (the key's q1_naf) are shared by every lane, so the branch
// on a digit is uniform and all warps of a block run the same products.
// Lanes >= n of the last block run on zeros and store nothing, so every
// warp reaches every barrier of r_mul_tc.  Identity-base lanes carry
// garbage residues that the caller masks; every residue the kernel holds
// is canonical (below its 12-bit modulus) whatever the lane's value, so
// the tensor-core product stays exact on them.
//
// Bound on the H100: see rns_tc.cuh (9 products per doubling, 11 per
// addition).
#include "rns_tc.cuh"

template <int S>
__global__ void __launch_bounds__(32 * TcLanes<S>::G, TcLadder<S>::min_blocks)
bgn_ladder_loop_kernel(const float* blob, const uint4* planes, int k,
                       const float* x, const float* y, const float* z,
                       const float* ax, const float* ay, const int* digits,
                       int nd, float* ox, float* oy, float* oz, int n) {
  const RnsConsts c = bgn_tc_load_consts<S>(blob, planes, k);
  const int lane = blockIdx.x * TcLanes<S>::G + (threadIdx.x >> 5);
  const bool live = lane < n;
  Fe<S> AX, AY, NAY, X, Y, Z;
  if (live) {
    fe_load(c, AX, ax, n, lane);
    fe_load(c, AY, ay, n, lane);
    fe_load(c, X, x, n, lane);
    fe_load(c, Y, y, n, lane);
    fe_load(c, Z, z, n, lane);
  } else {
    fe_zero(AX);
    fe_zero(AY);
    fe_zero(X);
    fe_zero(Y);
    fe_zero(Z);
  }
  fe_neg(c, NAY, AY, 3);             // -A for negative digits
  for (int i = 0; i < nd; i++) {
    dbl_pt<S, MulTc<S>>(c, X, Y, Z);
    const int d = digits[i];
    if (d != 0) {
      Fe<S> YA;
      fe_pick(YA, d > 0, AY, NAY);
      add_pt<S, MulTc<S>>(c, X, Y, Z, AX, YA);
    }
  }
  if (live) {
    fe_store(c, ox, X, n, lane);
    fe_store(c, oy, Y, n, lane);
    fe_store(c, oz, Z, n, lane);
  }
}

template <int S>
static int ladder_loop_launch(const float* blob, const uint4* planes, int k,
                              const float* x, const float* y, const float* z,
                              const float* ax, const float* ay,
                              const int* digits, int nd, float* ox,
                              float* oy, float* oz, int n,
                              cudaStream_t stream) {
  constexpr int G = TcLanes<S>::G;
  const int smem = bgn_tc_layout(k, G).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      bgn_ladder_loop_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  bgn_ladder_loop_kernel<S><<<(n + G - 1) / G, 32 * G, smem, stream>>>(
      blob, planes, k, x, y, z, ax, ay, digits, nd, ox, oy, oz, n);
  return (int)cudaGetLastError();
}

extern "C" int bgn_ladder_loop(const float* blob, const void* planes, int k,
                               int slots, const float* x, const float* y,
                               const float* z, const float* ax,
                               const float* ay, const int* digits, int nd,
                               float* ox, float* oy, float* oz, int n,
                               cudaStream_t stream) {
  const uint4* pl = static_cast<const uint4*>(planes);
  return BGN_DISPATCH(slots, k, ladder_loop_launch, blob, pl, k, x, y, z, ax,
                      ay, digits, nd, ox, oy, oz, n, stream);
}
