// Fixed-base window chain base^e from a radix-R table, one kernel.
//
// Replaces bgn_tpu/ops/pallas_rns.py:window_ladder_tab_pallas
// (_win_ladder_tab_kernel): P^|m| of EncryptDeterministic, and E_det(0)
// behind encrypt_zero and Neg (rns_pairing.fixed_base_mul_rns).  On the
// TPU the window axis is a sequential grid dimension whose accumulator
// lives in VMEM scratch, and row d of window j is picked by a one-hot
// bf16 matmul against the resident selection matrix.  Here one warp walks
// all windows of its lane (rns.cuh win_chain, the chain of dual_ladder.cu)
// and reads row d of window j straight from the [J, R, 2k] float32 table
// (12 MB at 512 bits, L2-resident; a row is one contiguous run).  LSB
// first: live = digit != 0; the first live window sets the accumulator to
// the row (Z = 1), a later one adds it (add_pt); a lane with no live
// window writes X = Y = Z = 0, the identity encoding normalize_rns tests.
// Digits differ per lane but not within a warp, so nothing diverges.
//
// Bound on the H100: instruction issue (11 r_muls per live window after
// the first) and the latency of the per-lane row reads.
#include "rns.cuh"

template <int S>
__global__ void __launch_bounds__(BGN_THREADS)
bgn_window_ladder_tab_kernel(const float* blob, int k, const float* tx,
                             const float* ty, int R, int Jd,
                             const int* digits, float* ox, float* oy,
                             float* oz, int n) {
  const RnsConsts c = bgn_load_consts<S>(blob, k);
  const int lane = bgn_lane();
  if (lane >= n) return;
  Fe<S> X, Y, Z;
  if (!win_chain(c, X, Y, Z, tx, ty, R, digits, 0, Jd, n, lane)) {
    fe_zero(X);
    fe_zero(Y);
    fe_zero(Z);
  }
  fe_store(c, ox, X, n, lane);
  fe_store(c, oy, Y, n, lane);
  fe_store(c, oz, Z, n, lane);
}

template <int S>
static int window_ladder_tab_launch(const float* blob, int k,
                                    const float* tx, const float* ty, int R,
                                    int Jd, const int* digits, float* ox,
                                    float* oy, float* oz, int n,
                                    cudaStream_t stream) {
  dim3 grid;
  size_t smem;
  cudaError_t err =
      bgn_prepare(bgn_window_ladder_tab_kernel<S>, k, n, &grid, &smem);
  if (err != cudaSuccess) return (int)err;
  bgn_window_ladder_tab_kernel<S><<<grid, BGN_THREADS, smem, stream>>>(
      blob, k, tx, ty, R, Jd, digits, ox, oy, oz, n);
  return (int)cudaGetLastError();
}

extern "C" int bgn_window_ladder_tab(const float* blob, int k, int slots,
                                     const float* tx, const float* ty, int R,
                                     int Jd, const int* digits, float* ox,
                                     float* oy, float* oz, int n,
                                     cudaStream_t stream) {
  return BGN_DISPATCH(slots, k, window_ladder_tab_launch, blob, k, tx, ty, R,
                      Jd, digits, ox, oy, oz, n, stream);
}
