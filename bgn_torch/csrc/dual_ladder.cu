// Randomized-Encrypt core C = P^(+-m) * Q^r in one kernel.
//
// Replaces bgn_tpu/ops/pallas_rns.py:dual_ladder_pallas
// (_dual_ladder_kernel with _jac_add_full).  On the TPU the window axis
// is a sequential grid dimension whose accumulators live in VMEM scratch
// between grid steps, and table rows are picked by a one-hot bf16 matmul.
// Here one warp walks all windows of its lane (rns.cuh win_chain):
// windows j < Jm add row d of P's table j into chain 1, the others row d
// of Q's table j - Jm into chain 2, each row read directly from the
// [J, R, 2k] float32 residue tables (about 24 MB at 512 bits, so they
// stay in the 50 MB L2; the warp reads a row as consecutive words).
// Digits differ per lane but not within a warp, so nothing diverges; a
// lane computes only the additions its flags keep, which gives the same
// values as the TPU kernel's compute-then-select.
//
// Flags follow the TPU kernel exactly: live = (digit != 0); the first
// live window of a chain sets the accumulator to the row (Z = 1), later
// live windows add it; m_neg negates chain 1's Y (27p - y) before the
// combine; a lane with neither chain live writes Z = 0 (the identity).
//
// Bound on the H100: instruction issue (11 r_muls per live window, 16 for
// the combine) and the latency of the per-lane row gather.
#include "rns.cuh"

template <int S>
__global__ void __launch_bounds__(BGN_THREADS)
bgn_dual_ladder_kernel(const float* blob, int k, const float* ptx,
                       const float* pty, const float* qtx, const float* qty,
                       int R, int Jm, int Jt, const int* digits,
                       const int* mneg, float* ox, float* oy, float* oz,
                       int n) {
  const RnsConsts c = bgn_load_consts<S>(blob, k);
  const int lane = bgn_lane();
  if (lane >= n) return;
  Fe<S> X1, Y1, Z1, X2, Y2, Z2;
  const bool st1 =
      win_chain(c, X1, Y1, Z1, ptx, pty, R, digits, 0, Jm, n, lane);
  const bool st2 =
      win_chain(c, X2, Y2, Z2, qtx, qty, R, digits, Jm, Jt, n, lane);
  if (st1 && mneg[lane]) fe_neg(c, Y1, Y1, 27);
  if (st1 && st2) {
    jac_add_full(c, X1, Y1, Z1, X2, Y2, Z2);
  } else if (!st1) {
    if (st2) {
      fe_copy(X1, X2);
      fe_copy(Y1, Y2);
      fe_copy(Z1, Z2);
    } else {
      fe_zero(X1);
      fe_zero(Y1);
      fe_zero(Z1);
    }
  }
  fe_store(c, ox, X1, n, lane);
  fe_store(c, oy, Y1, n, lane);
  fe_store(c, oz, Z1, n, lane);
}

template <int S>
static int dual_ladder_launch(const float* blob, int k, const float* ptx,
                              const float* pty, const float* qtx,
                              const float* qty, int R, int Jm, int Jt,
                              const int* digits, const int* mneg, float* ox,
                              float* oy, float* oz, int n,
                              cudaStream_t stream) {
  dim3 grid;
  size_t smem;
  cudaError_t err = bgn_prepare(bgn_dual_ladder_kernel<S>, k, n, &grid, &smem);
  if (err != cudaSuccess) return (int)err;
  bgn_dual_ladder_kernel<S><<<grid, BGN_THREADS, smem, stream>>>(
      blob, k, ptx, pty, qtx, qty, R, Jm, Jt, digits, mneg, ox, oy, oz, n);
  return (int)cudaGetLastError();
}

extern "C" int bgn_dual_ladder(const float* blob, int k, int slots,
                               const float* ptx, const float* pty,
                               const float* qtx, const float* qty, int R,
                               int Jm, int Jt, const int* digits,
                               const int* mneg, float* ox, float* oy,
                               float* oz, int n, cudaStream_t stream) {
  return BGN_DISPATCH(slots, k, dual_ladder_launch, blob, k, ptx, pty, qtx,
                      qty, R, Jm, Jt, digits, mneg, ox, oy, oz, n, stream);
}
