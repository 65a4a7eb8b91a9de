// Randomized-Encrypt core C = P^(+-m) * Q^r in one kernel.
//
// Replaces bgn_tpu/ops/pallas_rns.py:dual_ladder_pallas
// (_dual_ladder_kernel with _jac_add_full).  On the TPU the window axis
// is a sequential grid dimension whose accumulators live in VMEM scratch
// between grid steps, and table rows are picked by a one-hot bf16 matmul.
// Here one warp per lane walks all windows of its lane in a loop, in
// blocks of G lanes whose base extensions run on the tensor cores
// (rns_tc.cuh r_mul_tc): windows j < Jm add row d of P's table j into
// chain 1, the others row d of Q's table j - Jm into chain 2, each row
// read directly from the [J, R, 2k] float32 residue tables (about 24 MB
// at 512 bits, so they stay in the 50 MB L2; the warp reads a row as
// consecutive words).
//
// r_mul_tc waits at four __syncthreads per product for every warp of the
// block, but the digits, and so the live windows, differ per lane.  So
// the kernel does what the TPU kernel does: it computes the addition for
// every lane at every window and selects (rns.cuh win_chain_sel), and it
// runs the combine (jac_add_full, 16 products) for every lane.  A dead
// window gathers row 0, residues of 0; a dead window is 1 in 256 of the
// 8-bit windows, so the discarded products are 1-2 % more.  Lanes >= n
// of the last block read no digit, run every product on row 0 and store
// nothing.  No warp returns, continues or breaks before its last product.
//
// Flags follow the TPU kernel exactly: live = (digit != 0); the first
// live window of a chain sets the accumulator to the row (Z = 1), later
// live windows add it; m_neg negates chain 1's Y (27p - y) before the
// combine; a lane with both chains live takes the combine, one with one
// chain live that chain, and one with neither writes Z = 0 (the
// identity).  The three single-chain cases are stored before the
// combine, so their inputs need not stay live through its products.
//
// Bound on the H100: the 11 products per window and the combine's 16
// (742 per lane at 512 bits: 66 windows), each held by r_mul_tc's four
// barriers and the channelwise work between them, as in the Miller
// kernel; the row gathers hit L2.  So it takes the Miller kernel's
// blocks per SM (TcLanes): at S = 4, N = 8192 four blocks (64 registers,
// ~850 B spilled) beat three, two (128 registers) and one; at S = 6 one
// block is best at the 1024-bit key's batch of 512 (PERF.md §6, the
// encrypt sweep).
#include "rns_tc.cuh"

template <int S>
__global__ void __launch_bounds__(32 * TcLanes<S>::G, TcLanes<S>::min_blocks)
bgn_dual_ladder_kernel(const float* blob, const uint4* planes, int k,
                       const float* ptx, const float* pty, const float* qtx,
                       const float* qty, int R, int Jm, int Jt,
                       const int* digits, const int* mneg, float* ox,
                       float* oy, float* oz, int n) {
  const RnsConsts c = bgn_tc_load_consts<S>(blob, planes, k);
  const int lane = blockIdx.x * TcLanes<S>::G + (threadIdx.x >> 5);
  Fe<S> X1, Y1, Z1, X2, Y2, Z2;
  const bool st1 = win_chain_sel<S, MulTc<S>>(c, X1, Y1, Z1, ptx, pty, R,
                                              digits, 0, Jm, n, lane);
  const bool st2 = win_chain_sel<S, MulTc<S>>(c, X2, Y2, Z2, qtx, qty, R,
                                              digits, Jm, Jt, n, lane);
  if (st1 && mneg[lane]) fe_neg(c, Y1, Y1, 27);   // st1: lane < n
  const bool both = st1 && st2;
  if (lane < n && !both) {
    if (st1) {
      fe_store(c, ox, X1, n, lane);
      fe_store(c, oy, Y1, n, lane);
      fe_store(c, oz, Z1, n, lane);
    } else if (st2) {
      fe_store(c, ox, X2, n, lane);
      fe_store(c, oy, Y2, n, lane);
      fe_store(c, oz, Z2, n, lane);
    } else {
      Fe<S> zero;
      fe_zero(zero);
      fe_store(c, ox, zero, n, lane);
      fe_store(c, oy, zero, n, lane);
      fe_store(c, oz, zero, n, lane);
    }
  }
  jac_add_full<S, MulTc<S>>(c, X1, Y1, Z1, X2, Y2, Z2);
  if (both) {
    fe_store(c, ox, X1, n, lane);
    fe_store(c, oy, Y1, n, lane);
    fe_store(c, oz, Z1, n, lane);
  }
}

template <int S>
static int dual_ladder_launch(const float* blob, const uint4* planes, int k,
                              const float* ptx, const float* pty,
                              const float* qtx, const float* qty, int R,
                              int Jm, int Jt, const int* digits,
                              const int* mneg, float* ox, float* oy,
                              float* oz, int n, cudaStream_t stream) {
  constexpr int G = TcLanes<S>::G;
  const int smem = bgn_tc_layout(k, G).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      bgn_dual_ladder_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  bgn_dual_ladder_kernel<S><<<(n + G - 1) / G, 32 * G, smem, stream>>>(
      blob, planes, k, ptx, pty, qtx, qty, R, Jm, Jt, digits, mneg, ox, oy,
      oz, n);
  return (int)cudaGetLastError();
}

extern "C" int bgn_dual_ladder(const float* blob, const void* planes, int k,
                               int slots, const float* ptx, const float* pty,
                               const float* qtx, const float* qty, int R,
                               int Jm, int Jt, const int* digits,
                               const int* mneg, float* ox, float* oy,
                               float* oz, int n, cudaStream_t stream) {
  const uint4* pl = static_cast<const uint4*>(planes);
  return BGN_DISPATCH(slots, k, dual_ladder_launch, blob, pl, k, ptx, pty,
                      qtx, qty, R, Jm, Jt, digits, mneg, ox, oy, oz, n,
                      stream);
}
