// Fixed-base window chain base^e from a radix-R table, one kernel.
//
// Replaces bgn_tpu/ops/pallas_rns.py:window_ladder_tab_pallas
// (_win_ladder_tab_kernel): P^|m| of EncryptDeterministic, and E_det(0)
// behind encrypt_zero and Neg (rns_pairing.fixed_base_mul_rns).  On the
// TPU the window axis is a sequential grid dimension whose accumulator
// lives in VMEM scratch, and row d of window j is picked by a one-hot
// bf16 matmul against the resident selection matrix.  Here one warp per
// lane walks all windows of its lane in a loop, in blocks of G lanes
// whose base extensions run on the tensor cores (rns_tc.cuh r_mul_tc),
// and reads row d of window j straight from the [J, R, 2k] float32 table
// (12 MB at 512 bits, L2-resident; a row is one contiguous run): the
// chain of dual_ladder.cu, once.
//
// r_mul_tc waits at four __syncthreads per product for every warp of the
// block, but the digits, and so the live windows, differ per lane.  So
// the kernel computes then selects, as the TPU kernel and the plain
// version do (rns.cuh win_chain_sel): at every window each lane adds its
// row (add_pt, 11 products) and keeps the sum only where the window is
// live (digit != 0); the first live window sets the accumulator to the
// row (Z = 1) instead.  A dead window, and a lane >= n of the last block
// (which reads no digit), gathers row 0, residues of 0.  A lane with no
// live window writes X = Y = Z = 0, the identity encoding normalize_rns
// tests; lanes >= n store nothing.  No warp returns, continues or breaks
// before its last product.  So a lane pays 11 products for every window,
// dead or live: E_det(0)'s two all-zero windows cost 22 products that a
// per-lane skip would not run.
//
// It takes the blocks per SM of dual_ladder.cu, which runs the same
// chain (TcLanes): at S = 4, B = 8192 four blocks beat one to three, at
// 64 windows and at 2; at S = 6 the caps lie within 5 % at the 1024-bit
// key's N = 64 (PERF.md §6, the encrypt sweep).
//
// Bound on the H100: the 11 products per window (704 per lane at 512
// bits and 64 windows), each held by r_mul_tc's four barriers and the
// channelwise work between them; the row gathers hit L2.
#include "rns_tc.cuh"

template <int S>
__global__ void __launch_bounds__(32 * TcLanes<S>::G, TcLanes<S>::min_blocks)
bgn_window_ladder_tab_kernel(const float* blob, const uint4* planes, int k,
                             const float* tx, const float* ty, int R, int Jd,
                             const int* digits, float* ox, float* oy,
                             float* oz, int n) {
  const RnsConsts c = bgn_tc_load_consts<S>(blob, planes, k);
  const int lane = blockIdx.x * TcLanes<S>::G + (threadIdx.x >> 5);
  Fe<S> X, Y, Z;
  const bool st = win_chain_sel<S, MulTc<S>>(c, X, Y, Z, tx, ty, R, digits,
                                             0, Jd, n, lane);
  if (lane < n) {
    if (!st) {
      fe_zero(X);
      fe_zero(Y);
      fe_zero(Z);
    }
    fe_store(c, ox, X, n, lane);
    fe_store(c, oy, Y, n, lane);
    fe_store(c, oz, Z, n, lane);
  }
}

template <int S>
static int window_ladder_tab_launch(const float* blob, const uint4* planes,
                                    int k, const float* tx, const float* ty,
                                    int R, int Jd, const int* digits,
                                    float* ox, float* oy, float* oz, int n,
                                    cudaStream_t stream) {
  constexpr int G = TcLanes<S>::G;
  const int smem = bgn_tc_layout(k, G).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      bgn_window_ladder_tab_kernel<S>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  bgn_window_ladder_tab_kernel<S><<<(n + G - 1) / G, 32 * G, smem, stream>>>(
      blob, planes, k, tx, ty, R, Jd, digits, ox, oy, oz, n);
  return (int)cudaGetLastError();
}

extern "C" int bgn_window_ladder_tab(const float* blob, const void* planes,
                                     int k, int slots, const float* tx,
                                     const float* ty, int R, int Jd,
                                     const int* digits, float* ox, float* oy,
                                     float* oz, int n, cudaStream_t stream) {
  const uint4* pl = static_cast<const uint4*>(planes);
  return BGN_DISPATCH(slots, k, window_ladder_tab_launch, blob, pl, k, tx, ty,
                      R, Jd, digits, ox, oy, oz, n, stream);
}
