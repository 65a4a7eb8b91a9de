// Fixed-base window chain fed by pre-gathered rows, one kernel.
//
// Replaces bgn_tpu/ops/pallas_rns.py:window_ladder_pallas
// (_win_ladder_kernel): the chain of window_ladder_tab.cu, with row j of
// each lane already gathered into a channel-major [Jd, 2k, N] stream and
// an identity flag per window and lane (ginf != 0: not live).  The TPU
// kernel streams one [2k, 512] block per window through VMEM while the
// accumulator stays in scratch.  Here one warp per lane walks all windows
// of its lane in a loop, in blocks of G lanes whose base extensions run
// on the tensor cores (rns_tc.cuh r_mul_tc), and loads row j of its lane
// from the stream at offset j * 2k * N (fe_load): the G warps of a block
// read G consecutive lanes, so each channel of a window is one 32-byte
// sector.
//
// r_mul_tc waits at four __syncthreads per product for every warp of the
// block, but the flags, and so the live windows, differ per lane.  So the
// chain (win_chain_rows) computes then selects, as the TPU kernel, the
// plain version (ops/cuda_rns.py _window_chain) and window_ladder_tab.cu
// do: at every window each lane adds its row (add_pt, 11 products) and
// keeps the sum only where the window is live; the first live window sets
// the accumulator to the row (Z = 1) instead.  A dead window and a lane
// >= n load zeros in place of the row: only the selected sum is kept, so
// the plain version's discarded products on the dead row differ and its
// output does not.  Before a window's products the block agrees
// (__syncthreads_or) whether any of its lanes is live there; where none
// is, every warp skips that window's 11 products alike, so no barrier is
// missed, and the result is the same bit for bit, as a dead window keeps
// the accumulator.  No warp returns, continues or breaks before its last
// product.  A lane with no live window writes X = Y = Z = 0, the identity
// encoding normalize_rns tests; lanes >= n store nothing.  On the rows
// gathered from a table it equals window_ladder_tab bit for bit.
//
// Bound on the H100: the 11 products of every window live in some lane of
// the block (704 per lane at 512 bits and 64 windows), each held by
// r_mul_tc's four barriers and the channelwise work between them; the
// stream, 2 * Jd * 2k * 4 bytes per lane read once (386 MB at B = 8192,
// Jd = 64, k = 46: ~0.12 ms at 3.35 TB/s), is not the limit.  It takes
// the blocks per SM of dual_ladder.cu and window_ladder_tab.cu, which run
// the same chain (TcLanes): at S = 4, N = 8192 four blocks beat one to
// three, at 64 windows (6.0 against 13.2, 7.6 and 6.8 ms) and at 2; at
// S = 6, N = 64 one block ties the best (PERF.md §6, the encrypt sweep).
#include "rns_tc.cuh"

// The window chain over the gathered stream gx, gy [Jd, 2k, n] with flags
// ginf [Jd, n] (nonzero: dead), computed for every lane and selected as in
// rns.cuh win_chain_sel, a window dead in every lane of the block skipped
// by the whole block.  Mul: the block-wide product.  The accumulator starts
// at X = Y = 0, Z = 1, so every operand of a discarded product is
// canonical.  Returns whether a window was live.
template <int S, class Mul>
static __device__ __forceinline__ bool win_chain_rows(
    const RnsConsts& c, Fe<S>& X, Fe<S>& Y, Fe<S>& Z, const float* gx,
    const float* gy, const int* ginf, int Jd, int n, int lane) {
  fe_zero(X);
  fe_zero(Y);
  fe_one(c, Z);
  bool st = false;
  for (int j = 0; j < Jd; j++) {
    const bool live = lane < n && ginf[(size_t)j * n + lane] == 0;
    if (__syncthreads_or(live)) {      // uniform over the block
      Fe<S> RX, RY, AX, AY, AZ;
      fe_zero(RX);
      fe_zero(RY);
      if (live) {
        const size_t off = (size_t)j * c.ch * n;
        fe_load(c, RX, gx + off, n, lane);
        fe_load(c, RY, gy + off, n, lane);
      }
      fe_copy(AX, X);
      fe_copy(AY, Y);
      fe_copy(AZ, Z);
      add_pt<S, Mul>(c, AX, AY, AZ, RX, RY);
      if (live && !st) {
        fe_copy(X, RX);
        fe_copy(Y, RY);
        fe_one(c, Z);
      } else if (live) {
        fe_copy(X, AX);
        fe_copy(Y, AY);
        fe_copy(Z, AZ);
      }
      st = st || live;
    }
  }
  return st;
}

template <int S>
__global__ void __launch_bounds__(32 * TcLanes<S>::G, TcLanes<S>::min_blocks)
bgn_window_ladder_kernel(const float* blob, const uint4* planes, int k,
                         const float* gx, const float* gy, const int* ginf,
                         int Jd, float* ox, float* oy, float* oz, int n) {
  const RnsConsts c = bgn_tc_load_consts<S>(blob, planes, k);
  const int lane = blockIdx.x * TcLanes<S>::G + (threadIdx.x >> 5);
  Fe<S> X, Y, Z;
  const bool st = win_chain_rows<S, MulTc<S>>(c, X, Y, Z, gx, gy, ginf, Jd,
                                              n, lane);
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
static int window_ladder_launch(const float* blob, const uint4* planes, int k,
                                const float* gx, const float* gy,
                                const int* ginf, int Jd, float* ox,
                                float* oy, float* oz, int n,
                                cudaStream_t stream) {
  constexpr int G = TcLanes<S>::G;
  const int smem = bgn_tc_layout(k, G).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      bgn_window_ladder_kernel<S>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  bgn_window_ladder_kernel<S><<<(n + G - 1) / G, 32 * G, smem, stream>>>(
      blob, planes, k, gx, gy, ginf, Jd, ox, oy, oz, n);
  return (int)cudaGetLastError();
}

extern "C" int bgn_window_ladder(const float* blob, const void* planes, int k,
                                 int slots, const float* gx, const float* gy,
                                 const int* ginf, int Jd, float* ox,
                                 float* oy, float* oz, int n,
                                 cudaStream_t stream) {
  const uint4* pl = static_cast<const uint4*>(planes);
  return BGN_DISPATCH(slots, k, window_ladder_launch, blob, pl, k, gx, gy,
                      ginf, Jd, ox, oy, oz, n, stream);
}
