// Fixed-base window chain fed by pre-gathered rows, one kernel.
//
// Replaces bgn_tpu/ops/pallas_rns.py:window_ladder_pallas
// (_win_ladder_kernel): the same chain as window_ladder_tab.cu, with row
// j of each lane already gathered into a channel-major [Jd, 2k, N] stream
// and an identity flag per window and lane (ginf != 0: not live).  The
// TPU kernel streams one [2k, 512] block per window through VMEM while
// the accumulator stays in scratch; here one warp walks its lane's
// windows with the accumulator in registers (rns.cuh win_step).  A lane
// with no live window writes X = Y = Z = 0.  On identical gathered rows
// it equals window_ladder_tab bit for bit.
//
// Bound on the H100: device memory latency and bytes.  The warp reads
// one lane's 2k channels of a window at stride N, so every thread's load
// is its own transaction (uncoalesced; a later layout with the lane axis
// innermost per warp would fix it), and the stream is 2 * Jd * 2k * 4
// bytes per lane read once; then instruction issue (11 r_muls per live
// window after the first).
#include "rns.cuh"

template <int S>
__global__ void __launch_bounds__(BGN_THREADS)
bgn_window_ladder_kernel(const float* blob, int k, const float* gx,
                         const float* gy, const int* ginf, int Jd, float* ox,
                         float* oy, float* oz, int n) {
  const RnsConsts c = bgn_load_consts<S>(blob, k);
  const int lane = bgn_lane();
  if (lane >= n) return;
  Fe<S> X, Y, Z;
  bool st = false;
  for (int j = 0; j < Jd; j++) {
    if (ginf[(size_t)j * n + lane] != 0) continue;   // identity row
    const size_t off = (size_t)j * c.ch * n;
    Fe<S> RX, RY;
    fe_load(c, RX, gx + off, n, lane);
    fe_load(c, RY, gy + off, n, lane);
    win_step(c, X, Y, Z, st, RX, RY);
  }
  if (!st) {
    fe_zero(X);
    fe_zero(Y);
    fe_zero(Z);
  }
  fe_store(c, ox, X, n, lane);
  fe_store(c, oy, Y, n, lane);
  fe_store(c, oz, Z, n, lane);
}

template <int S>
static int window_ladder_launch(const float* blob, int k, const float* gx,
                                const float* gy, const int* ginf, int Jd,
                                float* ox, float* oy, float* oz, int n,
                                cudaStream_t stream) {
  dim3 grid;
  size_t smem;
  cudaError_t err =
      bgn_prepare(bgn_window_ladder_kernel<S>, k, n, &grid, &smem);
  if (err != cudaSuccess) return (int)err;
  bgn_window_ladder_kernel<S><<<grid, BGN_THREADS, smem, stream>>>(
      blob, k, gx, gy, ginf, Jd, ox, oy, oz, n);
  return (int)cudaGetLastError();
}

extern "C" int bgn_window_ladder(const float* blob, int k, int slots,
                                 const float* gx, const float* gy,
                                 const int* ginf, int Jd, float* ox,
                                 float* oy, float* oz, int n,
                                 cudaStream_t stream) {
  return BGN_DISPATCH(slots, k, window_ladder_launch, blob, k, gx, gy, ginf,
                      Jd, ox, oy, oz, n, stream);
}
