// x^e in F_p by square-and-multiply over shared MSB-first bits, one kernel.
//
// Replaces bgn_tpu/ops/pallas_rns.py:pow_loop_pallas (_pow_loop_kernel).
// It serves the Fermat inversion x^(p-2): of the norm in the final
// exponentiation (N = batch), of the batch product in normalize_rns
// (N = 1) and of the BSGS candidate product in r_batch_inv (N = 2 *
// decrypt batch).  One warp per lane runs the whole chain with the
// accumulator in registers; the bit branch is uniform (shared bits).
//
// Bound on the H100: instruction issue (1.5 r_muls per bit on average).
// At N = 1 the chain is one warp's latency: 16L dependent squarings with
// no parallelism to hide it.
#include "rns.cuh"

template <int S>
__global__ void __launch_bounds__(BGN_THREADS)
bgn_pow_loop_kernel(const float* blob, int k, const float* x,
                    const int* bits, int nb, float* out, int n) {
  const RnsConsts c = bgn_load_consts<S>(blob, k);
  const int lane = bgn_lane();
  if (lane >= n) return;
  Fe<S> X, ACC;
  fe_load(c, X, x, n, lane);
  fe_one(c, ACC);
  for (int i = 0; i < nb; i++) {
    r_mul(c, ACC, ACC, ACC);
    if (bits[i] > 0) r_mul(c, ACC, ACC, X);
  }
  fe_store(c, out, ACC, n, lane);
}

template <int S>
static int pow_loop_launch(const float* blob, int k, const float* x,
                           const int* bits, int nb, float* out, int n,
                           cudaStream_t stream) {
  dim3 grid;
  size_t smem;
  cudaError_t err = bgn_prepare(bgn_pow_loop_kernel<S>, k, n, &grid, &smem);
  if (err != cudaSuccess) return (int)err;
  bgn_pow_loop_kernel<S><<<grid, BGN_THREADS, smem, stream>>>(blob, k, x,
                                                              bits, nb, out, n);
  return (int)cudaGetLastError();
}

extern "C" int bgn_pow_loop(const float* blob, int k, int slots,
                            const float* x, const int* bits, int nb,
                            float* out, int n, cudaStream_t stream) {
  return BGN_DISPATCH(slots, k, pow_loop_launch, blob, k, x, bits, nb, out,
                      n, stream);
}

extern "C" const char* bgn_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
