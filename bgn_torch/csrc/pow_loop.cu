// x^e in F_p by square-and-multiply over shared MSB-first bits, one kernel.
//
// Replaces bgn_tpu/ops/pallas_rns.py:pow_loop_pallas (_pow_loop_kernel).
// It serves the Fermat inversion x^(p-2): of the norm in the final
// exponentiation (_fp2_inv, N = the Mult batch), of the BSGS candidate
// product in r_batch_inv (N = 2 * the L1 decrypt batch: the candidates
// and their negatives), and of the one batch product of normalize_rns and
// of mont_inv_rns (N = 1: every L1 Add/Sub, the level-1 Encrypt paths and
// curve.normalize's limb batch inversion).  One warp runs one lane's
// chain with the accumulator in registers, and a block of G lanes runs
// the base extensions of every product on the tensor cores (rns_tc.cuh
// r_mul_tc), as ladder_loop.cu does.  The bits are shared by every lane,
// so the bit branch is uniform and every warp of a block runs the same
// products; lanes >= n of the last block (seven of eight at N = 1) run
// on zeros and store nothing, so every warp reaches every barrier.
//
// Bound on the H100: at the wide batches instruction issue of r_mul_tc's
// channelwise work and its four barriers per product (1.5 products per
// bit on average); at N = 1 the latency of the dependent chain (16L
// squarings and about half as many multiplies, one after another), held
// by the channelwise work every product waits on (PERF.md §6-7).
#include "rns_tc.cuh"

template <int S>
__global__ void __launch_bounds__(32 * TcLanes<S>::G, TcPow<S>::min_blocks)
bgn_pow_loop_kernel(const float* blob, const uint4* planes, int k,
                    const float* x, const int* bits, int nb, float* out,
                    int n) {
  const RnsConsts c = bgn_tc_load_consts<S>(blob, planes, k);
  const int lane = blockIdx.x * TcLanes<S>::G + (threadIdx.x >> 5);
  const bool live = lane < n;
  Fe<S> X, ACC;
  if (live)
    fe_load(c, X, x, n, lane);
  else
    fe_zero(X);
  fe_one(c, ACC);
  for (int i = 0; i < nb; i++) {
    MulTc<S>::mul(c, ACC, ACC, ACC);
    if (bits[i] > 0) MulTc<S>::mul(c, ACC, ACC, X);
  }
  if (live) fe_store(c, out, ACC, n, lane);
}

template <int S>
static int pow_loop_launch(const float* blob, const uint4* planes, int k,
                           const float* x, const int* bits, int nb,
                           float* out, int n, cudaStream_t stream) {
  constexpr int G = TcLanes<S>::G;
  const int smem = bgn_tc_layout(k, G).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      bgn_pow_loop_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  bgn_pow_loop_kernel<S><<<(n + G - 1) / G, 32 * G, smem, stream>>>(
      blob, planes, k, x, bits, nb, out, n);
  return (int)cudaGetLastError();
}

extern "C" int bgn_pow_loop(const float* blob, const void* planes, int k,
                            int slots, const float* x, const int* bits,
                            int nb, float* out, int n, cudaStream_t stream) {
  const uint4* pl = static_cast<const uint4*>(planes);
  return BGN_DISPATCH(slots, k, pow_loop_launch, blob, pl, k, x, bits, nb,
                      out, n, stream);
}

extern "C" const char* bgn_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
