// Batched Montgomery product a*b*R^-1 mod p on 16-bit limbs, R = 2^(16L).
//
// Replaces bgn_tpu/fieldcore/pallas_mont.py:mont_mul_pallas_f32
// (_cios_kernel_f32, CIOS over 8-bit digits in fp32) and :mont_mul_pallas
// (_cios_kernel, CIOS over 16-bit limbs in uint32).  The two TPU kernels
// compute the same function with the same contract; they differ only
// because the TPU's vector unit emulates 32-bit integer multiplies.  Hopper
// multiplies 32-bit integers natively, so one integer kernel serves both.
//
// Contract (fieldcore/montgomery.py mont_mul): a, b int64 [L, n] limbs,
// a < R and b < p (canonical), out [L, n] canonical limbs < p.  The
// operands are read through (limb, lane) element strides, so a broadcast
// operand (lane stride 0, e.g. R^2 in to_mont) needs no copy, and
// neighbouring threads read neighbouring lanes.
//
// One thread per lane runs the CIOS loop of mont.cuh (bgn_cios: the
// lazily carried uint32 accumulator T[0..2L] and its audit) and one
// conditional subtraction of p.  T and this lane's b live in local memory,
// sized by the limb cap LC, a template parameter: LC = 160 for L <= 160
// (the 512- to 2048-bit keys, L = 34, 66, 130) and LC = 264 up to the L of
// a 4096-bit key (258), so the narrower keys keep their frame; p lives in
// shared memory.
//
// Bound on the H100: at L = 34 and n = 8192 the bytes (3 * 8 * L per
// lane) take ~2 us and the L^2 32-bit multiply-adds per lane ~0.6 us (the
// least a CIOS needs: 2 (L/2)^2 products of 32-bit limbs, each a low and a
// high multiply-add); the kernel
// is bound by the latency of its local-memory accumulator and by the
// launch itself, and on the port's paths by the torch ops around it.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mont.cuh"

#define BGN_MONT_LCAP 160              // limbs: 2048-bit keys have L = 130
#define BGN_MONT_LMAX 264              // 4096-bit keys have L = 258
#define BGN_MONT_THREADS 128

// limb i of a lane's first operand, read through its element strides
struct BgnStridedLimbs {
  const int64_t* v;
  long long stride;
  __device__ __forceinline__ unsigned operator()(int i) const {
    return (unsigned)v[i * stride];
  }
};

template <int LC>
__global__ void __launch_bounds__(BGN_MONT_THREADS)
bgn_mont_mul_kernel(const int64_t* __restrict__ a, long long a_sl,
                    long long a_sn, const int64_t* __restrict__ b,
                    long long b_sl, long long b_sn,
                    const int64_t* __restrict__ p, unsigned pinv, int L,
                    int64_t* __restrict__ out, int n) {
  __shared__ unsigned ps[LC];
  for (int j = threadIdx.x; j < L; j += blockDim.x) ps[j] = (unsigned)p[j];
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const int64_t* al = a + lane * a_sn;
  const int64_t* bl = b + lane * b_sn;
  unsigned bv[LC];
  unsigned T[2 * LC + 1];
  for (int j = 0; j < L; j++) bv[j] = (unsigned)bl[j * b_sl];
  bgn_cios(BgnStridedLimbs{al, a_sl}, bv, ps, pinv, L, T);
  bgn_cond_sub_p(T + L, ps, L, bv);
  for (int j = 0; j < L; j++)
    out[(size_t)j * n + lane] = (int64_t)bv[j];
}

extern "C" int bgn_mont_mul(const int64_t* a, long long a_sl, long long a_sn,
                            const int64_t* b, long long b_sl, long long b_sn,
                            const int64_t* p, int pinv, int L, int64_t* out,
                            int n, cudaStream_t stream) {
  if (L < 1 || L > BGN_MONT_LMAX || n < 1) return (int)cudaErrorInvalidValue;
  const int grid = (n + BGN_MONT_THREADS - 1) / BGN_MONT_THREADS;
  if (L <= BGN_MONT_LCAP)
    bgn_mont_mul_kernel<BGN_MONT_LCAP><<<grid, BGN_MONT_THREADS, 0, stream>>>(
        a, a_sl, a_sn, b, b_sl, b_sn, p, (unsigned)pinv, L, out, n);
  else
    bgn_mont_mul_kernel<BGN_MONT_LMAX><<<grid, BGN_MONT_THREADS, 0, stream>>>(
        a, a_sl, a_sn, b, b_sl, b_sn, p, (unsigned)pinv, L, out, n);
  return (int)cudaGetLastError();
}
