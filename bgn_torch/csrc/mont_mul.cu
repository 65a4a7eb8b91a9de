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
// One thread per lane runs the CIOS loop of montgomery.py over a flat,
// lazily carried uint32 accumulator T[0..2L]: per outer step i every
// position gains less than 4 * 2^16 plus the shifted carry of position i,
// and a position lives for at most L + 1 steps, so T < 2^32 for L < 16000
// (the audit in bgn_tpu/fieldcore/montgomery.py).  m is taken before the
// inner loop from the low 16 bits of T[i] + a_i*b_0, so one pass adds both
// a_i*b and m*p.  The value in T[L..2L] is below 2p: a ripple gives its
// 16-bit limbs and one conditional subtraction of p the canonical result.
// The limbs stay 16-bit, so R is 2^(16L) for every L, odd L included.
// T and this lane's b live in local memory (L <= BGN_MONT_LMAX), p in
// shared memory.
//
// Bound on the H100: at L = 34 and n = 8192 the bytes (3 * 8 * L per
// lane) take ~2 us and the 2 L^2 multiply-adds per lane ~1 us; the kernel
// is bound by the latency of its local-memory accumulator and by the
// launch itself, and on the port's paths by the torch ops around it.
#include <cuda_runtime.h>
#include <stdint.h>

#define BGN_MONT_LMAX 160              // limbs: 2048-bit keys have L = 130
#define BGN_MONT_THREADS 128
#define BGN_MONT_MASK 0xFFFFu

__global__ void __launch_bounds__(BGN_MONT_THREADS)
bgn_mont_mul_kernel(const int64_t* __restrict__ a, long long a_sl,
                    long long a_sn, const int64_t* __restrict__ b,
                    long long b_sl, long long b_sn,
                    const int64_t* __restrict__ p, unsigned pinv, int L,
                    int64_t* __restrict__ out, int n) {
  __shared__ unsigned ps[BGN_MONT_LMAX];
  for (int j = threadIdx.x; j < L; j += blockDim.x) ps[j] = (unsigned)p[j];
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const int64_t* al = a + lane * a_sn;
  const int64_t* bl = b + lane * b_sn;
  unsigned bv[BGN_MONT_LMAX];
  unsigned T[2 * BGN_MONT_LMAX + 1];
  for (int j = 0; j < L; j++) bv[j] = (unsigned)bl[j * b_sl];
  for (int j = 0; j <= 2 * L; j++) T[j] = 0;
  for (int i = 0; i < L; i++) {
    const unsigned ai = (unsigned)al[i * a_sl];
    const unsigned m = (((T[i] + ai * bv[0]) & BGN_MONT_MASK) * pinv)
                       & BGN_MONT_MASK;
    unsigned hi = 0;                   // high halves owed to position i+j
    for (int j = 0; j < L; j++) {
      const unsigned x = ai * bv[j], y = m * ps[j];
      T[i + j] += (x & BGN_MONT_MASK) + (y & BGN_MONT_MASK) + hi;
      hi = (x >> 16) + (y >> 16);
    }
    T[i + L] += hi;
    T[i + 1] += T[i] >> 16;            // the low 16 bits of T[i] are zero
  }
  // T[L..2L] -> 16-bit limbs of a value < 2p (carries < 2^16)
  unsigned c = 0;
  for (int j = 0; j <= L; j++) {
    const unsigned s = T[L + j] + c;
    T[L + j] = s & BGN_MONT_MASK;
    c = s >> 16;
  }
  // value - p into bv; keep it unless it borrowed
  int borrow = 0;
  for (int j = 0; j <= L; j++) {
    int s = (int)T[L + j] - (j < L ? (int)ps[j] : 0) - borrow;
    borrow = s < 0;
    if (j < L) bv[j] = (unsigned)(s + (borrow << 16));
  }
  for (int j = 0; j < L; j++)
    out[(size_t)j * n + lane] = (int64_t)(borrow ? T[L + j] : bv[j]);
}

extern "C" int bgn_mont_mul(const int64_t* a, long long a_sl, long long a_sn,
                            const int64_t* b, long long b_sl, long long b_sn,
                            const int64_t* p, int pinv, int L, int64_t* out,
                            int n, cudaStream_t stream) {
  if (L < 1 || L > BGN_MONT_LMAX || n < 1) return (int)cudaErrorInvalidValue;
  const int grid = (n + BGN_MONT_THREADS - 1) / BGN_MONT_THREADS;
  bgn_mont_mul_kernel<<<grid, BGN_MONT_THREADS, 0, stream>>>(
      a, a_sl, a_sn, b, b_sl, b_sn, p, (unsigned)pinv, L, out, n);
  return (int)cudaGetLastError();
}
