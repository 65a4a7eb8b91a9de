// RNS field and curve arithmetic as CUDA device functions: the library
// that every loop kernel of bgn_torch runs, the counterpart of
// bgn_tpu/fieldcore/rns.py (_red, r_mul, r_add, r_sub) and the step
// functions of bgn_tpu/ops/rns_pairing.py (_dbl_step, _add_step, _add_pt,
// _fp2_mul, _fp2_sqr) and pallas_rns.py (_jac_add_full).
//
// An F_p element is 2k residues modulo 12-bit primes (base A = channels
// 0..k-1, base B = channels k..2k-1, k <= 64).  One warp owns one lane
// (one batch element): thread l of the warp holds channel c = 32*s + l in
// slot s of a 4-entry register array (Fe).  Every index into an Fe is a
// compile-time constant and every helper is inlined (r_mul is one
// out-of-line copy taking and returning Fe by value), so a lane's whole
// loop state stays in registers: no local memory, no cache misses on the
// dependent chain.  Channelwise work is one slot op per thread; the two
// base extensions of an r_mul broadcast each source residue to the warp
// with a shuffle, and each thread accumulates the destination channels it
// owns against the extension matrix in shared memory (rows padded to a
// stride of 1 mod 32, so the warp's reads hit distinct banks).  Branches
// depend only on a lane's digits, so a warp never diverges.
//
// Exactness: every float value is an integer below 2^24, so float
// products and sums are exact, and contraction into FMAs changes nothing.
// The base extensions are exact int32 dot products against the unsplit
// extension matrices (sum < 64 * 4095^2 < 2^31), and the alpha estimate
// an exact int32 sum (a warp reduction) scaled in double.  The result of
// each step is the canonical residue of the same integer that the plain
// PyTorch version (fieldcore/rns.py) reduces, so the two agree bit for
// bit.  Only the narrow path (k <= 64) exists.
//
// What bounds it on the H100: instruction issue.  One r_mul is ~2k
// shuffles and ~2k (shared load + integer multiply-add) pairs per thread
// of the warp, where a tensor-core product would issue a few dozen
// instructions; the out-of-line r_mul adds a call per product.  It does
// not use the tensor cores (a later step).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define BGN_KMAX 64
#define BGN_SLOTS 4                    // 2k <= 128 channels over 32 threads
#define BGN_KPCOLS 33                  // kp columns: (K*p) mod m, K <= 32
#define BGN_LANES 4                    // lanes (warps) per block
#define BGN_THREADS (32 * BGN_LANES)
#define BGN_FULL 0xffffffffu

// A lane's F_p element as this thread's slots; passed by value to the
// out-of-line r_mul (16 bytes travel in registers), by reference to the
// inlined helpers, so it never lives in memory.
struct Fe {
  float v[BGN_SLOTS];
};

// The block's copy of the constant blob (dynamic shared memory).
extern __shared__ float bgn_smem[];

// Shape of the constants and this thread's place in its warp; the other
// fields are word offsets into bgn_smem (so every access is a shared-
// memory load, also inside the out-of-line r_mul).
struct RnsConsts {
  int k, ch, rs, lid;          // rs: matrix row stride; lid: thread in warp
  int m, recip, one, kp, qc_a, p_mod_b, ainv_b, crt_inv_b, b_mod_a;
  int w1a, w2a, mat1, mat2;    // int entries: [k], [k], [k][rs], [k][rs]
};

#define BGN_F(o) (bgn_smem[o])
#define BGN_I(o) (reinterpret_cast<const int*>(bgn_smem)[o])

// Row stride of the extension matrices: >= k and == 1 (mod 32), so the
// warp's reads of 32 consecutive rows hit distinct banks.  Mirrors
// cuda_rns.blob_layout.
static __host__ __device__ inline int bgn_row_stride(int k) {
  return k <= 1 ? 1 : ((k - 2) / 32 + 1) * 32 + 1;
}

// Word offsets of the constant blob; mirrors cuda_rns.blob_layout.
static __host__ __device__ inline int bgn_layout(int k, RnsConsts* c) {
  int ch = 2 * k, rs = bgn_row_stride(k), o = 0;
  c->k = k;
  c->ch = ch;
  c->rs = rs;
  c->m = o; o += ch;
  c->recip = o; o += ch;
  c->one = o; o += ch;
  c->kp = o; o += ch * BGN_KPCOLS;
  c->qc_a = o; o += k;
  c->p_mod_b = o; o += k;
  c->ainv_b = o; o += k;
  c->crt_inv_b = o; o += k;
  c->b_mod_a = o; o += k;
  c->w1a = o; o += k;
  c->w2a = o; o += k;
  c->mat1 = o; o += k * rs;    // [j][i]: dst base-B channel j, src i
  c->mat2 = o; o += k * rs;    // [i][j]: dst base-A channel i, src j
  return o;
}

static inline size_t bgn_smem_bytes(int k) {
  RnsConsts c;
  return sizeof(float) * bgn_layout(k, &c);
}

// Copy the blob into shared memory (whole block) and lay it out.  Every
// thread of the block calls it before any early return.
static __device__ inline RnsConsts bgn_load_consts(const float* blob, int k) {
  RnsConsts c;
  const int words = bgn_layout(k, &c);
  for (int w = threadIdx.x; w < words; w += blockDim.x) bgn_smem[w] = blob[w];
  __syncthreads();
  c.lid = threadIdx.x & 31;
  return c;
}

// The lane this thread's warp serves.
static __device__ __forceinline__ int bgn_lane() {
  return blockIdx.x * BGN_LANES + (threadIdx.x >> 5);
}

static __device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(BGN_FULL, v, o);
  return v;
}

#define BGN_CH(c, s) (32 * (s) + (c).lid)

// ---------------------------------------------------------------------------
// Channelwise primitives (slot s of every thread; channels >= 2k are
// padding whose values nothing reads)
// ---------------------------------------------------------------------------

// Modulus of channel ch (1 for padding channels).
static __device__ __forceinline__ float bgn_mod(const RnsConsts& c, int ch) {
  return ch < c.ch ? BGN_F(c.m + ch) : 1.f;
}

// (K*p) mod m of channel ch (0 for padding channels).
static __device__ __forceinline__ float bgn_kp(const RnsConsts& c, int ch,
                                               int K) {
  return ch < c.ch ? BGN_F(c.kp + ch * BGN_KPCOLS + K) : 0.f;
}

// v mod m for integer-valued v <= 2^24 - 2^12, recip the downward-biased
// reciprocal (fieldcore/rns.py _red): q is floor(v/m) or one less.
static __device__ __forceinline__ float bgn_red(float v, float m, float r) {
  float q = floorf(__fmul_rn(v, r));
  float x = __fsub_rn(v, __fmul_rn(q, m));
  return x >= m ? x - m : x;
}

static __device__ __forceinline__ void r_add(const RnsConsts& c, Fe& out,
                                             const Fe& x, const Fe& y) {
#pragma unroll
  for (int s = 0; s < BGN_SLOTS; s++) {
    const float m = bgn_mod(c, BGN_CH(c, s));
    const float v = x.v[s] + y.v[s];
    out.v[s] = v >= m ? v - m : v;
  }
}

// x - y + K*p (K = the static bound of y), kept nonnegative.
static __device__ __forceinline__ void r_sub(const RnsConsts& c, Fe& out,
                                             const Fe& x, const Fe& y, int K) {
#pragma unroll
  for (int s = 0; s < BGN_SLOTS; s++) {
    const int ch = BGN_CH(c, s);
    const float m = bgn_mod(c, ch);
    float v = (x.v[s] + bgn_kp(c, ch, K)) - y.v[s];
    v = v < 0.f ? v + m : v;
    out.v[s] = v >= m ? v - m : v;
  }
}

static __device__ __forceinline__ void fe_copy(Fe& out, const Fe& x) {
#pragma unroll
  for (int s = 0; s < BGN_SLOTS; s++) out.v[s] = x.v[s];
}

static __device__ __forceinline__ void fe_zero(Fe& out) {
#pragma unroll
  for (int s = 0; s < BGN_SLOTS; s++) out.v[s] = 0.f;
}

// This thread's slots of a full 2k-channel row in device memory.
static __device__ __forceinline__ void fe_gather(const RnsConsts& c, Fe& out,
                                                 const float* row) {
#pragma unroll
  for (int s = 0; s < BGN_SLOTS; s++) {
    const int ch = BGN_CH(c, s);
    out.v[s] = ch < c.ch ? row[ch] : 0.f;
  }
}

// The Montgomery one (residues of A mod p).
static __device__ __forceinline__ void fe_one(const RnsConsts& c, Fe& out) {
#pragma unroll
  for (int s = 0; s < BGN_SLOTS; s++) {
    const int ch = BGN_CH(c, s);
    out.v[s] = ch < c.ch ? BGN_F(c.one + ch) : 0.f;
  }
}

// Residues of (K*p - value) for a coordinate of static bound K.
static __device__ __forceinline__ void fe_neg(const RnsConsts& c, Fe& out,
                                              const Fe& v, int K) {
#pragma unroll
  for (int s = 0; s < BGN_SLOTS; s++) {
    const int ch = BGN_CH(c, s);
    const float x = bgn_kp(c, ch, K) - v.v[s];
    out.v[s] = x < 0.f ? x + bgn_mod(c, ch) : x;
  }
}

// floor(s * 2^-19 + eps) for an exact int32 sum s.
static __device__ __forceinline__ int bgn_alpha(int s, double eps) {
  return (int)floor((double)s * (1.0 / 524288.0) + eps);
}

// RNS Montgomery product x*y/A (value bound 3), by the whole warp.  Out of
// line: one copy per kernel keeps the build short (inlined at its ~40 call
// sites, ptxas took minutes).
static __device__ __noinline__ Fe r_mul_v(const int k, const Fe x,
                                          const Fe y) {
  RnsConsts c;                       // offsets from k: registers, no memory
  bgn_layout(k, &c);
  c.lid = threadIdx.x & 31;
  Fe out = {};
  int qv[BGN_SLOTS];      // qhat (base A slots) and later rhat (base B)
  float dB[BGN_SLOTS];
  int s1 = 0;
#pragma unroll
  for (int s = 0; s < BGN_SLOTS; s++) {
    const int ch = BGN_CH(c, s);
    const float d = bgn_red(__fmul_rn(x.v[s], y.v[s]), bgn_mod(c, ch),
                            ch < c.ch ? BGN_F(c.recip + ch) : 1.f);
    qv[s] = 0;
    dB[s] = d;
    if (ch < k) {
      qv[s] = (int)bgn_red(__fmul_rn(d, BGN_F(c.qc_a + ch)),
                           BGN_F(c.m + ch), BGN_F(c.recip + ch));
      s1 += BGN_I(c.w1a + ch) * qv[s];
    }
  }
  // ext A -> B: q * p * A^-1 in base B (alpha biased down by 0.4)
  const int a1 = bgn_alpha(warp_sum(s1), -0.4);
  int acc[BGN_SLOTS] = {0, 0, 0, 0};
#pragma unroll
  for (int sa = 0; sa < 2; sa++) {            // base A lies in slots 0, 1
#pragma unroll 8
    for (int l = 0; l < 32; l++) {
      const int i = 32 * sa + l;
      if (i >= k) break;
      const int q = __shfl_sync(BGN_FULL, qv[sa], l);
#pragma unroll
      for (int s = 0; s < BGN_SLOTS; s++) {
        const int ch = BGN_CH(c, s);
        if (ch >= k && ch < c.ch)
          acc[s] += q * BGN_I(c.mat1 + (ch - k) * c.rs + i);
      }
    }
  }
  int s2 = 0;
#pragma unroll
  for (int s = 0; s < BGN_SLOTS; s++) {
    const int ch = BGN_CH(c, s);
    if (ch >= k && ch < c.ch) {
      const int j = ch - k;
      const float m = BGN_F(c.m + ch), r = BGN_F(c.recip + ch);
      const int mi = (int)m;
      const int T = acc[s] + 128 * mi - a1 * (int)BGN_F(c.p_mod_b + j);
      const float qpa = (float)(T % mi);
      const float v = bgn_red(__fmul_rn(dB[s], BGN_F(c.ainv_b + j)), m, r) + qpa;
      const float rr = v >= m ? v - m : v;
      out.v[s] = rr;
      qv[s] = (int)bgn_red(__fmul_rn(rr, BGN_F(c.crt_inv_b + j)), m, r);
      s2 += BGN_I(c.w2a + j) * qv[s];
    }
  }
  // ext B -> A: exact (alpha centred)
  const int a2 = bgn_alpha(warp_sum(s2), 0.5);
  int acc2[2] = {0, 0};
#pragma unroll
  for (int sb = 0; sb < BGN_SLOTS; sb++) {
    if (32 * sb + 31 < k) continue;             // no base-B channel here
#pragma unroll 8
    for (int l = 0; l < 32; l++) {
      const int chb = 32 * sb + l;
      if (chb >= c.ch) break;
      const int q = __shfl_sync(BGN_FULL, qv[sb], l);
      if (chb < k) continue;
      const int j = chb - k;
#pragma unroll
      for (int s = 0; s < 2; s++) {
        const int ch = BGN_CH(c, s);
        if (ch < k) acc2[s] += q * BGN_I(c.mat2 + ch * c.rs + j);
      }
    }
  }
#pragma unroll
  for (int s = 0; s < 2; s++) {
    const int ch = BGN_CH(c, s);
    if (ch < k) {
      const int mi = (int)BGN_F(c.m + ch);
      const int T = acc2[s] + 128 * mi - a2 * (int)BGN_F(c.b_mod_a + ch);
      out.v[s] = (float)(T % mi);
    }
  }
  return out;
}

static __device__ __forceinline__ void r_mul(const RnsConsts& c, Fe& out,
                                             const Fe& x, const Fe& y) {
  out = r_mul_v(c.k, x, y);
}

// ---------------------------------------------------------------------------
// Curve and Miller steps.  The integer after each r_sub is the static
// bound K of its subtrahend, as rns_pairing.py's RVal bookkeeping sets it
// (invariants X, Y < 27p, Z < 6p, f < 9p, affine inputs < 3p).
// ---------------------------------------------------------------------------

// Jacobian doubling + tangent line at phi(B) + f <- f^2 * line (21 r_muls).
static __device__ __forceinline__ void dbl_step(const RnsConsts& c, Fe& X,
                                                Fe& Y, Fe& Z, Fe& fr, Fe& fi,
                                                const Fe& xb, const Fe& yb) {
  Fe XX, ZZ, YY, YZ, t2, ab, sqre, ta, tb;
  r_mul(c, XX, X, X);
  r_mul(c, ZZ, Z, Z);
  r_mul(c, YY, Y, Y);
  r_mul(c, YZ, Y, Z);
  r_mul(c, t2, X, Z);
  r_mul(c, ab, fr, fi);
  r_add(c, ta, fr, fi);
  r_sub(c, tb, fr, fi, 9);
  r_mul(c, sqre, ta, tb);
  Fe Z3, sqim;
  r_add(c, Z3, YZ, YZ);
  r_add(c, sqim, ab, ab);
  Fe ZZZ, ZZZZ, YYYY, T;
  r_mul(c, ZZZ, Z, ZZ);
  r_mul(c, ZZZZ, ZZ, ZZ);
  r_mul(c, YYYY, YY, YY);
  r_mul(c, T, X, YY);
  Fe M, S;
  r_add(c, ta, XX, XX);
  r_add(c, ta, XX, ta);
  r_add(c, M, ta, ZZZZ);             // 12
  r_add(c, S, T, T);
  r_add(c, S, S, S);                 // 12
  // layer 3 (MM reuses XX, t1 reuses ZZ, Z3ZZZ reuses YY, Z3Y reuses ab)
  r_mul(c, XX, M, M);
  r_mul(c, ZZ, ZZZ, xb);
  r_mul(c, YY, Z3, ZZZ);
  r_mul(c, ab, Z3, Y);
  Fe X3;
  r_sub(c, X3, XX, S, 12);
  r_sub(c, X3, X3, S, 12);           // 27
  Fe Y8;
  r_add(c, Y8, YYYY, YYYY);
  r_add(c, Y8, Y8, Y8);
  r_add(c, Y8, Y8, Y8);              // 24
  // layer 4
  r_sub(c, ta, S, X3, 27);
  r_mul(c, ZZZZ, M, ta);             // MSX3
  r_add(c, tb, ZZ, t2);
  r_mul(c, T, M, tb);                // Mt
  r_mul(c, YZ, YY, yb);              // l_im
  r_sub(c, Y, ZZZZ, Y8, 24);         // Y3 (old Y no longer needed)
  r_sub(c, M, T, ab, 3);             // l_re
  // layer 5
  r_mul(c, XX, sqre, M);             // m0
  r_mul(c, ZZ, sqim, YZ);            // m1
  r_add(c, ta, sqre, sqim);
  r_add(c, tb, M, YZ);
  r_mul(c, YY, ta, tb);              // m2
  r_sub(c, fr, XX, ZZ, 3);
  r_sub(c, ta, YY, XX, 3);
  r_sub(c, fi, ta, ZZ, 3);
  fe_copy(X, X3);
  fe_copy(Z, Z3);
}

// Mixed addition V + A + line through V, A at phi(B) + f <- f * line
// (17 r_muls).
static __device__ __forceinline__ void add_step(const RnsConsts& c, Fe& X1,
                                                Fe& Y1, Fe& Z1, Fe& fr, Fe& fi,
                                                const Fe& ax, const Fe& ay,
                                                const Fe& xb, const Fe& yb) {
  Fe ZZ, U2, ZZZ, H, R, ta;
  r_mul(c, ZZ, Z1, Z1);
  r_mul(c, U2, ax, ZZ);
  r_mul(c, ZZZ, Z1, ZZ);
  r_mul(c, ta, ay, ZZZ);             // S2
  r_sub(c, H, U2, X1, 27);           // 30
  r_sub(c, R, ta, Y1, 27);           // 30
  Fe HH, RR, Z3, Rx;
  r_mul(c, HH, H, H);
  r_mul(c, RR, R, R);
  r_mul(c, Z3, Z1, H);
  r_add(c, ta, xb, ax);
  r_mul(c, Rx, R, ta);
  Fe HHH, V, Z3ya, lim;
  r_mul(c, HHH, H, HH);
  r_mul(c, V, X1, HH);
  r_mul(c, Z3ya, Z3, ay);
  r_mul(c, lim, Z3, yb);
  Fe X3;
  r_sub(c, X3, RR, HHH, 3);
  r_sub(c, X3, X3, V, 3);
  r_sub(c, X3, X3, V, 3);            // 12
  r_sub(c, U2, Rx, Z3ya, 3);         // l_re
  r_sub(c, ta, V, X3, 12);
  r_mul(c, ZZ, R, ta);               // RVX3
  r_mul(c, ZZZ, Y1, HHH);            // Y1HHH
  r_sub(c, Y1, ZZ, ZZZ, 3);          // Y3
  r_mul(c, HH, fr, U2);              // m0
  r_mul(c, RR, fi, lim);             // m1
  r_add(c, ta, fr, fi);
  r_add(c, H, U2, lim);
  r_mul(c, R, ta, H);                // m2
  r_sub(c, fr, HH, RR, 3);
  r_sub(c, ta, R, HH, 3);
  r_sub(c, fi, ta, RR, 3);
  fe_copy(X1, X3);
  fe_copy(Z1, Z3);
}

// Mixed addition V + A without line math or completeness selects
// (11 r_muls).
static __device__ __forceinline__ void add_pt(const RnsConsts& c, Fe& X1,
                                              Fe& Y1, Fe& Z1, const Fe& ax,
                                              const Fe& ay) {
  Fe ZZ, U2, ZZZ, H, R, ta;
  r_mul(c, ZZ, Z1, Z1);
  r_mul(c, U2, ax, ZZ);
  r_mul(c, ZZZ, Z1, ZZ);
  r_mul(c, ta, ay, ZZZ);             // S2
  r_sub(c, H, U2, X1, 27);
  r_sub(c, R, ta, Y1, 27);
  Fe HH, RR;
  r_mul(c, HH, H, H);
  r_mul(c, RR, R, R);
  r_mul(c, Z1, Z1, H);               // Z3 (old Z1 no longer needed)
  r_mul(c, U2, H, HH);               // HHH
  r_mul(c, ZZ, X1, HH);              // V
  r_sub(c, X1, RR, U2, 3);
  r_sub(c, X1, X1, ZZ, 3);
  r_sub(c, X1, X1, ZZ, 3);           // X3, 12
  r_sub(c, ta, ZZ, X1, 12);
  r_mul(c, HH, R, ta);               // RVX3
  r_mul(c, RR, Y1, U2);              // Y1HHH
  r_sub(c, Y1, HH, RR, 3);
}

// General Jacobian + Jacobian addition (both live, not +-equal);
// result bounds (12, 6, 3).  Outputs overwrite X1, Y1, Z1.
static __device__ __forceinline__ void jac_add_full(const RnsConsts& c,
                                                    Fe& X1, Fe& Y1, Fe& Z1,
                                                    const Fe& X2, const Fe& Y2,
                                                    const Fe& Z2) {
  Fe Z1Z1, Z2Z2, T1, T2, Z1Z2, U1, U2, S1, H, Rr, ta;
  r_mul(c, Z1Z1, Z1, Z1);
  r_mul(c, Z2Z2, Z2, Z2);
  r_mul(c, T1, Y1, Z2);
  r_mul(c, T2, Y2, Z1);
  r_mul(c, Z1Z2, Z1, Z2);
  r_mul(c, U1, X1, Z2Z2);
  r_mul(c, U2, X2, Z1Z1);
  r_mul(c, S1, T1, Z2Z2);
  r_mul(c, ta, T2, Z1Z1);            // S2
  r_sub(c, H, U2, U1, 3);
  r_sub(c, Rr, ta, S1, 3);
  r_mul(c, Z1Z1, H, H);              // HH
  r_mul(c, Z2Z2, Rr, Rr);            // RR
  r_mul(c, T1, H, Z1Z1);             // HHH
  r_mul(c, T2, U1, Z1Z1);            // V
  r_mul(c, Z1, Z1Z2, H);             // Z3
  r_sub(c, X1, Z2Z2, T1, 3);
  r_sub(c, X1, X1, T2, 3);
  r_sub(c, X1, X1, T2, 3);           // X3, 12
  r_sub(c, ta, T2, X1, 12);
  r_mul(c, U1, Rr, ta);              // RVX3
  r_mul(c, U2, S1, T1);              // S1HHH
  r_sub(c, Y1, U1, U2, 3);           // Y3, 6
}

// F_p^2: (ar, ai) <- (ar + ai i)^2 with input bounds (9, 9).
static __device__ __forceinline__ void fp2_sqr(const RnsConsts& c, Fe& ar,
                                               Fe& ai) {
  Fe ta, tb, ab;
  r_add(c, ta, ar, ai);
  r_sub(c, tb, ar, ai, 9);
  r_mul(c, ab, ar, ai);
  r_mul(c, ar, ta, tb);
  r_add(c, ai, ab, ab);
}

// F_p^2 Karatsuba: (ar, ai) <- (ar + ai i)(xr + xi i).
static __device__ __forceinline__ void fp2_mul(const RnsConsts& c, Fe& ar,
                                               Fe& ai, const Fe& xr,
                                               const Fe& xi) {
  Fe t0, t1, ta, tb;
  r_mul(c, t0, ar, xr);
  r_mul(c, t1, ai, xi);
  r_add(c, ta, ar, ai);
  r_add(c, tb, xr, xi);
  r_mul(c, ta, ta, tb);              // t2
  r_sub(c, ar, t0, t1, 3);
  r_sub(c, tb, ta, t0, 3);
  r_sub(c, ai, tb, t1, 3);
}

// Channel-major [ch, n] tensor <-> this thread's slots of one lane.
static __device__ __forceinline__ void fe_load(const RnsConsts& c, Fe& out,
                                               const float* src, int n,
                                               int lane) {
#pragma unroll
  for (int s = 0; s < BGN_SLOTS; s++) {
    const int ch = BGN_CH(c, s);
    out.v[s] = ch < c.ch ? src[(size_t)ch * n + lane] : 0.f;
  }
}

static __device__ __forceinline__ void fe_store(const RnsConsts& c,
                                                float* dst, const Fe& v, int n,
                                                int lane) {
#pragma unroll
  for (int s = 0; s < BGN_SLOTS; s++) {
    const int ch = BGN_CH(c, s);
    if (ch < c.ch) dst[(size_t)ch * n + lane] = v.v[s];
  }
}

// Raise the dynamic shared-memory limit and pick the launch shape.
template <typename K>
static inline cudaError_t bgn_prepare(K kernel, int k, int n, dim3* grid,
                                      size_t* smem) {
  *smem = bgn_smem_bytes(k);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  *grid = dim3((n + BGN_LANES - 1) / BGN_LANES);
  return err;
}
