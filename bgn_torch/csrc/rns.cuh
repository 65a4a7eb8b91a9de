// RNS field and curve arithmetic as CUDA device functions: the library
// that every RNS kernel of bgn_torch runs (a loop kernel calls the steps
// in a loop, a step kernel once), the counterpart of
// bgn_tpu/fieldcore/rns.py (_red, r_add, r_sub) and the step functions of
// bgn_tpu/ops/rns_pairing.py (_dbl_step, _add_step, _dbl_pt, _add_pt,
// _fp2_mul, _fp2_sqr) and pallas_rns.py (_jac_add_full).  The RNS
// Montgomery product itself is rns_tc.cuh's r_mul_tc, which every kernel
// passes to the step functions as their product policy (Mul: MulTc<S>).
//
// An F_p element is 2k residues modulo 12-bit primes (base A = channels
// 0..k-1, base B = channels k..2k-1).  One warp owns one lane (one batch
// element): thread l of the warp holds channel c = 32*s + l in slot s of
// an S-entry register array (Fe<S>), so 2k <= 32*S.  Every kernel is
// instantiated three times: S = 4 for k <= 64 (keys to ~700 bits), S = 6
// for k <= 96 (1024-bit keys, k = 90) and S = 12 for 96 < k <= 192
// (2048-bit keys, k = 185); the wrapper picks S from k (ops/cuda_rns.py
// slots_for).  Which base a slot holds follows from ch < k, so base A may
// end inside a slot (at k = 90, slot 2 holds base-A channels 64..89 and
// base-B channels 90..95).  Every index into an Fe is a compile-time
// constant and every helper here is inlined (the product is one
// out-of-line copy per S taking and returning Fe by value), so a lane's
// whole loop state stays in registers.  Channelwise work is one slot op
// per thread; the constants a thread reads (moduli, reciprocals, the
// Montgomery one, (K*p) mod m) sit in shared memory at the word offsets
// of the constant blob (bgn_layout, mirrored by cuda_rns.blob_layout).
// Branches depend only on a lane's digits or flags, or on digits shared
// by the block, so a warp never diverges.
//
// Exactness: every float value is an integer below 2^24, so float
// products and sums are exact, and contraction into FMAs changes nothing.
// The base extensions are exact dot products against the unsplit
// extension matrices plus the bias KC*m (fieldcore/rns.py _kc): with
// residues and matrix entries <= 4092 the sum, less alpha times a residue
// (alpha >= -1), lies in [0, k * 4092^2 + (KC + 1) * 4093).  Up to S = 6
// it is summed in int32, which holds it for every k <= 128 (at k = 128,
// KC = 256: 2.1444e9 < 2.1475e9); at S = 12 in unsigned 32-bit integers,
// which hold it for every k <= 256 (at k = 192, KC = 256: 3.216e9; at
// k = 256, KC = 512: 4.2887e9 < 4.2950e9), the subtraction of alpha times
// a residue wrapping mod 2^32, exact because the true value lies in that
// range.
// The alpha estimate:
//  - narrow path (k <= 64): an exact int32 sum of 8-bit weights
//    round(2^19/m) times residues (< 64 * 256 * 4096 = 2^26), a warp
//    reduction, scaled in double;
//  - wide path (k > 64): floor(sum_i q_i * recip_i + eps) in double, as
//    fieldcore/rns.py _alpha_sum.  Each product of a 12-bit integer and
//    an fp32 reciprocal (~2^-12, 24-bit mantissa) is a multiple of 2^-35
//    below 4, and the sum stays below 192 * 4 < 2^10, so the double sum
//    (45 significant bits at most) is exact in any order: the warp
//    reduction gives the plain version's value.
// The result of each step is the canonical residue of the same integer
// that the plain PyTorch version (fieldcore/rns.py) reduces, so the two
// agree bit for bit.  Above k = 192 there is no instantiation (a key with
// more channels takes the limb path: scheme._make_rns).  What bounds each
// kernel on the H100 is written in its source and in rns_tc.cuh.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#define BGN_KNARROW 64                 // narrow alpha path: k <= 64
#define BGN_KSMEM 96                   // k above: S = 12, blob rows per source
#define BGN_KPCOLS 33                  // kp columns: (K*p) mod m, K <= 32
#define BGN_FULL 0xffffffffu

// A lane's F_p element as this thread's S slots; passed by value to the
// out-of-line product (4S bytes travel in registers), by reference to the
// inlined helpers, so it never lives in memory.
template <int S>
struct Fe {
  float v[S];
};

// The block's copy of the constants (dynamic shared memory).
extern __shared__ float bgn_smem[];

// Shape of the constants and this thread's place in its warp; the other
// fields are word offsets into bgn_smem (so every access is a shared-
// memory load, also inside the out-of-line product) or, for the matrices,
// into the blob (their offsets lay out the blob; the kernels take the
// matrices as rns_tc.cuh's planes instead).
struct RnsConsts {
  int k, ch, rs, lid;          // rs: matrix row stride; lid: thread in warp
  int m, recip, one, kp, qc_a, p_mod_b, ainv_b, crt_inv_b, b_mod_a;
  int w1a, w2a, mat1, mat2;    // int entries: [k], [k], [k][rs], [k][rs]
  int smem;                    // words of the blob copied to shared memory
};

#define BGN_F(o) (bgn_smem[o])
#define BGN_I(o) (reinterpret_cast<const int*>(bgn_smem)[o])

// Row stride of the extension matrices.  In shared memory (gmem false,
// k <= BGN_KSMEM): rows per destination, >= k and == 1 (mod 32), so the
// warp's reads of 32 consecutive rows hit distinct banks.  In device
// memory (gmem true, S = 12): rows per source, indexed by destination
// channel, 2k rounded up to 32.  Mirrors cuda_rns.blob_layout.
static __host__ __device__ inline int bgn_row_stride(int k, bool gmem) {
  if (gmem) return (2 * k + 31) / 32 * 32;
  return k <= 1 ? 1 : ((k - 2) / 32 + 1) * 32 + 1;
}

// Word offsets of the constant blob; mirrors cuda_rns.blob_layout.  gmem
// is k > BGN_KSMEM, given by the callers at compile time as S > 6 where
// they can.
static __host__ __device__ inline int bgn_layout(int k, RnsConsts* c,
                                                 bool gmem) {
  int ch = 2 * k, rs = bgn_row_stride(k, gmem), o = 0;
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
  if (gmem) {                  // 128-byte aligned rows in device memory
    c->smem = o;
    o = (o + 31) / 32 * 32;
    c->mat1 = o; o += k * rs;  // [i][ch]: src base-A channel i, dst ch >= k
    c->mat2 = o; o += k * rs;  // [j][ch]: src base-B channel j, dst ch < k
    return o;
  }
  c->mat1 = o; o += k * rs;    // [j][i]: dst base-B channel j, src i
  c->mat2 = o; o += k * rs;    // [i][j]: dst base-A channel i, src j
  c->smem = o;
  return o;
}

// The C = KC*m bias of the extensions: must exceed the largest alpha
// (<= k).  Mirrors fieldcore/rns.py _kc.
static __host__ __device__ inline int bgn_kc(int k) {
  if (k <= BGN_KNARROW) return 128;
  int b = 0;
  for (int v = k + 1; v; v >>= 1) b++;
  return 1 << (b > 7 ? b : 7);
}

static __device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(BGN_FULL, v, o);
  return v;
}

static __device__ __forceinline__ double warp_sum(double v) {
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

template <int S>
static __device__ __forceinline__ void r_add(const RnsConsts& c, Fe<S>& out,
                                             const Fe<S>& x, const Fe<S>& y) {
#pragma unroll
  for (int s = 0; s < S; s++) {
    const float m = bgn_mod(c, BGN_CH(c, s));
    const float v = x.v[s] + y.v[s];
    out.v[s] = v >= m ? v - m : v;
  }
}

// x - y + K*p (K = the static bound of y), kept nonnegative.
template <int S>
static __device__ __forceinline__ void r_sub(const RnsConsts& c, Fe<S>& out,
                                             const Fe<S>& x, const Fe<S>& y,
                                             int K) {
#pragma unroll
  for (int s = 0; s < S; s++) {
    const int ch = BGN_CH(c, s);
    const float m = bgn_mod(c, ch);
    float v = (x.v[s] + bgn_kp(c, ch, K)) - y.v[s];
    v = v < 0.f ? v + m : v;
    out.v[s] = v >= m ? v - m : v;
  }
}

template <int S>
static __device__ __forceinline__ void fe_copy(Fe<S>& out, const Fe<S>& x) {
#pragma unroll
  for (int s = 0; s < S; s++) out.v[s] = x.v[s];
}

template <int S>
static __device__ __forceinline__ void fe_zero(Fe<S>& out) {
#pragma unroll
  for (int s = 0; s < S; s++) out.v[s] = 0.f;
}

// This thread's slots of a full 2k-channel row in device memory.
template <int S>
static __device__ __forceinline__ void fe_gather(const RnsConsts& c,
                                                 Fe<S>& out,
                                                 const float* row) {
#pragma unroll
  for (int s = 0; s < S; s++) {
    const int ch = BGN_CH(c, s);
    out.v[s] = ch < c.ch ? row[ch] : 0.f;
  }
}

// The Montgomery one (residues of A mod p).
template <int S>
static __device__ __forceinline__ void fe_one(const RnsConsts& c, Fe<S>& out) {
#pragma unroll
  for (int s = 0; s < S; s++) {
    const int ch = BGN_CH(c, s);
    out.v[s] = ch < c.ch ? BGN_F(c.one + ch) : 0.f;
  }
}

// Residues of (K*p - value) for a coordinate of static bound K.
template <int S>
static __device__ __forceinline__ void fe_neg(const RnsConsts& c, Fe<S>& out,
                                              const Fe<S>& v, int K) {
#pragma unroll
  for (int s = 0; s < S; s++) {
    const int ch = BGN_CH(c, s);
    const float x = bgn_kp(c, ch, K) - v.v[s];
    out.v[s] = x < 0.f ? x + bgn_mod(c, ch) : x;
  }
}

// floor(s * 2^-19 + eps) for an exact int32 sum s (narrow path).
static __device__ __forceinline__ int bgn_alpha(int s, double eps) {
  return (int)floor((double)s * (1.0 / 524288.0) + eps);
}

// ---------------------------------------------------------------------------
// Curve and Miller steps.  The integer after each r_sub is the static
// bound K of its subtrahend, as rns_pairing.py's RVal bookkeeping sets it
// (invariants X, Y < 27p, Z < 6p, f < 9p, affine inputs < 3p).  Mul is
// the product policy, Mul::mul(c, out, x, y): every kernel names it, and
// every kernel passes rns_tc.cuh's block-wide MulTc<S>.
// ---------------------------------------------------------------------------

// Jacobian doubling + tangent line at phi(B) + f <- f^2 * line (21 r_muls).
template <int S, class Mul>
static __device__ __forceinline__ void dbl_step(const RnsConsts& c,
                                                Fe<S>& X, Fe<S>& Y, Fe<S>& Z,
                                                Fe<S>& fr, Fe<S>& fi,
                                                const Fe<S>& xb,
                                                const Fe<S>& yb) {
  Fe<S> XX, ZZ, YY, YZ, t2, ab, sqre, ta, tb;
  Mul::mul(c, XX, X, X);
  Mul::mul(c, ZZ, Z, Z);
  Mul::mul(c, YY, Y, Y);
  Mul::mul(c, YZ, Y, Z);
  Mul::mul(c, t2, X, Z);
  Mul::mul(c, ab, fr, fi);
  r_add(c, ta, fr, fi);
  r_sub(c, tb, fr, fi, 9);
  Mul::mul(c, sqre, ta, tb);
  Fe<S> Z3, sqim;
  r_add(c, Z3, YZ, YZ);
  r_add(c, sqim, ab, ab);
  Fe<S> ZZZ, ZZZZ, YYYY, T;
  Mul::mul(c, ZZZ, Z, ZZ);
  Mul::mul(c, ZZZZ, ZZ, ZZ);
  Mul::mul(c, YYYY, YY, YY);
  Mul::mul(c, T, X, YY);
  Fe<S> M, Sv;
  r_add(c, ta, XX, XX);
  r_add(c, ta, XX, ta);
  r_add(c, M, ta, ZZZZ);             // 12
  r_add(c, Sv, T, T);
  r_add(c, Sv, Sv, Sv);              // 12
  // layer 3 (MM reuses XX, t1 reuses ZZ, Z3ZZZ reuses YY, Z3Y reuses ab)
  Mul::mul(c, XX, M, M);
  Mul::mul(c, ZZ, ZZZ, xb);
  Mul::mul(c, YY, Z3, ZZZ);
  Mul::mul(c, ab, Z3, Y);
  Fe<S> X3;
  r_sub(c, X3, XX, Sv, 12);
  r_sub(c, X3, X3, Sv, 12);          // 27
  Fe<S> Y8;
  r_add(c, Y8, YYYY, YYYY);
  r_add(c, Y8, Y8, Y8);
  r_add(c, Y8, Y8, Y8);              // 24
  // layer 4
  r_sub(c, ta, Sv, X3, 27);
  Mul::mul(c, ZZZZ, M, ta);             // MSX3
  r_add(c, tb, ZZ, t2);
  Mul::mul(c, T, M, tb);                // Mt
  Mul::mul(c, YZ, YY, yb);              // l_im
  r_sub(c, Y, ZZZZ, Y8, 24);         // Y3 (old Y no longer needed)
  r_sub(c, M, T, ab, 3);             // l_re
  // layer 5
  Mul::mul(c, XX, sqre, M);             // m0
  Mul::mul(c, ZZ, sqim, YZ);            // m1
  r_add(c, ta, sqre, sqim);
  r_add(c, tb, M, YZ);
  Mul::mul(c, YY, ta, tb);              // m2
  r_sub(c, fr, XX, ZZ, 3);
  r_sub(c, ta, YY, XX, 3);
  r_sub(c, fi, ta, ZZ, 3);
  fe_copy(X, X3);
  fe_copy(Z, Z3);
}

// Mixed addition V + A + line through V, A at phi(B) + f <- f * line
// (17 r_muls).
template <int S, class Mul>
static __device__ __forceinline__ void add_step(const RnsConsts& c,
                                                Fe<S>& X1, Fe<S>& Y1,
                                                Fe<S>& Z1, Fe<S>& fr,
                                                Fe<S>& fi, const Fe<S>& ax,
                                                const Fe<S>& ay,
                                                const Fe<S>& xb,
                                                const Fe<S>& yb) {
  Fe<S> ZZ, U2, ZZZ, H, R, ta;
  Mul::mul(c, ZZ, Z1, Z1);
  Mul::mul(c, U2, ax, ZZ);
  Mul::mul(c, ZZZ, Z1, ZZ);
  Mul::mul(c, ta, ay, ZZZ);             // S2
  r_sub(c, H, U2, X1, 27);           // 30
  r_sub(c, R, ta, Y1, 27);           // 30
  Fe<S> HH, RR, Z3, Rx;
  Mul::mul(c, HH, H, H);
  Mul::mul(c, RR, R, R);
  Mul::mul(c, Z3, Z1, H);
  r_add(c, ta, xb, ax);
  Mul::mul(c, Rx, R, ta);
  Fe<S> HHH, V, Z3ya, lim;
  Mul::mul(c, HHH, H, HH);
  Mul::mul(c, V, X1, HH);
  Mul::mul(c, Z3ya, Z3, ay);
  Mul::mul(c, lim, Z3, yb);
  Fe<S> X3;
  r_sub(c, X3, RR, HHH, 3);
  r_sub(c, X3, X3, V, 3);
  r_sub(c, X3, X3, V, 3);            // 12
  r_sub(c, U2, Rx, Z3ya, 3);         // l_re
  r_sub(c, ta, V, X3, 12);
  Mul::mul(c, ZZ, R, ta);               // RVX3
  Mul::mul(c, ZZZ, Y1, HHH);            // Y1HHH
  r_sub(c, Y1, ZZ, ZZZ, 3);          // Y3
  Mul::mul(c, HH, fr, U2);              // m0
  Mul::mul(c, RR, fi, lim);             // m1
  r_add(c, ta, fr, fi);
  r_add(c, H, U2, lim);
  Mul::mul(c, R, ta, H);                // m2
  r_sub(c, fr, HH, RR, 3);
  r_sub(c, ta, R, HH, 3);
  r_sub(c, fi, ta, RR, 3);
  fe_copy(X1, X3);
  fe_copy(Z1, Z3);
}

// Jacobian doubling without line math (9 r_muls, 9 r_adds, 4 r_subs), the
// operation order of rns_pairing.py _dbl_pt; result bounds (27, 27, 6).
// Mul: the product policy, as for dbl_step.
template <int S, class Mul>
static __device__ __forceinline__ void dbl_pt(const RnsConsts& c, Fe<S>& X,
                                              Fe<S>& Y, Fe<S>& Z) {
  Fe<S> XX, YY, ZZ;
  Mul::mul(c, XX, X, X);
  Mul::mul(c, YY, Y, Y);
  Mul::mul(c, ZZ, Z, Z);
  Fe<S> YYYY, ZZZZ, T, YZ;
  Mul::mul(c, YYYY, YY, YY);
  Mul::mul(c, ZZZZ, ZZ, ZZ);
  Mul::mul(c, T, X, YY);
  Mul::mul(c, YZ, Y, Z);
  Fe<S> M, Sv, ta;
  r_add(c, ta, XX, XX);
  r_add(c, ta, XX, ta);
  r_add(c, M, ta, ZZZZ);             // 12
  r_add(c, Sv, T, T);
  r_add(c, Sv, Sv, Sv);              // 12
  Mul::mul(c, XX, M, M);                // MM
  r_sub(c, X, XX, Sv, 12);
  r_sub(c, X, X, Sv, 12);            // X3, 27
  r_add(c, YY, YYYY, YYYY);
  r_add(c, YY, YY, YY);
  r_add(c, YY, YY, YY);              // Y8, 24
  r_sub(c, ta, Sv, X, 27);
  Mul::mul(c, ZZ, M, ta);               // MSX3
  r_sub(c, Y, ZZ, YY, 24);           // Y3, 27
  r_add(c, Z, YZ, YZ);               // Z3, 6
}

// Mixed addition V + A without line math or completeness selects
// (11 r_muls).
template <int S, class Mul>
static __device__ __forceinline__ void add_pt(const RnsConsts& c, Fe<S>& X1,
                                              Fe<S>& Y1, Fe<S>& Z1,
                                              const Fe<S>& ax,
                                              const Fe<S>& ay) {
  Fe<S> ZZ, U2, ZZZ, H, R, ta;
  Mul::mul(c, ZZ, Z1, Z1);
  Mul::mul(c, U2, ax, ZZ);
  Mul::mul(c, ZZZ, Z1, ZZ);
  Mul::mul(c, ta, ay, ZZZ);             // S2
  r_sub(c, H, U2, X1, 27);
  r_sub(c, R, ta, Y1, 27);
  Fe<S> HH, RR;
  Mul::mul(c, HH, H, H);
  Mul::mul(c, RR, R, R);
  Mul::mul(c, Z1, Z1, H);               // Z3 (old Z1 no longer needed)
  Mul::mul(c, U2, H, HH);               // HHH
  Mul::mul(c, ZZ, X1, HH);              // V
  r_sub(c, X1, RR, U2, 3);
  r_sub(c, X1, X1, ZZ, 3);
  r_sub(c, X1, X1, ZZ, 3);           // X3, 12
  r_sub(c, ta, ZZ, X1, 12);
  Mul::mul(c, HH, R, ta);               // RVX3
  Mul::mul(c, RR, Y1, U2);              // Y1HHH
  r_sub(c, Y1, HH, RR, 3);
}

// One fixed-base window chain over windows [j0, j1) of per-lane `digits`
// ([Jt, n]), row d of window j read from the tables tx/ty [J, R, 2k] at
// ((j - j0) * R + d) * 2k (one contiguous run per row; row 0 is the
// identity), computed for every lane and selected, as the TPU kernels
// (_dual_ladder_kernel, _win_ladder_tab_kernel) and the plain version
// (ops/cuda_rns.py _window_chain) run it, so that every warp of a block
// runs the same products (Mul: the block-wide product of rns_tc.cuh;
// dual_ladder.cu and window_ladder_tab.cu).
// At every window each warp gathers its lane's row d (a dead window,
// d = 0, and a lane >= n, which reads no digit, gather row 0: residues
// of 0) and adds it to the accumulator (add_pt, 11 products); then a
// live window sets the accumulator to the row (Z = 1) if none was live
// before, else to the sum, and a dead one keeps it.  The accumulator
// starts at X = Y = 0, Z = 1, as the plain version's, so every operand
// of a discarded product is canonical.  Returns whether a window was
// live.
template <int S, class Mul>
static __device__ __forceinline__ bool win_chain_sel(
    const RnsConsts& c, Fe<S>& X, Fe<S>& Y, Fe<S>& Z, const float* tx,
    const float* ty, int R, const int* digits, int j0, int j1, int n,
    int lane) {
  fe_zero(X);
  fe_zero(Y);
  fe_one(c, Z);
  bool st = false;
  for (int j = j0; j < j1; j++) {
    const int d = lane < n ? digits[(size_t)j * n + lane] : 0;
    const size_t row = ((size_t)(j - j0) * R + d) * c.ch;
    Fe<S> RX, RY, AX, AY, AZ;
    fe_gather(c, RX, tx + row);
    fe_gather(c, RY, ty + row);
    fe_copy(AX, X);
    fe_copy(AY, Y);
    fe_copy(AZ, Z);
    add_pt<S, Mul>(c, AX, AY, AZ, RX, RY);
    if (d != 0 && !st) {
      fe_copy(X, RX);
      fe_copy(Y, RY);
      fe_one(c, Z);
    } else if (d != 0) {
      fe_copy(X, AX);
      fe_copy(Y, AY);
      fe_copy(Z, AZ);
    }
    st = st || d != 0;
  }
  return st;
}

// General Jacobian + Jacobian addition (both live, not +-equal);
// result bounds (12, 6, 3).  Outputs overwrite X1, Y1, Z1.  Mul: the
// product policy, as for dbl_step.
template <int S, class Mul>
static __device__ __forceinline__ void jac_add_full(const RnsConsts& c,
                                                    Fe<S>& X1, Fe<S>& Y1,
                                                    Fe<S>& Z1,
                                                    const Fe<S>& X2,
                                                    const Fe<S>& Y2,
                                                    const Fe<S>& Z2) {
  Fe<S> Z1Z1, Z2Z2, T1, T2, Z1Z2, U1, U2, S1, H, Rr, ta;
  Mul::mul(c, Z1Z1, Z1, Z1);
  Mul::mul(c, Z2Z2, Z2, Z2);
  Mul::mul(c, T1, Y1, Z2);
  Mul::mul(c, T2, Y2, Z1);
  Mul::mul(c, Z1Z2, Z1, Z2);
  Mul::mul(c, U1, X1, Z2Z2);
  Mul::mul(c, U2, X2, Z1Z1);
  Mul::mul(c, S1, T1, Z2Z2);
  Mul::mul(c, ta, T2, Z1Z1);         // S2
  r_sub(c, H, U2, U1, 3);
  r_sub(c, Rr, ta, S1, 3);
  Mul::mul(c, Z1Z1, H, H);           // HH
  Mul::mul(c, Z2Z2, Rr, Rr);         // RR
  Mul::mul(c, T1, H, Z1Z1);          // HHH
  Mul::mul(c, T2, U1, Z1Z1);         // V
  Mul::mul(c, Z1, Z1Z2, H);          // Z3
  r_sub(c, X1, Z2Z2, T1, 3);
  r_sub(c, X1, X1, T2, 3);
  r_sub(c, X1, X1, T2, 3);           // X3, 12
  r_sub(c, ta, T2, X1, 12);
  Mul::mul(c, U1, Rr, ta);           // RVX3
  Mul::mul(c, U2, S1, T1);           // S1HHH
  r_sub(c, Y1, U1, U2, 3);           // Y3, 6
}

// F_p^2: (ar, ai) <- (ar + ai i)^2 with input bounds (9, 9).  Mul: the
// product policy, as for dbl_step.
template <int S, class Mul>
static __device__ __forceinline__ void fp2_sqr(const RnsConsts& c, Fe<S>& ar,
                                               Fe<S>& ai) {
  Fe<S> ta, tb, ab;
  r_add(c, ta, ar, ai);
  r_sub(c, tb, ar, ai, 9);
  Mul::mul(c, ab, ar, ai);
  Mul::mul(c, ar, ta, tb);
  r_add(c, ai, ab, ab);
}

// F_p^2 Karatsuba: (ar, ai) <- (ar + ai i)(xr + xi i).
template <int S, class Mul>
static __device__ __forceinline__ void fp2_mul(const RnsConsts& c, Fe<S>& ar,
                                               Fe<S>& ai, const Fe<S>& xr,
                                               const Fe<S>& xi) {
  Fe<S> t0, t1, ta, tb;
  Mul::mul(c, t0, ar, xr);
  Mul::mul(c, t1, ai, xi);
  r_add(c, ta, ar, ai);
  r_add(c, tb, xr, xi);
  Mul::mul(c, ta, ta, tb);           // t2
  r_sub(c, ar, t0, t1, 3);
  r_sub(c, tb, ta, t0, 3);
  r_sub(c, ai, tb, t1, 3);
}

// Per-lane select between two elements on a warp-uniform flag.
template <int S>
static __device__ __forceinline__ void fe_pick(Fe<S>& out, bool take_a,
                                               const Fe<S>& a,
                                               const Fe<S>& b) {
#pragma unroll
  for (int s = 0; s < S; s++) out.v[s] = take_a ? a.v[s] : b.v[s];
}

// Channel-major [ch, n] tensor <-> this thread's slots of one lane.
template <int S>
static __device__ __forceinline__ void fe_load(const RnsConsts& c, Fe<S>& out,
                                               const float* src, int n,
                                               int lane) {
#pragma unroll
  for (int s = 0; s < S; s++) {
    const int ch = BGN_CH(c, s);
    out.v[s] = ch < c.ch ? src[(size_t)ch * n + lane] : 0.f;
  }
}

template <int S>
static __device__ __forceinline__ void fe_store(const RnsConsts& c,
                                                float* dst, const Fe<S>& v,
                                                int n, int lane) {
#pragma unroll
  for (int s = 0; s < S; s++) {
    const int ch = BGN_CH(c, s);
    if (ch < c.ch) dst[(size_t)ch * n + lane] = v.v[s];
  }
}

// Launch the instantiation for `slots` (4: k <= 64, 6: k <= 96, 12:
// 96 < k <= 192, the device-memory matrices) of a template launcher
// fn<S>(args...); any other slot count, or k outside it, is refused before
// a launch.
#define BGN_DISPATCH(slots, k, fn, ...)                                   \
  (((slots) == 4 && (k) <= 64)   ? fn<4>(__VA_ARGS__)                     \
   : ((slots) == 6 && (k) <= BGN_KSMEM) ? fn<6>(__VA_ARGS__)              \
   : ((slots) == 12 && (k) > BGN_KSMEM && (k) <= 192)                     \
       ? fn<12>(__VA_ARGS__)                                              \
       : (int)cudaErrorInvalidValue)
