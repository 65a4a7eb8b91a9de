// The RNS Montgomery product with its two base extensions on the tensor
// cores, for a block of G lanes (G warps, one warp per lane as in rns.cuh):
// the product every RNS kernel runs (miller_loop.cu, ladder_loop.cu,
// pow_loop.cu, fp2_pow_loop.cu, dual_ladder.cu, window_ladder_tab.cu,
// window_ladder.cu, dbl_step.cu, add_step.cu, pt_dbl.cu, pt_add.cu,
// pow_step.cu, fp2_pow_step.cu and rns_exit.cu).  Its specification is
// the plain version's r_mul (fieldcore/rns.py): the same channelwise
// steps, the same alpha estimates and the same exact extension sums.
//
// Why the tensor cores: a base extension is a matrix-vector product of
// the k x k extension matrix and a lane's k source residues.  Run by one
// warp per lane, one source channel at a time (a shuffle of the residue,
// then per slot a load of a matrix entry and an integer multiply-add), it
// is bound by instruction issue: ~800 issued instructions per thread per
// product at k = 45 (the 512-bit key), against ~140 for all the
// channelwise work.
//
// What r_mul_tc does about it: the G lanes of a block share the two k x k
// extension matrices, so an extension becomes one matrix product
// [k x k] x [k x G] for the block, which the tensor cores run as
// mma.sync.aligned.m16n8k32 over unsigned 8-bit operands with 32-bit
// sums:
//  1. every warp does the channelwise work of its lane (d = x*y, qhat,
//     the alpha sum, exact and per warp) and writes its lane's k source
//     residues into a shared tile as two u8 planes, lo (bits 0-7) and hi
//     (bits 8-11), one column per lane;
//  2. __syncthreads(); the warps split the ceil(k/16) x G/8 output tiles
//     and run, per 32-channel step of the source, four products of the
//     matrix planes and the residue planes (HH, HL, LH, LL; HL and LH
//     share one accumulator);
//  3. each tile's sums combine as HH * 2^16 + (HL + LH) * 2^8 + LL into a
//     shared [G x k] tile of 32-bit words; __syncthreads();
//  4. every warp reads its lane's column back and goes on channelwise
//     (T = sum + KC*m - alpha*(p mod b) ...).
// The same for the extension B -> A: four barriers per product.  The
// matrix planes (cuda_rns.tc_planes) sit in shared memory in the
// m16n8k32 A-fragment order, so a warp loads a fragment with one 16-byte
// load per thread; the residue tile rows are padded by 16 bytes and the
// sum tile rows by 4 words, so the fragment loads and stores hit distinct
// banks.
//
// Exactness: residues and matrix entries are below 4096, so each has a
// lo plane (< 256) and a hi plane (< 16).  Each plane product sum is at
// most k * 255^2 < 2^31 (k <= 192), so the signed 32-bit mma sums are
// exact, and HL + LH at most 2 * k * 255 * 15.  The combined value is
// exactly the integer dot product sum_i q_i * M[dst][i] that the plain
// version's extension computes (fieldcore/rns.py, through its 6-bit
// split); every term is nonnegative and the sum is bounded by the audit
// of rns.cuh (below k * 4092^2 + (KC + 1) * 4093 < 3.22e9 at k = 192), so
// it fits unsigned 32 bits at S = 12 and int32 below (k <= 96).  So
// r_mul_tc returns the plain version's residues bit for bit.
//
// Lanes >= n of the last block run on zeros and store nothing, so every
// warp of the block reaches every barrier; the Miller and ladder digits
// are shared by all lanes, so all warps run the same sequence of
// products, and the window chains' per-lane digits or flags
// (dual_ladder.cu, window_ladder_tab.cu, window_ladder.cu) pick among
// additions computed for every lane (rns.cuh win_chain_sel,
// window_ladder.cu win_chain_rows).
#pragma once

#include "rns.cuh"

// The lanes (warps) per block G, a multiple of 8 (the mma N dimension),
// and the blocks per SM that __launch_bounds__ asks each S's register
// budget to allow (S = 12 takes one block: 255 registers).  The barriers
// of r_mul_tc stall a block and more resident blocks hide them: at S = 4
// four blocks (64 registers, some state spilled to L1) beat one to three,
// five and six; at S = 6 one block keeps the state in registers, and a
// 1024-bit batch of 512 lanes fills only 64 SMs anyway.  G = 16 lost at
// S = 4 and 6 (PERF.md, the PR 6 sweep).  dbl_step.cu, one doubling of the
// Miller loop per launch, takes the same caps: at S = 4, N = 8192 four
// blocks beat one to three and five, at S = 6 one block is best at the
// 1024-bit key's batches (PERF.md §6, the step sweep); so do add_step.cu,
// one addition per launch, dual_ladder.cu, window_ladder_tab.cu and
// window_ladder.cu (the encrypt sweep) and pt_add.cu (at N = 8192, Encrypt's window chains,
// four blocks beat one to three and five by 8-24 %; at the decrypt's 2048
// one or two blocks win by 8 %, less in all than Encrypt loses).
template <int S>
struct TcLanes {
  static constexpr int G = 8;
  static constexpr int min_blocks = S == 4 ? 4 : 1;
};

// The blocks per SM of the ladder kernel (ladder_loop.cu), which holds 6
// Fe<S> against the Miller loop's 10 and runs 2048 lanes (256 blocks) at
// the 512-bit decrypt's working size, so no SM gets more than two blocks:
// at S = 4 a cap of two (112 registers, no spills) beats the Miller
// kernel's four (64 registers, 408 B spilled), 9.4-9.5 against 9.7-10.0
// ms; at S = 6 one block beats two and three (PERF.md §6, the sweep of
// scripts/kernel_variants.py).  pt_dbl.cu, one doubling of that ladder
// per launch, takes it too: at N = 2048 two blocks (93 registers, no
// spills) beat four (64 registers, 152 B spilled) by 6 % (PERF.md §6,
// the step sweep).
template <int S>
struct TcLadder {
  static constexpr int min_blocks = S == 4 ? 2 : 1;
};

// The blocks per SM of the tensor-core forms of pow_loop.cu (2 Fe<S> of
// state) and fp2_pow_loop.cu (5 Fe<S> and fp2_mul's temporaries), from
// the sweep of scripts/kernel_variants.py (PERF.md §6): pow_loop at S = 4,
// N = 8192 (1024 blocks) runs 5.8 ms at four blocks (64 registers, no
// spills) against 7.9 at one or two; fp2_pow_loop at N = 2048 (256
// blocks) is best at two blocks, at S = 4 (112 registers; three or four
// spill) and at S = 6 (128 registers against 133 at one block, so two
// blocks fit an SM: 1.10 against 1.90 ms).  pow_loop at S = 6 is the same
// at every cap.  fp2_pow_step.cu, one digit of fp2_pow_loop per launch,
// takes TcFp2Pow too: at N = 2048 two blocks beat four (PERF.md §6, the
// step sweep).  pow_step.cu, one square-and-multiply per launch, takes
// TcPow too: at S = 4, N = 8192 four blocks beat one to three and five
// (PERF.md §6, the step sweep).
template <int S>
struct TcPow {
  static constexpr int min_blocks = S == 4 ? 4 : 1;
};

template <int S>
struct TcFp2Pow {
  static constexpr int min_blocks = S == 4 ? 2 : S == 6 ? 2 : 1;
};

// The block's shared memory, 16-byte aligned: bgn_smem (rns.cuh) under
// another name for the byte-addressed tiles.
extern __shared__ __align__(16) unsigned char bgn_tc_smem[];

// Byte offsets of the tensor-core tiles after the constants' small
// vectors (m .. w2a, the same words in both layouts of bgn_layout); the
// extension matrices of the constant blob are not copied.
struct TcLayout {
  int mt, kt;            // 16-row tiles of k, 32-channel steps of k
  int small;             // words of small vectors copied from the blob
  int planes, q, sums;   // byte offsets
  int qs, cs;            // residue tile row stride (bytes), sum tile (words)
  int bytes;             // dynamic shared memory of the block
};

static __host__ __device__ inline TcLayout bgn_tc_layout(int k, int G) {
  RnsConsts c;
  bgn_layout(k, &c, false);
  TcLayout t;
  t.mt = (k + 15) / 16;
  t.kt = (k + 31) / 32;
  t.small = c.w2a + k;
  t.planes = (4 * t.small + 15) / 16 * 16;
  t.qs = 32 * t.kt + 16;
  t.cs = 16 * t.mt + 4;
  t.q = t.planes + 2 * t.mt * t.kt * 2 * 512;   // [mat][mt][kt][plane][512]
  t.sums = t.q + 2 * G * t.qs;                   // [plane][lane][qs]
  t.bytes = t.sums + 4 * G * t.cs;               // [lane][cs] words
  return t;
}

// Copy the small vectors and the matrix planes into shared memory (the
// whole block) and lay out the constants.
template <int S>
static __device__ inline RnsConsts bgn_tc_load_consts(const float* blob,
                                                      const uint4* planes,
                                                      int k) {
  RnsConsts c;
  bgn_layout(k, &c, S > 6);
  const TcLayout t = bgn_tc_layout(k, TcLanes<S>::G);
  if (reinterpret_cast<uintptr_t>(bgn_tc_smem) & 15) __trap();
  for (int w = threadIdx.x; w < t.small; w += blockDim.x)
    bgn_smem[w] = blob[w];
  uint4* dst = reinterpret_cast<uint4*>(bgn_tc_smem + t.planes);
  for (int w = threadIdx.x; w < 2 * t.mt * t.kt * 2 * 32; w += blockDim.x)
    dst[w] = planes[w];
  __syncthreads();
  c.lid = threadIdx.x & 31;
  return c;
}

// D += A * B for one m16n8k32 tile: A 16 x 32 u8 (row), B 32 x 8 u8
// (col), D 16 x 8 s32.
static __device__ __forceinline__ void bgn_mma_u8(unsigned (&d)[4],
                                                  const uint4& a,
                                                  unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// One base extension for the block: sums[lane][dst] = sum_src
// M[dst][src] * q[src][lane] for matrix mat (0: A -> B, 1: B -> A), from
// the residue planes in the q tile.  Called between two barriers.
template <int G>
static __device__ __forceinline__ void bgn_tc_extend(const TcLayout& t,
                                                     int mat, int warp,
                                                     int lid) {
  constexpr int NT = G / 8;
  const int g = lid >> 2, tq = lid & 3;
  const unsigned char* qt = bgn_tc_smem + t.q;
  unsigned* sums = reinterpret_cast<unsigned*>(bgn_tc_smem + t.sums);
  for (int tile = warp; tile < t.mt * NT; tile += G) {
    const int mt = tile % t.mt, nt = tile / t.mt;
    const int col = nt * 8 + g;                  // this thread's B column
    unsigned hh[4] = {0, 0, 0, 0}, mid[4] = {0, 0, 0, 0},
             ll[4] = {0, 0, 0, 0};
    const uint4* af = reinterpret_cast<const uint4*>(
        bgn_tc_smem + t.planes + ((mat * t.mt + mt) * t.kt) * 2 * 512);
    for (int kt = 0; kt < t.kt; kt++) {
      const uint4 alo = af[(2 * kt) * 32 + lid];
      const uint4 ahi = af[(2 * kt + 1) * 32 + lid];
      const int kb = 32 * kt + 4 * tq;
      const unsigned* blo =
          reinterpret_cast<const unsigned*>(qt + col * t.qs + kb);
      const unsigned* bhi =
          reinterpret_cast<const unsigned*>(qt + (G + col) * t.qs + kb);
      const unsigned l0 = blo[0], l1 = blo[4], h0 = bhi[0], h1 = bhi[4];
      bgn_mma_u8(hh, ahi, h0, h1);
      bgn_mma_u8(mid, ahi, l0, l1);
      bgn_mma_u8(mid, alo, h0, h1);
      bgn_mma_u8(ll, alo, l0, l1);
    }
#pragma unroll
    for (int r = 0; r < 4; r++) {
      const int row = 16 * mt + g + 8 * (r >> 1);
      const int lane = nt * 8 + 2 * tq + (r & 1);
      sums[lane * t.cs + row] = (hh[r] << 16) + (mid[r] << 8) + ll[r];
    }
  }
}

// This warp's residue q (< 4096) of source channel src into the q tile.
static __device__ __forceinline__ void bgn_tc_put(const TcLayout& t, int G,
                                                  int warp, int src,
                                                  unsigned q) {
  unsigned char* qt = bgn_tc_smem + t.q;
  qt[warp * t.qs + src] = (unsigned char)(q & 255u);
  qt[(G + warp) * t.qs + src] = (unsigned char)(q >> 8);
}

// RNS Montgomery product x*y/A (value bound 3) for the block's G lanes,
// equal to the plain version's r_mul (fieldcore/rns.py) bit for bit;
// every warp of the block calls it with its lane's operands.  Out of line:
// one copy per kernel and S keeps the build short (inlined at its ~40
// call sites, ptxas took minutes).  The channelwise steps run per warp;
// only the two extension sums come from the tensor cores.
template <int S>
static __device__ __noinline__ Fe<S> r_mul_tc(const int k, const Fe<S> x,
                                              const Fe<S> y) {
  constexpr int SA = S / 2;
  constexpr int G = TcLanes<S>::G;
  RnsConsts c;
  bgn_layout(k, &c, S > 6);
  c.lid = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const TcLayout t = bgn_tc_layout(k, G);
  const unsigned* sums =
      reinterpret_cast<const unsigned*>(bgn_tc_smem + t.sums) + warp * t.cs;
  const bool wide = S > 4 && k > BGN_KNARROW;
  using Acc = typename std::conditional<(S > 6), unsigned, int>::type;
  const Acc KC = S > 4 ? bgn_kc(k) : 128;
  Fe<S> out = {};
  int qv[S];
  float dB[S];
  int s1 = 0;
  double w1 = 0.0;
#pragma unroll
  for (int s = 0; s < S; s++) {
    const int ch = BGN_CH(c, s);
    const float d = bgn_red(__fmul_rn(x.v[s], y.v[s]), bgn_mod(c, ch),
                            ch < c.ch ? BGN_F(c.recip + ch) : 1.f);
    qv[s] = 0;
    dB[s] = d;
    if (ch < k) {
      qv[s] = (int)bgn_red(__fmul_rn(d, BGN_F(c.qc_a + ch)),
                           BGN_F(c.m + ch), BGN_F(c.recip + ch));
      if (wide)
        w1 += (double)qv[s] * (double)BGN_F(c.recip + ch);
      else
        s1 += BGN_I(c.w1a + ch) * qv[s];
      bgn_tc_put(t, G, warp, ch, (unsigned)qv[s]);
    }
  }
  const int a1 = wide ? (int)floor(warp_sum(w1) - 0.4)
                      : bgn_alpha(warp_sum(s1), -0.4);
  __syncthreads();
  bgn_tc_extend<G>(t, 0, warp, c.lid);          // A -> B
  __syncthreads();
  int s2 = 0;
  double w2 = 0.0;
#pragma unroll
  for (int s = 0; s < S; s++) {
    const int ch = BGN_CH(c, s);
    if (ch >= k && ch < c.ch) {
      const int j = ch - k;
      const float m = BGN_F(c.m + ch), r = BGN_F(c.recip + ch);
      const Acc mi = (Acc)m;
      const Acc T = (Acc)sums[j] + KC * mi
                    - (Acc)a1 * (Acc)BGN_F(c.p_mod_b + j);
      const float qpa = (float)(T % mi);
      const float v = bgn_red(__fmul_rn(dB[s], BGN_F(c.ainv_b + j)), m, r) + qpa;
      const float rr = v >= m ? v - m : v;
      out.v[s] = rr;
      qv[s] = (int)bgn_red(__fmul_rn(rr, BGN_F(c.crt_inv_b + j)), m, r);
      if (wide)
        w2 += (double)qv[s] * (double)r;
      else
        s2 += BGN_I(c.w2a + j) * qv[s];
      bgn_tc_put(t, G, warp, j, (unsigned)qv[s]);   // the mmas are done
    }
  }
  const int a2 = wide ? (int)floor(warp_sum(w2) + 0.5)
                      : bgn_alpha(warp_sum(s2), 0.5);
  __syncthreads();                              // every sum read
  bgn_tc_extend<G>(t, 1, warp, c.lid);          // B -> A
  __syncthreads();
#pragma unroll
  for (int s = 0; s < SA; s++) {
    const int ch = BGN_CH(c, s);
    if (ch < k) {
      const Acc mi = (Acc)BGN_F(c.m + ch);
      const Acc T = (Acc)sums[ch] + KC * mi
                    - (Acc)a2 * (Acc)BGN_F(c.b_mod_a + ch);
      out.v[s] = (float)(T % mi);
    }
  }
  return out;
}

// The product policy that runs r_mul_tc: of the step functions (dbl_step,
// add_step, dbl_pt, add_pt) in miller_loop.cu, ladder_loop.cu and the
// step kernels, of add_pt and jac_add_full in dual_ladder.cu,
// window_ladder_tab.cu and window_ladder.cu, and of fp2_sqr / fp2_mul in
// fp2_pow_loop.cu and fp2_pow_step.cu.
template <int S>
struct MulTc {
  static __device__ __forceinline__ void mul(const RnsConsts& c, Fe<S>& out,
                                             const Fe<S>& x,
                                             const Fe<S>& y) {
    out = r_mul_tc<S>(c.k, x, y);
  }
};
