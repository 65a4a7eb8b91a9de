"""The tensor-core base extension of csrc/rns_tc.cuh, held on the CPU:
the u8 planes of the extension matrices (cuda_rns.tc_planes) against the
matrices of the constant blob through their documented index map, and an
integer emulation of the kernel's block product (the m16n8k32 fragments,
the four plane products, their combination) against the extension sums of
the plain r_mul (fieldcore/rns.py), bit for bit, also on every product of
a ladder as scalar_mul_rns runs it (identity-base lanes, a short last
block).  No JAX.

The moduli are odd numbers p = 3 mod 4 with no factor below 2000 that
pass Fermat tests to six bases, found from a seed; their widths give
k = 47 (the 512-bit key's slot count S = 4), 92 (S = 6) and 186 (S = 12).
"""
import _torch_threads  # noqa: F401  (first: one torch thread per process)
import math
import random

import numpy as np
import pytest
import torch

from bgn_torch.fieldcore import limbs as lb
from bgn_torch.fieldcore import montgomery as mg
from bgn_torch.fieldcore import rns as trn
from bgn_torch.ops import cuda_rns, curve
from bgn_torch.ops import rns_pairing as rp

WIDTHS = {544: 47, 1056: 92, 2080: 186}


def _ctx(bits):
    rng = random.Random(bits)
    small = math.prod(trn._primes_desc(3, 2000))
    while True:
        p = rng.getrandbits(bits) | (1 << (bits - 1)) | 3
        if math.gcd(p, small) == 1 and \
                all(pow(a, p - 1, p) == 1 for a in (2, 3, 5, 7, 11, 13)):
            ctx = trn.make_rns_ctx(p, device="cpu")
            assert ctx.k == WIDTHS[bits]
            return ctx


@pytest.fixture(scope="module", params=sorted(WIDTHS), ids=lambda b: f"{b}b")
def ctx(request):
    return _ctx(request.param)


def _tiles(k):
    """16-row tiles and 32-channel steps of k (rns_tc.cuh TcLayout)."""
    return -(-k // 16), -(-k // 32)


def _blob_mats(ctx):
    """mat1 [dst j, src i] and mat2 [dst i, src j] read back from the
    constant blob (both of its layouts)."""
    k = ctx.k
    off = cuda_rns.blob_layout(k)
    blob = cuda_rns.const_blob(ctx).numpy().astype(np.int64)
    rs = off["rs"]
    m1 = blob[off["mat1"]:off["mat1"] + k * rs].reshape(k, rs)
    m2 = blob[off["mat2"]:off["mat2"] + k * rs].reshape(k, rs)
    if k > cuda_rns.K_SMEM_MAX:                     # rows per source
        return m1[:, k:2 * k].T, m2[:, :k].T
    return m1[:, :k], m2[:, :k]


def test_tc_planes_map_back_to_the_blob_matrices(ctx):
    """hi * 256 + lo through tc_index gives mat1 and mat2 of const_blob;
    every entry of the padded matrices appears once in each plane, the
    padding is zero, the hi plane holds 4 bits, and there are as many
    bytes as tc_index maps: 2 matrices x mt x kt tiles x 2 planes x 512."""
    k = ctx.k
    planes = cuda_rns.tc_planes(ctx).numpy().astype(np.int64)
    mat, plane, row, col = cuda_rns.tc_index(k)
    mt, kt = _tiles(k)
    assert planes.shape == mat.shape
    assert planes.size == 2 * mt * kt * 2 * 512
    flat = (mat * 16 * mt + row) * 32 * kt + col
    for pl in (0, 1):
        counts = np.bincount(flat[plane == pl], minlength=2 * 16 * mt * 32 * kt)
        assert counts.min() == 1 and counts.max() == 1
    assert planes[plane == 1].max() < 16
    M = np.zeros((2, 16 * mt, 32 * kt), dtype=np.int64)
    np.add.at(M, (mat, row, col), np.where(plane == 1, 256, 1) * planes)
    mat1, mat2 = _blob_mats(ctx)
    np.testing.assert_array_equal(M[0, :k, :k], mat1)
    np.testing.assert_array_equal(M[1, :k, :k], mat2)
    assert not M[:, k:, :].any() and not M[:, :, k:].any()
    assert cuda_rns.tc_planes(ctx) is cuda_rns.tc_planes(ctx)   # cached


def _mma(a_frags, b_frags):
    """mma.sync.m16n8k32.row.col.s32.u8.u8.s32 over one warp's fragments:
    a_frags [..., 32, 16] bytes, b_frags [..., 32, 8] bytes -> d
    [..., 32, 4] int64, by the PTX fragment layouts (g = lane // 4,
    q = lane % 4); leading axes broadcast, one warp's product each."""
    lane = np.arange(32)[:, None]
    g, q = lane // 4, lane % 4
    i = np.arange(16)[None, :]
    A = np.zeros(a_frags.shape[:-2] + (16, 32), dtype=np.int64)
    A[..., g + 8 * ((i // 4) % 2), 4 * q + i % 4 + 16 * (i // 8)] = a_frags
    j = np.arange(8)[None, :]
    B = np.zeros(b_frags.shape[:-2] + (32, 8), dtype=np.int64)
    B[..., 4 * q + j % 4 + 16 * (j // 4), g] = b_frags
    D = A @ B
    r = np.arange(4)[None, :]
    d = D[..., g + 8 * (r // 2), 2 * q + r % 2]
    assert d.max() < 2 ** 31                       # the s32 sums are exact
    return d


def _block_extension(ctx, mat, cols, G=8):
    """The kernel's extension for blocks of G lanes (rns_tc.cuh
    bgn_tc_extend): residues cols [k, N] (one column per lane, N a
    multiple of G, block b the lanes b*G .. b*G + G - 1) as lo/hi planes
    of each block's q tile, the warps' output tiles, four plane products
    per 32-channel step, HH * 2^16 + (HL + LH) * 2^8 + LL in unsigned 32
    bits.  Every block, output tile and step is one warp's _mma, run as
    one batch.  Returns the sum tiles [N, k]."""
    k = ctx.k
    mt, kt = _tiles(k)
    N = cols.shape[1]
    assert N % G == 0 and G % 8 == 0
    planes = cuda_rns.tc_planes(ctx).numpy().reshape(2, mt, kt, 2, 32, 16)
    alo = planes[mat, :, :, 0].astype(np.int64)            # [mt, kt, 32, 16]
    ahi = planes[mat, :, :, 1].astype(np.int64)
    qt = np.zeros((2, N, 32 * kt), dtype=np.int64)
    qt[0, :, :k] = (cols & 255).T
    qt[1, :, :k] = (cols >> 8).T
    lane = np.arange(32)
    g, q = lane // 4, lane % 4
    kb = 32 * np.arange(kt)[:, None] + 4 * q                # [kt, 32]
    idx = np.concatenate([kb[..., None] + np.arange(4),
                          kb[..., None] + 16 + np.arange(4)], axis=-1)
    base = np.arange(0, N, 8).reshape(N // G, G // 8)       # [blocks, nt]
    rows = (base[:, :, None] + g)[:, :, None, :, None]      # lane's row
    b = [qt[pl][rows, idx] for pl in (0, 1)]                # [.., kt, 32, 8]
    blo, bhi = (x[:, :, None] for x in b)                   # + tile axis t
    acc = {"hh": _mma(ahi, bhi), "mid": _mma(ahi, blo) + _mma(alo, bhi),
           "ll": _mma(alo, blo)}                            # [.., t, s, 32, 4]
    u32 = {n: v.sum(axis=3).astype(np.uint32) for n, v in acc.items()}
    v = (u32["hh"] << np.uint32(16)) + (u32["mid"] << np.uint32(8)) \
        + u32["ll"]                                         # [.., t, 32, 4]
    r = np.arange(4)
    out_row = base[:, :, None, None, None] + (2 * q[:, None] + r % 2)
    out_col = 16 * np.arange(mt)[:, None, None] + (g[:, None] + 8 * (r // 2))
    sums = np.zeros((N, 16 * mt), dtype=np.uint32)
    sums[out_row, out_col] = v
    return sums[:, :k]


def _plain_sums(ctx, W, q):
    """The plain r_mul's extension sum of residues q [k, N]: the split
    product O of fieldcore/rns.py recombined, 4096 O1 + 64 O2 + O3."""
    k = ctx.k
    O, _ = trn._ext_dot(W, trn._split6(q))
    O = O.numpy().astype(np.int64)
    return O[:k] * 4096 + O[k:2 * k] * 64 + O[2 * k:3 * k]


@pytest.mark.parametrize("kind", ["random", "all_m_minus_1"])
def test_block_product_equals_plain_extension_sums(ctx, kind):
    """The emulated block product equals the plain extension sums bit for
    bit, for both extensions, over 13 lanes (a batch that is not a
    multiple of G = 8: the last block's lanes 13-15 run on zeros), with
    seeded random residues and with every residue m - 1, the largest
    sums."""
    k, n, G = ctx.k, 13, 8
    m = ctx.m.numpy().astype(np.int64)[:, 0]
    if kind == "random":
        q = np.random.default_rng(k).integers(0, 1 << 30, (2 * k, n)) \
            % m[:, None]
    else:
        q = np.repeat(m[:, None] - 1, n, axis=1)
    for mat, W, src in ((0, ctx.w1, q[:k]), (1, ctx.w2, q[k:])):
        want = _plain_sums(ctx, W, torch.tensor(src, dtype=torch.float32))
        cols = np.zeros((k, 2 * G), dtype=np.int64)
        cols[:, :n] = src
        got = _block_extension(ctx, mat, cols, G).T.astype(np.int64)
        np.testing.assert_array_equal(got[:, :n], want)
        assert not got[:, n:].any()


def test_block_product_on_the_ladder_inputs(ctx, monkeypatch):
    """The ladder kernel's products (csrc/ladder_loop.cu, dbl_pt and
    add_pt on r_mul_tc) on the inputs rns_pairing.scalar_mul_rns gives
    it: 13 lanes of an L1 decrypt's ciphertext points, lanes 3 and 7 the
    identity (x = y = 0, as curve.to_affine leaves it), padded to two
    blocks of G = 8 with the zero lanes the kernel runs past n.  Every
    source residue that a product writes to the planes is below 4096,
    and the emulated block product equals the plain extension sums of
    every product of the ladder, both extensions, bit for bit; the padded
    ladder's 13 lanes equal the unpadded one's."""
    k, n, G = ctx.k, 13, 8
    p = lb.limbs_to_ints(ctx.p_limbs.reshape(-1, 1))[0]
    rng = random.Random(k)
    mctx = mg.make_mont_ctx(p, L=ctx.L, device="cpu")
    xs = [rng.randrange(p) for _ in range(n)]
    ys = [rng.randrange(p) for _ in range(n)]
    inf = np.zeros(n, dtype=np.int64)
    for i in (3, 7):
        xs[i] = ys[i] = 0
        inf[i] = 1
    base = curve.AffinePoint(torch.as_tensor(lb.ints_to_limbs(xs, mctx.L)),
                             torch.as_tensor(lb.ints_to_limbs(ys, mctx.L)),
                             torch.as_tensor(inf))
    unpadded, records = [], []
    real_dot = trn._ext_dot

    def recording_dot(W, x):
        records.append((0 if W is ctx.w1 else 1, x))
        return real_dot(W, x)

    def padded_ladder(rns, X, Y, Z, ax, ay, digits):
        unpadded.append(cuda_rns.ladder_loop_plain(rns, X, Y, Z, ax, ay,
                                                   digits))
        pad = [torch.cat([v, torch.zeros_like(v[:, :2 * G - n])], dim=1)
               for v in (X, Y, Z, ax, ay)]
        monkeypatch.setattr(trn, "_ext_dot", recording_dot)
        out = cuda_rns.ladder_loop_plain(rns, *pad, digits)
        monkeypatch.setattr(trn, "_ext_dot", real_dot)
        return out

    monkeypatch.setattr(cuda_rns, "ladder_loop", padded_ladder)
    monkeypatch.setattr(rp, "_PALLAS_MODE", "loop")
    out = rp.scalar_mul_rns(mctx, ctx, base, [1, 1, -1])
    for got, want in zip(out, unpadded[0]):
        assert torch.equal(got.v[:, :n], want)
    # the plain steps stack independent products along the lanes
    # (r_mul_many): 2G columns per product, 2 doublings and 2 additions
    products = [x.shape[1] // (2 * G) for mat, x in records if mat == 0]
    assert sum(products) == 2 * 9 + 2 * 11
    for mat, x in records:
        q = (x[:k] * 64 + x[k:]).numpy().astype(np.int64)   # [k, 2G * j]
        assert q.min() >= 0 and q.max() < 4096
        want = _plain_sums(ctx, ctx.w1 if mat == 0 else ctx.w2,
                           torch.tensor(q, dtype=torch.float32))
        got = _block_extension(ctx, mat, q, G).T.astype(np.int64)
        np.testing.assert_array_equal(got, want)
