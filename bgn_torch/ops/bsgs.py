"""Batched baby-step/giant-step discrete-log decryption.

The port's counterpart of `bgn_tpu/ops/bsgs.py`: the same host-built,
salted, sorted digest tables and the same reference indexing (a hit at
giant step i with table value j means m = i*bound + j + 1; the inverse is
tried second and its hit negated).  The G1 and GT giant-step scans run
in RNS by default; candidates convert to canonical limbs only for the digest lookup, and
every digest hit is verified against the full stored limbs.  Under
BGNParams(rns_miller="0") the limb scans bsgs_g1 (complete mixed
additions, one limb normalize over all candidates) and bsgs_gt (F_p^2
products) run instead, as in the JAX package off the TPU.

Digests are uint32 sums with wraparound in the JAX package; here they are
computed in int64 (products < 2^48, sums < 2^55) and masked to 32 bits,
which gives the same values.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from .. import hostmath as hm
from ..fieldcore import limbs as lb
from ..fieldcore import montgomery as mg
from ..fieldcore import rns as rn
from ..fieldcore.montgomery import MontCtx
from ..utils import convert
from . import fp2
from . import rns_pairing as rp
from .curve import AffinePoint, JacPoint, dbl, madd, normalize, to_jac

_MASK32 = 0xFFFFFFFF


def _host_mont(x: int, p: int, L: int) -> np.ndarray:
    """Montgomery form limbs of x (host)."""
    return lb.int_to_limbs(x * (1 << (16 * L)) % p, L)


def _host_digest(words: np.ndarray, salts: np.ndarray) -> np.ndarray:
    """words [W, T] -> digest [T]; linear salted hash mod 2^32."""
    return (words.astype(np.uint64) * salts[:, None].astype(np.uint64)
            ).sum(axis=0).astype(np.uint32)


def _device_digest(words: torch.Tensor, salts: torch.Tensor) -> torch.Tensor:
    """words [W, *batch] int64 limbs, salts [W] -> [*batch] digests."""
    s = salts.reshape((salts.shape[0],) + (1,) * (words.dim() - 1))
    return (words * s).sum(dim=0) & _MASK32


class GroupTable(nn.Module):
    """Sorted digest table for one group (G1 or GT): digests [T] sorted,
    values [T] (j of each entry), keys [W, L, T] full Montgomery limbs for
    verification, salts [W*L]; all int64 holding uint32 values."""

    def __init__(self, digests, values, keys, salts):
        super().__init__()
        for name, a in (("digests", digests), ("values", values),
                        ("keys", keys), ("salts", salts)):
            self.register_buffer(
                name, torch.as_tensor(np.asarray(a).astype(np.int64)))


class DecryptTables(nn.Module):
    """Everything device-side decryption needs: the two group tables,
    gsk = P^q1 and e(P,P)^q1, and the giant steps gamma^-1."""

    def __init__(self, table_g1: GroupTable, table_gt: GroupTable,
                 gsk_g1: AffinePoint, gamma_inv_g1: AffinePoint, gsk_gt,
                 gamma_inv_gt, bound: int, bound_t: int):
        super().__init__()
        self.table_g1 = table_g1
        self.table_gt = table_gt
        for name, pt in (("gsk_g1", gsk_g1), ("gamma_inv_g1", gamma_inv_g1)):
            for f in AffinePoint._fields:
                self.register_buffer(f"{name}_{f}", getattr(pt, f))
        self.register_buffer("gsk_gt", torch.as_tensor(gsk_gt))
        self.register_buffer("gamma_inv_gt", torch.as_tensor(gamma_inv_gt))
        self.bound = bound
        self.bound_t = bound_t

    def point(self, name: str) -> AffinePoint:
        return AffinePoint(*(getattr(self, f"{name}_{f}")
                             for f in AffinePoint._fields))


def _build_group_table(L: int, elems, to_words, rng) -> GroupTable:
    """elems: list of T host group elements; to_words: elem -> [W*L]."""
    T = len(elems)
    words = np.stack([to_words(e) for e in elems], axis=1)  # [W*L, T]
    while True:
        salts = np.asarray(
            [rng.getrandbits(32) | 1 for _ in range(words.shape[0])],
            dtype=np.uint32)
        digests = _host_digest(words, salts)
        if len(np.unique(digests)) == T:
            break
    order = np.argsort(digests, kind="stable")
    W = words.shape[0] // L
    return GroupTable(digests=digests[order],
                      values=np.arange(T, dtype=np.uint32)[order],
                      keys=words[:, order].reshape(W, L, T), salts=salts)


def _ec_multiples(gen, count: int, p: int):
    """[1*gen, 2*gen, ..., count*gen] as affine host points (Jacobian
    accumulation + one batched inversion)."""
    gx, gy = gen
    jacs = [(gx, gy, 1)]
    if count > 1:
        lam = (3 * gx * gx + 1) * pow(2 * gy, -1, p) % p
        x2 = (lam * lam - 2 * gx) % p
        y2 = (lam * (gx - x2) - gy) % p
        X, Y, Z = x2, y2, 1
        jacs.append((X, Y, Z))
    for _ in range(count - 2):
        ZZ = Z * Z % p
        H = (gx * ZZ - X) % p
        if H == 0:
            raise ValueError("multiples chain wrapped the group order; "
                             "msg_space too large for this subgroup")
        R = (gy * ZZ % p * Z - Y) % p
        HH = H * H % p
        HHH = H * HH % p
        V = X * HH % p
        X = (R * R - HHH - 2 * V) % p
        Y = (R * (V - X) - Y * HHH) % p
        Z = Z * H % p
        jacs.append((X, Y, Z))
    zs = [z for _, _, z in jacs]
    prefix = [1] * (len(zs) + 1)
    for i, z in enumerate(zs):
        prefix[i + 1] = prefix[i] * z % p
    inv = pow(prefix[-1], -1, p)
    out = [None] * len(jacs)
    for i in range(len(jacs) - 1, -1, -1):
        X, Y, Z = jacs[i]
        zi = inv * prefix[i] % p
        inv = inv * Z % p
        zi2 = zi * zi % p
        out[i] = (X * zi2 % p, Y * zi2 % p * zi % p)
    return out


def build_decrypt_tables(key: hm.GoldenKey, ctx: MontCtx, rng) -> DecryptTables:
    """Host-side table build (PrecomputeTables, gsbs.go:17-51); draws the
    same salts from `rng` as the JAX package, G1 table first."""
    params, p, L = key.params, key.params.p, ctx.L
    q1, msg_space = params.q1, key.msg_space
    bound = math.isqrt(msg_space - 1) + 1 if msg_space > 1 else 1
    bound_t = bound + 1

    gen_g1 = hm.ec_mul(q1, key.P, p)
    gen_gt = hm.fp2_pow(key.gt_base(), q1, p)
    g1_elems = _ec_multiples(gen_g1, bound_t + 1, p)
    gt_elems = []
    auxt = gen_gt
    for _ in range(bound_t + 1):
        gt_elems.append(auxt)
        auxt = hm.fp2_mul(auxt, gen_gt, p)

    def words(e):
        return np.concatenate([_host_mont(e[0], p, L), _host_mont(e[1], p, L)])

    gamma_g1 = hm.ec_mul(bound, gen_g1, p)
    gamma_gt = hm.fp2_pow(gen_gt, bound, p)
    dev = ctx.p.device
    return DecryptTables(
        table_g1=_build_group_table(L, g1_elems, words, rng),
        table_gt=_build_group_table(L, gt_elems, words, rng),
        gsk_g1=convert.point_from_host(ctx, gen_g1),
        gamma_inv_g1=convert.point_from_host(ctx, hm.ec_neg(gamma_g1, p)),
        gsk_gt=convert.fp2_single_from_host(ctx, gen_gt),
        gamma_inv_gt=convert.fp2_single_from_host(
            ctx, hm.fp2_conj(gamma_gt, p)),
        bound=bound, bound_t=bound_t,
    ).to(dev)


def _lookup(table: GroupTable, words: torch.Tensor):
    """words [W*L, *batch] -> (hit {0,1}, value) via searchsorted + verify."""
    batch_shape = words.shape[1:]
    d = _device_digest(words, table.salts)
    T = table.digests.shape[0]
    idx = torch.searchsorted(table.digests, d.reshape(-1)).reshape(batch_shape)
    idx = torch.clamp(idx, max=T - 1)
    cand = table.keys.reshape(-1, T)[:, idx]                 # [W*L, *batch]
    hit = torch.all(cand == words, dim=0).to(torch.int64)
    return hit, table.values[idx]


def _first_hit(hits: torch.Tensor, vals: torch.Tensor, bound: int):
    """hits, vals: [bound+1, *batch] -> (found, m) with m = i*bound + val
    + 1 for the FIRST hit i (gsbs.go:98)."""
    found = torch.any(hits.to(torch.bool), dim=0)
    i_star = torch.argmax(hits, dim=0)
    val = torch.gather(vals, 0, i_star[None])[0]
    return found.to(torch.int64), i_star * bound + val + 1


def _signed_result(hits, vals, bound: int, is_zero_ct):
    """(found, m signed) from the hits of the positive lane [:, 0] and the
    inverse lane [:, 1]: the positive hit first (bgn.go:235-242), m = 0
    for the identity."""
    found_p, m_p = _first_hit(hits[:, 0], vals[:, 0], bound)
    found_n, m_n = _first_hit(hits[:, 1], vals[:, 1], bound)
    m_signed = torch.where(found_p.to(torch.bool), m_p, -m_n)
    m_signed = torch.where(is_zero_ct.to(torch.bool),
                           torch.zeros_like(m_signed), m_signed)
    return is_zero_ct | found_p | found_n, m_signed


def g1_lanes(ctx: MontCtx, csk: JacPoint) -> JacPoint:
    """csk and its inverse on a new batch axis: Jacobian [L, 2, *batch]."""
    neg_csk = JacPoint(csk.X, mg.mod_neg(ctx, csk.Y), csk.Z)
    return JacPoint(*(torch.stack([u, w], dim=1) for u, w in zip(csk, neg_csk)))


def g1_scan(ctx: MontCtx, tables: DecryptTables, v: JacPoint, length: int):
    """The limb giant-step chain v, v*gamma^-1, ... (`length` candidates,
    complete mixed additions) from the stacked lanes v [L, 2, *batch], ONE
    limb normalize of all candidates, and the digest lookup.  Returns
    (hits, vals) [length, 2, *batch]."""
    batch = tuple(v.Z.shape[2:])
    L = ctx.L
    g = tables.point("gamma_inv_g1")
    shape = (L,) + batch
    base = AffinePoint(lb.expand_to(g.x, shape), lb.expand_to(g.y, shape),
                       g.inf.reshape((1,) * len(batch)).expand(batch))
    base2 = dbl(ctx, to_jac(ctx, base))
    base_b = AffinePoint(base.x[:, None], base.y[:, None], base.inf[None])
    base2_b = JacPoint(base2.X[:, None], base2.Y[:, None], base2.Z[:, None])
    auxs = [v]
    for _ in range(length - 1):
        v = madd(ctx, v, base_b, base2_b)
        auxs.append(v)
    # candidates [L, length, 2, *batch], normalized in one batch inversion
    aff = normalize(ctx, JacPoint(*(torch.stack(c, dim=1)
                                    for c in zip(*auxs))))
    words = torch.cat([aff.x, aff.y], dim=0)
    hits, vals = _lookup(tables.table_g1, words)
    return hits * (1 - aff.inf), vals   # the identity matches no entry


def bsgs_g1(ctx: MontCtx, tables: DecryptTables, csk: JacPoint):
    """Limb giant-step scan + lookup for a batch of G1 points csk = C^q1
    (Jacobian [L, *batch]): the chain csk * gamma^-i of complete mixed
    additions for i = 0..bound, in both signs, then ONE limb normalize of
    all candidates.  Returns (found {0,1}, m signed) of batch shape."""
    hits, vals = g1_scan(ctx, tables, g1_lanes(ctx, csk), tables.bound + 1)
    return _signed_result(hits, vals, tables.bound, lb.is_zero(csk.Z))


def gt_scan(ctx: MontCtx, tables: DecryptTables, z, length: int):
    """The limb giant-step chain of F_p^2 products from the stacked lanes
    z [2, L, 2, *batch] (`length` candidates) and the digest lookup.
    Returns (hits, vals) [length, 2, *batch]."""
    batch = tuple(z.shape[3:])
    gamma = tables.gamma_inv_gt.reshape((2, ctx.L, 1) + (1,) * len(batch))
    auxs = [z]
    for _ in range(length - 1):
        z = fp2.mul(ctx, z, gamma)
        auxs.append(z)
    auxs = torch.stack(auxs, dim=2)                     # [2, L, C, 2, *b]
    words = auxs.reshape((2 * ctx.L,) + tuple(auxs.shape[2:]))
    return _lookup(tables.table_gt, words)


def bsgs_gt(ctx: MontCtx, tables: DecryptTables, csk):
    """bsgs_g1 for GT: csk [2, L, *batch] = c^q1 in F_p^2; the giant steps
    are F_p^2 products and the inverse is the conjugate (unitary)."""
    z = torch.stack([csk, fp2.conj(ctx, csk)], dim=2)   # [2, L, 2, *batch]
    hits, vals = gt_scan(ctx, tables, z, tables.bound + 1)
    return _signed_result(hits, vals, tables.bound, fp2.is_one(ctx, csk))


def g1_rns_lanes(rns, Xr, Yr, Zr):
    """csk (RVals [2k, B]) and its inverse (X, K*p - Y, Z) side by side:
    raw residues [2k, 2B]."""
    negY = rns.kp[:, Yr.bound:Yr.bound + 1] - Yr.v
    negY = torch.where(negY < 0, negY + rns.m, negY)
    return (torch.cat([Xr.v, Xr.v], dim=-1), torch.cat([Yr.v, negY], dim=-1),
            torch.cat([Zr.v, Zr.v], dim=-1))


def g1_rns_scan(ctx: MontCtx, rns, tables: DecryptTables, X, Y, Z, inf2,
                length: int):
    """The RNS giant-step chain from the stacked lanes X, Y, Z [2k, 2B]
    (`length` candidates, the incomplete mixed addition: see bsgs_g1_rns),
    one batch inversion, the candidates' canonical limbs and the digest
    lookup.  inf2: [2B] identity mask of the lanes.  Returns (hits, vals,
    mask) [length, 2, B]; mask flags the identity candidates."""
    k2 = 2 * rns.k
    B = X.shape[-1] // 2
    L = ctx.L
    C = length
    g = tables.point("gamma_inv_g1")
    gx = rn.to_rns_mont(rns, g.x.reshape(L, 1)).v.expand(k2, 2 * B)
    gy = rn.to_rns_mont(rns, g.y.reshape(L, 1)).v.expand(k2, 2 * B)
    Xs, Ys, Zs = [], [], []
    for i in range(C):                          # collect BEFORE the add
        Xs.append(X)
        Ys.append(Y)
        Zs.append(Z)
        if i < C - 1:
            X, Y, Z = rp._add_pt(rns, X, Y, Z, rp._pt(gx), rp._pt(gy))

    def wide(vals):                  # C x [2k, 2B] -> [2k, C * 2B]
        return torch.stack(list(vals), dim=1).reshape(k2, C * 2 * B)

    # identity mask from canonical limb Z (no exact zero test in RNS)
    Zl = rn.from_rns_mont(rns, rn.RVal(wide(Zs), 6))
    zmask = lb.is_zero(Zl).reshape(C, 2 * B) | inf2[None]
    one_b = rns.one_rns.expand(k2, 2 * B)
    zsub = torch.where(zmask[:, None].to(torch.bool), one_b[None],
                       torch.stack(Zs, dim=0))          # [C, 2k, 2B]
    zinv = rn.r_batch_inv(rns, zsub, ctx.pm2_bits)

    iw = rn.RVal(wide(zinv), 3)
    i2 = rn.r_mul(rns, iw, iw)
    i3 = rn.r_mul(rns, i2, iw)
    xl, yl = rn.from_rns_mont(rns, rn.r_mul(rns, rn.RVal(wide(Xs), 27), i2),
                              rn.r_mul(rns, rn.RVal(wide(Ys), 27), i3))
    mask4 = zmask.reshape(C, 2, B)
    xl = lb.select(mask4, torch.zeros_like(xl.reshape(L, C, 2, B)),
                   xl.reshape(L, C, 2, B))
    yl = lb.select(mask4, torch.zeros_like(yl.reshape(L, C, 2, B)),
                   yl.reshape(L, C, 2, B))

    words = torch.cat([xl, yl], dim=0)                   # [2L, C, 2, B]
    hits, vals = _lookup(tables.table_g1, words)
    return hits * (1 - mask4), vals, mask4


def bsgs_g1_rns(ctx: MontCtx, rns, tables: DecryptTables, Xr, Yr, Zr,
                base_inf):
    """G1 giant-step scan + lookup for csk in RNS form (RVals [2k, B], the
    raw output of rns_pairing.scalar_mul_rns).  base_inf: [B] identity
    mask of the input ciphertexts (their raw residues are garbage).

    The chain uses the incomplete mixed addition: candidate i hits
    V == -addend only when m == (i+1)*bound (the true sum is the
    identity and comes out as Z == 0), and V == +addend only after the
    true hit at step i-2; a Z == 0 candidate keeps Z == 0 and is masked
    from the lookup.  Returns (found {0,1}, m signed) int64 [B]."""
    B = Xr.v.shape[-1]
    inf2 = torch.cat([base_inf, base_inf], dim=-1).to(torch.int64)
    hits, vals, mask4 = g1_rns_scan(ctx, rns, tables,
                                    *g1_rns_lanes(rns, Xr, Yr, Zr), inf2,
                                    tables.bound + 1)
    # csk == identity <=> m = 0 (candidate 0 is csk itself)
    return _signed_result(hits, vals, tables.bound, mask4[0, 0] | inf2[:B])


def gt_rns_lanes(rns, zr, zi):
    """csk (RVals [2k, B]) and its conjugate side by side: raw residues
    [2k, 2B]."""
    negI = rns.kp[:, zi.bound:zi.bound + 1] - zi.v
    negI = torch.where(negI < 0, negI + rns.m, negI)
    return torch.cat([zr.v, zr.v], dim=-1), torch.cat([zi.v, negI], dim=-1)


def gt_rns_scan(ctx: MontCtx, rns, tables: DecryptTables, cr, ci,
                length: int):
    """The RNS giant-step chain of F_p^2 products from the stacked lanes
    (cr, ci) [2k, 2B] (`length` candidates, each taken as bound 9), their
    canonical limbs and the digest lookup.  Returns (hits, vals) [length,
    2, B] and the limbs (re, im) [L, length, 2, B]."""
    k2 = 2 * rns.k
    B = cr.shape[-1] // 2
    L = ctx.L
    C = length
    gr = rn.to_rns_mont(rns, tables.gamma_inv_gt[0].reshape(L, 1))
    gi = rn.to_rns_mont(rns, tables.gamma_inv_gt[1].reshape(L, 1))
    grb = rn.RVal(gr.v.expand(k2, 2 * B), 3)
    gib = rn.RVal(gi.v.expand(k2, 2 * B), 3)

    Rs, Is = [cr], [ci]
    for _ in range(C - 1):
        nr, ni = rp._fp2_mul(rns, (rn.RVal(cr, 9), rn.RVal(ci, 9)),
                             (grb, gib))
        cr, ci = nr.v, ni.v
        Rs.append(cr)
        Is.append(ci)

    def limbs(stack):
        flat = torch.stack(stack, dim=1).reshape(k2, C * 2 * B)
        return rn.from_rns_mont(rns, rn.RVal(flat, 9)).reshape(L, C, 2, B)

    rl, il = limbs(Rs), limbs(Is)
    words = torch.cat([rl, il], dim=0)                   # [2L, C, 2, B]
    hits, vals = _lookup(tables.table_gt, words)
    return hits, vals, rl, il


def bsgs_gt_rns(ctx: MontCtx, rns, tables: DecryptTables, zr, zi):
    """GT giant-step scan for csk = (zr, zi) RVals [2k, B] (raw output of
    rns_pairing.fp2_pow_rns).  GT inverses are conjugations (unitary
    subgroup).  Returns (found {0,1}, m signed) int64 [B]."""
    hits, vals, rl, il = gt_rns_scan(ctx, rns, tables,
                                     *gt_rns_lanes(rns, zr, zi),
                                     tables.bound + 1)
    # csk == 1 <=> m = 0: candidate 0 of the positive lane is csk
    one_ext = lb.expand_to(ctx.one, rl[:, 0, 0].shape)
    is_zero_ct = lb.eq(rl[:, 0, 0], one_ext) & lb.is_zero(il[:, 0, 0])
    return _signed_result(hits, vals, tables.bound, is_zero_ct)
