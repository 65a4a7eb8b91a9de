"""Batched arithmetic on E: y^2 = x^3 + x over F_p (the A1 curve) on
limbs: the port's counterpart of `bgn_tpu/ops/curve.py`.

  - AffinePoint(x, y, inf): x, y int64 Montgomery-form limbs [L, *batch],
    inf int64 {0,1} of batch shape (1 = the identity O).  Ciphertexts are
    stored affine.
  - JacPoint(X, Y, Z): the compute form; Z == 0 encodes O.

madd is complete (v = O, b = O, v == b via 2b, v == -b, by lane selects),
so the limb ladders and the re-randomizing additions are total functions.
The port's hot G1 paths run in RNS (ops/rns_pairing.py); these limb forms
serve the L1 re-randomization (fixed_base_mul over Q's table), the wide
L1 MultConst (scalar_mul) and their normalize, and under
BGNParams(rns_miller="0") every G1 op (Encrypt, the L1 ops, the L1
decrypt's C^q1 and giant steps).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..fieldcore import limbs as lb
from ..fieldcore import montgomery as mg
from ..fieldcore.montgomery import MontCtx


class AffinePoint(NamedTuple):
    x: torch.Tensor    # [L, *batch] Montgomery form
    y: torch.Tensor    # [L, *batch]
    inf: torch.Tensor  # [*batch] {0,1}


class JacPoint(NamedTuple):
    X: torch.Tensor
    Y: torch.Tensor
    Z: torch.Tensor    # Z == 0 encodes the identity


def affine_infinity(ctx: MontCtx, batch_shape=()) -> AffinePoint:
    z = torch.zeros((ctx.L,) + tuple(batch_shape), dtype=torch.int64,
                    device=ctx.p.device)
    return AffinePoint(z, z, torch.ones(tuple(batch_shape), dtype=torch.int64,
                                        device=ctx.p.device))


def jac_infinity(ctx: MontCtx, batch_shape=()) -> JacPoint:
    one = lb.expand_to(ctx.one, (ctx.L,) + tuple(batch_shape))
    return JacPoint(one, one, torch.zeros_like(one))


def to_jac(ctx: MontCtx, a: AffinePoint) -> JacPoint:
    one = lb.expand_to(ctx.one, tuple(a.x.shape))
    return JacPoint(a.x, a.y, lb.select(a.inf, torch.zeros_like(one), one))


def normalize(ctx: MontCtx, j: JacPoint, rns=None) -> AffinePoint:
    """Jacobian -> canonical affine via the batch inversion of Z.  rns:
    an RNSCtx; when the RNS path handles the key (pairing.use_rns), its
    pow_loop kernel runs the batch's one Fermat inversion
    (rns_pairing.mont_inv_rns), as the JAX package does on the TPU;
    otherwise the limb chain mont_inv."""
    L = ctx.L
    zflat = j.Z.reshape(L, -1)
    inv_fn = None
    from . import pairing as pairing_mod
    if pairing_mod.use_rns(rns):
        from .rns_pairing import mont_inv_rns

        def inv_fn(t):
            return mont_inv_rns(ctx, rns, t)

    zinv = mg.batch_mont_inv(ctx, zflat, inv_fn=inv_fn).reshape(j.Z.shape)
    zinv2 = mg.mont_mul(ctx, zinv, zinv)
    zinv3 = mg.mont_mul(ctx, zinv2, zinv)
    x = mg.mont_mul(ctx, j.X, zinv2)
    y = mg.mont_mul(ctx, j.Y, zinv3)
    inf = lb.is_zero(j.Z)
    zero = torch.zeros_like(x)
    return AffinePoint(lb.select(inf, zero, x), lb.select(inf, zero, y), inf)


def neg_affine(ctx: MontCtx, a: AffinePoint) -> AffinePoint:
    return AffinePoint(a.x, mg.mod_neg(ctx, a.y), a.inf)


def eq_affine(a: AffinePoint, b: AffinePoint) -> torch.Tensor:
    """Equality of canonical affine points; int64 {0,1}."""
    both_inf = a.inf & b.inf
    coords = lb.eq(a.x, b.x) & lb.eq(a.y, b.y) & (1 - a.inf) & (1 - b.inf)
    return both_inf | coords


def select_jac(mask, a: JacPoint, b: JacPoint) -> JacPoint:
    return JacPoint(lb.select(mask, a.X, b.X), lb.select(mask, a.Y, b.Y),
                    lb.select(mask, a.Z, b.Z))


def select_affine(mask, a: AffinePoint, b: AffinePoint) -> AffinePoint:
    return AffinePoint(lb.select(mask, a.x, b.x), lb.select(mask, a.y, b.y),
                       torch.where(mask.to(torch.bool), a.inf, b.inf))


def dbl(ctx: MontCtx, v: JacPoint) -> JacPoint:
    """Jacobian doubling for a = 1 (curve y^2 = x^3 + x), 9 muls.  Z == 0
    and Y == 0 (2-torsion) both land on Z' == 0."""
    X, Y, Z = v
    XX = mg.mont_mul(ctx, X, X)
    YY = mg.mont_mul(ctx, Y, Y)
    YYYY = mg.mont_mul(ctx, YY, YY)
    ZZ = mg.mont_mul(ctx, Z, Z)
    ZZZZ = mg.mont_mul(ctx, ZZ, ZZ)
    M = mg.mod_add(ctx, mg.mod_add(ctx, XX, mg.mod_add(ctx, XX, XX)), ZZZZ)
    T = mg.mont_mul(ctx, X, YY)
    S = mg.mod_add(ctx, T, T)
    S = mg.mod_add(ctx, S, S)                      # S = 4*X*Y^2
    MM = mg.mont_mul(ctx, M, M)
    X3 = mg.mod_sub(ctx, mg.mod_sub(ctx, MM, S), S)
    Y8 = mg.mod_add(ctx, YYYY, YYYY)
    Y8 = mg.mod_add(ctx, Y8, Y8)
    Y8 = mg.mod_add(ctx, Y8, Y8)                   # 8*Y^4
    Y3 = mg.mod_sub(ctx, mg.mont_mul(ctx, M, mg.mod_sub(ctx, S, X3)), Y8)
    YZ = mg.mont_mul(ctx, Y, Z)
    Z3 = mg.mod_add(ctx, YZ, YZ)
    return JacPoint(X3, Y3, Z3)


def madd(ctx: MontCtx, v: JacPoint, b: AffinePoint,
         b_dbl: Optional[JacPoint] = None) -> JacPoint:
    """Complete mixed addition v + b, 11 muls plus selects.  b_dbl: the
    precomputed 2b (Jacobian) used when v == b; computed here if None."""
    X1, Y1, Z1 = v
    ZZ = mg.mont_mul(ctx, Z1, Z1)
    U2 = mg.mont_mul(ctx, b.x, ZZ)
    ZZZ = mg.mont_mul(ctx, Z1, ZZ)
    S2 = mg.mont_mul(ctx, b.y, ZZZ)
    H = mg.mod_sub(ctx, U2, X1)
    R = mg.mod_sub(ctx, S2, Y1)
    HH = mg.mont_mul(ctx, H, H)
    HHH = mg.mont_mul(ctx, H, HH)
    V = mg.mont_mul(ctx, X1, HH)
    RR = mg.mont_mul(ctx, R, R)
    X3 = mg.mod_sub(ctx, mg.mod_sub(ctx, mg.mod_sub(ctx, RR, HHH), V), V)
    Y3 = mg.mod_sub(ctx, mg.mont_mul(ctx, R, mg.mod_sub(ctx, V, X3)),
                    mg.mont_mul(ctx, Y1, HHH))
    Z3 = mg.mont_mul(ctx, Z1, H)
    out = JacPoint(X3, Y3, Z3)

    v_inf = lb.is_zero(Z1)
    h_zero = lb.is_zero(H)
    r_zero = lb.is_zero(R)
    if b_dbl is None:                  # v == b: the doubling of b
        b_dbl = dbl(ctx, to_jac(ctx, b))
    same = h_zero & r_zero & (1 - v_inf) & (1 - b.inf)
    out = select_jac(same, b_dbl, out)
    opp = h_zero & (1 - r_zero) & (1 - v_inf) & (1 - b.inf)   # v == -b: O
    out = JacPoint(out.X, out.Y, lb.select(opp, torch.zeros_like(out.Z),
                                           out.Z))
    out = select_jac(v_inf, to_jac(ctx, b), out)              # v == O: b
    return select_jac(b.inf & (1 - v_inf), v, out)            # b == O: v


def add_affine(ctx: MontCtx, a: AffinePoint, b: AffinePoint) -> JacPoint:
    """General complete a + b for two affine batches."""
    return madd(ctx, to_jac(ctx, a), b)


def sum_affine(ctx: MontCtx, points, batch_shape, rns=None) -> AffinePoint:
    """Sum of affine point batches of one batch shape: a fold of complete
    mixed additions into a Jacobian accumulator (no inversion per step)
    and ONE normalize at the end (rns as in normalize)."""
    v = jac_infinity(ctx, tuple(batch_shape))
    for pt in points:
        v = madd(ctx, v, pt)
    return normalize(ctx, v, rns=rns)


def fixed_base_mul(ctx: MontCtx, table: AffinePoint, digits) -> JacPoint:
    """base^e from a radix-R window table: table [L, J, R] with entry
    (j, d) = base^(d*R^j) (d = 0 the identity); digits [Jd, *batch] base-R
    digits of e, least significant first, Jd <= J.  One complete mixed
    addition per window."""
    d = torch.as_tensor(digits, device=table.x.device).to(torch.int64)
    Jd, batch = d.shape[0], tuple(d.shape[1:])
    jidx = torch.arange(Jd, device=d.device).reshape((Jd,) + (1,) * len(batch))
    gx, gy = table.x[:, jidx, d], table.y[:, jidx, d]   # [L, Jd, *batch]
    ginf = table.inf[jidx, d]                           # [Jd, *batch]
    v = jac_infinity(ctx, batch)
    for j in range(Jd):
        v = madd(ctx, v, AffinePoint(gx[:, j], gy[:, j], ginf[j]))
    return v


def scalar_mul(ctx: MontCtx, base: AffinePoint, bits) -> JacPoint:
    """base^e (written multiplicatively, as pbc does) by double-and-add.
    bits: [nbits] shared (an addition only on set bits) or [nbits, *batch]
    one exponent per element (both paths and a select).  Leading zero bits
    are harmless; an identity base gives the identity."""
    bits = torch.as_tensor(bits, device=base.x.device)
    batch = tuple(np.broadcast_shapes(tuple(base.x.shape[1:]),
                                      tuple(bits.shape[1:])))
    shape = (ctx.L,) + batch
    base = AffinePoint(lb.expand_to(base.x, shape), lb.expand_to(base.y, shape),
                       base.inf.reshape(tuple(base.inf.shape) + (1,) * (
                           len(batch) - base.inf.dim())).expand(batch))
    base2 = dbl(ctx, to_jac(ctx, base))
    v = jac_infinity(ctx, batch)
    if bits.dim() == 1:
        for bit in bits.tolist():
            v = dbl(ctx, v)
            if bit:
                v = madd(ctx, v, base, base2)
    else:
        for bit in bits:
            d = dbl(ctx, v)
            v = select_jac(bit.expand(batch), madd(ctx, d, base, base2), d)
    return JacPoint(v.X, v.Y, lb.select(base.inf, torch.zeros_like(v.Z), v.Z))
