"""Encrypted dot product: the flagship BGN workload (2-DNF / SIP pattern).

The port's counterpart of `bgn_tpu/models/encrypted_dot.py`.  Given
coordinate-wise encryptions E(x_i), E(y_i) of two vectors, an L2
encryption of <x, y> is prod_i e(Cx_i, Cy_i): D pairings plus a GT
reduction, no interaction, no secret key (the reference exposes the
primitives, Mult bgn.go:294 and Add bgn.go:442, not the composition).

Fusion: the Tate pairing is f^e with e = (p^2-1)/n, and exponentiation is
a homomorphism of F_p^2^*, so prod_i e(A_i, B_i) = (prod_i f_i)^e.  The
kernel therefore runs the D Miller loops (one miller_loop launch over all
D*B lanes), reduces the Miller values over the coordinate axis in RNS
(a log-depth tree of F_p^2 products on flat [2k, batch] operands) and
pays the final exponentiation (pow_loop, fp2_pow_loop) ONCE per output.
Identity inputs contribute f = 1 (e(O, X) = 1), so the result is the
group element the Mult + Add composition gives.

Shapes: ct_x, ct_y are L1 ciphertext batches of shape [D] (one vector) or
[D, B] (B vectors side by side); the reduction is over axis 0.
"""

from __future__ import annotations

import torch

from ..fieldcore import rns as rn
from ..fieldcore.rns import RVal
from ..ops import fp2
from ..ops import pairing as pairing_mod
from ..ops import rns_pairing as rp
from ..ops.curve import AffinePoint
from ..scheme import BGNPublicKey, Ciphertext, PublicDeviceKey


def prod_gt(ctx, z):
    """F_p^2 product over axis 2 of [2, L, N, *batch] limb values: a
    log-depth halving tree (an odd tail is carried to the next round)."""
    while z.shape[2] > 1:
        half = z.shape[2] // 2
        z = torch.cat([fp2.mul(ctx, z[:, :, :half], z[:, :, half:2 * half]),
                       z[:, :, 2 * half:]], dim=2)
    return z[:, :, 0]


def encrypted_dot_kernel(dev: PublicDeviceKey, x_pt: AffinePoint,
                         y_pt: AffinePoint):
    """[D, *batch] L1 points -> [2, L, *batch] GT elements encrypting
    <x, y>: D Miller loops, the reduction before the final exponentiation,
    ONE final exponentiation.  A key without RNS takes the limb Miller
    loop and limb F_p^2 products."""
    ctx = dev.ctx
    D = x_pt.inf.shape[0]
    triv = (x_pt.inf | y_pt.inf).to(torch.bool)      # e(O, .) = 1
    if not pairing_mod.use_rns(dev.rns):
        f = pairing_mod.miller_loop(ctx, x_pt, y_pt, dev.n_bits)
        f = fp2.select(triv, fp2.one(ctx, tuple(f.shape[2:])), f)
        return pairing_mod.final_exponentiation(ctx, prod_gt(ctx, f),
                                                dev.l_bits)
    rns = dev.rns
    (fr, fi), batch_shape = rp._miller_f_rns(ctx, rns, x_pt, y_pt,
                                             dev.n_naf)
    rest = tuple(batch_shape[1:])
    R = rp._flat(rest)
    tr = triv.reshape(1, -1)                          # [1, D*R]
    fre = torch.where(tr, rns.one_rns, fr.v)          # bound 1 <= _BF
    fim = torch.where(tr, torch.zeros_like(fi.v), fi.v)
    k2 = fre.shape[0]
    # log-depth product over the coordinate axis on flat [2k, batch]
    # operands; _fp2_mul's output bounds (6, 9) keep every round inside
    # the r_mul headroom (9*9 = 81 << h)
    n = D
    while n > 1:
        half = n // 2
        f3r = fre.reshape(k2, n, R)
        f3i = fim.reshape(k2, n, R)

        def part(t, lo, hi):
            return RVal(t[:, lo:hi].reshape(k2, (hi - lo) * R), 9)

        nr, ni = rp._fp2_mul(rns, (part(f3r, 0, half), part(f3i, 0, half)),
                             (part(f3r, half, 2 * half),
                              part(f3i, half, 2 * half)))
        fre = torch.cat([nr.v.reshape(k2, half, R), f3r[:, 2 * half:]],
                        dim=1).reshape(k2, -1)
        fim = torch.cat([ni.v.reshape(k2, half, R), f3i[:, 2 * half:]],
                        dim=1).reshape(k2, -1)
        n = half + (n % 2)
    zr, zi = rp.final_exponentiation_rns(ctx, rns, (RVal(fre, 9),
                                                    RVal(fim, 9)),
                                         dev.l_bits)
    return rn.from_rns_mont(rns, zr, zi).reshape((2, ctx.L) + rest)


def encrypted_dot(pk: BGNPublicKey, ct_x: Ciphertext,
                  ct_y: Ciphertext) -> Ciphertext:
    """E(x_i), E(y_i) [D, *batch] -> E_L2(<x, y>) [*batch] (not
    re-randomized: the composition's Mult would add e(Q, Q)^r per
    product; see aggregation.weighted_aggregate)."""
    if ct_x.level2 or ct_y.level2:
        raise ValueError("encrypted_dot needs level-1 inputs")
    return Ciphertext(encrypted_dot_kernel(pk.dev, ct_x.data, ct_y.data),
                      level2=True)
