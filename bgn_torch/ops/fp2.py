"""Batched F_p^2 = F_p[i]/(i^2+1) arithmetic on limbs (valid since
p == 3 mod 4): the port's counterpart of `bgn_tpu/ops/fp2.py`.

GT, the pairing's target group, is the order-n subgroup of F_p^2^*; every
L2 ciphertext is one of its elements.  Elements are limb tensors
[2, L, *batch] ([0] = real, [1] = imaginary, Montgomery form).  L2
Add/Sub and the L2 re-randomization run here on the limb product
(fieldcore/montgomery.py mont_mul); the pairing and the L2 MultConst
ladder run in RNS (ops/rns_pairing.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..fieldcore import limbs as lb
from ..fieldcore import montgomery as mg
from ..fieldcore.montgomery import MontCtx


def make(re, im):
    return torch.stack([re, im], dim=0)


def one(ctx: MontCtx, batch_shape=()):
    """Multiplicative identity (Montgomery form of (1, 0))."""
    re = lb.expand_to(ctx.one, (ctx.L,) + tuple(batch_shape))
    return make(re, torch.zeros_like(re))


def zero(ctx: MontCtx, batch_shape=()):
    return torch.zeros((2, ctx.L) + tuple(batch_shape), dtype=torch.int64,
                       device=ctx.p.device)


def mul(ctx: MontCtx, x, y):
    """Karatsuba: 3 mont_muls per F_p^2 product."""
    a, b = x[0], x[1]
    c, d = y[0], y[1]
    t0 = mg.mont_mul(ctx, a, c)
    t1 = mg.mont_mul(ctx, b, d)
    t2 = mg.mont_mul(ctx, mg.mod_add(ctx, a, b), mg.mod_add(ctx, c, d))
    re = mg.mod_sub(ctx, t0, t1)
    im = mg.mod_sub(ctx, mg.mod_sub(ctx, t2, t0), t1)
    return make(re, im)


def sqr(ctx: MontCtx, x):
    """(a+bi)^2 = (a+b)(a-b) + 2ab i: 2 mont_muls."""
    a, b = x[0], x[1]
    re = mg.mont_mul(ctx, mg.mod_add(ctx, a, b), mg.mod_sub(ctx, a, b))
    ab = mg.mont_mul(ctx, a, b)
    return make(re, mg.mod_add(ctx, ab, ab))


def conj(ctx: MontCtx, x):
    """a - bi: the inverse of a unitary (GT) element."""
    return make(x[0], mg.mod_neg(ctx, x[1]))


def inv(ctx: MontCtx, x):
    """1/(a+bi) = (a-bi)/(a^2+b^2)."""
    a, b = x[0], x[1]
    norm = mg.mod_add(ctx, mg.mont_mul(ctx, a, a), mg.mont_mul(ctx, b, b))
    ninv = mg.mont_inv(ctx, norm)
    return make(mg.mont_mul(ctx, a, ninv),
                mg.mont_mul(ctx, mg.mod_neg(ctx, b), ninv))


def div(ctx: MontCtx, x, y):
    return mul(ctx, x, inv(ctx, y))


def pow_bits(ctx: MontCtx, x, bits):
    """x^e with e as MSB-first bits [nbits, *eb] (shared [nbits] or one
    exponent per element); square-and-multiply from 1, a select per bit."""
    bits = torch.as_tensor(bits, device=x.device)
    batch = tuple(np.broadcast_shapes(tuple(x.shape[2:]),
                                      tuple(bits.shape[1:])))
    shape = (2, ctx.L) + batch
    acc = lb.expand_to(one(ctx), shape)
    x = lb.expand_to(x, shape)
    for bit in bits:
        acc = sqr(ctx, acc)
        acc = select(bit.expand(batch), mul(ctx, acc, x), acc)
    return acc


def eq(x, y):
    """Exact equality; int64 {0,1} of batch shape."""
    return lb.eq(x[0], y[0]) & lb.eq(x[1], y[1])


def is_one(ctx: MontCtx, x):
    one_re = ctx.one.reshape((ctx.L,) + (1,) * (x.dim() - 2))
    return (torch.all(x[0] == one_re, dim=0)
            & torch.all(x[1] == 0, dim=0)).to(torch.int64)


def select(mask, x, y):
    """where(mask, x, y) with mask of batch shape."""
    return torch.where(mask.to(torch.bool)[None, None], x, y)
