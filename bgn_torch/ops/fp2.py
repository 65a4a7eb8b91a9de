"""F_p^2 = F_p[i]/(i^2+1) elements as limb tensors [2, L, *batch]
([0] = real, [1] = imaginary, Montgomery form): the port's counterpart of
the parts of `bgn_tpu/ops/fp2.py` that the pairing's identity select and
the L2 MultConst's negation need.  The arithmetic itself runs in RNS
(ops/rns_pairing.py)."""

from __future__ import annotations

import torch

from ..fieldcore import montgomery as mg
from ..fieldcore.montgomery import MontCtx


def one(ctx: MontCtx, batch_shape=()):
    """Multiplicative identity (Montgomery form of (1, 0))."""
    re = ctx.one.reshape((ctx.L,) + (1,) * len(batch_shape)) \
        .expand((ctx.L,) + tuple(batch_shape))
    return torch.stack([re, torch.zeros_like(re)], dim=0)


def select(mask, x, y):
    """where(mask, x, y) with mask of batch shape."""
    return torch.where(mask.to(torch.bool)[None, None], x, y)


def conj(ctx: MontCtx, x):
    """a - bi: the inverse of a unitary (GT) element."""
    return torch.stack([x[0], mg.mod_neg(ctx, x[1])], dim=0)
