"""Points on E: y^2 = x^3 + x over F_p (the A1 curve).

The port's counterpart of `bgn_tpu/ops/curve.py`, reduced to the point
types and negation: the port's curve arithmetic runs in the RNS domain
(ops/rns_pairing.py).  x, y are int64 Montgomery-form limbs [L, *batch];
inf is int64 {0,1} of batch shape (1 = the identity O).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

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


def neg_affine(ctx: MontCtx, a: AffinePoint) -> AffinePoint:
    return AffinePoint(a.x, mg.mod_neg(ctx, a.y), a.inf)
