"""Points on E: y^2 = x^3 + x over F_p (the A1 curve).

The port's counterpart of `bgn_tpu/ops/curve.py`, reduced to the affine
batch type: the port's curve arithmetic runs in the RNS domain
(ops/rns_pairing.py).  x, y are int64 Montgomery-form limbs [L, *batch];
inf is int64 {0,1} of batch shape (1 = the identity O).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class AffinePoint(NamedTuple):
    x: torch.Tensor    # [L, *batch] Montgomery form
    y: torch.Tensor    # [L, *batch]
    inf: torch.Tensor  # [*batch] {0,1}
