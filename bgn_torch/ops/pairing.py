"""Batched symmetric Tate pairing e(A, B) on the A1 curve.

The port's counterpart of `bgn_tpu/ops/pairing.py` `pairing()`:
e(A, B) = f_{n,A}(phi(B))^((p^2-1)/n) with the distortion map
phi(x, y) = (-x, i*y), computed in RNS (ops/rns_pairing.py).  The port
has only the RNS path.  Identity inputs yield 1 (e(O, X) = 1), as in PBC.
"""

from __future__ import annotations

import torch

from ..fieldcore.montgomery import MontCtx
from . import fp2
from . import rns_pairing
from .curve import AffinePoint


def pairing(ctx: MontCtx, a: AffinePoint, b: AffinePoint, n_digits, l_bits,
            rns) -> torch.Tensor:
    """Full batched pairing -> GT [2, L, *batch] Montgomery limbs.
    n_digits: the Miller digits (signed NAF or plain bits of n, MSB
    first); l_bits: the bits of the cofactor l (final exponentiation)."""
    z = rns_pairing.pairing_rns(ctx, rns, a, b, n_digits, l_bits)
    trivial = a.inf | b.inf
    return fp2.select(trivial, fp2.one(ctx, tuple(z.shape[2:])), z)
