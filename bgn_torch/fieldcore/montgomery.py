"""Montgomery context for a fixed odd modulus p (limb domain, R = 2^(16L)).

The port's counterpart of `bgn_tpu/fieldcore/montgomery.py` `MontCtx` /
`make_mont_ctx`, with the limb-domain subtraction and negation.  Only the
fields the RNS path reads are kept: the limb CIOS product is not on the
port's path yet.  Ciphertexts and GT elements are stored as
Montgomery-form limbs x*R mod p, as in the JAX package.
"""

from __future__ import annotations

import torch
from torch import nn

from . import limbs as lb


class MontCtx(nn.Module):
    """Montgomery constants as buffers, so `.to(device)` moves them."""

    def __init__(self, p_limbs, one, pm2_bits, p_host: int):
        super().__init__()
        self.register_buffer("p", torch.as_tensor(p_limbs, dtype=torch.int64))
        self.register_buffer("one", torch.as_tensor(one, dtype=torch.int64))
        self.register_buffer("pm2_bits",
                             torch.as_tensor(pm2_bits, dtype=torch.int64))
        self.p_host = p_host

    @property
    def L(self) -> int:
        return self.p.shape[0]


def make_mont_ctx(p: int, L: int | None = None, device="cuda") -> MontCtx:
    """Build a MontCtx from a host modulus (host math, then one upload)."""
    if p % 2 == 0:
        raise ValueError("modulus must be odd")
    if L is None:
        L = lb.num_limbs_for_bits(p.bit_length())
    R = 1 << (lb.LIMB_BITS * L)
    if p >= R:
        raise ValueError("modulus does not fit limb count")
    return MontCtx(lb.int_to_limbs(p, L), lb.int_to_limbs(R % p, L),
                   lb.int_to_bits(p - 2, lb.LIMB_BITS * L), p).to(device)


def mod_sub(ctx: MontCtx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b mod p for limbs [L, *batch] < p."""
    d, borrow = lb.sub(a, b)
    d_fix, _ = lb.add(d, lb.expand_to(ctx.p, d.shape))
    return lb.select(borrow, d_fix, d)


def mod_neg(ctx: MontCtx, a: torch.Tensor) -> torch.Tensor:
    """-a mod p for limbs [L, *batch] < p (maps 0 to 0)."""
    d, _ = lb.sub(lb.expand_to(ctx.p, a.shape), a)
    return lb.select(lb.is_zero(a), a, d)
