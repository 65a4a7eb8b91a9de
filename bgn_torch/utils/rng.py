"""Device-side uniform randomness mod n: the port's counterpart of
`bgn_tpu/utils/rng.py` (make_device_sampler_ctx, device_random_below).

The raw 16-bit limbs come from an explicit `torch.Generator` on the key's
device in place of the JAX package's threefry bits, so the two packages
draw different numbers from one seed; the reduction mod n is the same
(`reduce_below`), and the tests hold it against the JAX package on the
same raw limbs.
"""

from __future__ import annotations

import torch

from ..fieldcore import limbs as lb
from ..fieldcore import montgomery as mg


def make_device_sampler_ctx(n: int, extra_limbs: int = 4,
                            device="cuda") -> mg.MontCtx:
    """MontCtx over modulus n sized for low-bias sampling: with
    L' = limbs(n) + extra_limbs, a uniform x < 2^(16 L') reduced mod n is
    within statistical distance n / 2^(16 L') <= 2^-64 of uniform (the
    device analog of crypto/rand's rejection sampling, bgn.go:567)."""
    L = lb.num_limbs_for_bits(n.bit_length()) + extra_limbs
    return mg.make_mont_ctx(n, L=L, device=device)


def reduce_below(sampler_ctx: mg.MontCtx, raw: torch.Tensor) -> torch.Tensor:
    """Limbs [L', *batch] of any x < R' -> canonical limbs of x mod n, by
    two Montgomery products: to_mont takes any x < R' (the CIOS result
    x*R'^2/R' mod n is below 2n before its conditional subtraction), and
    from_mont then gives x mod n exactly."""
    return mg.from_mont(sampler_ctx, mg.to_mont(sampler_ctx, raw))


def device_random_below(sampler_ctx: mg.MontCtx, generator: torch.Generator,
                        batch_shape) -> torch.Tensor:
    """Uniform residues mod n on the generator's device: canonical limbs
    [L', *batch] < n."""
    raw = torch.randint(0, 1 << lb.LIMB_BITS,
                        (sampler_ctx.L,) + tuple(batch_shape),
                        generator=generator, device=generator.device,
                        dtype=torch.int64)
    return reduce_below(sampler_ctx, raw)
