"""The batched Montgomery product on 16-bit limbs: its CUDA kernel's
wrapper and its plain PyTorch version (the port's counterpart of
`bgn_tpu/fieldcore/pallas_mont.py`).

  mont_mul_plain  the CIOS of bgn_tpu/fieldcore/montgomery.py
                  _mont_mul_loop in torch ops: a loop over the L outer
                  limbs, the lazily carried accumulator, the carry-
                  lookahead normalize and one conditional subtraction of p
  mont_mul        wrapper: a CPU tensor goes to mont_mul_plain, a CUDA
                  tensor launches csrc/mont_mul.cu (which replaces both
                  mont_mul_pallas_f32 and mont_mul_pallas: CIOS on 32-bit
                  words, in registers at the keys' widths) or raises; it
                  counts its launches in `mont_mul.launches`

Contract (both): a, b int64 [L, *batch] of one shape (broadcast views are
fine), a < R = 2^(16L) and b < p; the result is a*b*R^-1 mod p as
canonical limbs [L, *batch].  The kernel and the plain version agree bit
for bit: both return the unique canonical residue.
"""

from __future__ import annotations

import torch

from .._build import is_cpu, launch, ptr
from . import limbs as lb

LMAX = 264                 # csrc/mont_mul.cu BGN_MONT_LMAX (4096-bit keys)


def mont_mul_plain(ctx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """CIOS over the L outer limbs with a sliding accumulator T [L+1]
    (entries stay below 2^32; the audit is in bgn_tpu's montgomery.py)."""
    L = ctx.L
    batch = tuple(a.shape[1:])
    p = ctx.p.reshape((L,) + (1,) * len(batch))
    T = torch.zeros((L + 1,) + batch, dtype=torch.int64, device=a.device)
    for i in range(L):
        prod = a[i][None] * b
        T[:L] += prod & lb.LIMB_MASK
        T[1:] += prod >> lb.LIMB_BITS
        m = ((T[0] & lb.LIMB_MASK) * ctx.pinv) & lb.LIMB_MASK
        q = m[None] * p
        T[:L] += q & lb.LIMB_MASK
        T[1:] += q >> lb.LIMB_BITS
        carry = T[0] >> lb.LIMB_BITS
        T = torch.cat([T[1:], torch.zeros_like(T[:1])], dim=0)
        T[0] += carry
    limbs, _ = lb.normalize(T)                     # [L+1], value < 2p
    p_ext = torch.cat([ctx.p, torch.zeros_like(ctx.p[:1])])
    diff, borrow = lb.sub(limbs, lb.expand_to(p_ext, limbs.shape))
    return lb.select(borrow, limbs, diff)[:L]


def mont_mul(ctx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Wrapper: the Montgomery product as one kernel on the card."""
    if is_cpu(a):
        return mont_mul_plain(ctx, a, b)
    L, shape = ctx.L, tuple(a.shape)
    for t in (a, b):
        if (tuple(t.shape) != shape or t.dtype != torch.int64
                or t.device != ctx.p.device):
            raise ValueError(f"expected int64 {shape} on {ctx.p.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if shape[0] != L or L > LMAX:
        raise ValueError(f"limb count {shape[0]} (context L = {L}, kernel "
                         f"max {LMAX})")
    n = a[0].numel()
    a2, b2 = a.reshape(L, n), b.reshape(L, n)
    out = torch.empty((L, n), dtype=torch.int64, device=a.device)
    if n:
        launch("bgn_mont_mul", ptr(a2), a2.stride(0), a2.stride(1), ptr(b2),
               b2.stride(0), b2.stride(1), ptr(ctx.p), L, ptr(out), n)
        mont_mul.launches += 1
    return out.reshape(shape)


mont_mul.launches = 0
