"""Batched Montgomery modular arithmetic (CIOS) on 16-bit limb tensors.

The port's counterpart of `bgn_tpu/fieldcore/montgomery.py`: `MontCtx`,
`mont_mul` and what is built on it (to/from Montgomery form, modular
add/sub/neg, powers, Fermat and batch inversion).  Limbs are int64
tensors [L, *batch] holding 16-bit values, R = 2^(16L).  Ciphertexts and
GT elements are Montgomery-form limbs x*R mod p, as in the JAX package.

`mont_mul` broadcasts its operands' batch shapes and runs the product
through fieldcore/cuda_mont.py: the hand-written CUDA kernel for a CUDA
tensor, the plain PyTorch CIOS for a CPU tensor.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from . import cuda_mont
from . import limbs as lb


class MontCtx(nn.Module):
    """Montgomery constants for a fixed odd modulus p, as buffers, so
    `.to(device)` moves them: p [L], r2 = R^2 mod p [L] (to_mont), one =
    R mod p [L], pm2_bits [16L] (bits of p-2, MSB first: Fermat
    inversion), pp1d4_bits [16L] (bits of (p+1)/4).  pinv = -p^-1 mod 2^16
    and p_host are host ints, so that no launch reads the device."""

    def __init__(self, p_limbs, pinv, r2, one, pm2_bits, pp1d4_bits,
                 p_host: int):
        super().__init__()
        for name, v in (("p", p_limbs), ("r2", r2), ("one", one),
                        ("pm2_bits", pm2_bits), ("pp1d4_bits", pp1d4_bits)):
            self.register_buffer(name, torch.as_tensor(v, dtype=torch.int64))
        self.pinv = int(pinv)
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
    pinv = (-pow(p, -1, 1 << lb.LIMB_BITS)) % (1 << lb.LIMB_BITS)
    return MontCtx(lb.int_to_limbs(p, L), pinv, lb.int_to_limbs(R * R % p, L),
                   lb.int_to_limbs(R % p, L),
                   lb.int_to_bits(p - 2, lb.LIMB_BITS * L),
                   lb.int_to_bits((p + 1) // 4, lb.LIMB_BITS * L),
                   p).to(device)


def _bcast(v: torch.Tensor, batch_ndim: int) -> torch.Tensor:
    """Reshape a [L] constant to [L, 1, 1, ...] for batch broadcast."""
    return v.reshape(tuple(v.shape) + (1,) * batch_ndim)


def mont_mul(ctx: MontCtx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a*b*R^-1 mod p, batched: a, b int64 [L, *batch]
    canonical limbs < p (batch shapes broadcast); same shape < p."""
    # numpy's broadcast: torch.broadcast_shapes imports sympy on first use
    batch = np.broadcast_shapes(tuple(a.shape[1:]), tuple(b.shape[1:]))
    shape = (ctx.L,) + tuple(batch)
    return cuda_mont.mont_mul(ctx, lb.expand_to(a, shape),
                              lb.expand_to(b, shape))


def mont_sqr(ctx: MontCtx, a: torch.Tensor) -> torch.Tensor:
    return mont_mul(ctx, a, a)


def to_mont(ctx: MontCtx, a: torch.Tensor) -> torch.Tensor:
    return mont_mul(ctx, a, _bcast(ctx.r2, a.dim() - 1))


def from_mont(ctx: MontCtx, a: torch.Tensor) -> torch.Tensor:
    """Montgomery form -> canonical residue (multiply by 1)."""
    one = torch.zeros_like(ctx.p)
    one[0] = 1
    return mont_mul(ctx, a, _bcast(one, a.dim() - 1))


def mod_add(ctx: MontCtx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b mod p for canonical or Montgomery residues < p."""
    s, carry = lb.add(a, b)
    d, borrow = lb.sub(s, lb.expand_to(ctx.p, s.shape))
    return lb.select(carry | (1 - borrow), d, s)


def mod_sub(ctx: MontCtx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b mod p for limbs [L, *batch] < p."""
    d, borrow = lb.sub(a, b)
    d_fix, _ = lb.add(d, lb.expand_to(ctx.p, d.shape))
    return lb.select(borrow, d_fix, d)


def mod_neg(ctx: MontCtx, a: torch.Tensor) -> torch.Tensor:
    """-a mod p for limbs [L, *batch] < p (maps 0 to 0)."""
    d, _ = lb.sub(lb.expand_to(ctx.p, a.shape), a)
    return lb.select(lb.is_zero(a), a, d)


def mont_pow(ctx: MontCtx, a: torch.Tensor, bits) -> torch.Tensor:
    """a^e mod p in Montgomery form; e as bits [nbits, *eb] MSB first
    (shared [nbits] or one exponent per element).  Square-and-multiply from
    1, so leading zero bits are harmless; the batch broadcasts with eb."""
    bits = torch.as_tensor(bits, device=a.device)
    batch = np.broadcast_shapes(tuple(a.shape[1:]), tuple(bits.shape[1:]))
    shape = (ctx.L,) + tuple(batch)
    acc = lb.expand_to(ctx.one, shape)
    a = lb.expand_to(a, shape)
    for bit in bits:
        acc = mont_sqr(ctx, acc)
        acc = lb.select(bit.expand(batch), mont_mul(ctx, acc, a), acc)
    return acc


def mont_inv(ctx: MontCtx, a: torch.Tensor) -> torch.Tensor:
    """a^-1 mod p in Montgomery form via Fermat (a^(p-2))."""
    return mont_pow(ctx, a, ctx.pm2_bits)


def _scan_mul(ctx: MontCtx, a: torch.Tensor, reverse: bool) -> torch.Tensor:
    """Inclusive product scan of a [L, N, *batch] along axis 1 (log-depth,
    Hillis-Steele).  The association order differs from the JAX package's
    associative scan; the products are exact, so the limbs agree."""
    out = a.flip(1) if reverse else a
    off = 1
    while off < out.shape[1]:
        prod = mont_mul(ctx, out[:, :-off], out[:, off:])
        out = torch.cat([out[:, :off], prod], dim=1)
        off *= 2
    return out.flip(1) if reverse else out


def batch_mont_inv(ctx: MontCtx, a: torch.Tensor, inv_fn=None):
    """Inverse of every element along axis 1 for one `mont_inv`'s cost:
    Montgomery's batch-inversion trick with prefix/suffix products
    (log-depth scans), inv_i = prefix_{i-1} * suffix_{i+1} * inv(total).
    Zero entries map to zero.  a: [L, N, *batch] Montgomery form.  inv_fn
    replaces the single mont_inv (same contract: Montgomery-form limbs in
    and out), e.g. rns_pairing.mont_inv_rns."""
    one = lb.expand_to(ctx.one, a.shape)
    is0 = torch.all(a == 0, dim=0, keepdim=True)        # [1, N, *batch]
    safe = torch.where(is0, one, a)
    prefix = _scan_mul(ctx, safe, reverse=False)
    suffix = _scan_mul(ctx, safe, reverse=True)
    total_inv = (inv_fn or (lambda t: mont_inv(ctx, t)))(prefix[:, -1])
    one_col = one[:, :1]
    pre_excl = torch.cat([one_col, prefix[:, :-1]], dim=1)
    suf_excl = torch.cat([suffix[:, 1:], one_col], dim=1)
    inv = mont_mul(ctx, mont_mul(ctx, pre_excl, suf_excl),
                   total_inv[:, None])
    return torch.where(is0, torch.zeros_like(inv), inv)
