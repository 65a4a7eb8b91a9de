"""Fixed-width big integers as limb-major 16-bit-limb tensors.

Same representation as `bgn_tpu/fieldcore/limbs.py`: a non-negative
integer x < 2^(16*L) is a tensor [L, *batch] of 16-bit limbs, limb 0 least
significant.  The port stores limbs as int64 (this torch has no uint32
add, sub, shift or compare on the CPU); the values are the same, so a
test compares them with the JAX package's uint32 limbs after a cast.

Host helpers work on numpy / Python ints; the limb ops work on tensors on
any device.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

LIMB_BITS = 16
LIMB_MASK = 0xFFFF


# ---------------------------------------------------------------------------
# Host <-> device conversion
# ---------------------------------------------------------------------------


def num_limbs_for_bits(bits: int) -> int:
    """Limb count for a given bit width."""
    return max(1, -(-bits // LIMB_BITS))


def int_to_limbs(x: int, L: int) -> np.ndarray:
    """Python int -> limb vector [L] int64 (host, numpy)."""
    if x < 0:
        raise ValueError("negative")
    if x >> (LIMB_BITS * L):
        raise ValueError(f"{x.bit_length()}-bit value does not fit {L} limbs")
    return np.array([(x >> (LIMB_BITS * i)) & LIMB_MASK for i in range(L)],
                    dtype=np.int64)


def ints_to_limbs(xs: Sequence[int], L: int) -> np.ndarray:
    """[B] python ints -> [L, B] int64 limb array (host, bytes-vectorized)."""
    nbytes = 2 * L
    buf = bytearray(nbytes * len(xs))
    for b, x in enumerate(xs):
        x = int(x)
        if x < 0:
            raise ValueError("negative")
        buf[b * nbytes:(b + 1) * nbytes] = x.to_bytes(nbytes, "little")
    a16 = np.frombuffer(bytes(buf), dtype=np.uint16).reshape(len(xs), L)
    return np.ascontiguousarray(a16.T).astype(np.int64)


def limbs_to_ints(a) -> list:
    """[L, B] -> list of B python ints (host, bytes-vectorized)."""
    rows = np.ascontiguousarray(_host(a).astype(np.uint16).T)  # [B, L]
    return [int.from_bytes(rows[b].tobytes(), "little")
            for b in range(rows.shape[0])]


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def int_to_bits(x: int, nbits: int) -> np.ndarray:
    """Python int -> bit vector [nbits] int64, MSB first (host)."""
    if x < 0 or (nbits < x.bit_length()):
        raise ValueError("value does not fit")
    return np.array([(x >> (nbits - 1 - i)) & 1 for i in range(nbits)],
                    dtype=np.int64)


def int_to_naf(x: int, width: int) -> np.ndarray:
    """Python int >= 0 -> non-adjacent form, int64 [width+1] digits in
    {-1, 0, 1}, MSB first (host).  sum_i d_i * 2^(width-i) == x."""
    if x < 0 or width < x.bit_length():
        raise ValueError("value does not fit")
    digits = []
    v = x
    while v:
        if v & 1:
            d = 2 - (v & 3)            # +1 if v%4==1, -1 if v%4==3
            v -= d
        else:
            d = 0
        digits.append(d)
        v >>= 1
    digits += [0] * (width + 1 - len(digits))
    return np.array(digits[::-1], dtype=np.int64)


# ---------------------------------------------------------------------------
# Limb ops (int64 tensors holding 16-bit limbs)
# ---------------------------------------------------------------------------


def add(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """a + b -> (limbs mod 2^(16L), carry in {0,1}): a sequential ripple."""
    out = torch.empty_like(a)
    carry = torch.zeros_like(a[0])
    for i in range(a.shape[0]):
        t = a[i] + b[i] + carry
        carry = t >> LIMB_BITS
        out[i] = t & LIMB_MASK
    return out, carry


def sub(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """a - b (two's complement) -> (limbs mod 2^(16L), borrow in {0,1}).

    borrow == 1 iff a < b.  A sequential ripple over the L limbs: int64
    holds every intermediate, and L is small."""
    out = torch.empty_like(a)
    borrow = torch.zeros_like(a[0])
    for i in range(a.shape[0]):
        t = a[i] - b[i] - borrow
        borrow = (t < 0).to(a.dtype)
        out[i] = t + borrow * (1 << LIMB_BITS)
    return out, borrow


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact limb equality; int64 {0,1} of batch shape."""
    return torch.all(a == b, dim=0).to(torch.int64)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return torch.all(a == 0, dim=0).to(torch.int64)


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """where(mask, a, b) with mask of batch shape broadcast over limbs."""
    return torch.where(mask.to(torch.bool)[None], a, b)


def expand_to(v: torch.Tensor, shape) -> torch.Tensor:
    """Broadcast v to `shape` by appending trailing batch axes:
    [L] -> [L, *batch] (leading dims of v are structural)."""
    v = v.reshape(tuple(v.shape) + (1,) * (len(shape) - v.dim()))
    return v.expand(tuple(shape))
