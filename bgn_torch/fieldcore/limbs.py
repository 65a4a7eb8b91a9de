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


def _carry_pass(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One carry pass: (t & mask) + (t >> 16) shifted up a limb, and the
    high part pushed out of the top limb."""
    hi = t >> LIMB_BITS
    out = t & LIMB_MASK
    out[1:] += hi[:-1]
    return out, hi[-1]


def normalize(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lazy limbs (each < 2^32) -> (canonical 16-bit limbs, overflow) with
    value = limbs + overflow * 2^(16L), as bgn_tpu/fieldcore/limbs.py
    normalize: two carry passes bring every entry to <= 2^16, then the
    remaining binary carries resolve by carry lookahead.  Limb j generates
    a carry (t == 2^16), propagates one (t == 2^16 - 1) or stops it; the
    carry out of limbs [0, j] is the generate bit of the highest
    non-propagating limb at or below j.  The JAX package combines the
    (generate, propagate) pairs with an associative scan; here the same
    scan is one cumulative max over the limb axis of the codes 2j + 2 + g
    (0 for a propagating limb), whose low bit is that generate bit: one
    launch on the card in place of log2(L) combine steps."""
    t, spill1 = _carry_pass(t)
    t, spill2 = _carry_pass(t)
    L = t.shape[0]
    pos = torch.arange(2, 2 * L + 2, 2, device=t.device)
    pos = pos.reshape((L,) + (1,) * (t.dim() - 1))
    code = torch.where(t == LIMB_MASK, 0, pos + (t >> LIMB_BITS))
    G = torch.cummax(code, dim=0).values & 1    # carry out of limbs [0, j]
    t[1:] += G[:-1]
    return t & LIMB_MASK, spill1 + spill2 + G[-1]


def add(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """a + b -> (limbs mod 2^(16L), carry in {0,1})."""
    return normalize(a + b)


def sub(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """a - b (two's complement) -> (limbs mod 2^(16L), borrow in {0,1}).

    borrow == 1 iff a < b."""
    t = a + (LIMB_MASK - b)
    t[0] += 1
    limbs, carry = normalize(t)
    return limbs, 1 - carry


def geq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a >= b elementwise over the batch; int64 {0,1} of batch shape."""
    return 1 - sub(a, b)[1]


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
