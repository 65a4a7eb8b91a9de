"""Host <-> device conversions for curve points and GT elements.

The port's counterpart of `bgn_tpu/utils/convert.py`: the Montgomery
scaling (x*R mod p) happens on host ints, then one upload.  Limbs are
int64 tensors on the context's device.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..fieldcore import limbs as lb
from ..fieldcore.montgomery import MontCtx
from ..ops.curve import AffinePoint

HostPoint = Optional[Tuple[int, int]]
HostFp2 = Tuple[int, int]


def _to_mont_limbs(ctx: MontCtx, vals: Sequence[int]) -> np.ndarray:
    """Host ints -> Montgomery-form limb array [L, B] (host math)."""
    p, R = ctx.p_host, 1 << (lb.LIMB_BITS * ctx.L)
    return lb.ints_to_limbs([int(v) * R % p for v in vals], ctx.L)


def _dev(ctx: MontCtx, a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.int64,
                           device=ctx.p.device)


def affine_from_host(ctx: MontCtx, points: Sequence[HostPoint],
                     batch_shape=None) -> AffinePoint:
    """Host affine points (None = identity) -> AffinePoint [L, B]."""
    L = ctx.L
    x = _to_mont_limbs(ctx, [0 if P is None else P[0] for P in points])
    y = _to_mont_limbs(ctx, [0 if P is None else P[1] for P in points])
    infs = np.array([1 if P is None else 0 for P in points], dtype=np.int64)
    if batch_shape is not None:
        x = x.reshape((L,) + tuple(batch_shape))
        y = y.reshape((L,) + tuple(batch_shape))
        infs = infs.reshape(batch_shape)
    return AffinePoint(_dev(ctx, x), _dev(ctx, y), _dev(ctx, infs))


def point_from_host(ctx: MontCtx, P: HostPoint) -> AffinePoint:
    """Single host point -> AffinePoint with scalar batch shape ()."""
    x = _to_mont_limbs(ctx, [0 if P is None else P[0]])[:, 0]
    y = _to_mont_limbs(ctx, [0 if P is None else P[1]])[:, 0]
    inf = np.int64(1 if P is None else 0)
    return AffinePoint(_dev(ctx, x), _dev(ctx, y), _dev(ctx, inf))


def fp2_from_host(ctx: MontCtx, vals: Sequence[HostFp2]) -> torch.Tensor:
    """Host (re, im) tuples -> [2, L, B] Montgomery limbs."""
    return _dev(ctx, np.stack([_to_mont_limbs(ctx, [v[0] for v in vals]),
                               _to_mont_limbs(ctx, [v[1] for v in vals])]))


def fp2_single_from_host(ctx: MontCtx, v: HostFp2) -> torch.Tensor:
    """Host (re, im) -> [2, L] Montgomery limbs."""
    z = np.stack([_to_mont_limbs(ctx, [v[0]])[:, 0],
                  _to_mont_limbs(ctx, [v[1]])[:, 0]], axis=0)
    return _dev(ctx, z)


def _from_mont_ints(ctx: MontCtx, limbs) -> List[int]:
    p, R = ctx.p_host, 1 << (lb.LIMB_BITS * ctx.L)
    rinv = pow(R, -1, p)
    return [v * rinv % p for v in lb.limbs_to_ints(limbs)]


def affine_to_host(ctx: MontCtx, ap: AffinePoint) -> List[HostPoint]:
    """AffinePoint [L, B] -> list of host points."""
    xs = _from_mont_ints(ctx, ap.x)
    ys = _from_mont_ints(ctx, ap.y)
    inf = ap.inf.cpu().tolist()
    return [None if inf[b] else (xs[b], ys[b]) for b in range(len(xs))]


def fp2_to_host(ctx: MontCtx, z) -> List[HostFp2]:
    """[2, L, B] -> list of host (re, im) tuples."""
    return list(zip(_from_mont_ints(ctx, z[0]), _from_mont_ints(ctx, z[1])))
