"""Batched symmetric Tate pairing e(A, B) on the A1 curve.

The port's counterpart of `bgn_tpu/ops/pairing.py`: e(A, B) =
f_{n,A}(phi(B))^((p^2-1)/n) with the distortion map phi(x, y) =
(-x, i*y).  Identity inputs yield 1 (e(O, X) = 1), as in PBC.  Three
algorithms, chosen as the JAX package chooses:

  RNS (ops/rns_pairing.py)   when use_rns(rns): the default
  fused limb Miller loop     rns_miller="0", _USE_FUSED and 2L + 1 <= 129:
                             one launch of ops/cuda_pairing.py's dbl_step
                             per bit and of add_step per 1-bit, the state
                             in 8-bit digits
  limb Miller loop           rns_miller="0" otherwise (e.g. 1024-bit keys,
                             L = 66): the step formulas on limbs through
                             the mont_mul kernel

Both limb loops end in the limb final exponentiation.  Design notes
(bgn_tpu/ops/pairing.py): the Miller loop walks the bits of n MSB first,
skipping the leading zeros; each step fuses the Jacobian doubling with
its tangent line, and a 1-bit adds A with its line.  Vertical lines
evaluate into F_p and die in the final exponentiation, so the final
addition (V = -A) is elided: the loop runs over bits[:-1] and a tail
doubling follows.  (p^2-1)/n = (p-1) l and z^(p-1) = conj(z)/z in F_p^2.

_RNS_MODE ("auto", "1" or "0") and _USE_FUSED are set by
config.BGNParams.apply_kernel_modes; no environment variable is read.
The port's "auto" is RNS on every device, where the JAX package's is RNS
on a TPU only (so on the CPU the JAX package runs the limb Miller loop).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fieldcore import limbs as lb
from ..fieldcore import montgomery as mg
from ..fieldcore.montgomery import MontCtx
from ..utils import profiling
from . import cuda_pairing
from . import cuda_rns
from . import fp2
from . import miller_lines
from . import rns_pairing
from .curve import AffinePoint, JacPoint, to_jac

_RNS_MODE = "auto"
_USE_FUSED = True


def use_rns(rns) -> bool:
    """Whether the RNS field path handles this key: any key with an RNS
    context, unless rns_miller="0"."""
    return rns is not None and _RNS_MODE != "0"


def _miller_bits(n_bits):
    """The bits of n the loop steps over, as host ints (one copy from the
    device per call, so no step synchronizes): those after the MSB, less
    the last (its addition is the elided vertical line); None for n < 2."""
    with profiling.span("wait.digits_to_host"):
        bits = cuda_rns._digits_host(n_bits)
    start = next((i for i, v in enumerate(bits[:-1]) if v), None)
    return None if start is None else bits[start + 1:-1]


def _dbl_with_line(ctx: MontCtx, v: JacPoint, xb, yb):
    """Jacobian doubling fused with the tangent-line evaluation at phi(B)."""
    mul = functools.partial(mg.mont_mul, ctx)
    V, line = miller_lines.dbl_line(ctx, mul, *v, xb, yb)
    return JacPoint(*V), fp2.make(*line)


def _madd_with_line(ctx: MontCtx, v: JacPoint, a: AffinePoint, xb, yb):
    """Mixed addition v + a fused with the line through v and a at
    phi(B); no completeness selects (the loop elides its one degenerate
    addition)."""
    mul = functools.partial(mg.mont_mul, ctx)
    V, line = miller_lines.madd_line(ctx, mul, *v, a.x, a.y, xb, yb)
    return JacPoint(*V), fp2.make(*line)


def _broadcast(ctx: MontCtx, a: AffinePoint, b: AffinePoint):
    """a and b broadcast to their common batch shape."""
    batch = tuple(np.broadcast_shapes(tuple(a.x.shape[1:]),
                                      tuple(b.x.shape[1:])))

    def bc(pt: AffinePoint) -> AffinePoint:
        inf = pt.inf.reshape(tuple(pt.inf.shape)
                             + (1,) * (len(batch) - pt.inf.dim()))
        return AffinePoint(lb.expand_to(pt.x, (ctx.L,) + batch),
                           lb.expand_to(pt.y, (ctx.L,) + batch),
                           inf.expand(batch))

    return bc(a), bc(b), batch


def miller_loop(ctx: MontCtx, a: AffinePoint, b: AffinePoint, n_bits):
    """f_{n,A}(phi(B)) for the whole batch on limbs; n_bits [nbits] MSB
    first, shared across the batch.  Returns [2, L, *batch]."""
    a, b, batch = _broadcast(ctx, a, b)
    xb, yb = b.x, b.y
    steps = _miller_bits(n_bits)
    f = fp2.one(ctx, batch)
    if steps is None:                  # n < 2: the loop never starts
        return f
    v = to_jac(ctx, a)                 # V = A, f = 1 at the MSB
    for bit in steps:
        v, line = _dbl_with_line(ctx, v, xb, yb)
        f = fp2.mul(ctx, fp2.sqr(ctx, f), line)
        if bit:
            v, line = _madd_with_line(ctx, v, a, xb, yb)
            f = fp2.mul(ctx, f, line)
    _, line = _dbl_with_line(ctx, v, xb, yb)     # tail: the last doubling
    return fp2.mul(ctx, fp2.sqr(ctx, f), line)


def final_exponentiation(ctx: MontCtx, f, l_bits):
    """f^((p^2-1)/n) = (conj(f)/f)^l; l_bits [lbits] MSB first, shared."""
    w = fp2.mul(ctx, fp2.conj(ctx, f), fp2.inv(ctx, f))
    return fp2.pow_bits(ctx, w, l_bits)


def miller_loop_fused(ctx: MontCtx, a: AffinePoint, b: AffinePoint, n_bits):
    """The Miller loop through the digit-domain step kernels
    (ops/cuda_pairing.py): the same contract and result as miller_loop;
    the state (V, f) stays in 8-bit digits [2L, B] from entry to exit."""
    a, b, batch = _broadcast(ctx, a, b)
    L = ctx.L
    flat = int(np.prod(batch, dtype=np.int64))

    def prep(x):
        return cuda_pairing.to_digits(x.reshape(L, flat))

    ax, ay = prep(a.x), prep(a.y)
    Bq = (prep(b.x), prep(b.y))
    one_d = prep(lb.expand_to(ctx.one, (L,) + batch))
    steps = _miller_bits(n_bits)
    f = (one_d, torch.zeros_like(one_d))
    if steps is not None:
        V = (ax, ay, one_d)            # A in Jacobian form, Z = 1
        for bit in steps:
            V, f = cuda_pairing.dbl_step(ctx, V, f, Bq)
            if bit:
                V, f = cuda_pairing.add_step(ctx, V, f, (ax, ay), Bq)
        _, f = cuda_pairing.dbl_step(ctx, V, f, Bq)   # tail
    return torch.stack([cuda_pairing.from_digits(d).reshape((L,) + batch)
                        for d in f], dim=0)


def pairing(ctx: MontCtx, a: AffinePoint, b: AffinePoint, n_bits, l_bits,
            rns=None, n_naf=None) -> torch.Tensor:
    """Full batched pairing -> GT [2, L, *batch] Montgomery limbs.
    n_bits: the bits of n, MSB first (the limb loops); n_naf: optional
    signed Miller digits for the RNS path (fewer additions; the reduced
    pairing value does not depend on the chain); l_bits: the bits of the
    cofactor l (final exponentiation)."""
    if use_rns(rns):
        digits = n_bits if n_naf is None else n_naf
        z = rns_pairing.pairing_rns(ctx, rns, a, b, digits, l_bits)
    elif _USE_FUSED and 2 * ctx.L + 1 <= 129:
        z = final_exponentiation(ctx, miller_loop_fused(ctx, a, b, n_bits),
                                 l_bits)
    else:
        z = final_exponentiation(ctx, miller_loop(ctx, a, b, n_bits), l_bits)
    with profiling.span("glue.select"):
        trivial = a.inf | b.inf
        return fp2.select(trivial, fp2.one(ctx, tuple(z.shape[2:])), z)
