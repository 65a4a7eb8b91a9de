"""The two Miller-step kernels of the limb-domain pairing, their wrappers
and their plain PyTorch versions: the port's counterpart of
`bgn_tpu/ops/pallas_pairing.py`.

The fused Miller loop (ops/pairing.py miller_loop_fused, selected by
config.BGNParams(rns_miller="0") with fused_miller on, for 2L + 1 <= 129)
keeps its state (V = (X, Y, Z), f = (re, im)) in the TPU kernels' digit
domain across the loop: an F_p element is a float32 array [L8, B] of
L8 = 2L canonical 8-bit digits of its Montgomery form, R = 2^(8 L8) =
2^(16L), the limb field's R.  One launch runs one step:

  dbl_step   Jacobian doubling + tangent line at phi(B) + f <- f^2 * line
             (21 Montgomery products); replaces pallas_pairing.dbl_step
             (_dbl_step_kernel) -> csrc/miller_dbl_digits.cu
  add_step   mixed addition V + A + line through V, A + f <- f * line
             (17 products); replaces pallas_pairing.add_step
             (_add_step_kernel) -> csrc/miller_add_digits.cu

The formulas are those of the TPU kernels, scale factors that die in the
final exponentiation included.  Every output is canonical (< p), so the
kernels, the plain versions and the JAX package's kernels agree bit for
bit.  A wrapper runs the plain version for a CPU tensor and launches the
kernel for a CUDA tensor (or raises); it counts its launches in
`launches`.  The plain versions convert the digits to int64 limbs, run
the step on limbs through cuda_mont.mont_mul_plain and convert back; the
kernels run it on 32-bit words (csrc/digits.cuh, csrc/mont_words.cuh).
The step formulas on limbs are ops/miller_lines.py's.
"""

from __future__ import annotations

import functools

import torch

from .._build import is_cpu, launch, ptr
from ..fieldcore import cuda_mont
from . import miller_lines as ml

LMAX = 64                  # csrc/digits.cuh: the widest L the kernels take


def to_digits(x: torch.Tensor) -> torch.Tensor:
    """int64 16-bit limbs [L, *b] -> float32 8-bit digits [2L, *b]."""
    d = torch.stack([x & 0xFF, x >> 8], dim=1)
    return d.reshape((2 * x.shape[0],) + tuple(x.shape[1:])).to(torch.float32)


def from_digits(d: torch.Tensor) -> torch.Tensor:
    """float32 8-bit digits [2L, *b] -> int64 16-bit limbs [L, *b]."""
    u = d.to(torch.int64).reshape((d.shape[0] // 2, 2) + tuple(d.shape[1:]))
    return u[:, 0] + (u[:, 1] << 8)


# ---------------------------------------------------------------------------
# Plain versions and wrappers
# ---------------------------------------------------------------------------


def _limbs_plain(ctx, fn, *digit_arrays):
    """Run fn(mul, *limb arrays) with mont_mul_plain; digits in and out."""
    mul = functools.partial(cuda_mont.mont_mul_plain, ctx)
    V, f = fn(mul, *(from_digits(d) for d in digit_arrays))
    return tuple(map(to_digits, V)), tuple(map(to_digits, f))


def dbl_step_plain(ctx, V, f, Bq):
    """One doubling step: (V', f') = (2V, f^2 * line_V(phi(B)))."""
    def step(mul, X, Y, Z, fr, fi, xb, yb):
        V2, line = ml.dbl_line(ctx, mul, X, Y, Z, xb, yb)
        return V2, ml.fp2_mul(ctx, mul, ml.fp2_sqr(ctx, mul, (fr, fi)), line)

    return _limbs_plain(ctx, step, *V, *f, *Bq)


def add_step_plain(ctx, V, f, A, Bq):
    """One addition step: (V', f') = (V + A, f * line_{V,A}(phi(B)))."""
    def step(mul, X, Y, Z, fr, fi, xa, ya, xb, yb):
        V2, line = ml.madd_line(ctx, mul, X, Y, Z, xa, ya, xb, yb)
        return V2, ml.fp2_mul(ctx, mul, (fr, fi), line)

    return _limbs_plain(ctx, step, *V, *f, *A, *Bq)


def _launch_step(wrapper, entry: str, ctx, ins):
    """Check the digit arrays, launch (inputs, outputs, p, L, n)."""
    L = ctx.L
    n = ins[0].shape[-1]
    for t in ins:
        if (t.dtype != torch.float32 or tuple(t.shape) != (2 * L, n)
                or t.device != ctx.p.device):
            raise ValueError(f"expected float32 [{2 * L}, {n}] on "
                             f"{ctx.p.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if L > LMAX:
        raise ValueError(f"L = {L} limbs: the digit kernels take L <= "
                         f"{LMAX} (2L + 1 <= 129, as the fused dispatch)")
    ins = [t.contiguous() for t in ins]
    outs = [torch.empty_like(ins[0]) for _ in range(5)]
    if n:
        launch(entry, *(ptr(t) for t in ins), *(ptr(t) for t in outs),
               ptr(ctx.p), L, n)
        wrapper.launches += 1
    return tuple(outs[:3]), tuple(outs[3:])


def dbl_step(ctx, V, f, Bq):
    """Wrapper: one Miller doubling step as one kernel on the card.
    V = (X, Y, Z), f = (re, im), Bq = (xb, yb): float32 digits [2L, B].
    Returns (V', f')."""
    if is_cpu(V[0]):
        return dbl_step_plain(ctx, V, f, Bq)
    return _launch_step(dbl_step, "bgn_miller_dbl_digits", ctx,
                        (*V, *f, *Bq))


dbl_step.launches = 0


def add_step(ctx, V, f, A, Bq):
    """Wrapper: one Miller addition step as one kernel on the card;
    A = (xa, ya) digits [2L, B]."""
    if is_cpu(V[0]):
        return add_step_plain(ctx, V, f, A, Bq)
    return _launch_step(add_step, "bgn_miller_add_digits", ctx,
                        (*V, *f, *A, *Bq))


add_step.launches = 0

WRAPPERS = (dbl_step, add_step)
