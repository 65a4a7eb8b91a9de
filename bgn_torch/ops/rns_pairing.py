"""Tate pairing, exponentiations and point normalization in RNS.

The port's counterpart of `bgn_tpu/ops/rns_pairing.py` (same formulas,
same static bounds, same call structure).  Field elements are RVals of
float32 residues [2k, N] (fieldcore/rns.py).  The loops that the JAX
package runs as Pallas kernels run here through the wrappers of
ops/cuda_rns.py: a hand-written CUDA kernel for a CUDA tensor, the plain
PyTorch version (built from the step functions below) for a CPU tensor.
The kernel granularity follows the JAX package's Pallas mode: "loop" (the
default) runs each Miller loop, ladder, window chain and exponentiation
as one kernel; "1" (config.BGNParams(rns_pallas="1")) runs it as a host
loop with one step-kernel launch per step.  Both give the same residues.

Static bound discipline (values < bound*p, headroom h >= 1024): loop
invariants X, Y < 27p, Z < 6p, f_re, f_im < 9p; affine inputs < 3p.  The
CUDA library (csrc/rns.cuh) hard-codes the r_sub bounds these functions
compute; the kernels are compared with the plain versions bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fieldcore import limbs as lb
from ..fieldcore import rns as rn
from ..fieldcore.montgomery import MontCtx
from ..fieldcore.rns import RNSCtx, RVal
from ..utils import profiling
from .curve import AffinePoint, JacPoint

# Loop-invariant bounds (multiples of p).
_BX, _BY, _BZ, _BF = 27, 27, 6, 9

# Kernel granularity (the JAX package's BGN_TPU_RNS_PALLAS, set here only
# through config.BGNParams.apply_kernel_modes):
#   "loop"  each ladder, Miller loop, window chain and exponentiation as
#           ONE kernel launch (ops/cuda_rns.py loop kernels); the default.
#   "1"     a host loop over the digits with one step-kernel launch per
#           step (dbl_step, add_step, pt_dbl, pt_add, pow_step,
#           fp2_pow_step), the state in device memory between steps.
_PALLAS_MODE = "loop"


def _mode() -> str:
    """The granularity of _PALLAS_MODE: "loop" or "step"."""
    if _PALLAS_MODE == "loop":
        return "loop"
    if _PALLAS_MODE == "1":
        return "step"
    raise ValueError(f"unknown kernel granularity {_PALLAS_MODE!r} "
                     "(the port runs 'loop' and '1')")


def _digits_on(digits, device) -> torch.Tensor:
    """Shared digits as a tensor on `device` for a loop kernel; a host
    array is copied there, a wait (a pageable copy synchronizes)."""
    if isinstance(digits, torch.Tensor) and digits.device == device:
        return digits
    with profiling.span("wait.digits_to_device"):
        return torch.as_tensor(digits).to(device)


def _digits_on_host(digits):
    """Shared digits as host ints for a host loop of step launches;
    reading a tensor is a wait."""
    from . import cuda_rns
    if not isinstance(digits, torch.Tensor):
        return digits
    with profiling.span("wait.digits_to_host"):
        return cuda_rns._digits_host(digits)


def _pt(v):
    """Wrap a point-coordinate residue array with its bound (3)."""
    return RVal(v, 3)


def _neg_coord(rns, v):
    """Residues of (3p - value) for a bound-3 coordinate array: the
    y-coordinate of the negated point, still bound 3."""
    t = rns.kp[:, 3:4] - v
    return torch.where(t < 0, t + rns.m, t)


def _flat(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def _dbl_step(rns: RNSCtx, X, Y, Z, fr, fi, xb, yb):
    """Fused Jacobian doubling + tangent line + f <- f^2 * line
    (21 r_muls in 5 dependency layers)."""
    X, Y, Z = RVal(X, _BX), RVal(Y, _BY), RVal(Z, _BZ)
    FR, FI = RVal(fr, _BF), RVal(fi, _BF)

    def muls(*pairs):
        return rn.r_mul_many(rns, pairs)

    def add(u, v):
        return rn.r_add(rns, u, v)

    def sub(u, v):
        return rn.r_sub(rns, u, v)

    XX, ZZ, YY, YZ, t2, ab, sq_re = muls(
        (X, X), (Z, Z), (Y, Y), (Y, Z), (X, Z), (FR, FI),
        (add(FR, FI), sub(FR, FI)))
    Z3 = add(YZ, YZ)
    sq_im = add(ab, ab)

    ZZZ, ZZZZ, YYYY, T = muls((Z, ZZ), (ZZ, ZZ), (YY, YY), (X, YY))
    M = add(add(XX, add(XX, XX)), ZZZZ)
    S = add(T, T)
    S = add(S, S)                                  # 4 X Y^2

    MM, t1, Z3ZZZ, Z3Y = muls((M, M), (ZZZ, xb), (Z3, ZZZ), (Z3, Y))
    X3 = sub(sub(MM, S), S)
    Y8 = add(YYYY, YYYY)
    Y8 = add(Y8, Y8)
    Y8 = add(Y8, Y8)

    MSX3, Mt, l_im = muls((M, sub(S, X3)), (M, add(t1, t2)), (Z3ZZZ, yb))
    Y3 = sub(MSX3, Y8)
    l_re = sub(Mt, Z3Y)

    m0, m1, m2 = muls((sq_re, l_re), (sq_im, l_im),
                      (add(sq_re, sq_im), add(l_re, l_im)))
    f_re = sub(m0, m1)
    f_im = sub(sub(m2, m0), m1)

    assert X3.bound <= _BX and Y3.bound <= _BY and Z3.bound <= _BZ
    assert f_re.bound <= _BF and f_im.bound <= _BF
    return X3.v, Y3.v, Z3.v, f_re.v, f_im.v


def _add_step(rns: RNSCtx, X1, Y1, Z1, fr, fi, ax, ay, xb, yb):
    """Fused mixed addition + line through V,A + f <- f * line
    (17 r_muls)."""
    X1, Y1, Z1 = RVal(X1, _BX), RVal(Y1, _BY), RVal(Z1, _BZ)
    FR, FI = RVal(fr, _BF), RVal(fi, _BF)

    def muls(*pairs):
        return rn.r_mul_many(rns, pairs)

    def add(u, v):
        return rn.r_add(rns, u, v)

    def sub(u, v):
        return rn.r_sub(rns, u, v)

    (ZZ,) = muls((Z1, Z1))
    U2, ZZZ = muls((ax, ZZ), (Z1, ZZ))
    (S2,) = muls((ay, ZZZ))
    H = sub(U2, X1)
    R = sub(S2, Y1)
    HH, RR, Z3, Rx = muls((H, H), (R, R), (Z1, H), (R, add(xb, ax)))
    HHH, V, Z3ya, l_im = muls((H, HH), (X1, HH), (Z3, ay), (Z3, yb))
    X3 = sub(sub(sub(RR, HHH), V), V)
    l_re = sub(Rx, Z3ya)
    RVX3, Y1HHH = muls((R, sub(V, X3)), (Y1, HHH))
    Y3 = sub(RVX3, Y1HHH)

    m0, m1, m2 = muls((FR, l_re), (FI, l_im),
                      (add(FR, FI), add(l_re, l_im)))
    f_re = sub(m0, m1)
    f_im = sub(sub(m2, m0), m1)

    assert X3.bound <= _BX and Y3.bound <= _BY and Z3.bound <= _BZ
    assert f_re.bound <= _BF and f_im.bound <= _BF
    return X3.v, Y3.v, Z3.v, f_re.v, f_im.v


def _dbl_pt(rns: RNSCtx, X, Y, Z):
    """Jacobian doubling (a = 1 curve), no line math; same formulas and
    bound invariants as _dbl_step (9 r_muls, 9 r_adds, 4 r_subs)."""
    X, Y, Z = RVal(X, _BX), RVal(Y, _BY), RVal(Z, _BZ)

    def muls(*pairs):
        return rn.r_mul_many(rns, pairs)

    def add(u, v):
        return rn.r_add(rns, u, v)

    def sub(u, v):
        return rn.r_sub(rns, u, v)

    XX, YY, ZZ = muls((X, X), (Y, Y), (Z, Z))
    YYYY, ZZZZ, T, YZ = muls((YY, YY), (ZZ, ZZ), (X, YY), (Y, Z))
    M = add(add(XX, add(XX, XX)), ZZZZ)
    S = add(T, T)
    S = add(S, S)
    (MM,) = muls((M, M))
    X3 = sub(sub(MM, S), S)
    Y8 = add(YYYY, YYYY)
    Y8 = add(Y8, Y8)
    Y8 = add(Y8, Y8)
    (MSX3,) = muls((M, sub(S, X3)))
    Y3 = sub(MSX3, Y8)
    Z3 = add(YZ, YZ)
    assert X3.bound <= _BX and Y3.bound <= _BY and Z3.bound <= _BZ
    return X3.v, Y3.v, Z3.v


def _add_pt(rns: RNSCtx, X1, Y1, Z1, ax, ay):
    """Mixed addition v + a, no line math, no completeness selects
    (valid when v != +-a and neither is the identity; 11 r_muls)."""
    X1, Y1, Z1 = RVal(X1, _BX), RVal(Y1, _BY), RVal(Z1, _BZ)

    def muls(*pairs):
        return rn.r_mul_many(rns, pairs)

    def sub(u, v):
        return rn.r_sub(rns, u, v)

    (ZZ,) = muls((Z1, Z1))
    U2, ZZZ = muls((ax, ZZ), (Z1, ZZ))
    (S2,) = muls((ay, ZZZ))
    H = sub(U2, X1)
    R = sub(S2, Y1)
    HH, RR, Z3 = muls((H, H), (R, R), (Z1, H))
    HHH, V = muls((H, HH), (X1, HH))
    X3 = sub(sub(sub(RR, HHH), V), V)
    RVX3, Y1HHH = muls((R, sub(V, X3)), (Y1, HHH))
    Y3 = sub(RVX3, Y1HHH)
    assert X3.bound <= _BX and Y3.bound <= _BY and Z3.bound <= _BZ
    return X3.v, Y3.v, Z3.v


def _scan_mul(rns: RNSCtx, z, reverse: bool):
    """Inclusive product scan of z [2k, B] along the lanes (log-depth,
    Hillis-Steele).  The association order differs from the JAX
    package's; only the canonical limbs after the exit are compared."""
    out = z.flip(1) if reverse else z
    off = 1
    while off < out.shape[1]:
        prod = rn.r_mul(rns, RVal(out[:, :-off], 6), RVal(out[:, off:], 6)).v
        out = torch.cat([out[:, :off], prod], dim=1)
        off *= 2
    return out.flip(1) if reverse else out


def normalize_rns(ctx: MontCtx, rns: RNSCtx, X, Y, Z) -> AffinePoint:
    """Jacobian (raw residues [2k, B], bounds <= (27, 27, 6)) -> canonical
    affine limbs, with one Fermat inversion of the batch product (_rns_pow
    at N = 1).  A dead lane's Z is literal 0.0 in every channel, which no
    live value can produce."""
    dead = torch.all(Z == 0.0, dim=0)
    one_b = rns.one_rns.expand_as(Z)
    zsafe = torch.where(dead[None], one_b, Z)
    prefix = _scan_mul(rns, zsafe, reverse=False)
    suffix = _scan_mul(rns, zsafe, reverse=True)
    total = prefix[:, -1:].contiguous()
    tinv = _rns_pow(rns, RVal(total, 3), ctx.pm2_bits).v    # [2k, 1]
    one_col = one_b[:, :1]
    pre_excl = torch.cat([one_col, prefix[:, :-1]], dim=1)
    suf_excl = torch.cat([suffix[:, 1:], one_col], dim=1)
    zinv = rn.r_mul(rns, RVal(pre_excl, 3), RVal(suf_excl, 3))
    zinv = rn.r_mul(rns, zinv, RVal(tinv.expand_as(Z), 3))
    zinv2 = rn.r_mul(rns, zinv, zinv)
    zinv3 = rn.r_mul(rns, zinv2, zinv)
    x = rn.r_mul(rns, RVal(X, _BX), zinv2)
    y = rn.r_mul(rns, RVal(Y, _BY), zinv3)
    xl, yl = rn.from_rns_mont(rns, x, y)
    zero = torch.zeros_like(xl)
    xl = torch.where(dead[None], zero, xl)
    yl = torch.where(dead[None], zero, yl)
    return AffinePoint(xl, yl, dead.to(torch.int64))


def mont_inv_rns(ctx: MontCtx, rns: RNSCtx, x):
    """Montgomery-form limb inverse x^-1 (montgomery.mont_inv's contract,
    limbs [L, *batch] in and out) with the Fermat chain x^(p-2) run in RNS
    (_rns_pow) instead of 16L sequential limb products; the inverse of the
    limb batch inversion in curve.normalize.  Exact: to_rns_mont /
    from_rns_mont round-trip the Montgomery representative."""
    batch_shape = tuple(x.shape[1:])
    xr = rn.to_rns_mont(rns, x.reshape(ctx.L, _flat(batch_shape)))
    w = _rns_pow(rns, xr, ctx.pm2_bits)
    return rn.from_rns_mont(rns, w).reshape((ctx.L,) + batch_shape)


def add_complete_rns(ctx: MontCtx, rns: RNSCtx, a: AffinePoint,
                     b: AffinePoint) -> AffinePoint:
    """COMPLETE affine a + b -> normalized AffinePoint (homomorphic L1
    Add/Sub, reference bgn.go:442-497): one incomplete mixed addition and
    one doubling computed for every lane, then the completeness selects
    of the limb madd, driven by exact zero tests on the canonical limbs of
    H = x_b - x_a and R = y_b - y_a (RNS has no cheap zero test)."""
    L = ctx.L
    batch_shape = tuple(a.x.shape[1:])
    flat = _flat(batch_shape)

    def prep(x):
        return rn.to_rns_mont(rns, x.reshape(L, flat))

    axr, ayr, bxr, byr = prep(a.x), prep(a.y), prep(b.x), prep(b.y)
    one = rns.one_rns.expand_as(axr.v)
    Xa, Ya, Za = _add_pt(rns, axr.v, ayr.v, one, bxr, byr)
    Xd, Yd, Zd = _dbl_pt(rns, axr.v, ayr.v, one)

    hl, rl = rn.from_rns_mont(rns, rn.r_sub(rns, bxr, axr),
                              rn.r_sub(rns, byr, ayr))
    h_zero, r_zero = lb.is_zero(hl), lb.is_zero(rl)
    a_inf, b_inf = a.inf.reshape(-1), b.inf.reshape(-1)
    live = (1 - a_inf) * (1 - b_inf)
    same = h_zero & r_zero & live
    opp = h_zero & (1 - r_zero) & live

    def sel(m, u, v):
        return torch.where(m.to(torch.bool)[None], u, v)

    X, Y, Z = sel(same, Xd, Xa), sel(same, Yd, Ya), sel(same, Zd, Za)
    zero = torch.zeros_like(Z)
    Z = sel(opp, zero, Z)
    # a == O -> b (affine, Z = 1); b == O (a live) -> a; O + O -> O
    X, Y, Z = sel(a_inf, bxr.v, X), sel(a_inf, byr.v, Y), sel(a_inf, one, Z)
    bo = b_inf * (1 - a_inf)
    X, Y, Z = sel(bo, axr.v, X), sel(bo, ayr.v, Y), sel(bo, one, Z)
    Z = sel(a_inf & b_inf, zero, Z)
    aff = normalize_rns(ctx, rns, X, Y, Z)
    return AffinePoint(aff.x.reshape((L,) + batch_shape),
                       aff.y.reshape((L,) + batch_shape),
                       aff.inf.reshape(batch_shape))


def neg_y_rns(rns: RNSCtx, Y, bound: int, mask):
    """Residues of the negated y-coordinate (bound*p - y) where mask,
    unchanged elsewhere; bound preserved."""
    t = rns.kp[:, bound:bound + 1] - Y
    t = torch.where(t < 0, t + rns.m, t)
    return torch.where(torch.as_tensor(mask, device=Y.device)
                       .to(torch.bool)[None], t, Y)


def fixed_base_mul_rns(ctx: MontCtx, rns: RNSCtx, table, digits, raw=False):
    """base^e via the radix-256 window table (x, y) [J, R, 2k] of base
    (the window_ladder_tab kernel; in step mode the rows are gathered and
    the chain runs one pt_add launch per window): LSB-first window
    accumulation, one mixed addition per live window, flag-exact identity
    handling; for exponents below ord(base) no addition is degenerate (JAX
    package docstring).  digits: [Jd, B] per-lane window digits, least
    significant first.  raw=True returns the (X, Y, Z) RVals; else a
    limb-Montgomery JacPoint.  Z = 0 (exact zero residues) for e = 0."""
    from . import cuda_rns
    dg = torch.as_tensor(digits).to(table[0].device)
    if _mode() == "loop":
        xyz = cuda_rns.window_ladder_tab(rns, table, dg)
    else:
        gx, gy = (g.contiguous() for g in cuda_rns._gather_rows(table, dg))
        X, Y, Z, st = cuda_rns._window_chain(rns, gx, gy, dg != 0,
                                             cuda_rns.pt_add)
        xyz = X, Y, torch.where(st[None], Z, torch.zeros_like(Z))
    out = (RVal(v, b) for v, b in zip(xyz, (_BX, _BY, _BZ)))
    if raw:
        return tuple(out)
    return JacPoint(*(rn.from_rns_mont(rns, v) for v in out))


def scalar_mul_rns(ctx: MontCtx, rns: RNSCtx, base: AffinePoint, digits):
    """base^e in G1 via an RNS double-and-add ladder (the ladder_loop
    kernel; in step mode a pt_dbl launch per digit after the first and a
    pt_add with A or -A on each nonzero one); e = shared MSB-first digits,
    plain bits or signed NAF, first digit +1 (the decrypt exponent q1,
    bgn.go:222-223).  Returns the raw (X, Y, Z) RVals over the flattened
    batch (the JAX package's raw=True, its only form in use):
    identity-base lanes carry garbage residues, which the caller masks via
    base.inf."""
    from . import cuda_rns
    flat = _flat(base.x.shape[1:])
    ax = rn.to_rns_mont(rns, base.x.reshape(ctx.L, flat)).v.contiguous()
    ay = rn.to_rns_mont(rns, base.y.reshape(ctx.L, flat)).v.contiguous()
    one = rns.one_rns.expand_as(ax).contiguous()
    if _mode() == "loop":
        X, Y, Z = cuda_rns.ladder_loop(rns, ax, ay, one, ax, ay,
                                       _digits_on(digits[1:], ax.device))
    else:
        X, Y, Z = cuda_rns._ladder_chain(rns, ax, ay, one, ax, ay,
                                         _digits_on_host(digits[1:]),
                                         cuda_rns.pt_dbl, cuda_rns.pt_add)
    return RVal(X, _BX), RVal(Y, _BY), RVal(Z, _BZ)


def scalar_mul_vec_rns(ctx: MontCtx, rns: RNSCtx, base: AffinePoint, bits):
    """base^k with a PER-ELEMENT exponent: base [L, *batch], bits
    [nbits, *batch] MSB-first plain bits (k >= 0); the RNS MultConst path
    (reference MultConst, bgn.go:253-291).  The incomplete additions are
    safe while 2^nbits < min(q1, q2) (JAX package docstring; the caller
    checks nbits).  Returns the raw (X, Y, Z) RVals over the flat batch
    (the JAX package's raw=True); k = 0 and identity-base lanes have
    Z = 0."""
    flat = _flat(base.x.shape[1:])
    ax = rn.to_rns_mont(rns, base.x.reshape(ctx.L, flat)).v
    ay = rn.to_rns_mont(rns, base.y.reshape(ctx.L, flat)).v
    one = rns.one_rns.expand_as(ax)
    bits2 = torch.as_tensor(bits).to(ax.device).reshape(-1, flat) \
        .to(torch.bool)
    X, Y, Z = ax, ay, one
    started = torch.zeros((flat,), dtype=torch.bool, device=ax.device)
    for b in bits2:
        dX, dY, dZ = _dbl_pt(rns, X, Y, Z)
        aX, aY, aZ = _add_pt(rns, dX, dY, dZ, _pt(ax), _pt(ay))
        st, newly = started[None], (~started & b)[None]
        bb = b[None]
        X = torch.where(st, torch.where(bb, aX, dX), torch.where(newly, ax, X))
        Y = torch.where(st, torch.where(bb, aY, dY), torch.where(newly, ay, Y))
        Z = torch.where(st, torch.where(bb, aZ, dZ),
                        torch.where(newly, one, Z))
        started = started | b
    dead = ~started | base.inf.reshape(-1).to(torch.bool)
    Z = torch.where(dead[None], torch.zeros_like(Z), Z)
    return RVal(X, _BX), RVal(Y, _BY), RVal(Z, _BZ)


# ---------------------------------------------------------------------------
# F_p^2 in RNS: pairs (re, im) of RVals; carry invariant (9p, 9p)
# ---------------------------------------------------------------------------


def _fp2_mul(rns, x, y):
    """Karatsuba: 3 r_muls, one stacked product."""
    a, b = x
    c, d = y
    t0, t1, t2 = rn.r_mul_many(
        rns, [(a, c), (b, d),
              (rn.r_add(rns, a, b), rn.r_add(rns, c, d))])
    return (rn.r_sub(rns, t0, t1),
            rn.r_sub(rns, rn.r_sub(rns, t2, t0), t1))


def _fp2_sqr(rns, x):
    a, b = x
    re, ab = rn.r_mul_many(
        rns, [(rn.r_add(rns, a, b), rn.r_sub(rns, a, b)), (a, b)])
    return re, rn.r_add(rns, ab, ab)


def _fp2_conj(rns, x):
    a, b = x
    return a, rn.r_sub(rns, rn.r_zero(rns, b.v.shape[1]), b)


def _rns_pow(rns: RNSCtx, x: RVal, bits) -> RVal:
    """x^e in F_p over shared MSB-first bits (x [2k, N], bound <= 16):
    one pow_loop launch, or in step mode one pow_step launch per bit.
    Result bound 3.  (rn.r_batch_inv keeps pow_loop in every mode, as the
    JAX package keeps its XLA scan there.)"""
    from . import cuda_rns
    assert x.bound <= 16, x.bound
    xv = x.v.contiguous()
    if _mode() == "loop":
        return RVal(cuda_rns.pow_loop(rns, xv, bits), 3)
    return RVal(cuda_rns._pow_chain(rns, xv, _digits_on_host(bits),
                                    cuda_rns.pow_step), 3)


def _fp2_inv(rns, x, pm2_bits):
    """1/(a+bi) = (a-bi)/(a^2+b^2); the Fermat inversion of the norm is
    one _rns_pow."""
    a, b = x
    with profiling.span("glue.fp2"):
        aa, bb = rn.r_mul_many(rns, [(a, a), (b, b)])
        norm = rn.r_add(rns, aa, bb)
    ninv = _rns_pow(rns, norm, pm2_bits)
    with profiling.span("glue.fp2"):
        nb = rn.r_sub(rns, rn.r_zero(rns, b.v.shape[1]), b)
        return rn.r_mul(rns, a, ninv), rn.r_mul(rns, nb, ninv)


def _fp2_pow_bits(rns, x, digits, unitary=False):
    """x^e for an F_p^2 element over shared MSB-first digits (signed NAF
    only when x is unitary: a negative digit multiplies by conj(x)); one
    fp2_pow_loop launch, or in step mode one fp2_pow_step launch per
    digit.  Negative digits of a non-unitary x raise before any launch."""
    from . import cuda_rns
    with profiling.span("glue.fp2"):
        if not unitary:
            with profiling.span("wait.fp2_pow_sign"):
                negative = bool((torch.as_tensor(digits) < 0).any())
            if negative:
                raise ValueError(
                    "non-unitary fp2 pow requires nonnegative digits "
                    "(signed NAF needs unitary=True)")
        xr, xi = x
        assert xr.bound <= 9 and xi.bound <= 10, (xr.bound, xi.bound)
        xrv, xiv = xr.v.contiguous(), xi.v.contiguous()
    if _mode() == "loop":
        ar, ai = cuda_rns.fp2_pow_loop(rns, xrv, xiv,
                                       _digits_on(digits, xrv.device))
    else:
        ar, ai = cuda_rns._fp2_chain(rns, xrv, xiv, _digits_on_host(digits),
                                     cuda_rns.fp2_pow_step)
    return RVal(ar, 9), RVal(ai, 9)


def fp2_pow_vec_rns(ctx: MontCtx, rns: RNSCtx, z, bits):
    """z^k with a per-element exponent for GT elements (limbs
    [2, L, *batch] in and out; bits [nbits, *batch] MSB-first): the RNS L2
    MultConst path.  Field products are complete, so no order bound is
    needed."""
    batch_shape = tuple(z.shape[2:])
    flat = _flat(batch_shape)
    zr = rn.to_rns_mont(rns, z[0].reshape(ctx.L, flat))
    zi = rn.to_rns_mont(rns, z[1].reshape(ctx.L, flat))
    ar, ai = rns.one_rns.expand_as(zr.v), torch.zeros_like(zr.v)
    bits2 = torch.as_tensor(bits).to(zr.v.device).reshape(-1, flat) \
        .to(torch.bool)
    for b in bits2:
        sq = _fp2_sqr(rns, (RVal(ar, 9), RVal(ai, 9)))
        mu = _fp2_mul(rns, sq, (zr, zi))
        assert mu[0].bound <= 9 and mu[1].bound <= 9
        ar = torch.where(b[None], mu[0].v, sq[0].v)
        ai = torch.where(b[None], mu[1].v, sq[1].v)
    return rn.from_rns_mont(rns, RVal(ar, 9), RVal(ai, 9)).reshape(
        (2, ctx.L) + batch_shape)


def fp2_pow_rns(ctx: MontCtx, rns: RNSCtx, z, digits, unitary=False,
                raw=False):
    """z^e for GT elements (limbs [2, L, B] in/out); raw=True returns the
    (re, im) RVals without the limb exit."""
    zr = rn.to_rns_mont(rns, z[0])
    zi = rn.to_rns_mont(rns, z[1])
    wr, wi = _fp2_pow_bits(rns, (RVal(zr.v, 9), RVal(zi.v, 9)), digits,
                           unitary=unitary)
    if raw:
        return wr, wi
    return rn.from_rns_mont(rns, wr, wi)


def final_exponentiation_rns(ctx: MontCtx, rns: RNSCtx, f, l_bits):
    """f^((p^2-1)/n) = (conj(f)/f)^l entirely in RNS."""
    with profiling.span("pairing.final_exp"):
        inv = _fp2_inv(rns, f, ctx.pm2_bits)
        with profiling.span("glue.fp2"):
            w = _fp2_mul(rns, _fp2_conj(rns, f), inv)
        return _fp2_pow_bits(rns, w, l_bits)


def _miller_f_rns(ctx: MontCtx, rns: RNSCtx, a: AffinePoint,
                  b: AffinePoint, n_digits):
    """Miller function value f_{n,A}(phi(B)) as RNS RVals over the flat
    batch (the miller_loop kernel; in step mode a dbl_step launch per
    digit after the first nonzero one and an add_step with A or -A after
    each nonzero digit but the last); the first nonzero digit must be
    +1."""
    L = ctx.L
    # numpy's broadcast: torch.broadcast_shapes imports sympy on first use
    batch_shape = np.broadcast_shapes(tuple(a.x.shape[1:]),
                                      tuple(b.x.shape[1:]))
    flat = _flat(batch_shape)

    def prep(x):
        return rn.to_rns_mont(
            rns, lb.expand_to(x, (L,) + tuple(batch_shape)).reshape(L, flat))

    from . import cuda_rns
    with profiling.span("pairing.miller"):
        with profiling.span("glue.to_rns"):
            ax, ay, xb, yb = (prep(v).v.contiguous()
                              for v in (a.x, a.y, b.x, b.y))
        if _mode() == "loop":
            fr, fi = cuda_rns.miller_loop(rns, ax, ay, xb, yb, n_digits)
        else:
            fr, fi = cuda_rns._miller_chain(
                rns, ax, ay, xb, yb, _digits_on_host(n_digits),
                cuda_rns.dbl_step, cuda_rns.add_step)
    return (RVal(fr, _BF), RVal(fi, _BF)), tuple(batch_shape)


def pairing_rns(ctx: MontCtx, rns: RNSCtx, a: AffinePoint, b: AffinePoint,
                n_digits, l_bits):
    """Full pairing (Miller + final exponentiation) in RNS with one limb
    conversion at exit: [2, L, *batch] limb-Montgomery."""
    f, batch_shape = _miller_f_rns(ctx, rns, a, b, n_digits)
    zr, zi = final_exponentiation_rns(ctx, rns, f, l_bits)
    with profiling.span("glue.from_rns"):
        return rn.from_rns_mont(rns, zr, zi).reshape((2, ctx.L) + batch_shape)
