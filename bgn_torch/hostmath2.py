"""Independent second pairing oracle (host-side, exact Python ints): the
port's own copy of `bgn_tpu/hostmath2.py`, on the port's hostmath.

Every "bit-exact against the reference" claim rests on hostmath.py's
golden model, a single-sourced oracle (the Go reference itself needs a
Go toolchain and PBC to run tools/dump_reference.go).  This module breaks
the single-sourcing with a SECOND, independently derived implementation
of the same pairing:

  - F_p^2 arithmetic in schoolbook form (hostmath.py uses Karatsuba);
  - a GENERIC affine Miller loop over E(F_p^2) that keeps the vertical
    lines (no denominator elimination) and tracks the Miller function as
    a numerator/denominator fraction (hostmath.tate_miller eliminates
    denominators and elides the final vertical entirely);
  - the final exponentiation computed directly as f^((p^2-1)/n)
    (hostmath.final_exponentiation uses the conj(f)/f Frobenius
    shortcut and the small power l);
  - the WEIL pairing w(P, S) = (-1)^n f_{n,P}(S)/f_{n,S}(P), whose
    reduced form must satisfy w^((p^2-1)/n) = t(P,S)/t(S,P) -- a
    consistency triangle none of whose legs shares code with
    hostmath.tate_pairing.

Agreement of tate_pairing_indep with hostmath.tate_pairing over many
random keys (tests/test_oracle2.py,
tests/test_torch_host_tools.py) means a silent error in either
implementation's line construction, loop structure, or final
exponentiation would have to be mirrored exactly in the other -- across
different formulas -- to go unnoticed.  Real reference-produced fixtures
(tools/dump_reference.go, docs/INTEROP.md) remain the final gate.
"""

from __future__ import annotations

from typing import Optional, Tuple

from .hostmath import A1Params

Fp2 = Tuple[int, int]
# A point of E(F_p^2): ((xr, xi), (yr, yi)) affine, or None for O.
Point2 = Optional[Tuple[Fp2, Fp2]]

_ONE: Fp2 = (1, 0)
_ZERO: Fp2 = (0, 0)


# ---------------------------------------------------------------------------
# Schoolbook F_p^2 (i^2 = -1); deliberately NOT the Karatsuba forms of
# hostmath.py.
# ---------------------------------------------------------------------------


def _add(x: Fp2, y: Fp2, p: int) -> Fp2:
    return ((x[0] + y[0]) % p, (x[1] + y[1]) % p)


def _sub(x: Fp2, y: Fp2, p: int) -> Fp2:
    return ((x[0] - y[0]) % p, (x[1] - y[1]) % p)


def _mul(x: Fp2, y: Fp2, p: int) -> Fp2:
    a, b = x
    c, d = y
    return ((a * c - b * d) % p, (a * d + b * c) % p)


def _inv(x: Fp2, p: int) -> Fp2:
    a, b = x
    norm_inv = pow(a * a + b * b, -1, p)
    return (a * norm_inv % p, -b * norm_inv % p)


def _pow(x: Fp2, e: int, p: int) -> Fp2:
    if e < 0:
        return _pow(_inv(x, p), -e, p)
    r = _ONE
    while e:
        if e & 1:
            r = _mul(r, x, p)
        x = _mul(x, x, p)
        e >>= 1
    return r


# ---------------------------------------------------------------------------
# Generic affine E(F_p^2) arithmetic, curve y^2 = x^3 + x
# ---------------------------------------------------------------------------


def ec2_neg(P: Point2, p: int) -> Point2:
    if P is None:
        return None
    return (P[0], _sub(_ZERO, P[1], p))


def ec2_add(P: Point2, Q: Point2, p: int) -> Point2:
    if P is None:
        return Q
    if Q is None:
        return P
    (x1, y1), (x2, y2) = P, Q
    if x1 == x2:
        if _add(y1, y2, p) == _ZERO:
            return None
        lam = _mul(_add(_mul((3, 0), _mul(x1, x1, p), p), _ONE, p),
                   _inv(_mul((2, 0), y1, p), p), p)
    else:
        lam = _mul(_sub(y2, y1, p), _inv(_sub(x2, x1, p), p), p)
    x3 = _sub(_sub(_mul(lam, lam, p), x1, p), x2, p)
    y3 = _sub(_mul(lam, _sub(x1, x3, p), p), y1, p)
    return (x3, y3)


def ec2_mul(k: int, P: Point2, p: int) -> Point2:
    if P is None or k == 0:
        return None
    if k < 0:
        return ec2_mul(-k, ec2_neg(P, p), p)
    R: Point2 = None
    while k:
        if k & 1:
            R = ec2_add(R, P, p)
        P = ec2_add(P, P, p)
        k >>= 1
    return R


def lift(P, p: int) -> Point2:
    """E(F_p) point -> E(F_p^2)."""
    if P is None:
        return None
    return ((P[0] % p, 0), (P[1] % p, 0))


def phi(Q, p: int) -> Point2:
    """Distortion map phi(x, y) = (-x, i*y) (same map as hostmath)."""
    if Q is None:
        return None
    return (((-Q[0]) % p, 0), (0, Q[1] % p))


# ---------------------------------------------------------------------------
# Generic Miller loop with verticals (numerator/denominator fractions)
# ---------------------------------------------------------------------------


def _eval_line(V: Point2, lam: Fp2, S: Point2, p: int) -> Fp2:
    """(y_S - y_V) - lam*(x_S - x_V)."""
    (xv, yv), (xs, ys) = V, S
    return _sub(_sub(ys, yv, p), _mul(lam, _sub(xs, xv, p), p), p)


def _eval_vert(V: Point2, S: Point2, p: int) -> Fp2:
    """x_S - x_V (the vertical through V); 1 for V = O."""
    if V is None:
        return _ONE
    return _sub(S[0], V[0], p)


def miller_full(P: Point2, S: Point2, n: int, p: int) -> Fp2:
    """f_{n,P}(S) by the textbook Miller recursion, verticals included.

    Every step multiplies by l_{V,W}(S) / v_{V+W}(S); nothing is elided,
    so intermediate values differ from hostmath.tate_miller by F_p^*
    factors that only the final exponentiation removes.  Division is
    deferred: the function is tracked as (num, den) and divided once.
    Requires S not in <P> (no line evaluates to zero at S then)."""
    assert P is not None and S is not None
    num, den = _ONE, _ONE
    V: Point2 = P
    for bit in bin(n)[3:]:
        # doubling: f <- f^2 * l_{V,V}(S) / v_{2V}(S)
        num = _mul(num, num, p)
        den = _mul(den, den, p)
        if V is not None:
            xv, yv = V
            if _add(yv, yv, p) == _ZERO:
                # 2-torsion: tangent is the vertical through V; 2V = O
                num = _mul(num, _eval_vert(V, S, p), p)
                V = None
            else:
                lam = _mul(_add(_mul((3, 0), _mul(xv, xv, p), p), _ONE, p),
                           _inv(_mul((2, 0), yv, p), p), p)
                V2 = ec2_add(V, V, p)
                num = _mul(num, _eval_line(V, lam, S, p), p)
                den = _mul(den, _eval_vert(V2, S, p), p)
                V = V2
        if bit == "1":
            # addition: f <- f * l_{V,P}(S) / v_{V+P}(S)
            if V is None:
                V = P          # l_{O,P}/v_P = v_P/v_P = 1
            elif V[0] == P[0] and _add(V[1], P[1], p) == _ZERO:
                # V = -P: chord is the vertical through V; V+P = O
                num = _mul(num, _eval_vert(V, S, p), p)
                V = None
            else:
                if V == P:
                    lam = _mul(
                        _add(_mul((3, 0), _mul(V[0], V[0], p), p), _ONE, p),
                        _inv(_mul((2, 0), V[1], p), p), p)
                else:
                    lam = _mul(_sub(P[1], V[1], p),
                               _inv(_sub(P[0], V[0], p), p), p)
                VP = ec2_add(V, P, p)
                num = _mul(num, _eval_line(V, lam, S, p), p)
                den = _mul(den, _eval_vert(VP, S, p), p)
                V = VP
    assert V is None, "exponent did not annihilate the base point"
    return _mul(num, _inv(den, p), p)


def tate_pairing_indep(P, Q, params: A1Params) -> Fp2:
    """e(P, Q) = f_{n,P}(phi(Q))^((p^2-1)/n), all parts independently
    derived from hostmath.tate_pairing (see module docstring); must agree
    with it bit-for-bit on every input."""
    if P is None or Q is None:
        return _ONE
    p, n = params.p, params.n
    f = miller_full(lift(P, p), phi(Q, p), n, p)
    return _pow(f, (p * p - 1) // n, p)


def weil_pairing(P2: Point2, S: Point2, n: int, p: int) -> Fp2:
    """w(P, S) = (-1)^n * f_{n,P}(S) / f_{n,S}(P)."""
    f_ps = miller_full(P2, S, n, p)
    f_sp = miller_full(S, P2, n, p)
    w = _mul(f_ps, _inv(f_sp, p), p)
    if n % 2 == 1:
        w = _sub(_ZERO, w, p)
    return w


def weil_tate_consistent(P, Q, params: A1Params) -> bool:
    """The Weil/Tate triangle: w(P, phi(Q))^((p^2-1)/n) must equal
    t(P, phi(Q)) / t(phi(Q), P) where t(X, Y) = f_{n,X}(Y)^((p^2-1)/n).
    ((-1)^((p^2-1)/n) = 1: the exponent is (p-1)*l with l = 4k.)"""
    p, n = params.p, params.n
    e = (p * p - 1) // n
    P2, S = lift(P, p), phi(Q, p)
    w = weil_pairing(P2, S, n, p)
    t_ps = _pow(miller_full(P2, S, n, p), e, p)
    t_sp = _pow(miller_full(S, P2, n, p), e, p)
    return _pow(w, e, p) == _mul(t_ps, _inv(t_sp, p), p)
