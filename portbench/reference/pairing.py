"""The reference's Tate pairing and curve arithmetic on plain Python ints.

The symmetric pairing of BGN on E: y^2 = x^3 + x over F_p (p = 3 mod 4)
with the distortion map phi(x, y) = (-x, i*y):

    e(A, B) = f_{n,A}(phi(B)) ^ ((p^2 - 1) / n) = (conj(f) / f) ^ l

The Miller loop runs over the NAF of n, most significant digit first, in
Jacobian coordinates (x = X/Z^2, y = Y/Z^3), so a step needs no
inversion.  Each line is scaled by a factor in F_p, which the final
exponentiation sends to 1 (z^(p-1) = 1 for z in F_p^*), as are the
vertical lines of denominator elimination.  The last digit's addition
reaches n*A = O along a vertical line, so it is left out, as in the
affine loop of hostmath's original (`tate_miller`).

Every F_p product and square of the Miller loop goes through `Fp.mul`,
so that a counting subclass reads how many the loop makes: the roofline
metric (metrics/miller_loop_roofline.py) prices the loop with those
counts, frozen there.  Imports nothing of the program.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

from . import hostmath as hm

Fp2 = Tuple[int, int]
Jac = Tuple[int, int, int]          # (X, Y, Z); Z = 0 is the identity


class Fp:
    """F_p products mod p."""

    def __init__(self, p: int):
        self.p = p

    def mul(self, a: int, b: int) -> int:
        return a * b % self.p


def fp2_mul(F: Fp, x: Fp2, y: Fp2) -> Fp2:
    """Karatsuba: 3 products."""
    p = F.p
    t0 = F.mul(x[0], y[0])
    t1 = F.mul(x[1], y[1])
    t2 = F.mul(x[0] + x[1], y[0] + y[1])
    return ((t0 - t1) % p, (t2 - t0 - t1) % p)


def fp2_sqr(F: Fp, x: Fp2) -> Fp2:
    """(a + b)(a - b) and 2ab: 2 products."""
    a, b = x
    return (F.mul(a + b, a - b), F.mul(a + a, b))


def dbl_step(F: Fp, V: Jac, f: Fp2, xq: int, yq: int):
    """V <- 2V and f <- f^2 * l_V(phi(Q)), l_V the tangent at V (a = 1).
    Point (dbl-2007-bl with a = 1): XX, YY, YYYY, ZZ, X*YY, ZZ^2, M^2,
    M*(S - X3), Y*Z = 9 products.  Tangent, scaled by Z3*ZZ:
    re = M*(xq*ZZ + X) - 2*YY, im = yq*(Z3*ZZ): 4.  f: 2 + 3."""
    p = F.p
    X, Y, Z = V
    XX = F.mul(X, X)
    YY = F.mul(Y, Y)
    YYYY = F.mul(YY, YY)
    ZZ = F.mul(Z, Z)
    S = 4 * F.mul(X, YY) % p
    M = (3 * XX + F.mul(ZZ, ZZ)) % p
    X3 = (F.mul(M, M) - 2 * S) % p
    Y3 = (F.mul(M, S - X3) - 8 * YYYY) % p
    Z3 = 2 * F.mul(Y, Z) % p
    line = ((F.mul(M, F.mul(xq, ZZ) + X) - 2 * YY) % p,
            F.mul(yq, F.mul(Z3, ZZ)))
    return (X3, Y3, Z3), fp2_mul(F, fp2_sqr(F, f), line)


def add_step(F: Fp, V: Jac, xa: int, ya: int, f: Fp2, xq: int, yq: int):
    """V <- V + (xa, ya) and f <- f * l(phi(Q)), l the chord through V and
    (xa, ya).  Point (madd): ZZ, xa*ZZ, Z*ZZ, ya*(Z*ZZ), HH, H*HH, X*HH,
    r^2, r*(V - X3), Y*HHH, Z*H = 11 products.  Chord, scaled by Z3:
    re = r*(xq + xa) - ya*Z3, im = yq*Z3: 3.  f: 3."""
    p = F.p
    X, Y, Z = V
    ZZ = F.mul(Z, Z)
    H = (F.mul(xa, ZZ) - X) % p
    r = (F.mul(ya, F.mul(Z, ZZ)) - Y) % p
    HH = F.mul(H, H)
    HHH = F.mul(H, HH)
    V2 = F.mul(X, HH)
    X3 = (F.mul(r, r) - HHH - 2 * V2) % p
    Y3 = (F.mul(r, V2 - X3) - F.mul(Y, HHH)) % p
    Z3 = F.mul(Z, H)
    line = ((F.mul(r, xq + xa) - F.mul(ya, Z3)) % p, F.mul(yq, Z3))
    return (X3, Y3, Z3), fp2_mul(F, f, line)


def naf(e: int) -> list:
    """Non-adjacent form of e > 0, digits in {-1, 0, 1}, most significant
    first, no leading zeros."""
    digits = []
    while e:
        d = 2 - (e & 3) if e & 1 else 0
        digits.append(d)
        e = (e - d) >> 1
    return digits[::-1]


def naf_shape(e: int) -> Tuple[int, int]:
    """(number of digits, number of nonzero digits) of naf(e), e > 0."""
    e3 = 3 * e
    c = e3 ^ e
    return ((e3 & c) >> 1).bit_length(), c.bit_count()


def miller(F: Fp, A: hm.Point, B: hm.Point, digits: Sequence[int]) -> Fp2:
    """f_{n,A}(phi(B)) up to a factor in F_p; digits = naf(n)."""
    if A is None or B is None:
        return (1, 0)
    p = F.p
    xa, ya = A
    xq, yq = B
    V: Jac = (xa, ya, 1)
    f: Fp2 = (1, 0)
    last = len(digits) - 1
    for i in range(1, len(digits)):
        V, f = dbl_step(F, V, f, xq, yq)
        d = digits[i]
        if d and i != last:
            V, f = add_step(F, V, xa, ya if d > 0 else (-ya) % p, f, xq, yq)
    return f


def final_exp(F: Fp, f: Fp2, l: int) -> Fp2:
    """f^((p^2 - 1)/n) = (conj(f) / f)^l."""
    p = F.p
    w = hm.fp2_mul(hm.fp2_conj(f, p), hm.fp2_inv(f, p), p)
    return hm.fp2_pow(w, l, p)


def pairing(A: hm.Point, B: hm.Point, n: int, l: int, p: int,
            digits: Optional[Sequence[int]] = None) -> Fp2:
    """e(A, B); digits: naf(n), when the caller has it."""
    if A is None or B is None:
        return (1, 0)
    F = Fp(p)
    return final_exp(F, miller(F, A, B, digits or naf(n)), l)


def encrypt(m: int, r: int, P: hm.Point, Q: hm.Point, p: int) -> hm.Point:
    """C = P^m * Q^r (EncryptWithRandomness, bgn.go:340-353), m, r >= 0."""
    return hm.ec_add(hm.ec_mul(m, P, p), hm.ec_mul(r, Q, p), p)


def product_lane(args) -> tuple:
    """(C_a, C_b, e(C_a, C_b)) of one lane of a mult request; args: (p, n,
    l, P, Q, naf(n), m, k, r, r')."""
    p, n, l, P, Q, digits, m, k, ra, rb = args
    A = encrypt(m, ra, P, Q, p)
    B = encrypt(k, rb, P, Q, p)
    return A, B, pairing(A, B, n, l, p, digits)
