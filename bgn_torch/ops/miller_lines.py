"""The Miller loop's step formulas on limbs, written once for every limb
Miller loop of the port: ops/pairing.py's miller_loop (through the
mont_mul wrapper) and the plain versions of ops/cuda_pairing.py's two
digit-domain step kernels (through cuda_mont.mont_mul_plain), whose CUDA
kernels run the same products in the same order.  `mul` is the
Montgomery product; mod_add / mod_sub are torch ops.  The formulas are
those of bgn_tpu/ops/pallas_pairing.py's step kernels, scale factors
that die in the final exponentiation included.
"""

from __future__ import annotations

import functools

from ..fieldcore import montgomery as mg


def dbl_line(ctx, mul, X, Y, Z, xb, yb):
    """Jacobian doubling fused with the tangent line at phi(B) = (-xb,
    i yb), scaled by Z3 Z^3: 16 products.  Returns ((X3, Y3, Z3),
    (l_re, l_im))."""
    add = functools.partial(mg.mod_add, ctx)
    sub = functools.partial(mg.mod_sub, ctx)
    XX = mul(X, X)
    ZZ = mul(Z, Z)
    ZZZ = mul(Z, ZZ)
    ZZZZ = mul(ZZ, ZZ)
    YY = mul(Y, Y)
    YYYY = mul(YY, YY)
    M = add(add(XX, add(XX, XX)), ZZZZ)
    T = mul(X, YY)
    S = add(T, T)
    S = add(S, S)                                  # 4 X Y^2
    MM = mul(M, M)
    X3 = sub(sub(MM, S), S)
    Y8 = add(YYYY, YYYY)
    Y8 = add(Y8, Y8)
    Y8 = add(Y8, Y8)
    Y3 = sub(mul(M, sub(S, X3)), Y8)
    YZ = mul(Y, Z)
    Z3 = add(YZ, YZ)
    t1 = mul(ZZZ, xb)
    t2 = mul(X, Z)
    l_re = sub(mul(M, add(t1, t2)), mul(Z3, Y))
    l_im = mul(mul(Z3, ZZZ), yb)
    return (X3, Y3, Z3), (l_re, l_im)


def madd_line(ctx, mul, X1, Y1, Z1, xa, ya, xb, yb):
    """Mixed addition V + A (A affine) fused with the line through V and
    A at phi(B), scaled by Z3: 14 products.  No completeness selects: in
    the Miller loop the only degenerate addition is the last one, which
    is elided."""
    add = functools.partial(mg.mod_add, ctx)
    sub = functools.partial(mg.mod_sub, ctx)
    ZZ = mul(Z1, Z1)
    U2 = mul(xa, ZZ)
    ZZZ = mul(Z1, ZZ)
    S2 = mul(ya, ZZZ)
    H = sub(U2, X1)
    R = sub(S2, Y1)
    HH = mul(H, H)
    HHH = mul(H, HH)
    V = mul(X1, HH)
    RR = mul(R, R)
    X3 = sub(sub(sub(RR, HHH), V), V)
    Y3 = sub(mul(R, sub(V, X3)), mul(Y1, HHH))
    Z3 = mul(Z1, H)
    l_re = sub(mul(R, add(xb, xa)), mul(Z3, ya))
    l_im = mul(Z3, yb)
    return (X3, Y3, Z3), (l_re, l_im)


def fp2_mul(ctx, mul, x, y):
    """Karatsuba F_p^2 product (ops/fp2.py mul): 3 products."""
    add = functools.partial(mg.mod_add, ctx)
    sub = functools.partial(mg.mod_sub, ctx)
    m0 = mul(x[0], y[0])
    m1 = mul(x[1], y[1])
    m2 = mul(add(x[0], x[1]), add(y[0], y[1]))
    return sub(m0, m1), sub(sub(m2, m0), m1)


def fp2_sqr(ctx, mul, x):
    """(a + bi)^2 = (a + b)(a - b) + 2ab i (ops/fp2.py sqr): 2 products."""
    ab = mul(x[0], x[1])
    return (mul(mg.mod_add(ctx, x[0], x[1]), mg.mod_sub(ctx, x[0], x[1])),
            mg.mod_add(ctx, ab, ab))
