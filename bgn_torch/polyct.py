"""Polynomial ciphertexts: coefficient-batched homomorphic ops.

The port's counterpart of `bgn_tpu/polyct.py` (the reference's poly.go).
A PolyCiphertext's coefficients live in ONE batched Ciphertext whose
leading batch axis is the coefficient index, so every coefficient-wise op
is one scheme op over the whole batch; the goroutine-per-pair fan-out of
MultPoly/MultConstPoly (poly.go:95-111, 129-153) becomes one batched
pairing (one `pk.mult`: the miller_loop, pow_loop and fp2_pow_loop
kernels) over all degree1*degree2 pairs plus a skew accumulation of the
products in torch ops.

Semantics mirrored exactly:
  - EncryptPoly / DecryptPoly coefficient-wise (poly.go:11-42); negative
    coefficients encrypt as the additive inverse (poly.go:17-22).
  - AddPoly with scale-factor alignment (MultConstPoly by
    FPScaleBase^diff, poly.go:209-226) and level promotion via MakePolyL2 =
    MultPoly(E(poly 1), ct) (poly.go:159-163, 173-182).
  - MultPoly: full convolution, result degree d1+d2, L2
    (poly.go:123-156); MultConstPoly: convolution with the unbalanced
    encoding of |constant|, NegPoly afterwards if negative (poly.go:70-120).
  - EvalPoly: homomorphic Horner collapse (poly.go:58-68).

A coefficient batch may carry trailing poly-batch dims: ct batch shape
(degree, B) holds B same-shape polynomials, and every op here runs all B
through the launches it uses for one (the accumulators loop over the d1
rows of a product, never over polynomials or coefficients).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from . import encoding
from .ops import curve
from .ops import fp2
from .ops.curve import AffinePoint
from .scheme import BGNPublicKey, BGNSecretKey, Ciphertext, _flat


@dataclass
class PolyCiphertext:
    """Reference PolyCiphertext (ciphertext.go:26-31): coefficient batch +
    degree + fixed-point scale factor + level flag."""

    ct: Ciphertext          # batch shape (degree, *poly batch)
    degree: int
    scale_factor: int

    @property
    def level2(self) -> bool:
        return self.ct.level2

    def copy(self) -> "PolyCiphertext":
        return PolyCiphertext(self.ct, self.degree, self.scale_factor)

    def string(self, pk) -> str:
        """Coefficient elements one per line (the analog of
        PolyCiphertext.String, ciphertext.go:64-73)."""
        return self.ct.string(pk) + "\n"


def _index(pk: BGNPublicKey, idx: np.ndarray) -> torch.Tensor:
    return torch.as_tensor(idx, dtype=torch.int64,
                           device=pk.dev.n_naf.device)


# ---------------------------------------------------------------------------
# Encrypt / decrypt
# ---------------------------------------------------------------------------


def encrypt_poly(pk: BGNPublicKey, pt: encoding.PolyPlaintext,
                 rng=None) -> PolyCiphertext:
    """Encrypt each coefficient (EncryptPoly, poly.go:11-29).  Negative
    coefficients become additive inverses: P^-|c| * Q^r, the same group
    element as the reference's Sub(E(0), E(|c|))."""
    ct = pk.encrypt(pt.coefficients, rng=rng)
    return PolyCiphertext(ct, pt.degree, pt.scale_factor)


def decrypt_poly(sk: BGNSecretKey, pct: PolyCiphertext, pk: BGNPublicKey,
                 tables) -> encoding.PolyPlaintext:
    """Decrypt each coefficient (DecryptPoly, poly.go:32-42).  Like the
    reference, an out-of-range coefficient does not raise (the reference
    drops the error and keeps a nil coefficient); it decrypts to 0."""
    vals = sk.decrypt_failsafe(pct.ct, pk, tables)
    return encoding.PolyPlaintext(pk, [int(v) for v in vals],
                                  pct.degree, pct.scale_factor)


def encrypt_poly_batch(pk: BGNPublicKey, pts, rng=None) -> PolyCiphertext:
    """Encrypt B same-scale polynomials as one (degree, B) coefficient
    batch (one Encrypt launch).  `pts`: PolyPlaintexts with equal
    scale_factor (the decode divides by fp_scale_base^scale_factor per
    poly, plaintext.go:315-335); shorter polys are zero-padded to the
    largest degree (E(0) lanes are exact)."""
    pts = list(pts)
    if not pts:
        raise ValueError("empty poly batch")
    sf = pts[0].scale_factor
    if any(p.scale_factor != sf for p in pts):
        raise ValueError("poly batch requires a uniform scale_factor")
    d = max(p.degree for p in pts)
    B = len(pts)
    coeffs = [(p.coefficients[i] if i < p.degree else 0)
              for i in range(d) for p in pts]      # coefficient-major [d*B]
    ct = pk.encrypt(coeffs, rng=rng).reshape((d, B))
    return PolyCiphertext(ct, d, sf)


def decrypt_poly_batch(sk: BGNSecretKey, pct: PolyCiphertext,
                       pk: BGNPublicKey, tables):
    """Decrypt a (degree, B) poly batch -> list of B PolyPlaintexts
    (coefficient-wise failsafe semantics, like decrypt_poly)."""
    vals = sk.decrypt_failsafe(pct.ct, pk, tables)
    vals = np.asarray(vals).reshape(pct.degree, -1)
    return [encoding.PolyPlaintext(pk, [int(v) for v in vals[:, b]],
                                   pct.degree, pct.scale_factor)
            for b in range(vals.shape[1])]


# ---------------------------------------------------------------------------
# Level promotion / negation / add / sub
# ---------------------------------------------------------------------------


def make_poly_l2(pk: BGNPublicKey, pct: PolyCiphertext) -> PolyCiphertext:
    """MakePolyL2 = MultPoly(EncryptPoly(E(1.0)), ct) (poly.go:159-163):
    the degree grows by one with a zero top coefficient, exactly like the
    reference.  E(1.0) is a fresh randomized encryption, as there."""
    one_ct = encrypt_poly(pk, encoding.new_poly_plaintext(pk, 1.0))
    rest = pct.ct.batch_shape[1:]
    if rest:
        one_ct = PolyCiphertext(_broadcast_trailing(one_ct.ct, rest),
                                one_ct.degree, one_ct.scale_factor)
    return mult_poly(pk, one_ct, pct)


def _broadcast_trailing(ct: Ciphertext, rest) -> Ciphertext:
    """Broadcast a [d] coefficient batch to [d, *rest] (one element value
    shared across the trailing poly-batch dims)."""
    rest = tuple(rest)
    pad = (1,) * len(rest)
    if ct.level2:
        return Ciphertext(ct.data.reshape(ct.data.shape[:3] + pad)
                          .expand(ct.data.shape[:3] + rest), True)
    L, d = ct.data.x.shape
    return Ciphertext(AffinePoint(
        ct.data.x.reshape((L, d) + pad).expand((L, d) + rest),
        ct.data.y.reshape((L, d) + pad).expand((L, d) + rest),
        ct.data.inf.reshape((d,) + pad).expand((d,) + rest)), False)


def neg_poly(pk: BGNPublicKey, pct: PolyCiphertext,
             rng=None) -> PolyCiphertext:
    """Coefficient-wise Sub(E(0), c) (NegPoly, poly.go:45-55)."""
    return PolyCiphertext(pk.neg(pct.ct, rng=rng), pct.degree,
                          pct.scale_factor)


def add_poly(pk: BGNPublicKey, a: PolyCiphertext, b: PolyCiphertext,
             rng=None) -> PolyCiphertext:
    """AddPoly (poly.go:171-207): level promotion, scale alignment, then
    coefficient-wise add with the longer poly's tail passed through."""
    if a.level2 or b.level2:
        if not a.level2:
            return add_poly(pk, make_poly_l2(pk, a), b, rng=rng)
        if not b.level2:
            return add_poly(pk, a, make_poly_l2(pk, b), rng=rng)
    a, b = _align(pk, a, b)
    degree = max(a.degree, b.degree)
    small, big = (a, b) if a.degree <= b.degree else (b, a)
    d_small = small.degree
    added = pk.add(big.ct[:d_small], small.ct, rng=rng)
    out = _concat_ct(pk, added, big.ct[d_small:], big.level2)
    return PolyCiphertext(out, degree, a.scale_factor)


def sub_poly(pk: BGNPublicKey, a: PolyCiphertext, b: PolyCiphertext,
             rng=None) -> PolyCiphertext:
    """SubPoly = AddPoly(a, NegPoly(b)) (poly.go:166-168)."""
    return add_poly(pk, a, neg_poly(pk, b, rng=rng), rng=rng)


def _align(pk: BGNPublicKey, ct1: PolyCiphertext, ct2: PolyCiphertext):
    """alignPolyCiphertexts (poly.go:209-226)."""
    if ct1.scale_factor > ct2.scale_factor:
        diff = ct1.scale_factor - ct2.scale_factor
        ct2 = mult_const_poly(pk, ct2,
                              math.pow(pk.poly_params.fp_scale_base, diff))
        return ct1, PolyCiphertext(ct2.ct, ct2.degree, ct1.scale_factor)
    if ct2.scale_factor > ct1.scale_factor:
        ct2a, ct1a = _align(pk, ct2, ct1)
        return ct1a, ct2a
    return ct1, ct2


def _concat_ct(pk: BGNPublicKey, head, tail, level2: bool):
    """Concatenate two coefficient batches along the coefficient axis
    (head may be None)."""
    if head is None:
        return tail
    if level2:
        return Ciphertext(torch.cat([head.data, tail.data], dim=2), True)
    return Ciphertext(AffinePoint(
        torch.cat([head.data.x, tail.data.x], dim=1),
        torch.cat([head.data.y, tail.data.y], dim=1),
        torch.cat([head.data.inf, tail.data.inf], dim=0)), False)


# ---------------------------------------------------------------------------
# Multiplication
# ---------------------------------------------------------------------------


def mult_poly(pk: BGNPublicKey, a: PolyCiphertext, b: PolyCiphertext,
              rng=None) -> PolyCiphertext:
    """MultPoly (poly.go:123-156): ONE pk.mult over all d1*d2 coefficient
    pairs of all polynomials, then the skew accumulation of the GT
    products.  Result degree d1+d2 with the top coefficient an encryption
    of zero, exactly like the reference's zero-padded result array."""
    if a.level2 or b.level2:
        raise ValueError("MultPoly requires level-1 polynomial ciphertexts")
    d1, d2 = a.degree, b.degree
    ii, kk = np.meshgrid(np.arange(d1), np.arange(d2), indexing="ij")
    prod = pk.mult(a.ct[_index(pk, ii.reshape(-1))],
                   b.ct[_index(pk, kk.reshape(-1))], rng=rng)
    out = _poly_accumulate_l2(pk.dev, prod.data, d1, d2)
    return PolyCiphertext(Ciphertext(out, True), d1 + d2,
                          a.scale_factor + b.scale_factor)


def mult_const_poly(pk: BGNPublicKey, pct: PolyCiphertext, constant,
                    rng=None) -> PolyCiphertext:
    """MultConstPoly (poly.go:70-120): convolution with the unbalanced
    encoding of |constant| (digits in {1, 2}) through ONE pk.mult_const
    over all coefficient pairs; NegPoly afterwards if the constant is
    negative."""
    constant = float(constant)
    is_negative = constant < 0
    if is_negative:
        constant = -constant
    poly = encoding.new_unbalanced_plaintext(pk, constant)
    d1, dp = pct.degree, poly.degree
    ii, kk = np.meshgrid(np.arange(d1), np.arange(dp), indexing="ij")
    pairs_ct = pct.ct[_index(pk, ii.reshape(-1))]
    consts = [poly.coefficients[k] for k in kk.reshape(-1)]
    rest_flat = _flat(pct.ct.batch_shape[1:])
    if rest_flat > 1:   # trailing poly-batch dims share the constant poly
        consts = [c for c in consts for _ in range(rest_flat)]
    prod = pk.mult_const(pairs_ct, consts, rng=rng)   # [d1*dp, *rest]
    if pct.level2:
        out = Ciphertext(_poly_accumulate_l2(pk.dev, prod.data, d1, dp),
                         True)
    else:
        out = Ciphertext(_poly_accumulate_l1(pk.dev, prod.data, d1, dp),
                         False)
    res = PolyCiphertext(out, d1 + dp, pct.scale_factor + poly.scale_factor)
    if is_negative:
        return neg_poly(pk, res, rng=rng)
    return res


def _skew_index(d1: int, d2: int, device):
    """Convolution skew: row i's entry k lands at output j = i + k.
    Returns (kkc [d1, d1+d2] clamped gather indices, valid [d1, d1+d2])."""
    kk = np.arange(d1 + d2)[None, :] - np.arange(d1)[:, None]
    valid = (kk >= 0) & (kk < d2)
    return (torch.as_tensor(np.clip(kk, 0, d2 - 1), device=device),
            torch.as_tensor(valid, device=device))


def _poly_accumulate_l2(dev, prods, d1: int, d2: int):
    """prods [2, L, d1*d2, *rest] -> diagonal products [2, L, d1+d2,
    *rest] in GT.  Each of the d1 rows is skew-gathered to its output
    offset (the identity outside its window) and the rows are folded by
    batched F_p^2 products, one per row (the JAX package's lax.scan)."""
    ctx = dev.ctx
    L, D = ctx.L, d1 + d2
    rest = tuple(prods.shape[3:])
    pad = (1,) * len(rest)
    rows = prods.reshape((2, L, d1, d2) + rest).movedim(2, 0)
    kkc, valid = _skew_index(d1, d2, prods.device)
    gathered = torch.gather(
        rows, 3, kkc.reshape((d1, 1, 1, D) + pad).expand((d1, 2, L, D) + rest))
    one = fp2.one(ctx, (D,) + rest)
    shifted = torch.where(valid.reshape((d1, 1, 1, D) + pad), gathered,
                          one[None])
    acc = one
    for row in shifted:
        acc = fp2.mul(ctx, acc, row)
    return acc


def _poly_accumulate_l1(dev, prods: AffinePoint, d1: int, d2: int):
    """prods AffinePoint [L, d1*d2, *rest] -> diagonal sums [L, d1+d2,
    *rest] in G1: the same skew gather (the identity outside a row's
    window), a fold of complete mixed additions with a Jacobian
    accumulator, and ONE normalize at the end."""
    ctx = dev.ctx
    L, D = ctx.L, d1 + d2
    rest = tuple(prods.inf.shape[1:])
    pad = (1,) * len(rest)
    px = prods.x.reshape((L, d1, d2) + rest).movedim(1, 0)
    py = prods.y.reshape((L, d1, d2) + rest).movedim(1, 0)
    pinf = prods.inf.reshape((d1, d2) + rest)
    kkc, valid = _skew_index(d1, d2, prods.inf.device)
    idx = kkc.reshape((d1, 1, D) + pad).expand((d1, L, D) + rest)
    gx = torch.gather(px, 2, idx)
    gy = torch.gather(py, 2, idx)
    ginf = torch.gather(pinf, 1,
                        kkc.reshape((d1, D) + pad).expand((d1, D) + rest))
    validr = valid.reshape((d1, D) + pad)
    ginf = torch.where(validr, ginf, torch.ones_like(ginf))
    gx = torch.where(validr[:, None], gx, torch.zeros_like(gx))
    gy = torch.where(validr[:, None], gy, torch.zeros_like(gy))
    return curve.sum_affine(ctx, (AffinePoint(gx[i], gy[i], ginf[i])
                                  for i in range(d1)), (D,) + rest,
                            rns=dev.rns)


# ---------------------------------------------------------------------------
# Horner evaluation
# ---------------------------------------------------------------------------


def eval_poly(pk: BGNPublicKey, pct: PolyCiphertext,
              rng=None) -> Ciphertext:
    """Homomorphic collapse to one ciphertext (EvalPoly, poly.go:58-68).
    The group is abelian, so the reference's Horner loop gives the same
    element as sum_i base^i * C_i: ONE batched MultConst (host powers
    base^i) and a pairwise-add tree of log2(degree) Adds (bit-identical
    for a deterministic key).  Batch shape (1, *poly batch)."""
    d = pct.degree
    if d == 0:
        return pk.encrypt_deterministic([0])
    base = pk.poly_params.poly_base
    ks = [pow(base, i, pk.n) for i in range(d)]
    rest_flat = _flat(pct.ct.batch_shape[1:])
    if rest_flat > 1:   # trailing poly-batch dims share the power ladder
        ks = [k for k in ks for _ in range(rest_flat)]
    cur = pk.mult_const(pct.ct, ks, rng=rng)
    n = d
    while n > 1:
        half = n // 2
        s = pk.add(cur[0:half], cur[half:2 * half], rng=rng)
        if n % 2:
            s = _concat_ct(pk, s, cur[2 * half:n], cur.level2)
        cur, n = s, half + (n % 2)
    return cur
