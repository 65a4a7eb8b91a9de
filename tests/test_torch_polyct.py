"""The port's polynomial ciphertexts (bgn_torch/polyct.py) on the shared
64-bit key (msg space 1021) carried across from the JAX arrays, on the
CPU: every op on B = 2 polys of degree <= 3 against the port's own scheme
ops composed by hand (limbs bit for bit: the key is deterministic) and
the host convolution / sum / scaling of the plaintext coefficients
(decrypted values exactly).  One mult_poly (L1 x L1 -> L2, d1 = 3,
d2 = 2) and one mult_const_poly (L2, d1 = 5, dp = 3) are held bit for bit
against bgn_tpu.polyct on the same inputs (the JAX ciphertexts hold the
port's limbs, so each JAX kernel compiles once; an L1 mult_const_poly
would add ~23 s of JAX compiles, so the L1 accumulator is held to the
port's MultConst and Add composed by hand).  Also both accumulators
at d1 != d2 and eval_poly at degree 0, 1 and an odd degree.
"""
import _torch_threads  # noqa: F401  (first: one torch thread per process)
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_carry import port_public_key, port_tables
from bgn_torch import config as tconfig
from bgn_torch import encoding as tenc
from bgn_torch import polyct as tpoly
from bgn_torch import scheme as tscheme
from bgn_torch.ops import fp2 as tfp2
from bgn_torch.ops import pairing as tpairing
from bgn_torch.ops import rns_pairing as trp
from bgn_tpu import polyct as jpoly
from bgn_tpu import scheme as jscheme
from bgn_tpu.ops import curve as jcurve


@pytest.fixture(scope="module")
def keys(shared_keypair):
    jpk, jsk, jtables = shared_keypair
    pk = port_public_key(jpk)
    sk = tscheme.BGNSecretKey(jsk.a1_params, jsk.r, jsk.poly_base)
    return jpk, pk, sk, port_tables(jtables)


def _u32(t):
    return t.cpu().numpy().astype(np.uint32)


def _jax_ct(ct):
    """The JAX package's Ciphertext holding the port's limbs."""
    if ct.level2:
        return jscheme.Ciphertext(jnp.asarray(_u32(ct.data)), True)
    return jscheme.Ciphertext(jcurve.AffinePoint(
        *(jnp.asarray(_u32(getattr(ct.data, f))) for f in ("x", "y", "inf"))),
        False)


def _same_jax(ct, jct):
    assert ct.level2 == jct.level2
    if ct.level2:
        np.testing.assert_array_equal(_u32(ct.data), np.asarray(jct.data))
        return
    for f in ("x", "y", "inf"):
        np.testing.assert_array_equal(_u32(getattr(ct.data, f)),
                                      np.asarray(getattr(jct.data, f)))


def _equal(a, b):
    """Bit-for-bit equality of two port ciphertext batches."""
    assert a.level2 == b.level2
    if a.level2:
        return torch.equal(a.data, b.data)
    return all(torch.equal(x, y) for x, y in zip(a.data, b.data))


def _coeffs(pts):
    d = max(p.degree for p in pts)
    return [[(p.coefficients[i] if i < p.degree else 0) for i in range(d)]
            for p in pts]


def _batch(pk, values, seed):
    pts = [tenc.new_poly_plaintext(pk, v) for v in values]
    return pts, tpoly.encrypt_poly_batch(pk, pts, rng=random.Random(seed))


def _decrypted(pk, sk, tables, pct):
    return [d.coefficients for d in
            tpoly.decrypt_poly_batch(sk, pct, pk, tables)]


def _stack(pk, cts, level2):
    """Coefficient ciphertexts [*rest] -> one [len, *rest] batch."""
    out = None
    for ct in cts:
        one = ct.reshape((1,) + ct.batch_shape)
        out = tpoly._concat_ct(pk, out, one, level2)
    return out


@pytest.fixture(scope="module")
def polys(keys):
    """a: 7.0 and 5.0 (degree 3, [1, -1, 1] and [-1, -1, 1]); b: 3.0 and
    4.0 (degree 2); both (degree, B = 2) batches of the same key."""
    _, pk, _, _ = keys
    pa, a = _batch(pk, (7.0, 5.0), 1)
    pb, b = _batch(pk, (3.0, 4.0), 2)
    return pa, a, pb, b


def test_encrypt_decrypt_batch(keys, polys):
    _, pk, sk, tables = keys
    pa, a, _, _ = polys
    assert (a.degree, a.scale_factor, a.ct.batch_shape, a.level2) == \
        (3, 0, (3, 2), False)
    flat = [c for col in zip(*_coeffs(pa)) for c in col]
    by_hand = pk.encrypt(flat, rng=random.Random(1)).reshape((3, 2))
    assert _equal(a.ct, by_hand)
    got = tpoly.decrypt_poly_batch(sk, a, pk, tables)
    assert [g.coefficients for g in got] == _coeffs(pa)
    assert [g.poly_eval() for g in got] == [7.0, 5.0]
    one = tpoly.encrypt_poly(pk, tenc.new_poly_plaintext(pk, 100.1),
                             rng=random.Random(3))
    dec = tpoly.decrypt_poly(sk, one, pk, tables)
    assert (dec.degree, dec.scale_factor) == (13, 8)
    assert f"{dec.poly_eval():.1f}" == "100.1"
    assert one.copy().ct is one.ct
    with pytest.raises(ValueError, match="uniform scale_factor"):
        tpoly.encrypt_poly_batch(pk, [tenc.new_poly_plaintext(pk, 7.0),
                                      tenc.new_poly_plaintext(pk, 0.5)])
    with pytest.raises(ValueError, match="empty"):
        tpoly.encrypt_poly_batch(pk, [])


def test_mult_poly_matches_jax_and_by_hand(keys, polys):
    jpk, pk, sk, tables = keys
    pa, a, pb, b = polys
    out = tpoly.mult_poly(pk, a, b)
    assert (out.degree, out.scale_factor, out.level2) == (5, 0, True)
    jout = jpoly.mult_poly(jpk, jpoly.PolyCiphertext(_jax_ct(a.ct), 3, 0),
                           jpoly.PolyCiphertext(_jax_ct(b.ct), 2, 0))
    assert (jout.degree, jout.scale_factor) == (5, 0)
    _same_jax(out.ct, jout.ct)
    # the L2 accumulator by hand: one Mult of every pair, then Adds
    prods = pk.mult(a.ct[torch.tensor([0, 0, 1, 1, 2, 2])],
                    b.ct[torch.tensor([0, 1, 0, 1, 0, 1])])
    assert _equal(out.ct, _stack(pk, _fold_by_hand(
        pk, [prods[i] for i in range(6)], 3, 2,
        tscheme.Ciphertext(tfp2.one(pk.dev.ctx, (2,)), True)), True))
    want = [list(np.convolve(x, y)) + [0] for x, y in zip(_coeffs(pa),
                                                          _coeffs(pb))]
    assert _decrypted(pk, sk, tables, out) == want
    vals = [d.poly_eval() for d in
            tpoly.decrypt_poly_batch(sk, out, pk, tables)]
    assert vals == [21.0, 20.0]
    with pytest.raises(ValueError, match="level-1"):
        tpoly.mult_poly(pk, out, a)


def _fold_by_hand(pk, prods, d1, dp, empty):
    """Output j = the sum (Add) of prods[i * dp + k] over i + k = j."""
    coeffs = []
    for j in range(d1 + dp):
        terms = [prods[i * dp + (j - i)] for i in range(d1)
                 if 0 <= j - i < dp]
        acc = terms[0] if terms else empty
        for t in terms[1:]:
            acc = pk.add(acc, t)
        coeffs.append(acc)
    return coeffs


def test_mult_const_poly_l1_by_hand(keys, polys):
    """5.0 encodes unbalanced as [2, 1, 0] (degree 3, the reference's
    zero top digit): the L1 accumulator at d1 = 2, dp = 3, a zero product
    among its terms, against MultConst and Add composed by hand (each
    held to the JAX package in test_torch_scheme_l1.py); -5.0 is the same
    followed by NegPoly."""
    _, pk, sk, tables = keys
    _, _, pb, b = polys
    digits = tenc.new_unbalanced_plaintext(pk, 5.0).coefficients
    assert digits == [2, 1, 0]
    out = tpoly.mult_const_poly(pk, b, 5.0)
    assert (out.degree, out.scale_factor, out.level2) == (5, 0, False)
    prods = [pk.mult_const(b.ct[i], c) for i in range(2) for c in digits]
    assert _equal(out.ct, _stack(pk, _fold_by_hand(
        pk, prods, 2, 3, pk.encrypt_zero(2)), False))
    want = [list(np.convolve(x, digits)) + [0] for x in _coeffs(pb)]
    assert _decrypted(pk, sk, tables, out) == want
    neg = tpoly.mult_const_poly(pk, b, -5.0)
    assert _equal(neg.ct, tpoly.neg_poly(pk, out).ct)
    assert [d.poly_eval() for d in
            tpoly.decrypt_poly_batch(sk, neg, pk, tables)] == [-15.0, -20.0]


def test_mult_const_poly_l2_matches_jax_and_by_hand(keys, polys):
    """At level 2 the products are GT powers and the accumulator the GT
    fold (d1 = 5, dp = 3: 4.0 is [1, 1, 0]); bit for bit against
    bgn_tpu.polyct.mult_const_poly on the same L2 input."""
    jpk, pk, sk, tables = keys
    _, a, _, b = polys
    prod = tpoly.mult_poly(pk, a, b)
    digits = tenc.new_unbalanced_plaintext(pk, 4.0).coefficients
    out = tpoly.mult_const_poly(pk, prod, 4.0)
    assert (out.degree, out.level2) == (8, True)
    jout = jpoly.mult_const_poly(
        jpk, jpoly.PolyCiphertext(_jax_ct(prod.ct), 5, 0), 4.0)
    assert (jout.degree, jout.scale_factor) == (8, 0)
    _same_jax(out.ct, jout.ct)
    prods = [pk.mult_const(prod.ct[i], c) for i in range(5) for c in digits]
    assert _equal(out.ct, _stack(pk, _fold_by_hand(
        pk, prods, 5, 3, tscheme.Ciphertext(tfp2.one(pk.dev.ctx, (2,)),
                                            True)), True))
    assert [d.poly_eval() for d in
            tpoly.decrypt_poly_batch(sk, out, pk, tables)] == [84.0, 80.0]


def test_add_sub_neg(keys, polys):
    _, pk, sk, tables = keys
    pa, a, pb, b = polys
    s = tpoly.add_poly(pk, a, b)
    by_hand = tpoly._concat_ct(pk, pk.add(a.ct[:2], b.ct), a.ct[2:], False)
    assert (s.degree, s.scale_factor) == (3, 0) and _equal(s.ct, by_hand)
    assert _equal(tpoly.add_poly(pk, b, a).ct, by_hand)
    n = tpoly.neg_poly(pk, b)
    assert _equal(n.ct, pk.neg(b.ct))
    d = tpoly.sub_poly(pk, a, b)
    assert _equal(d.ct, tpoly.add_poly(pk, a, n).ct)
    ca, cb = _coeffs(pa), _coeffs(pb)
    assert _decrypted(pk, sk, tables, s) == \
        [[x + y for x, y in zip(u, v + [0])] for u, v in zip(ca, cb)]
    assert _decrypted(pk, sk, tables, d) == \
        [[x - y for x, y in zip(u, v + [0])] for u, v in zip(ca, cb)]
    assert [p.poly_eval() for p in
            tpoly.decrypt_poly_batch(sk, d, pk, tables)] == [4.0, 1.0]


def test_add_aligns_scales_and_levels(keys, polys):
    """A scale-8 poly (0.5) and a scale-0 poly (7.0): the scale-0 one is
    scaled by 3^8 through mult_const_poly; an L2 poly plus an L1 poly
    promotes the L1 one through make_poly_l2 (a fresh E(1.0))."""
    _, pk, sk, tables = keys
    pa, a, pb, b = polys
    _, half = _batch(pk, (0.5, 0.5), 4)
    mixed = tpoly.add_poly(pk, half, a)
    assert mixed.scale_factor == 8 and not mixed.level2
    want = [float(tenc.new_poly_plaintext(pk, 0.5).poly_eval_fraction() + v)
            for v in (7, 5)]
    assert [p.poly_eval() for p in
            tpoly.decrypt_poly_batch(sk, mixed, pk, tables)] == want
    l2 = tpoly.add_poly(pk, tpoly.mult_poly(pk, a, b), a)
    assert l2.level2 and l2.degree == 5
    assert [p.poly_eval() for p in
            tpoly.decrypt_poly_batch(sk, l2, pk, tables)] == [28.0, 25.0]
    up = tpoly.make_poly_l2(pk, b)
    assert (up.degree, up.level2) == (3, True)
    assert _decrypted(pk, sk, tables, up) == [c + [0] for c in _coeffs(pb)]


@pytest.mark.parametrize("values,degree", [((1.0, 1.0), 1),
                                           ((7.0, 5.0), 3),
                                           ((100.0, 91.0), 5)])
def test_eval_poly(keys, values, degree):
    """Degree 1 and the odd degrees 3 and 5, against sum_i 3^i C_i
    composed by hand from MultConst and Add."""
    _, pk, sk, tables = keys
    pts, pct = _batch(pk, values, 5)
    assert pct.degree == degree
    got = tpoly.eval_poly(pk, pct)
    assert got.batch_shape == (1, 2)
    acc = None
    for i in range(degree):
        term = pk.mult_const(pct.ct[i], 3 ** i)
        acc = term if acc is None else pk.add(acc, term)
    assert _equal(got, acc.reshape((1, 2)))
    assert [int(v) for v in sk.decrypt(got, pk, tables).reshape(-1)] == \
        [int(v) for v in values]


def test_eval_poly_degree_zero_and_l2(keys, polys):
    _, pk, sk, tables = keys
    pa, a, pb, b = polys
    empty = tpoly.PolyCiphertext(a.ct[:0], 0, 0)
    zero = tpoly.eval_poly(pk, empty)
    assert _equal(zero, pk.encrypt_deterministic([0]))
    l2 = tpoly.eval_poly(pk, tpoly.mult_poly(pk, a, b))
    assert l2.level2
    assert [int(v) for v in sk.decrypt(l2, pk, tables).reshape(-1)] == \
        [21, 20]


def test_skew_index_and_strings(keys, polys):
    jpk, pk, _, _ = keys
    _, a, _, _ = polys
    for d1, d2 in ((1, 1), (3, 2), (2, 5), (13, 13)):
        kk, valid = tpoly._skew_index(d1, d2, "cpu")
        jkk, jvalid = jpoly._skew_index(d1, d2)
        np.testing.assert_array_equal(kk.numpy(), np.asarray(jkk))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    jct = jpoly.PolyCiphertext(_jax_ct(a.ct), 3, 0)
    assert a.string(pk) == jct.string(jpk)
    prod = tpoly.mult_poly(pk, a, a)
    assert prod.string(pk) == \
        jpoly.PolyCiphertext(_jax_ct(prod.ct), 6, 0).string(jpk)


@pytest.mark.parametrize("mode", [dict(rns_pallas="1"), dict(rns_miller="0")],
                         ids=["step", "limb"])
def test_mult_poly_and_mult_const_poly_in_other_modes(keys, polys, mode,
                                                      monkeypatch):
    """One MultPoly (d1 = 3, d2 = 2) and one L1 MultConstPoly (by 5.0) in
    step mode (the step kernels' plain versions) and in limb mode (the
    limb pairing and the limb ladders), limbs equal to the default mode's;
    monkeypatch restores the modes."""
    _, pk, _, _ = keys
    _, a, _, b = polys
    want = (tpoly.mult_poly(pk, a, b), tpoly.mult_const_poly(pk, b, 5.0))
    monkeypatch.setattr(trp, "_PALLAS_MODE", trp._PALLAS_MODE)
    monkeypatch.setattr(tpairing, "_RNS_MODE", tpairing._RNS_MODE)
    tconfig.BGNParams(**mode).apply_kernel_modes()
    got = (tpoly.mult_poly(pk, a, b), tpoly.mult_const_poly(pk, b, 5.0))
    for g, w in zip(got, want):
        assert (g.degree, g.scale_factor, g.level2) == \
            (w.degree, w.scale_factor, w.level2)
        assert _equal(g.ct, w.ct)
