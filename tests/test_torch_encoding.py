"""The port's plaintext encodings (bgn_torch/encoding.py) against the JAX
package's (bgn_tpu/encoding.py, pure Python) on the same inputs: the
degree tables, both encodings, `rationalize`, `_degree`, the float
encoders and `poly_eval`, over seeded values and the reference's own
(poly_test.go: 100.1, 7.0, 2.5, integers; the negative-balanced error).
Also the port's keygen and key carried from JAX fill the same tables.
No kernel and no JAX computation: a few seconds.
"""
import _torch_threads  # noqa: F401  (first: one torch thread per process)
import random
from types import SimpleNamespace

import pytest

from bgn_torch import encoding as tenc
from bgn_torch import scheme as tscheme
from bgn_tpu import encoding as jenc
from bgn_tpu.scheme import PolyEncodingParams as JParams

REFERENCE_VALUES = (100.1, 7.0, 2.5, 1.0, 0.5, 0.0, 3.3333, 42.0, 729.0,
                    1021.75, 0.0001)


def _keys(base=3, scale=3, prec=0.0001):
    """A stand-in key of each package holding only what encoding reads."""
    jpk = SimpleNamespace(poly_params=JParams(base, scale, prec),
                          _encoding_tables=None)
    tpk = SimpleNamespace(poly_params=tscheme.PolyEncodingParams(
        base, scale, prec), _encoding_tables=None)
    jenc.compute_encoding_table(jpk)
    tenc.compute_encoding_table(tpk)
    return jpk, tpk


def _same(tp, jp):
    assert (tp.coefficients, tp.degree, tp.scale_factor) == \
        (jp.coefficients, jp.degree, jp.scale_factor)
    assert tp.poly_eval_fraction() == jp.poly_eval_fraction()
    assert tp.poly_eval() == jp.poly_eval()
    assert str(tp) == str(jp)


@pytest.mark.parametrize("base", [2, 3, 5])
def test_tables_match(base):
    jpk, tpk = _keys(base)
    assert tenc.DEGREE_BOUND == jenc.DEGREE_BOUND == 128
    assert tpk._encoding_tables.degree_table == \
        jpk._encoding_tables.degree_table
    assert tpk._encoding_tables.degree_sum_table == \
        jpk._encoding_tables.degree_sum_table


@pytest.mark.parametrize("base", [2, 3])
def test_integer_encodings_match(base):
    jpk, tpk = _keys(base)
    jt, tt = jpk._encoding_tables, tpk._encoding_tables
    rng = random.Random(base)
    targets = list(range(0, 200)) + [rng.randrange(1, 10 ** 12)
                                     for _ in range(300)]
    for t in targets:
        assert tenc.balanced_encode(tt, t, base) == \
            jenc.balanced_encode(jt, t, base), t
        assert tenc.balanced_encode(tt, -t, base) == \
            jenc.balanced_encode(jt, -t, base), -t
        assert tenc.unbalanced_encode(tt, t, base) == \
            jenc.unbalanced_encode(jt, t, base), t
        for balanced in (True, False):
            assert tenc._degree(tt, t, 127, balanced) == \
                jenc._degree(jt, t, 127, balanced)
    with pytest.raises(ValueError):
        tenc.unbalanced_encode(tt, -5, base)


def test_rationalize_matches():
    rng = random.Random(11)
    xs = [rng.random() * 1000 for _ in range(150)] + [0.1, 0.5, 0.25, 0.75]
    for base, prec in ((3, 0.0001), (2, 0.001), (5, 0.01)):
        for x in xs:
            frac = x - int(x)
            assert tenc.rationalize(frac, base, prec) == \
                jenc.rationalize(frac, base, prec), (x, base)


@pytest.mark.parametrize("base,scale", [(3, 3), (2, 2), (3, 2)])
def test_float_encoders_match(base, scale):
    jpk, tpk = _keys(base, scale)
    rng = random.Random(base * 10 + scale)
    values = list(REFERENCE_VALUES) + [rng.randrange(0, 340) * 1.0
                                       for _ in range(40)] \
        + [round(rng.random() * 200, 3) for _ in range(40)]
    for v in values:
        _same(tenc.new_poly_plaintext(tpk, v), jenc.new_poly_plaintext(jpk, v))
        _same(tenc.new_unbalanced_plaintext(tpk, v),
              jenc.new_unbalanced_plaintext(jpk, v))


def test_reference_values():
    """poly_test.go's values: 100.1 is balanced degree 13 at scale factor
    8 (the B = 512 workload of chip_smoke), 7.0 is [1, -1, 1], and the
    decoded values match at %.1f as the reference compares."""
    _, tpk = _keys()
    p = tenc.new_poly_plaintext(tpk, 100.1)
    assert (p.degree, p.scale_factor) == (13, 8)
    assert f"{p.poly_eval():.1f}" == "100.1"
    seven = tenc.new_poly_plaintext(tpk, 7.0)
    assert (seven.coefficients, seven.degree, seven.scale_factor) == \
        ([1, -1, 1], 3, 0)
    assert f"{tenc.new_unbalanced_plaintext(tpk, 2.5).poly_eval():.1f}" \
        == "2.5"


def test_negative_balanced_raises_in_both():
    jpk, tpk = _keys()
    for pk, enc in ((tpk, tenc), (jpk, jenc)):
        with pytest.raises(ValueError, match="negative encodings"):
            enc.new_poly_plaintext(pk, -3.5)
        with pytest.raises(ValueError, match="Negative encoding"):
            enc.new_unbalanced_plaintext(pk, -3.0)
    bare = SimpleNamespace(poly_params=tscheme.PolyEncodingParams(3, 3, 1e-4),
                           _encoding_tables=None)
    with pytest.raises(RuntimeError, match="not computed"):
        tenc.new_poly_plaintext(bare, 2.0)


def test_plaintext_wrapper():
    _, tpk = _keys()
    pt = tenc.new_plaintext(tpk, 17)
    assert pt.pk is tpk and pt.value == 17
    poly = tenc.PolyPlaintext(tpk, [1, None, 2], 3, 1)
    assert poly.poly_eval_fraction() == jenc.PolyPlaintext(
        _keys()[0], [1, None, 2], 3, 1).poly_eval_fraction()


def test_keys_carry_the_tables(shared_keypair64):
    """The port's keygen and the key carried across from JAX hold the
    JAX key's encoding parameters, tables and Miller digit encoding."""
    from _torch_carry import port_public_key

    jpk, _ = shared_keypair64
    pk, _ = tscheme.keygen(64, 101, rng=random.Random(5), device="cpu")
    carried = port_public_key(jpk)
    for k in (pk, carried):
        assert (k.poly_params.poly_base, k.poly_params.fp_scale_base,
                k.poly_params.fp_precision) == (3, 3, 0.0001)
        assert k._encoding_tables.degree_table == \
            jpk._encoding_tables.degree_table
        assert k._encoding_tables.degree_sum_table == \
            jpk._encoding_tables.degree_sum_table
        assert k.n_digits_kind == jpk.n_digits_kind == "naf"
        _same(tenc.new_poly_plaintext(k, 100.1),
              jenc.new_poly_plaintext(jpk, 100.1))
