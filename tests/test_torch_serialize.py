"""The port's serialization (bgn_torch/serialize.py) against the JAX
package's (bgn_tpu/serialize.py): key JSON, ciphertext and
poly-ciphertext bytes written by each package load in the other with
equal limbs; the port's bytes for a deterministic ciphertext equal the
JAX package's bytes for the same group elements (the JAX ciphertexts are
built from hostmath's points and pairing values, so no JAX kernel is
compiled); public_key_from_parts rebuilds the keygen key tensor for
tensor; and the load-time validation errors.  Both packages store an
identity lane of a level-1 batch as inf = 1 with x = y = 0.  On the CPU.
"""
import _torch_threads  # noqa: F401  (first: one torch thread per process)
import io
import json
import random

import numpy as np
import pytest
import torch

from bgn_torch import encoding as tenc
from bgn_torch import hostmath as thm
from bgn_torch import polyct as tpoly
from bgn_torch import scheme as tscheme
from bgn_torch import serialize as tser
from bgn_tpu import polyct as jpoly
from bgn_tpu import scheme as jscheme
from bgn_tpu import serialize as jser
from bgn_tpu.utils import convert as jconvert

MS = [0, 1, 5, 340, -7, 1020]
RS = [0, 3, 99, 12345, 7, 2 ** 40]


@pytest.fixture(scope="module")
def keys(shared_keypair):
    """The JAX key and the port's own keygen key from the same seed."""
    jpk, jsk, _ = shared_keypair
    pk, sk = tscheme.keygen(64, 1021, rng=random.Random(5), device="cpu")
    gk = thm.GoldenKey(params=sk.a1_params, P=pk.P_host, Q=pk.Q_host,
                       R=sk.r, msg_space=pk.msg_space)
    return jpk, jsk, pk, sk, gk


def _state_equal(a, b):
    sa, sb = a.dev.state_dict(), b.dev.state_dict()
    assert sa.keys() == sb.keys()
    for name in sa:
        assert sa[name].dtype == sb[name].dtype, name
        assert torch.equal(sa[name], sb[name]), name
    for attr in ("k", "h", "L"):
        assert getattr(a.dev.rns, attr) == getattr(b.dev.rns, attr)
    assert a.dev.ctx.p_host == b.dev.ctx.p_host
    assert a.dev.ctx.pinv == b.dev.ctx.pinv
    for attr in ("key_bits", "n", "l", "p", "msg_space", "deterministic",
                 "P_host", "Q_host", "poly_params", "n_digits_kind"):
        assert getattr(a, attr) == getattr(b, attr), attr
    assert a._encoding_tables == b._encoding_tables


def _golden_points(gk):
    p = gk.params.p
    out = []
    for m, r in zip(MS, RS):
        pm = thm.ec_mul(abs(m), gk.P, p)
        if m < 0:
            pm = thm.ec_neg(pm, p)
        out.append(thm.ec_add(pm, thm.ec_mul(r, gk.Q, p), p))
    return out


def _npz(data: bytes) -> dict:
    z = np.load(io.BytesIO(data))
    return {k: z[k] for k in z.files}


def _savez(arrays: dict) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def test_public_key_json_both_ways(keys):
    jpk, _, pk, _, _ = keys
    s = tser.public_key_to_json(pk)
    assert s == jser.public_key_to_json(jpk)
    assert json.loads(s)["n_digits"] == "naf"
    for text in (s, jser.public_key_to_json(jpk)):
        _state_equal(tser.public_key_from_json(text, device="cpu"), pk)
    back = jser.public_key_from_json(s)
    assert (back.n, back.p, back.P_host, back.Q_host, back.n_digits_kind) \
        == (jpk.n, jpk.p, jpk.P_host, jpk.Q_host, jpk.n_digits_kind)
    for name in ("n_naf", "l_bits", "pair_qq"):
        np.testing.assert_array_equal(np.asarray(getattr(back.dev, name)),
                                      np.asarray(getattr(jpk.dev, name)))


def test_public_key_from_parts_equals_keygen(keys):
    _, _, pk, _, _ = keys
    parts = dict(key_bits=pk.key_bits, n=pk.n, l=pk.l, p=pk.p,
                 msg_space=pk.msg_space, deterministic=pk.deterministic,
                 poly_params=pk.poly_params, P_host=pk.P_host,
                 Q_host=pk.Q_host, device="cpu")
    _state_equal(tscheme.public_key_from_parts(**parts, n_digits="naf"), pk)
    # no recorded encoding: the chain check mod n alone picks NAF too
    _state_equal(tscheme.public_key_from_parts(**parts, validate=False), pk)
    bits = tscheme.public_key_from_parts(**parts, n_digits="bits")
    assert bits.n_digits_kind == "bits"
    got = bits.dev.n_naf.numpy()                   # plain bits, MSB first
    assert got[0] == 1 and int("".join(map(str, got)), 2) == pk.n
    with pytest.raises(ValueError, match="unknown digit encoding"):
        tscheme.public_key_from_parts(**parts, n_digits="windows")


def test_secret_key_json_both_ways(keys):
    _, jsk, _, sk, _ = keys
    s = tser.secret_key_to_json(sk)
    assert s == jser.secret_key_to_json(jsk)
    back = tser.secret_key_from_json(jser.secret_key_to_json(jsk))
    assert (back.key, back.r, back.poly_base) == (jsk.key, jsk.r,
                                                   jsk.poly_base)
    np.testing.assert_array_equal(back.q1_naf, np.asarray(jsk.q1_naf))
    assert jser.secret_key_from_json(s).r == sk.r


def test_ciphertext_bytes_equal_and_load_across(keys):
    """Level 1 (lane 0 the identity: m = r = 0) and level 2 (pairings)."""
    jpk, _, pk, _, gk = keys
    ct = pk.encrypt_with_randomness(MS, RS)
    pts = _golden_points(gk)
    assert pts[0] is None
    jct = jscheme.Ciphertext(jconvert.affine_from_host(jpk.dev.ctx, pts),
                             False)
    data = tser.ciphertext_to_bytes(pk, ct)
    assert data == jser.ciphertext_to_bytes(jpk, jct)
    z = _npz(data)
    assert (z["x"].dtype, z["inf"].dtype, z["level2"].dtype) == \
        (np.uint32, np.uint32, np.int32)
    assert z["inf"][0] == 1 and not z["x"][:, 0].any() \
        and not z["y"][:, 0].any()
    back = tser.ciphertext_from_bytes(pk, jser.ciphertext_to_bytes(jpk, jct),
                                      device="cpu")
    assert all(torch.equal(u, v) for u, v in zip(back.data, ct.data))
    jback = jser.ciphertext_from_bytes(jpk, data)
    for f in ("x", "y", "inf"):
        np.testing.assert_array_equal(np.asarray(getattr(jback.data, f)),
                                      np.asarray(getattr(jct.data, f)))
    assert ct.string(pk) == jct.string(jpk)

    prod = pk.mult(ct[1:4], ct[3:6])
    vals = [thm.tate_pairing(u, v, gk.params) for u, v in zip(pts[1:4],
                                                              pts[3:6])]
    jprod = jscheme.Ciphertext(jconvert.fp2_from_host(jpk.dev.ctx, vals),
                               True)
    data2 = tser.ciphertext_to_bytes(pk, prod)
    assert data2 == jser.ciphertext_to_bytes(jpk, jprod)
    back2 = tser.ciphertext_from_bytes(pk, data2, device="cpu")
    assert back2.level2 and torch.equal(back2.data, prod.data)
    np.testing.assert_array_equal(
        np.asarray(jser.ciphertext_from_bytes(jpk, data2).data),
        np.asarray(jprod.data))
    assert prod.string(pk) == jprod.string(jpk)


def test_poly_ciphertext_bytes_both_ways(keys):
    jpk, _, pk, _, _ = keys
    pts = [tenc.new_poly_plaintext(pk, v) for v in (100.1, 100.1)]
    pct = tpoly.encrypt_poly_batch(pk, pts, rng=random.Random(8))
    data = tser.poly_ciphertext_to_bytes(pk, pct)
    back = tser.poly_ciphertext_from_bytes(pk, data, device="cpu")
    assert (back.degree, back.scale_factor) == (13, 8)
    assert all(torch.equal(u, v) for u, v in zip(back.ct.data, pct.ct.data))
    jback = jser.poly_ciphertext_from_bytes(jpk, data)
    assert (jback.degree, jback.scale_factor) == (13, 8)
    np.testing.assert_array_equal(np.asarray(jback.ct.data.x),
                                  pct.ct.data.x.numpy().astype(np.uint32))
    jdata = jser.poly_ciphertext_to_bytes(
        jpk, jpoly.PolyCiphertext(jback.ct, 13, 8))
    assert jdata == data
    again = tser.poly_ciphertext_from_bytes(pk, jdata, device="cpu")
    assert all(torch.equal(u, v) for u, v in zip(again.ct.data,
                                                 pct.ct.data))


def test_canonical_element_bytes(keys):
    jpk, _, pk, _, gk = keys
    assert tser.coord_nbytes(pk) == jser.coord_nbytes(jpk) == 12
    for P in (None, gk.P, gk.Q):
        assert tser.point_bytes(pk, P) == jser.point_bytes(jpk, P)
    z = thm.tate_pairing(gk.P, gk.Q, gk.params)
    assert tser.gt_bytes(pk, z) == jser.gt_bytes(jpk, z)


def test_validation_errors(keys):
    """Off-curve point, coordinate >= p, non-unitary and out-of-range GT
    values, wrong format version, empty data, bad key parts; each raises
    in the port as in the JAX package, and validate=False loads."""
    jpk, _, pk, _, _ = keys
    ct = pk.encrypt_with_randomness(MS, RS)
    z = _npz(tser.ciphertext_to_bytes(pk, ct))
    p_limbs = np.array([(pk.p >> (16 * i)) & 0xFFFF
                        for i in range(z["x"].shape[0])], dtype=np.uint32)
    off = dict(z, y=z["y"].copy())
    off["y"][0, 1] ^= 1
    big = dict(z, x=z["x"].copy())
    big["x"][:, 2] = p_limbs
    prod = pk.mult(ct[1:3], ct[2:4])
    z2 = _npz(tser.ciphertext_to_bytes(pk, prod))
    nonunit = dict(z2, re=z2["re"].copy())
    nonunit["re"][0, 0] ^= 1
    big2 = dict(z2, im=z2["im"].copy())
    big2["im"][:, 1] = p_limbs
    for arrays, msg in ((off, "not on the curve"), (big, "coordinate >= p"),
                        (nonunit, "not unitary"),
                        (big2, "GT coordinate >= p")):
        data = _savez(arrays)
        with pytest.raises(ValueError, match=msg):
            tser.ciphertext_from_bytes(pk, data, device="cpu")
        with pytest.raises(ValueError, match=msg):
            jser.ciphertext_from_bytes(jpk, data)
    loose = tser.ciphertext_from_bytes(pk, _savez(off), validate=False,
                                       device="cpu")
    assert loose.batch_shape == ct.batch_shape
    with pytest.raises(ValueError, match="no data"):
        tser.ciphertext_from_bytes(pk, b"", device="cpu")
    with pytest.raises(ValueError, match="no data"):
        tser.poly_ciphertext_from_bytes(pk, b"", device="cpu")
    for to_json, from_json, key in (
            (tser.public_key_to_json,
             lambda s: tser.public_key_from_json(s, device="cpu"), pk),
            (tser.secret_key_to_json, tser.secret_key_from_json,
             keys[3])):
        d = json.loads(to_json(key))
        d["version"] = 2
        with pytest.raises(ValueError, match="unsupported key format"):
            from_json(json.dumps(d))
    ok = (pk.n, pk.l, pk.p, pk.P_host, pk.Q_host)
    tscheme.validate_public_key_parts(*ok)
    x, y = pk.P_host
    for bad, msg in (((pk.n, pk.l + 4, pk.p, pk.P_host, pk.Q_host),
                      "p != l"),
                     ((pk.n, pk.l, pk.p, (x, (y + 1) % pk.p), pk.Q_host),
                      "not on the curve"),
                     ((pk.n, pk.l, pk.p, (x + pk.p, y), pk.Q_host),
                      "coordinate >= p"),
                     ((pk.n, pk.l, pk.p, pk.P_host, None), "identity")):
        with pytest.raises(ValueError, match=msg):
            tscheme.validate_public_key_parts(*bad)
        with pytest.raises(ValueError, match=msg):
            jscheme.validate_public_key_parts(*bad)


def test_loaders_default_to_the_card(keys):
    """Loaders run on the card unless asked otherwise; a ciphertext is
    loaded on its key's device only."""
    _, _, pk, _, _ = keys
    data = tser.ciphertext_to_bytes(pk, pk.encrypt_deterministic([3]))
    with pytest.raises(ValueError, match="the key lives on cpu"):
        tser.ciphertext_from_bytes(pk, data)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tser.public_key_from_json(tser.public_key_to_json(pk))
