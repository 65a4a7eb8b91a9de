"""The port's interop (bgn_torch/interop) against the JAX package's
(bgn_tpu/interop): the gob primitives and the encoding/gob worked example,
the A1 params string and PBC element bytes, the public-key, L1, L2 and
poly-ciphertext gob bytes of one key, the synthesized conformance vectors
and their verification (7 / 7 / 7, the device check on the CPU), the
corruption cases, and the loaders' device rule.  The JAX side runs only
its codecs: its ciphertexts are built from hostmath's points and pairing
values, so no JAX kernel is compiled.  On the CPU.
"""
import _torch_threads  # noqa: F401  (first: one torch thread per process)
import base64
import json
import random

import pytest
import torch

from bgn_torch import encoding as tenc
from bgn_torch import hostmath as thm
from bgn_torch import polyct as tpoly
from bgn_torch import scheme as tscheme
from bgn_torch.interop import conformance as tconf
from bgn_torch.interop import gob as tgob
from bgn_torch.interop import pbc as tpbc
from bgn_torch.interop import reference as tref
from bgn_torch.utils import convert as tconvert
from bgn_tpu import polyct as jpoly
from bgn_tpu import scheme as jscheme
from bgn_tpu.interop import conformance as jconf
from bgn_tpu.interop import gob as jgob
from bgn_tpu.interop import pbc as jpbc
from bgn_tpu.interop import reference as jref
from bgn_tpu.utils import convert as jconvert

MS = [0, 1, 5, 7, 10, 100]
RS = [0, 3, 99, 12345, 7, 2 ** 40]


@pytest.fixture(scope="module")
def keys(shared_keypair64):
    """The JAX key and the port's own keygen key from the same seed, the
    port's decrypt tables, and the golden key."""
    jpk, jsk = shared_keypair64
    pk, sk = tscheme.keygen(64, 101, rng=random.Random(5), device="cpu")
    assert (pk.n, pk.p, pk.P_host, pk.Q_host) == \
        (jpk.n, jpk.p, jpk.P_host, jpk.Q_host)
    tables = pk.setup_decryption(sk, rng=random.Random(2))
    gk = thm.GoldenKey(params=sk.a1_params, P=pk.P_host, Q=pk.Q_host,
                       R=sk.r, msg_space=pk.msg_space)
    return jpk, pk, sk, tables, gk


@pytest.fixture(scope="module")
def vectors():
    return tconf.synthesize_vectors(key_bits=64, msg_space=101)


def _jax_l1(jpk, pts):
    return jscheme.Ciphertext(jconvert.affine_from_host(jpk.dev.ctx, pts),
                              False)


def _equal(a, b):
    if a.level2:
        assert b.level2 and torch.equal(a.data, b.data)
    else:
        assert not b.level2
        for u, v in zip(a.data, b.data):
            assert torch.equal(u, v)


# ---------------------------------------------------------------------------
# gob and PBC codecs, byte for byte against bgn_tpu.interop
# ---------------------------------------------------------------------------


def test_gob_primitives_match_jax():
    ints = [0, 1, -1, 7, 22, -65, 127, 128, 255, 256, 1 << 40, -(1 << 62)]
    for i in ints:
        assert tgob.encode_int(i) == jgob.encode_int(i)
        if i >= 0:
            assert tgob.encode_uint(i) == jgob.encode_uint(i)
    for x in (0.0, 17.0, -2.5, 0.0001, 1e300):
        assert tgob.encode_float(x) == jgob.encode_float(x)
        assert tgob._Reader(tgob.encode_float(x)).float_() == x
    for b in (b"", b"\x00\x01", bytes(range(200))):
        assert tgob.encode_bytes(b) == jgob.encode_bytes(b)
    for s in ("", "type a1\n", "x" * 300):
        assert tgob.encode_string(s) == jgob.encode_string(s)
    for v in (True, False):
        assert tgob.encode_bool(v) == jgob.encode_bool(v)
    for x in (0, 1, -1, 5, -5, 1021, -(1 << 130), (1 << 512) - 3):
        enc = tgob.big_int_gob_encode(x)
        assert enc == jgob.big_int_gob_encode(x)
        assert tgob.big_int_gob_decode(enc) == x
    assert tgob.big_int_gob_encode(0) == b"\x02"


def test_gob_worked_example_and_structs_match_jax():
    """The encoding/gob documentation's struct{X, Y int}{22, 33}, a
    struct whose zero fields are all omitted, and nested structs with
    slices and a big-int payload."""
    point_t = tgob.struct_of("Point", [("X", tgob.INT_T), ("Y", tgob.INT_T)])
    got = tgob.dumps(point_t, {"X": 22, "Y": 33})
    assert got == bytes.fromhex("1fff8103010105506f696e7401ff8200"
                                "01020101580104000101590104000000"
                                "07ff82012c014200")
    assert got == jgob.dumps(
        jgob.struct_of("Point", [("X", jgob.INT_T), ("Y", jgob.INT_T)]),
        {"X": 22, "Y": 33})
    assert tgob.loads(got) == {"X": 22, "Y": 33}

    def schemas(g):
        zero = g.struct_of("W", [("A", g.INT_T), ("B", g.BYTES_T),
                                 ("C", g.BOOL_T)])
        inner = g.struct_of("Inner", [("K", g.INT_T), ("F", g.FLOAT_T)])
        outer = g.struct_of("Outer", [
            ("Bs", g.slice_of(g.BYTES_T)), ("N", g.gob_encoder_type("Int")),
            ("S", g.STRING_T), ("I", inner)])
        return zero, outer

    tz, to = schemas(tgob)
    jz, jo = schemas(jgob)
    empty = {"A": 0, "B": b"", "C": False}
    assert tgob.dumps(tz, empty) == jgob.dumps(jz, empty)
    assert tgob.loads(tgob.dumps(tz, empty)) == empty
    v = {"Bs": [b"\x00\x01", b"", b"xyz"],
         "N": tgob.big_int_gob_encode(-(1 << 200)),
         "S": "type a1\n", "I": {"K": -7, "F": 0.0001}}
    blob = tgob.dumps(to, v)
    assert blob == jgob.dumps(jo, v)
    assert tgob.loads(blob) == v == jgob.loads(blob)


def test_pbc_params_and_element_bytes_match_jax(keys):
    _, pk, _, _, gk = keys
    p = pk.p
    s = tpbc.a1_params_to_str(p, pk.n, pk.l)
    assert s == jpbc.a1_params_to_str(p, pk.n, pk.l)
    assert tpbc.parse_a1_params_str(s) == (p, pk.n, pk.l)
    assert tpbc.parse_l_from_params(s) == pk.l
    for bad in ("type a\np 7\nn 3\nl 4\n", "type a1\np 7\nn 3\nl 4\n",
                "type a1\np 11\nn 3\n"):
        with pytest.raises(ValueError):
            tpbc.parse_a1_params_str(bad)
    assert tpbc.element_length_in_bytes(p) == jpbc.element_length_in_bytes(p)
    C = thm.golden_encrypt(gk, 5, 77)
    z = thm.tate_pairing(C, C, gk.params)
    for P in (C, None, pk.P_host):
        b = tpbc.point_to_bytes(P, p)
        assert b == jpbc.point_to_bytes(P, p)
        assert tpbc.point_from_bytes(b, p) == P
    assert tpbc.gt_to_bytes(z, p) == jpbc.gt_to_bytes(z, p)
    assert tpbc.gt_from_bytes(tpbc.gt_to_bytes(z, p), p) == z
    with pytest.raises(ValueError):
        tpbc.point_from_bytes(b"\x00" * 3, p)
    with pytest.raises(ValueError):
        tpbc.fp_to_bytes(p, p)
    with pytest.raises(ValueError):
        tpbc.fp_from_bytes(p.to_bytes(tpbc.element_length_in_bytes(p),
                                      "big"), p)


# ---------------------------------------------------------------------------
# Wrapper blobs of one key, against bgn_tpu.interop.reference
# ---------------------------------------------------------------------------


def test_public_key_gob_equal_and_round_trip(keys):
    jpk, pk, _, _, _ = keys
    blob = tref.public_key_to_gob(pk)
    assert blob == jref.public_key_to_gob(jpk)
    w = tgob.loads(blob)
    assert tpbc.parse_l_from_params(w["PairingParams"]) == pk.l
    back = tref.public_key_from_gob(blob, device="cpu")
    for attr in ("key_bits", "n", "l", "p", "msg_space", "deterministic",
                 "P_host", "Q_host", "poly_params", "n_digits_kind"):
        assert getattr(back, attr) == getattr(pk, attr), attr
    sa, sb = back.dev.state_dict(), pk.dev.state_dict()
    assert sa.keys() == sb.keys()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert tref.public_key_to_gob(back) == blob
    j = jref.public_key_from_gob(blob)
    assert (j.n, j.P_host, j.Q_host) == (pk.n, pk.P_host, pk.Q_host)
    bad = bytearray(blob)
    bad[-40] ^= 0xFF
    with pytest.raises(ValueError):
        tref.public_key_from_gob(bytes(bad), device="cpu")


def test_ciphertext_gob_equal_and_round_trip(keys):
    """L1 with an identity lane (m = r = 0) and L2 from hostmath's
    pairings: blobs equal to the JAX package's, loaded back equal and
    decrypted right."""
    jpk, pk, sk, tables, gk = keys
    ct = pk.encrypt_with_randomness(MS, RS)
    pts = [thm.golden_encrypt(gk, m, r) for m, r in zip(MS, RS)]
    assert pts[0] is None
    blobs = tref.ciphertext_to_gob(pk, ct)
    assert blobs == jref.ciphertext_to_gob(jpk, _jax_l1(jpk, pts))
    back = tref.ciphertext_from_gob(pk, blobs, device="cpu")
    _equal(back, ct)
    assert list(sk.decrypt(back, pk, tables)) == MS
    assert list(sk.decrypt(tref.ciphertext_from_gob(pk, blobs[3],
                                                    device="cpu"),
                           pk, tables)) == [MS[3]]

    zs = [thm.tate_pairing(C, C, gk.params) for C in pts[1:4]]
    prod = tscheme.Ciphertext(tconvert.fp2_from_host(pk.dev.ctx, zs),
                              True)
    blobs2 = tref.ciphertext_to_gob(pk, prod)
    jprod = jscheme.Ciphertext(jconvert.fp2_from_host(jpk.dev.ctx, zs), True)
    assert blobs2 == jref.ciphertext_to_gob(jpk, jprod)
    back2 = tref.ciphertext_from_gob(pk, blobs2, device="cpu")
    _equal(back2, prod)
    assert list(sk.decrypt(back2, pk, tables)) == [m * m for m in MS[1:4]]
    with pytest.raises(ValueError, match="no data"):
        tref.ciphertext_from_gob(pk, b"", device="cpu")
    with pytest.raises(ValueError, match="mixed"):
        tref.ciphertext_from_gob(pk, blobs[:1] + blobs2[:1], device="cpu")


def test_poly_ciphertext_gob_equal_and_round_trip(keys):
    jpk, pk, sk, tables, gk = keys
    ppt = tenc.new_poly_plaintext(pk, 38.0)
    coeffs = [int(c) for c in ppt.coefficients]
    assert min(coeffs) < 0
    rs = [11 * (i + 1) for i in range(len(coeffs))]
    pct = tpoly.PolyCiphertext(pk.encrypt_with_randomness(coeffs, rs),
                               ppt.degree, ppt.scale_factor)
    # P has order n: P^c = P^(c mod n), negative c included
    pts = [thm.golden_encrypt(gk, c % pk.n, r) for c, r in zip(coeffs, rs)]
    jpct = jpoly.PolyCiphertext(_jax_l1(jpk, pts), ppt.degree,
                                ppt.scale_factor)
    blob = tref.poly_ciphertext_to_gob(pk, pct)
    assert blob == jref.poly_ciphertext_to_gob(jpk, jpct)
    back = tref.poly_ciphertext_from_gob(pk, blob, device="cpu")
    assert (back.degree, back.scale_factor) == (pct.degree,
                                                pct.scale_factor)
    _equal(back.ct, pct.ct)
    dec = tpoly.decrypt_poly(sk, back, pk, tables)
    assert dec.poly_eval() == pytest.approx(38.0)


def test_loaders_need_the_keys_device(keys):
    _, pk, _, _, _ = keys
    blobs = tref.ciphertext_to_gob(pk, pk.encrypt_with_randomness([1], [2]))
    with pytest.raises(ValueError, match="the key lives on"):
        tref.ciphertext_from_gob(pk, blobs, device="meta")
    with pytest.raises(ValueError, match="the key lives on"):
        tref.poly_ciphertext_from_gob(pk, tref.poly_ciphertext_to_gob(
            pk, tpoly.PolyCiphertext(pk.encrypt_with_randomness([1], [2]),
                                     1, 0)), device="meta")
    if not torch.cuda.is_available():     # the default is the card
        with pytest.raises(ValueError, match="the key lives on"):
            tref.ciphertext_from_gob(pk, blobs)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tref.public_key_from_gob(tref.public_key_to_gob(pk))


def test_corrupt_elements_raise_validate_errors(keys):
    _, pk, _, _, gk = keys
    p = pk.p
    C = thm.golden_encrypt(gk, 3, 4)
    off = tpbc.fp_to_bytes(C[0], p) + tpbc.fp_to_bytes((C[1] + 1) % p, p)
    blob = tgob.dumps(tref.CIPHERTEXT_WRAPPER_T, {"CBytes": off, "L2": False})
    with pytest.raises(ValueError, match="not on the curve"):
        tref.ciphertext_from_gob(pk, blob, device="cpu")
    z = thm.tate_pairing(C, C, gk.params)
    bad = tpbc.gt_to_bytes(((z[0] + 1) % p, z[1]), p)
    blob2 = tgob.dumps(tref.CIPHERTEXT_WRAPPER_T, {"CBytes": bad, "L2": True})
    with pytest.raises(ValueError, match="not unitary"):
        tref.ciphertext_from_gob(pk, blob2, device="cpu")


# ---------------------------------------------------------------------------
# Conformance vectors
# ---------------------------------------------------------------------------


def test_synthesized_vectors_equal_jax(vectors):
    want = jconf.synthesize_vectors(key_bits=64, msg_space=101)
    assert vectors.keys() == want.keys()
    for k in want:
        assert vectors[k] == want[k], k
    assert tconf.synthesize_vectors(
        key_bits=64, msg_space=101, rng=random.Random(3)) == \
        jconf.synthesize_vectors(key_bits=64, msg_space=101,
                                 rng=random.Random(3))


def test_verify_vectors_host_and_device(vectors):
    host = tconf.verify_reference_vectors(vectors)
    assert host == {"key": 1, "pairing": 1, "encrypt": 7, "ops": 7}
    assert jconf.verify_reference_vectors(vectors) == host
    dev = tconf.verify_reference_vectors(vectors, device="cpu")
    assert dev == dict(host, device_encrypt=7)
    pk, sk = tref.import_reference_key(vectors, device="cpu")
    assert format(pk.n, "x") == vectors["n"]
    assert (sk.key, sk.r) == (int(vectors["q1"], 16), int(vectors["r"], 16))
    assert tpbc.point_to_bytes(pk.P_host, pk.p).hex() == \
        vectors["p_bytes_hex"]
    assert base64.b64decode(vectors["public_key_gob"]) == \
        tref.public_key_to_gob(pk)


def _corrupt(vec, path, flip_last=True):
    bad = json.loads(json.dumps(vec))
    obj = bad
    for k in path[:-1]:
        obj = obj[k]
    h = obj[path[-1]]
    obj[path[-1]] = (h[:-2] + format(int(h[-2:], 16) ^ 1, "02x")
                     if flip_last else h[:-2] + "00")
    return bad


@pytest.mark.parametrize("path,flip", [
    (("ciphertexts", 2, "bytes_hex"), True),   # tests/test_interop.py:212
    (("gt_gen_bytes_hex",), False),
    (("ops", 2, "bytes_hex"), True),
    (("q_bytes_hex",), True),
])
def test_corruption_raises_conformance_error(vectors, path, flip):
    bad = _corrupt(vectors, path, flip)
    with pytest.raises(tconf.ConformanceError):
        tconf.verify_reference_vectors(bad)
    with pytest.raises(jconf.ConformanceError):
        jconf.verify_reference_vectors(bad)


def test_device_check_raises_on_a_wrong_device_vector(vectors, tmp_path):
    """A device encryption that disagrees raises: nothing catches it."""
    pk, _ = tref.import_reference_key(vectors, device="cpu")
    bad = json.loads(json.dumps(vectors))
    bad["ciphertexts"][1]["r"] = format(int(bad["ciphertexts"][1]["r"], 16)
                                        + 1, "x")
    with pytest.raises(tconf.ConformanceError, match="device ciphertext"):
        tconf._verify_device(bad, pk)
    assert tref.load_reference_vectors(tmp_path / "absent.json") is None
    path = tmp_path / "vectors.json"
    path.write_text(json.dumps(vectors))
    assert tref.load_reference_vectors(path) == vectors
