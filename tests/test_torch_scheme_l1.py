"""The port's level-1 scheme ops (bgn_torch/scheme.py) against the JAX
package and the host oracle, exactly, on the shared 64-bit key (msg
space 1021) carried across from the JAX arrays: EncryptDeterministic,
encrypt_zero, Add / Sub / Neg of L1 ciphertexts (incl. the identity and
both completeness branches, a + a and a + (-a)), MultConst at both
levels, MakeL2 and the L1 decrypts.  Limbs must equal the JAX package's
and points hostmath's; decrypted values must equal hostmath's golden
decrypt.  Inputs of the JAX ops after the first are the port's limbs, so
that each JAX kernel compiles once (MakeL2 is held to the host pairing
only: test_torch_scheme.py holds the same pairing against the JAX
package's Mult).  Everything runs on the CPU.
"""
import _torch_threads  # noqa: F401  (first: one torch thread per process)
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_carry import port_public_key, port_tables
from bgn_torch import scheme as tscheme
from bgn_torch.utils import convert as tconvert
from bgn_tpu import hostmath as hm
from bgn_tpu import scheme as jscheme
from bgn_tpu.ops import curve as jcurve


@pytest.fixture(scope="module")
def keys(shared_keypair):
    """The JAX key and tables, the port's built from their arrays (the
    secret key from the same q1 and R), and the host oracle's key."""
    jpk, jsk, jtables = shared_keypair
    pk = port_public_key(jpk)
    sk = tscheme.BGNSecretKey(jsk.a1_params, jsk.r, jsk.poly_base)
    gk = hm.GoldenKey(params=jsk.a1_params, P=jpk.P_host, Q=jpk.Q_host,
                      R=jsk.r, msg_space=jpk.msg_space)
    return jpk, jsk, jtables, pk, sk, port_tables(jtables), gk


def _u32(t):
    return t.cpu().numpy().astype(np.uint32)


def _same_l1(ct, jct):
    assert not ct.level2 and not jct.level2
    for f in ("x", "y", "inf"):
        np.testing.assert_array_equal(_u32(getattr(ct.data, f)),
                                      np.asarray(getattr(jct.data, f)))


def _same_l2(ct, jct):
    assert ct.level2 and jct.level2
    np.testing.assert_array_equal(_u32(ct.data), np.asarray(jct.data))


def _jax_ct(ct):
    """The JAX package's Ciphertext holding the port's limbs."""
    if ct.level2:
        return jscheme.Ciphertext(jnp.asarray(_u32(ct.data)), True)
    return jscheme.Ciphertext(jcurve.AffinePoint(
        *(jnp.asarray(_u32(getattr(ct.data, f))) for f in ("x", "y", "inf"))),
        False)


def _host_l1(pk, ct):
    return tconvert.affine_to_host(pk.dev.ctx, ct.data)


def _hmul(gk, m):
    """m * P on the host (None: the identity)."""
    p = gk.params.p
    pt = hm.ec_mul(abs(m), gk.P, p)
    return hm.ec_neg(pt, p) if m < 0 else pt


MS = [0, 1, 7, -5, 30, -500, 2, 13]
KS = [3, 0, -7, 5, 30, 500, -2, 11]


def test_encrypt_deterministic_and_zero_match_jax(keys):
    """C = P^m for m = 0, +-m, and E_det(0) = O."""
    jpk, _, _, pk, _, _, gk = keys
    a, ja = pk.encrypt_deterministic(MS), jpk.encrypt_deterministic(MS)
    _same_l1(a, ja)
    assert _host_l1(pk, a) == [_hmul(gk, m) for m in MS]
    z = pk.encrypt_zero(batch=3)
    _same_l1(z, jpk.encrypt_zero(batch=3))
    assert list(z.data.inf.numpy()) == [1, 1, 1]


def test_add_sub_neg_match_jax(keys):
    """L1 Add, Sub and Neg: identity lanes (m = 0), a + a (the doubling
    branch) and a + (-a) (the opposite branch, result O)."""
    jpk, _, _, pk, _, _, gk = keys
    p = gk.params.p
    a = pk.encrypt_deterministic(MS)
    b = pk.encrypt_with_randomness(KS, [5, 6, 0, 9, 1, 2, 3, 4])
    ja, jb = _jax_ct(a), _jax_ct(b)
    ha, hb = _host_l1(pk, a), _host_l1(pk, b)
    for op, jop, host in ((pk.add, jpk.add, hm.ec_add),
                          (pk.sub, jpk.sub,
                           lambda u, v, p: hm.ec_add(u, hm.ec_neg(v, p), p))):
        got = op(a, b, rng=None)
        _same_l1(got, jop(ja, jb))
        assert _host_l1(pk, got) == [host(u, v, p) for u, v in zip(ha, hb)]
    twice = pk.add(a, a)
    _same_l1(twice, jpk.add(ja, ja))
    assert _host_l1(pk, twice) == [_hmul(gk, 2 * m) for m in MS]
    n = pk.neg(a)
    _same_l1(n, jpk.neg(ja))
    assert _host_l1(pk, n) == [_hmul(gk, -m) for m in MS]
    opp = pk.add(a, n)
    assert list(opp.data.inf.numpy()) == [1] * len(MS)


def test_mult_const_matches_jax(keys):
    """C^k at level 1 (scalar and per-element k, incl. 0, negatives and
    identity-base lanes) and at level 2 (e(C, P)^k)."""
    jpk, _, _, pk, _, _, gk = keys
    a = pk.encrypt_deterministic(MS)
    ja = _jax_ct(a)
    for ks in (5, [2, 0, -3, 1, 4, -1, 0, 2]):
        got = pk.mult_const(a, ks)
        _same_l1(got, jpk.mult_const(ja, ks))
        kl = [ks] * len(MS) if isinstance(ks, int) else ks
        assert _host_l1(pk, got) == [_hmul(gk, m * k) for m, k in zip(MS, kl)]
    l2 = pk.make_l2(a)
    jl2 = _jax_ct(l2)
    assert tconvert.fp2_to_host(pk.dev.ctx, l2.data) == \
        [hm.tate_pairing(_hmul(gk, m), gk.P, gk.params) for m in MS]
    assert pk.make_l2(l2) is l2
    gt = gk.gt_base()
    for k in (4, -2):
        got = pk.mult_const(l2, k)
        _same_l2(got, jpk.mult_const(jl2, k))
        assert tconvert.fp2_to_host(pk.dev.ctx, got.data) == \
            [hm.fp2_pow(gt, (m * k) % gk.params.n, gk.params.p) for m in MS]


def test_decrypt_l1_matches_hostmath(keys):
    """decrypt, decrypt_failsafe and decrypt_with_status of L1
    ciphertexts against the host oracle: negatives, 0, the largest
    reachable value and an out-of-range one; and the values of the ops
    above.  (test_torch_l1.py holds the ladder and the giant-step scan
    against the JAX package.)"""
    _, _, _, pk, sk, tables, gk = keys
    top = tables.bound * tables.bound + tables.bound + 2
    ms = [3, -7, 0, top, top + 50, -top, 1, 0]
    ct = pk.encrypt_with_randomness(ms, [9, 1, 4, 0, 6, 2, 8, 0])
    vals, ok = sk.decrypt_with_status(ct, pk, tables)
    host = [hm.golden_decrypt_l1(gk, c) for c in _host_l1(pk, ct)]
    assert host == [3, -7, 0, top, None, -top, 1, 0]
    assert list(ok) == [h is not None for h in host]
    assert [int(v) for v, o in zip(vals, ok) if o] == \
        [h for h in host if h is not None]
    assert list(sk.decrypt_failsafe(ct, pk, tables)) == \
        [0 if h is None else h for h in host]
    with pytest.raises(ValueError, match="out of bounds"):
        sk.decrypt(ct, pk, tables)
    a = pk.encrypt_deterministic(MS)
    b = pk.encrypt_deterministic(KS)
    assert list(sk.decrypt(pk.add(a, b), pk, tables)) == \
        [m + k for m, k in zip(MS, KS)]
    assert list(sk.decrypt(pk.sub(a, b), pk, tables)) == \
        [m - k for m, k in zip(MS, KS)]
    assert list(sk.decrypt(pk.neg(a), pk, tables)) == [-m for m in MS]
    assert list(sk.decrypt(pk.mult_const(a, [2, 0, -3, 1, 4, -1, 0, 2]),
                           pk, tables)) == [0, 0, -21, -5, 120, 500, 0, 26]

