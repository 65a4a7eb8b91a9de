"""The port's scheme (bgn_torch/scheme.py) against the JAX package and the
host oracle, exactly: keygen and decrypt tables from the same seed, the
key carried across from JAX arrays, Encrypt -> Mult -> DecryptL2 limbs
and values on the shared 64-bit key, and one 512-bit round trip of the
port alone against hostmath (the k = 45 channel layout the H100 kernels
see).  Everything runs on the CPU (device="cpu": the kernel wrappers run
their plain PyTorch versions).
"""
import _torch_threads  # noqa: F401  (first: one torch thread per process)
import random

import numpy as np
import pytest
import torch

from _torch_carry import port_public_key, port_tables
from bgn_torch import scheme as tscheme
from bgn_torch.utils import convert as tconvert
from bgn_tpu import hostmath as hm


def _u32(t):
    return t.cpu().numpy().astype(np.uint32)


@pytest.fixture(scope="module")
def port_key():
    """The port's own key and tables, drawn exactly as conftest's
    shared_keypair draws the JAX ones."""
    rng = random.Random(5)
    pk, sk = tscheme.keygen(64, 1021, rng=rng, device="cpu")
    return pk, sk, pk.setup_decryption(sk, rng=rng)


def test_keygen_matches_jax(port_key, shared_keypair):
    jpk, jsk, jtables = shared_keypair
    pk, sk, tables = port_key
    assert (pk.p, pk.n, pk.l, sk.key, sk.r) == (jpk.p, jpk.n, jpk.l, jsk.key,
                                                 jsk.r)
    assert (pk.P_host, pk.Q_host) == (jpk.P_host, jpk.Q_host)
    d, jd = pk.dev, jpk.dev
    for name in ("p", "r2", "one", "pm2_bits", "pp1d4_bits"):
        np.testing.assert_array_equal(_u32(getattr(d.ctx, name)),
                                      np.asarray(getattr(jd.ctx, name)))
    assert d.ctx.pinv == int(jd.ctx.pinv)
    np.testing.assert_array_equal(_u32(d.pair_qq), np.asarray(jd.pair_qq))
    for f in ("x", "y", "inf"):
        np.testing.assert_array_equal(_u32(getattr(d.P, f)),
                                      np.asarray(getattr(jd.P, f)))
        np.testing.assert_array_equal(_u32(getattr(d.Q, f)),
                                      np.asarray(getattr(jd.Q, f)))
        np.testing.assert_array_equal(_u32(getattr(d.q_tab, f)),
                                      np.asarray(getattr(jd.q_win, f)))
    np.testing.assert_array_equal(d.n_naf.numpy(), np.asarray(jd.n_naf))
    np.testing.assert_array_equal(d.l_bits.numpy(), np.asarray(jd.l_bits))
    np.testing.assert_array_equal(sk.q1_naf, np.asarray(jsk.q1_naf))
    for (tx, ty), jw in ((d.p_win, jd.p_win_rns), (d.q_win, jd.q_win_rns)):
        np.testing.assert_array_equal(tx.numpy(), np.moveaxis(np.asarray(jw[0]), 0, -1))
        np.testing.assert_array_equal(ty.numpy(), np.moveaxis(np.asarray(jw[1]), 0, -1))
    # decrypt tables from the same rng stream
    for t, jt in ((tables.table_g1, jtables.table_g1),
                  (tables.table_gt, jtables.table_gt)):
        for f in ("digests", "values", "keys", "salts"):
            np.testing.assert_array_equal(_u32(getattr(t, f)),
                                          np.asarray(getattr(jt, f)))
    np.testing.assert_array_equal(_u32(tables.gamma_inv_gt),
                                  np.asarray(jtables.gamma_inv_gt))
    assert (tables.bound, tables.bound_t) == (jtables.bound, jtables.bound_t)


def test_carry_across_equals_own_key(port_key, shared_keypair):
    """The key and tables built from the JAX arrays equal the port's."""
    jpk, _, jtables = shared_keypair
    pk, _, tables = port_key
    carried = port_public_key(jpk)
    own, got = pk.dev.state_dict(), carried.dev.state_dict()
    assert own.keys() == got.keys()
    for name in own:
        assert torch.equal(own[name], got[name]), name
    assert (carried.dev.rns.k, carried.dev.rns.h, carried.dev.rns.L) == \
        (pk.dev.rns.k, pk.dev.rns.h, pk.dev.rns.L)
    assert carried.dev.ctx.p_host == pk.dev.ctx.p_host
    assert carried.dev.ctx.pinv == pk.dev.ctx.pinv
    own_t, got_t = tables.state_dict(), port_tables(jtables).state_dict()
    assert own_t.keys() == got_t.keys()
    for name in own_t:
        assert torch.equal(own_t[name], got_t[name]), name


def test_encrypt_mult_decrypt_match_jax(port_key, shared_keypair):
    """Same (m, r) -> same L1 limbs; same pairing limbs; same decrypts;
    all equal to the host oracle.  Lanes include m = 0, r = 0, m < 0 and
    (m, r) = (0, 0), whose ciphertext is the identity."""
    jpk, jsk, jtables = shared_keypair
    pk, sk, tables = port_key
    ms = [0, 1, -7, 30, 5, -13, 0, 2]
    rs = [5, 0, 12345, 1, 999999, 424242, 0, pk.n - 1]
    ks = [3, 9, 5, 2, 7, 4, 6, 11]
    krs = [17, 23, 0, 99, 4242, 7, 1, 5]
    a, ja = pk.encrypt_with_randomness(ms, rs), jpk.encrypt_with_randomness(ms, rs)
    b, jb = pk.encrypt_with_randomness(ks, krs), jpk.encrypt_with_randomness(ks, krs)
    for u, v in ((a, ja), (b, jb)):
        for f in ("x", "y", "inf"):
            np.testing.assert_array_equal(_u32(getattr(u.data, f)),
                                          np.asarray(getattr(v.data, f)))
    gk = hm.GoldenKey(params=sk.a1_params, P=pk.P_host, Q=pk.Q_host,
                      R=sk.r, msg_space=pk.msg_space)
    host_a = [hm.golden_encrypt(gk, m, r) for m, r in zip(ms, rs)]
    host_b = [hm.golden_encrypt(gk, m, r) for m, r in zip(ks, krs)]
    assert tconvert.affine_to_host(pk.dev.ctx, a.data) == host_a
    assert host_a[6] is None

    prod, jprod = pk.mult(a, b), jpk.mult(ja, jb)
    np.testing.assert_array_equal(_u32(prod.data), np.asarray(jprod.data))
    assert tconvert.fp2_to_host(pk.dev.ctx, prod.data) == \
        [hm.tate_pairing(u, v, gk.params) for u, v in zip(host_a, host_b)]

    got = sk.decrypt(prod, pk, tables)
    want = [m * k for m, k in zip(ms, ks)]
    assert list(got) == want
    assert list(sk.decrypt_failsafe(prod, pk, tables)) == want
    assert list(jsk.decrypt(jprod, jpk, jtables)) == want
    assert [hm.golden_decrypt_l2(gk, z) for z in
            tconvert.fp2_to_host(pk.dev.ctx, prod.data)] == want
    assert list(sk.decrypt(a, pk, tables)) == ms        # level 1


def test_512bit_round_trip_against_hostmath():
    """The port alone at the reference's test constants (bgn_test.go:
    512-bit key, msg space 1021), batch 4, on the k = 45 layout."""
    rng = random.Random(512512)
    pk, sk = tscheme.keygen(512, 1021, rng=rng, device="cpu")
    assert (pk.dev.rns.k, pk.dev.ctx.L) == (45, 34)
    tables = pk.setup_decryption(sk, rng=rng)
    ms, rs = [3, 0, -7, 500], [rng.randrange(pk.n) for _ in range(4)]
    ks, krs = [5, 9, 2, 1], [rng.randrange(pk.n) for _ in range(4)]
    a = pk.encrypt_with_randomness(ms, rs)
    b = pk.encrypt_with_randomness(ks, krs)
    gk = hm.GoldenKey(params=sk.a1_params, P=pk.P_host, Q=pk.Q_host,
                      R=sk.r, msg_space=pk.msg_space)
    host_a = [hm.golden_encrypt(gk, m, r) for m, r in zip(ms, rs)]
    host_b = [hm.golden_encrypt(gk, m, r) for m, r in zip(ks, krs)]
    assert tconvert.affine_to_host(pk.dev.ctx, a.data) == host_a
    assert tconvert.affine_to_host(pk.dev.ctx, b.data) == host_b
    prod = pk.mult(a, b)
    z = tconvert.fp2_to_host(pk.dev.ctx, prod.data)
    assert z[1] == hm.tate_pairing(host_a[1], host_b[1], gk.params)
    assert list(sk.decrypt(prod, pk, tables)) == [15, 0, -14, 500]
