"""The four kernel functions of bgn_torch/ops/cuda_rns.py (here their plain
PyTorch versions: the wrappers run those for CPU tensors) against the JAX
package, on the shared 64-bit key, batch <= 8, same inputs.

The JAX side runs the XLA path that tests/test_rns.py proves
bit-identical to its Pallas kernels (the CPU default), and the dual
ladder through `dual_ladder_pallas(..., interpret=True)`.  Residues are
compared by their value mod p (host CRT) and their bound: the JAX
package's fp32 alpha sum may read a value as value + p (its audit allows
it), the port's is exact.  Limbs after the exit conversion must be
identical.
"""
import _torch_threads  # noqa: F401  (first: one torch thread per process)
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_carry import port_public_key
from bgn_torch.fieldcore import rns as trn
from bgn_torch.ops import cuda_rns
from bgn_torch.ops import rns_pairing as trp
from bgn_torch.utils import convert as tconvert
from bgn_tpu import hostmath as hm
from bgn_tpu import scheme as jscheme
from bgn_tpu.fieldcore import rns as jrn
from bgn_tpu.ops import pallas_rns
from bgn_tpu.ops import rns_pairing as jrp
from bgn_tpu.utils import convert as jconvert


@pytest.fixture(scope="module")
def keys(shared_keypair64):
    pk, sk = shared_keypair64
    return pk, sk, port_public_key(pk)


def _crt_val(k, v, b):
    acc, mod = 0, 1
    for i, mi in enumerate(trn._primes_desc()[0:2 * k:2]):
        t = ((int(v[i, b]) - acc) * pow(mod % mi, -1, mi)) % mi
        acc += mod * t
        mod *= mi
    return acc


def _same_value(p, k, got, want, bound):
    """got (torch) and want (jax/numpy) residues [2k, B]: equal mod p,
    got below bound * p."""
    g, w = got.numpy(), np.asarray(want)
    assert g.shape == w.shape
    for b in range(g.shape[1]):
        gv = _crt_val(k, g, b)
        assert gv % p == _crt_val(k, w, b) % p, b
        assert gv < bound * p, b


def _residues(pk, n, seed):
    """n random field elements as RNS-Montgomery residues (bound 3)."""
    rng = random.Random(seed)
    ctx, rns = pk.dev.ctx, pk.dev.rns
    vals = [rng.randrange(pk.p) for _ in range(n)]
    lim = jconvert.affine_from_host(ctx, [(v, v) for v in vals]).x
    return np.asarray(jrn.to_rns_mont(rns, lim).v)


@pytest.mark.parametrize("n", [1, 6])
def test_pow_loop_matches_jax(keys, n):
    """x^(p-2) (the Fermat inversion of _fp2_inv at N = B and of
    normalize_rns at N = 1)."""
    pk, _, tpk = keys
    x = _residues(pk, n, 11 + n)
    bits = np.asarray(pk.dev.ctx.pm2_bits)
    want = jrp._rns_pow(pk.dev.rns, jrn.RVal(jnp.asarray(x), 3),
                        jnp.asarray(bits))
    before = cuda_rns.pow_loop.launches
    got = cuda_rns.pow_loop(tpk.dev.rns, torch.tensor(x), bits)
    assert cuda_rns.pow_loop.launches == before       # CPU: plain version
    _same_value(pk.p, pk.dev.rns.k, got, want.v, 3)
    np.testing.assert_array_equal(
        trn.from_rns_mont(tpk.dev.rns, trn.RVal(got, 3)).numpy()
        .astype(np.uint32),
        np.asarray(jrn.from_rns_mont(pk.dev.rns, want)))


@pytest.mark.parametrize("digits", ["l_bits", "q1_naf"])
def test_fp2_pow_loop_matches_jax(keys, digits):
    """^l of the final exponentiation (plain bits) and z^q1 of the L2
    decrypt (signed NAF digits: negative digits multiply by conj(x))."""
    pk, sk, tpk = keys
    unitary = digits == "q1_naf"
    d = np.asarray(pk.dev.l_bits if not unitary else sk.q1_naf)
    xr, xi = _residues(pk, 6, 21), _residues(pk, 6, 22)
    wr, wi = jrp._fp2_pow_bits(
        pk.dev.rns, (jrn.RVal(jnp.asarray(xr), 9), jrn.RVal(jnp.asarray(xi), 9)),
        jnp.asarray(d), unitary=unitary)
    gr, gi = cuda_rns.fp2_pow_loop(tpk.dev.rns, torch.tensor(xr),
                                   torch.tensor(xi), d)
    _same_value(pk.p, pk.dev.rns.k, gr, wr.v, 9)
    _same_value(pk.p, pk.dev.rns.k, gi, wi.v, 9)


def test_miller_loop_matches_jax(keys):
    """f_{n,A}(phi(B)) over the NAF digits of n, incl. an identity lane
    (zero coordinates: both sides compute the same garbage)."""
    pk, _, tpk = keys
    p = pk.p
    pts_a = [hm.ec_mul(m, pk.P_host, p) for m in (1, 2, 7, 100, 55)] + [None]
    pts_b = [hm.ec_mul(m, pk.Q_host, p) for m in (3, 5, 2, 99, 4, 6)]
    a = jconvert.affine_from_host(pk.dev.ctx, pts_a)
    b = jconvert.affine_from_host(pk.dev.ctx, pts_b)
    (wr, wi), _ = jrp._miller_f_rns(pk.dev.ctx, pk.dev.rns, a, b,
                                    pk.dev.n_naf)
    ta = tconvert.affine_from_host(tpk.dev.ctx, pts_a)
    tb = tconvert.affine_from_host(tpk.dev.ctx, pts_b)
    for tpt, jpt in ((ta, a), (tb, b)):
        for u, v in zip(tpt, jpt):
            np.testing.assert_array_equal(u.numpy().astype(np.uint32),
                                          np.asarray(v))
    (gr, gi), _ = trp._miller_f_rns(tpk.dev.ctx, tpk.dev.rns, ta, tb,
                                    tpk.dev.n_naf)
    _same_value(p, pk.dev.rns.k, gr.v, wr.v, 9)
    _same_value(p, pk.dev.rns.k, gi.v, wi.v, 9)


def test_dual_ladder_matches_jax(keys):
    """P^(+-m) * Q^r against dual_ladder_pallas in interpret mode, incl.
    m = 0, r = 0, m < 0 and the (m, r) = (0, 0) identity lane."""
    pk, _, tpk = keys
    ms = [0, 1, -7, 100, 55, -13, 0, 2]
    rs = [5, 0, 12345, 1, 999999, 424242, 0, pk.n - 1]
    m_digits, m_neg = jscheme._signed_digits(ms, pk.n)
    r_digits, _ = jscheme._signed_digits(rs, pk.n)
    Jm, Jr = m_digits.shape[0], r_digits.shape[0]
    dev = pk.dev
    wsel = jnp.concatenate([dev.p_win_rns[2][:Jm], dev.q_win_rns[2][:Jr]],
                           axis=0)
    dig = jnp.concatenate([m_digits, r_digits], axis=0)
    want = pallas_rns.dual_ladder_pallas(
        dev.rns, wsel, dev.p_win_rns[0].shape[0], Jm, dig,
        jnp.asarray(m_neg), interpret=True)
    got = cuda_rns.dual_ladder(
        tpk.dev.rns, tpk.dev.p_win, tpk.dev.q_win, Jm,
        torch.as_tensor(np.asarray(dig).astype(np.int64)),
        torch.as_tensor(np.asarray(m_neg).astype(np.int64)))
    for g, w, bound in zip(got, want, (27, 27, 6)):
        _same_value(pk.p, dev.rns.k, g, w, bound)
    zero_lane = np.all(np.asarray(want[2]) == 0, axis=0)
    assert list(zero_lane) == [False] * 6 + [True, False]
    np.testing.assert_array_equal(torch.all(got[2] == 0, dim=0).numpy(),
                                  zero_lane)
