"""The port's RNS field (bgn_torch/fieldcore/rns.py) against the JAX
package's (bgn_tpu/fieldcore/rns.py), exactly.

Constants must be equal.  Residues are compared by the value they stand
for mod p (host CRT) plus a check of their bound: the JAX package sums
the narrow-path alpha in fp32 in an order-dependent way (a value may be
read as value + p), the port sums it exactly.  Limbs are compared with
array_equal.  Sizes: p of 80 and 515 bits (narrow path, k <= 64) and 800
bits (wide path, k > 64).
"""
import _torch_threads  # noqa: F401  (first: one torch thread per process)
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bgn_tpu.fieldcore import limbs as jlb
from bgn_tpu.fieldcore import rns as jrn
from bgn_torch.fieldcore import limbs as tlb
from bgn_torch.fieldcore import rns as trn

BITS = [80, 515, 800]
FIELDS = ("m", "recip", "kp", "qc_a", "w1", "p_mod_b", "ainv_b",
          "crt_inv_b", "w2", "b_mod_a", "crt_inv_a", "w_alpha_a", "one_rns",
          "c_in", "c_out", "pow2_8", "crt_rows", "a_rows", "p_limbs")


def _rand_prime(bits, rng):
    while True:
        c = rng.getrandbits(bits) | (1 << (bits - 1)) | 1
        if all(pow(a, c - 1, c) == 1 for a in (2, 3, 5, 7, 11, 13, 17, 19)):
            return c


def _crt_val(k, v, b):
    """Exact value from base-A residues (v is [2k, B] numpy)."""
    acc, mod = 0, 1
    for i, mi in enumerate(trn._primes_desc()[0:2 * k:2]):
        t = ((int(v[i, b]) - acc) * pow(mod % mi, -1, mi)) % mi
        acc += mod * t
        mod *= mi
    return acc


def _setup(bits):
    rng = random.Random(bits)
    p = _rand_prime(bits, rng)
    B = 12
    xs = [rng.randrange(p) for _ in range(B)]
    ys = [rng.randrange(p) for _ in range(B)]
    xs[:3] = [0, 1, p - 1]
    ys[:3] = [0, p - 1, p - 1]
    return p, xs, ys, jrn.make_rns_ctx(p), trn.make_rns_ctx(p, device="cpu")


def _assert_same_value(p, k, got, want, bound):
    g, w = got.v.numpy(), np.asarray(want.v)
    assert got.bound == want.bound == bound
    for b in range(g.shape[1]):
        gv, wv = _crt_val(k, g, b), _crt_val(k, w, b)
        assert gv % p == wv % p
        assert gv < bound * p


@pytest.mark.parametrize("bits", BITS)
def test_rns_ctx_constants_equal(bits):
    """Every constant array equals the JAX context's (w1, w2 as float32)."""
    rng = random.Random(bits)
    p = _rand_prime(bits, rng)
    jctx = jrn.make_rns_ctx(p)
    tctx = trn.make_rns_ctx(p, device="cpu")
    assert (tctx.k, tctx.h, tctx.L) == (jctx.k, jctx.h, jctx.L)
    assert (tctx.k > trn._K_NARROW) == (bits == 800)
    for name in FIELDS:
        want = np.asarray(getattr(jctx, name))
        want = want.astype(np.float32 if name in ("w1", "w2") else want.dtype)
        got = getattr(tctx, name).numpy()
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got.astype(want.dtype), want,
                                      err_msg=name)


@pytest.mark.parametrize("bits", BITS)
def test_rns_ops_match_jax(bits):
    """limbs_to_rns, r_mul, rns_to_limbs, to/from_rns_mont: same values."""
    p, xs, ys, jctx, tctx = _setup(bits)
    L, k = jctx.L, jctx.k
    xl = jlb.ints_to_limbs(xs, L)
    yl = jlb.ints_to_limbs(ys, L)

    jx = jrn.limbs_to_rns(jctx, jnp.asarray(xl))
    tx = trn.limbs_to_rns(tctx, torch.as_tensor(xl.astype(np.int64)))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))   # canonical
    jy = jrn.limbs_to_rns(jctx, jnp.asarray(yl))
    ty = trn.limbs_to_rns(tctx, torch.as_tensor(yl.astype(np.int64)))

    jz = jrn.r_mul(jctx, jrn.RVal(jx, 1), jrn.RVal(jy, 1))
    tz = trn.r_mul(tctx, trn.RVal(tx, 1), trn.RVal(ty, 1))
    _assert_same_value(p, k, tz, jz, 3)
    A = 1
    for q in trn._primes_desc()[0:2 * k:2]:
        A *= q
    for b in range(len(xs)):
        assert _crt_val(k, tz.v.numpy(), b) % p == \
            xs[b] * ys[b] * pow(A, -1, p) % p

    # exit conversion: canonical limbs, equal to the JAX package's
    np.testing.assert_array_equal(
        trn.rns_to_limbs(tctx, tz).numpy().astype(np.uint32),
        np.asarray(jrn.rns_to_limbs(jctx, jz)))

    # Montgomery-domain entry/exit round trip
    jm = jrn.to_rns_mont(jctx, jnp.asarray(xl))
    tm = trn.to_rns_mont(tctx, torch.as_tensor(xl.astype(np.int64)))
    _assert_same_value(p, k, tm, jm, 3)
    back = trn.from_rns_mont(tctx, tm)
    np.testing.assert_array_equal(back.numpy().astype(np.uint32),
                                  np.asarray(jrn.from_rns_mont(jctx, jm)))
    assert tlb.limbs_to_ints(back) == xs


@pytest.mark.parametrize("bits", BITS)
def test_rns_add_sub_many_match_jax(bits):
    """r_add, r_sub (bound growth), r_mul_many and r_one agree in value."""
    p, xs, ys, jctx, tctx = _setup(bits)
    L, k = jctx.L, jctx.k
    xl, yl = jlb.ints_to_limbs(xs, L), jlb.ints_to_limbs(ys, L)
    jx = jrn.RVal(jrn.limbs_to_rns(jctx, jnp.asarray(xl)), 1)
    jy = jrn.RVal(jrn.limbs_to_rns(jctx, jnp.asarray(yl)), 1)
    tx = trn.RVal(trn.limbs_to_rns(tctx, torch.as_tensor(xl.astype(np.int64))), 1)
    ty = trn.RVal(trn.limbs_to_rns(tctx, torch.as_tensor(yl.astype(np.int64))), 1)
    js = jrn.r_sub(jctx, jrn.r_add(jctx, jx, jy), jrn.r_add(jctx, jy, jy))
    ts = trn.r_sub(tctx, trn.r_add(tctx, tx, ty), trn.r_add(tctx, ty, ty))
    _assert_same_value(p, k, ts, js, 4)
    jm = jrn.r_mul_many(jctx, [(js, jx), (jy, js), (jrn.r_one(jctx, (len(xs),)), jy)])
    tm = trn.r_mul_many(tctx, [(ts, tx), (ty, ts), (trn.r_one(tctx, len(xs)), ty)])
    for u, v in zip(tm, jm):
        _assert_same_value(p, k, u, v, 3)
