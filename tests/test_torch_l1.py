"""The level-1 path's kernels and field pieces in bgn_torch against the JAX
package, on the shared 64-bit key, same inputs, exactly.

The three new kernel functions of bgn_torch/ops/cuda_rns.py run their
plain PyTorch versions here (CPU tensors); the JAX side runs its Pallas
kernels in interpret mode.  Residues are compared by their value mod p
(host CRT) and their bound, as in test_torch_kernels.py: the JAX
package's fp32 alpha sum may read a value as value + p.  Limbs after the
exit conversion, identity lanes and decrypted values must be identical.
"""
import _torch_threads  # noqa: F401  (first: one torch thread per process)
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_carry import port_public_key, port_tables
from bgn_torch.fieldcore import limbs as tlb
from bgn_torch.fieldcore import montgomery as tmg
from bgn_torch.fieldcore import rns as trn
from bgn_torch.ops import bsgs as tbsgs
from bgn_torch.ops import cuda_rns
from bgn_torch.ops import curve as tcurve
from bgn_torch.ops import rns_pairing as trp
from bgn_torch.utils import convert as tconvert
from bgn_tpu import hostmath as hm
from bgn_tpu.fieldcore import limbs as jlb
from bgn_tpu.fieldcore import montgomery as jmg
from bgn_tpu.fieldcore import rns as jrn
from bgn_tpu.ops import bsgs as jbsgs
from bgn_tpu.ops import pallas_rns
from bgn_tpu.ops import rns_pairing as jrp
from bgn_tpu.utils import convert as jconvert


@pytest.fixture(scope="module")
def keys(shared_keypair):
    pk, sk, tables = shared_keypair
    return pk, sk, tables, port_public_key(pk), port_tables(tables)


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


def _u32(t):
    return t.cpu().numpy().astype(np.uint32)


def _points(pk, ms):
    """Host points m*P (None: the identity) as JAX and port affine limbs."""
    pts = [None if m is None else hm.ec_mul(m, pk.P_host, pk.p) for m in ms]
    return (jconvert.affine_from_host(pk.dev.ctx, pts),
            tconvert.affine_from_host(port_public_key(pk).dev.ctx, pts))


@pytest.mark.parametrize("kind", ["naf", "bits"])
def test_ladder_loop_matches_jax(keys, kind):
    """C^q1 from the start state (C, Z = 1) over q1_naf[1:] and over the
    plain bits of q1, incl. an identity-base lane (zero coordinates: both
    sides compute the same garbage, which the caller masks)."""
    pk, sk, _, tpk, _ = keys
    jrns, trns = pk.dev.rns, tpk.dev.rns
    digits = (np.asarray(sk.q1_naf) if kind == "naf"
              else np.asarray(sk.q1_bits))[1:]
    ja, ta = _points(pk, [1, 2, 7, 100, None, 55])
    jx, jy = jrn.to_rns_mont(jrns, ja.x), jrn.to_rns_mont(jrns, ja.y)
    one = jnp.broadcast_to(jrns.one_rns, jx.v.shape)
    want = pallas_rns.ladder_loop_pallas(jrns, jx.v, jy.v, one, jx, jy,
                                         jnp.asarray(digits), interpret=True)
    tx = trn.to_rns_mont(trns, ta.x).v
    ty = trn.to_rns_mont(trns, ta.y).v
    before = cuda_rns.ladder_loop.launches
    got = cuda_rns.ladder_loop(trns, tx, ty, trns.one_rns.expand_as(tx),
                               tx, ty, digits)
    assert cuda_rns.ladder_loop.launches == before     # CPU: plain version
    for g, w, bound in zip(got, want, (27, 27, 6)):
        _same_value(pk.p, jrns.k, g, w, bound)


def test_window_ladder_tab_matches_jax(keys):
    """P^e from P's window table: full-width digits (every window), zero
    digits inside a lane, an all-zero lane (X = Y = Z = 0) and a lane
    whose only live window is the last."""
    pk, _, _, tpk, _ = keys
    rng = np.random.default_rng(61)
    J = pk.dev.p_win_rns[0].shape[1]
    dig = rng.integers(0, 256, size=(J, 8))
    dig[:, 2] = 0
    dig[:-1, 3] = 0
    dig[1::2, 4] = 0
    wsel = pk.dev.p_win_rns[2]
    want = pallas_rns.window_ladder_tab_pallas(
        pk.dev.rns, wsel, pk.dev.p_win_rns[0].shape[0],
        jnp.asarray(dig.astype(np.uint32)), interpret=True)
    got = cuda_rns.window_ladder_tab(tpk.dev.rns, tpk.dev.p_win,
                                     torch.as_tensor(dig))
    for g, w, bound in zip(got, want, (27, 27, 6)):
        _same_value(pk.p, pk.dev.rns.k, g, w, bound)
    dead = np.all(np.asarray(want[2]) == 0, axis=0)
    assert list(dead) == [False, False, True] + [False] * 5
    for g in got:
        assert torch.all(g[:, 2] == 0)
    assert torch.equal(torch.all(got[2] == 0, dim=0), torch.as_tensor(dead))
    # fixed_base_mul_rns: raw residues, and the limb JacPoint form
    raw = trp.fixed_base_mul_rns(tpk.dev.ctx, tpk.dev.rns, tpk.dev.p_win, dig,
                                 raw=True)
    assert all(torch.equal(r.v, g) for r, g in zip(raw, got))
    jac = trp.fixed_base_mul_rns(tpk.dev.ctx, tpk.dev.rns, tpk.dev.p_win, dig)
    for g, r in zip(jac, raw):           # canonical limbs of the same values
        assert torch.equal(g, trn.from_rns_mont(tpk.dev.rns, r))


def test_window_ladder_matches_jax_and_tab(keys):
    """The chain over the gathered stream equals window_ladder_pallas on
    the JAX package's gathered rows, and window_ladder_tab bit for bit on
    the same digits (short digits: 2 windows, as m < 2^16 gives)."""
    pk, _, _, tpk, _ = keys
    rng = np.random.default_rng(67)
    dig = rng.integers(0, 256, size=(2, 8))
    dig[:, 5] = 0
    dig[0, 6] = 0
    tx, ty, _ = pk.dev.p_win_rns                     # [2k, J, R]
    jidx = np.arange(2)[:, None]
    gx = jnp.moveaxis(tx[:, jidx, dig], 1, 0)         # [Jd, 2k, B]
    gy = jnp.moveaxis(ty[:, jidx, dig], 1, 0)
    ginf = np.asarray(pk.dev.p_win.inf)[jidx, dig].astype(np.float32)
    assert np.array_equal(ginf, (dig == 0).astype(np.float32))
    want = pallas_rns.window_ladder_pallas(pk.dev.rns, gx, gy,
                                           jnp.asarray(ginf), interpret=True)
    tgx, tgy = cuda_rns._gather_rows(tpk.dev.p_win, torch.as_tensor(dig))
    np.testing.assert_array_equal(tgx.numpy(), np.asarray(gx))
    got = cuda_rns.window_ladder(tpk.dev.rns, tgx, tgy, torch.as_tensor(ginf))
    for g, w, bound in zip(got, want, (27, 27, 6)):
        _same_value(pk.p, pk.dev.rns.k, g, w, bound)
    tab = cuda_rns.window_ladder_tab(tpk.dev.rns, tpk.dev.p_win,
                                     torch.as_tensor(dig))
    assert all(torch.equal(a, b) for a, b in zip(got, tab))
    assert torch.all(got[2][:, 5] == 0)


def test_limb_mod_sub_neg_match_jax(keys):
    """mod_sub and mod_neg on int64 limbs equal the JAX package's (0 and
    p - 1 included), and neg_affine negates y only."""
    pk, _, _, tpk, _ = keys
    rng = random.Random(73)
    L = pk.dev.ctx.L
    xs = [0, 1, pk.p - 1] + [rng.randrange(pk.p) for _ in range(5)]
    ys = [0, pk.p - 1, 1] + [rng.randrange(pk.p) for _ in range(5)]
    jx, jy = (jnp.asarray(jlb.ints_to_limbs(v, L)) for v in (xs, ys))
    tx, ty = (torch.as_tensor(jlb.ints_to_limbs(v, L).astype(np.int64))
              for v in (xs, ys))
    np.testing.assert_array_equal(
        _u32(tmg.mod_sub(tpk.dev.ctx, tx, ty)),
        np.asarray(jmg.mod_sub(pk.dev.ctx, jx, jy)))
    np.testing.assert_array_equal(_u32(tmg.mod_neg(tpk.dev.ctx, tx)),
                                  np.asarray(jmg.mod_neg(pk.dev.ctx, jx)))
    assert tlb.limbs_to_ints(tmg.mod_sub(tpk.dev.ctx, tx, ty)) == \
        [(x - y) % pk.p for x, y in zip(xs, ys)]
    pt = tcurve.neg_affine(tpk.dev.ctx, tcurve.AffinePoint(tx, ty, tx[0]))
    assert torch.equal(pt.x, tx) and torch.equal(pt.inf, tx[0])
    assert tlb.limbs_to_ints(pt.y) == [(-y) % pk.p for y in ys]


def test_r_pow_bits_and_r_batch_inv_match_jax(keys):
    """x^(p-2) through the pow_loop kernel's plain version equals the
    square-and-multiply chain bit for bit, and the JAX r_pow_bits in
    value; the batch inversion of a [C, 2k, B] stack gives the JAX
    package's canonical limbs, and z * z^-1 = 1."""
    pk, _, _, tpk, _ = keys
    jrns, trns = pk.dev.rns, tpk.dev.rns
    L, k2 = pk.dev.ctx.L, 2 * jrns.k
    rng = random.Random(71)
    vals = [rng.randrange(1, pk.p) for _ in range(12)]
    lim = jlb.ints_to_limbs(vals, L)
    jz = jrn.to_rns_mont(jrns, jnp.asarray(lim)).v
    tz = trn.to_rns_mont(trns, torch.as_tensor(lim.astype(np.int64))).v
    bits = np.asarray(pk.dev.ctx.pm2_bits)

    got = trn.r_pow_bits(trns, trn.RVal(tz, 3), bits)
    acc = trns.one_rns.expand_as(tz)
    for b in bits:
        acc = trn.r_mul(trns, trn.RVal(acc, 3), trn.RVal(acc, 3)).v
        if b:
            acc = trn.r_mul(trns, trn.RVal(acc, 3), trn.RVal(tz, 3)).v
    assert got.bound == 3 and torch.equal(got.v, acc)
    want = jrn.r_pow_bits(jrns, jrn.RVal(jz, 3), jnp.asarray(bits))
    _same_value(pk.p, jrns.k, got.v, want.v, 3)

    jinv = jrn.r_batch_inv(jrns, jz.reshape(k2, 3, 4).transpose(1, 0, 2),
                           jnp.asarray(bits))
    tinv = trn.r_batch_inv(trns, tz.reshape(k2, 3, 4).permute(1, 0, 2),
                           bits)
    assert tinv.shape == (3, k2, 4)
    tl = trn.from_rns_mont(trns, trn.RVal(tinv.permute(1, 0, 2)
                                          .reshape(k2, 12), 3))
    jl = jrn.from_rns_mont(jrns, jrn.RVal(jinv.transpose(1, 0, 2)
                                          .reshape(k2, 12), 3))
    np.testing.assert_array_equal(_u32(tl), np.asarray(jl))
    # limbs v stand for v/R, so (v/R) * (w/R) = 1 means v * w = R^2
    R2 = pow(2, 32 * L, pk.p)
    assert [v * w % pk.p for v, w in zip(vals, tlb.limbs_to_ints(tl))] == \
        [R2] * 12


def test_bsgs_g1_rns_matches_jax(keys):
    """The G1 giant-step scan over csk = C^q1 (raw, from scalar_mul_rns):
    positive and negative values, 0 (csk is the identity), the largest
    reachable value, an out-of-range value and an identity-base lane."""
    pk, sk, tables, tpk, ttables = keys
    gk = hm.GoldenKey(params=sk.a1_params, P=pk.P_host, Q=pk.Q_host,
                      R=sk.r, msg_space=pk.msg_space)
    bound = tables.bound
    ms = [3, -7, 0, 500, bound * bound + bound + 1, 1100, 1, None]
    ja, ta = _points(pk, ms)
    jX, jY, jZ = jrp.scalar_mul_rns(pk.dev.ctx, pk.dev.rns, ja, sk.q1_naf,
                                    raw=True)
    jf, jm = jbsgs.bsgs_g1_rns(pk.dev.ctx, pk.dev.rns, tables, jX, jY, jZ,
                               ja.inf)
    tX, tY, tZ = trp.scalar_mul_rns(tpk.dev.ctx, tpk.dev.rns, ta, sk.q1_naf)
    for g, w in zip((tX, tY, tZ), (jX, jY, jZ)):
        _same_value(pk.p, pk.dev.rns.k, g.v, w.v, g.bound)
    tf, tm = tbsgs.bsgs_g1_rns(tpk.dev.ctx, tpk.dev.rns, ttables, tX, tY, tZ,
                               ta.inf)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    host = [0 if m is None else
            hm.golden_decrypt_l1(gk, hm.ec_mul(m, pk.P_host, pk.p))
            for m in ms]
    assert host == [3, -7, 0, 500, ms[4], None, 1, 0]
    assert list(tf.numpy()) == [1, 1, 1, 1, 1, 0, 1, 1]
    assert [int(v) for v, f in zip(tm, tf) if f] == \
        [h for h in host if h is not None]
