"""The port's limb path (bgn_torch: fieldcore/limbs.py, montgomery.py,
cuda_mont.py, ops/fp2.py, ops/curve.py, rns_pairing.mont_inv_rns)
against the JAX package, exactly, on the shared 64-bit key (L = 6) and a
512-bit modulus (L = 34).  The Montgomery product's plain version is held
against the JAX package's CIOS and both of its Pallas kernels in interpret
mode; everything above it against the JAX functions on the same limbs and
against host ints.  Everything runs on the CPU (the mont_mul wrapper runs
its plain version for CPU tensors).
"""
import _torch_threads  # noqa: F401  (first: one torch thread per process)
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_carry import port_public_key
from bgn_torch.fieldcore import cuda_mont
from bgn_torch.fieldcore import limbs as tlb
from bgn_torch.fieldcore import montgomery as tmg
from bgn_torch.ops import curve as tcurve
from bgn_torch.ops import fp2 as tfp2
from bgn_torch.ops import rns_pairing as trp
from bgn_torch.utils import convert as tconvert
from bgn_tpu import hostmath as hm
from bgn_tpu.fieldcore import limbs as jlb
from bgn_tpu.fieldcore import montgomery as jmg
from bgn_tpu.fieldcore import pallas_mont
from bgn_tpu.ops import curve as jcurve
from bgn_tpu.ops import fp2 as jfp2
from bgn_tpu.utils import convert as jconvert


@pytest.fixture(scope="module")
def keys(shared_keypair64):
    jpk, _ = shared_keypair64
    return jpk, port_public_key(jpk)


def _u32(t):
    return t.cpu().numpy().astype(np.uint32)


def _both(vals, L):
    """Host ints -> (JAX uint32 limbs, port int64 limbs) [L, B]."""
    a = jlb.ints_to_limbs(vals, L)
    return jnp.asarray(a), torch.as_tensor(a.astype(np.int64))


def _same(got, want):
    np.testing.assert_array_equal(_u32(got), np.asarray(want))


def _operands(p, rng, n=13):
    xs = [0, 1, p - 1, p - 2] + [rng.randrange(p) for _ in range(n - 4)]
    ys = [p - 1, 0, p - 1, 1] + [rng.randrange(p) for _ in range(n - 4)]
    return xs, ys


@pytest.mark.parametrize("modulus", ["key64", "p512"])
def test_mont_mul_plain_matches_jax(keys, modulus):
    """The plain CIOS equals the JAX package's mont_mul and host ints, on
    the shared key's p and on a 512-bit odd modulus (L = 34); the wrapper
    sends CPU tensors to it without counting a launch, and broadcasts a
    [L] operand (to_mont's R^2)."""
    jpk, tpk = keys
    rng = random.Random(81)
    if modulus == "key64":
        jctx, tctx = jpk.dev.ctx, tpk.dev.ctx
    else:
        p = rng.getrandbits(512) | (1 << 511) | 1
        jctx, tctx = jmg.make_mont_ctx(p, L=34), tmg.make_mont_ctx(
            p, L=34, device="cpu")
    p, L = tctx.p_host, tctx.L
    xs, ys = _operands(p, rng)
    (ja, ta), (jb, tb) = _both(xs, L), _both(ys, L)
    got = cuda_mont.mont_mul_plain(tctx, ta, tb)
    _same(got, jmg.mont_mul(jctx, ja, jb))
    rinv = pow(1 << (16 * L), -1, p)
    assert tlb.limbs_to_ints(got) == [x * y * rinv % p for x, y in zip(xs, ys)]
    before = cuda_mont.mont_mul.launches
    assert torch.equal(tmg.mont_mul(tctx, ta, tb), got)
    assert tlb.limbs_to_ints(tmg.mont_mul(tctx, ta, tb[:, :1])) == \
        [x * ys[0] * rinv % p for x in xs]
    _same(tmg.to_mont(tctx, ta), jmg.to_mont(jctx, ja))
    assert cuda_mont.mont_mul.launches == before


def test_mont_mul_plain_matches_pallas_kernels(keys):
    """At L = 6 the plain CIOS equals both TPU kernels that csrc/mont_mul.cu
    replaces, mont_mul_pallas_f32 (8-bit digits in fp32) and
    mont_mul_pallas (uint32), in interpret mode."""
    jpk, tpk = keys
    p, L = tpk.dev.ctx.p_host, tpk.dev.ctx.L
    assert L == 6
    xs, ys = _operands(p, random.Random(83), n=24)
    (ja, ta), (jb, tb) = _both(xs, L), _both(ys, L)
    got = cuda_mont.mont_mul_plain(tpk.dev.ctx, ta, tb)
    _same(got, pallas_mont.mont_mul_pallas_f32(jpk.dev.ctx, ja, jb,
                                               interpret=True))
    _same(got, pallas_mont.mont_mul_pallas(jpk.dev.ctx, ja, jb,
                                           interpret=True))


@pytest.mark.parametrize("L", [6, 34])
def test_carry_lookahead_matches_host_ints(L):
    """normalize / add / sub / geq: carries that run the whole width
    (all-ones limbs), borrows, and lazy limbs up to 2^32 - 1, against host
    ints and the JAX package's normalize."""
    rng = random.Random(89 + L)
    top = (1 << (16 * L)) - 1
    xs = [0, top, top, 1, 1 << (16 * L - 1)] + \
        [rng.randrange(top) for _ in range(7)]
    ys = [0, 1, top, top, 1 << (16 * L - 1)] + \
        [rng.randrange(top) for _ in range(7)]
    (_, ta), (_, tb) = _both(xs, L), _both(ys, L)
    s, c = tlb.add(ta, tb)
    assert [v + (int(k) << (16 * L)) for v, k in zip(tlb.limbs_to_ints(s), c)] \
        == [x + y for x, y in zip(xs, ys)]
    d, b = tlb.sub(ta, tb)
    assert tlb.limbs_to_ints(d) == [(x - y) % (top + 1) for x, y in zip(xs, ys)]
    assert b.tolist() == [int(x < y) for x, y in zip(xs, ys)]
    assert tlb.geq(ta, tb).tolist() == [int(x >= y) for x, y in zip(xs, ys)]
    lazy = np.random.default_rng(L).integers(0, 1 << 32, size=(L, 9),
                                             dtype=np.int64)
    lazy[:, 0] = (1 << 32) - 1
    lazy[:, 1] = 0xFFFF
    limbs, over = tlb.normalize(torch.as_tensor(lazy))
    want = [sum(int(lazy[j, i]) << (16 * j) for j in range(L))
            for i in range(9)]
    assert [v + (int(o) << (16 * L)) for v, o in
            zip(tlb.limbs_to_ints(limbs), over)] == want
    jl, jo = jlb.normalize(jnp.asarray(lazy.astype(np.uint32)))
    _same(limbs, jl)
    np.testing.assert_array_equal(over.numpy(), np.asarray(jo))


def test_montgomery_ops_match_jax(keys):
    """to_mont, from_mont, mod_add, mont_pow (shared and per-element
    bits), mont_inv, and batch_mont_inv with zero entries (which map to
    zero), against the JAX package."""
    jpk, tpk = keys
    jctx, tctx = jpk.dev.ctx, tpk.dev.ctx
    p, L = tctx.p_host, tctx.L
    xs, ys = _operands(p, random.Random(97), n=10)
    xs[1] = 0
    (ja, ta), (jb, tb) = _both(xs, L), _both(ys, L)
    _same(tmg.to_mont(tctx, ta), jmg.to_mont(jctx, ja))
    _same(tmg.from_mont(tctx, ta), jmg.from_mont(jctx, ja))
    _same(tmg.mod_add(tctx, ta, tb), jmg.mod_add(jctx, ja, jb))
    assert tlb.limbs_to_ints(tmg.mod_add(tctx, ta, tb)) == \
        [(x + y) % p for x, y in zip(xs, ys)]
    bits = np.random.default_rng(5).integers(0, 2, size=(11, 10))
    _same(tmg.mont_pow(tctx, ta, bits),
          jmg.mont_pow(jctx, ja, jnp.asarray(bits.astype(np.uint32))))
    _same(tmg.mont_pow(tctx, ta, bits[:, 0]),
          jmg.mont_pow(jctx, ja, jnp.asarray(bits[:, 0].astype(np.uint32))))
    _same(tmg.mont_inv(tctx, tb), jmg.mont_inv(jctx, jb))
    grid = ta.reshape(L, 2, 5)                 # zeros at lanes 0 and 1
    inv = tmg.batch_mont_inv(tctx, grid)
    _same(inv, jmg.batch_mont_inv(jctx, ja.reshape(L, 2, 5)))
    R = 1 << (16 * L)
    got = tlb.limbs_to_ints(inv.reshape(L, 10))
    assert got[:2] == [0, 0]
    assert all(v * x % p == R * R % p for v, x in zip(got[2:], xs[2:]))


def test_mont_inv_rns_matches_jax(keys):
    """The Fermat inversion through the pow_loop kernel's plain version
    equals the limb mont_inv of both packages."""
    jpk, tpk = keys
    p, L = tpk.dev.ctx.p_host, tpk.dev.ctx.L
    rng = random.Random(101)
    xs = [1, p - 1] + [rng.randrange(1, p) for _ in range(6)]
    ja, ta = _both(xs, L)
    got = trp.mont_inv_rns(tpk.dev.ctx, tpk.dev.rns, ta.reshape(L, 2, 4))
    assert got.shape == (L, 2, 4)
    _same(got.reshape(L, 8), jmg.mont_inv(jpk.dev.ctx, ja))


def test_fp2_ops_match_jax(keys):
    """F_p^2 mul (Karatsuba), sqr, inv, div, conj, and pow_bits with
    per-element and shared bits, against the JAX package."""
    jpk, tpk = keys
    jctx, tctx = jpk.dev.ctx, tpk.dev.ctx
    p, L = tctx.p_host, tctx.L
    rng = random.Random(103)
    vals = [[rng.randrange(1, p) for _ in range(6)] for _ in range(4)]
    (jx0, tx0), (jx1, tx1), (jy0, ty0), (jy1, ty1) = (_both(v, L)
                                                      for v in vals)
    jx, tx = jfp2.make(jx0, jx1), tfp2.make(tx0, tx1)
    jy, ty = jfp2.make(jy0, jy1), tfp2.make(ty0, ty1)
    for top, jop, args in ((tfp2.mul, jfp2.mul, "xy"), (tfp2.sqr, jfp2.sqr, "x"),
                           (tfp2.inv, jfp2.inv, "x"), (tfp2.div, jfp2.div, "xy"),
                           (tfp2.conj, jfp2.conj, "y")):
        targs = [{"x": tx, "y": ty}[c] for c in args]
        jargs = [{"x": jx, "y": jy}[c] for c in args]
        _same(top(tctx, *targs), jop(jctx, *jargs))
    assert tfp2.is_one(tctx, tfp2.mul(tctx, tx, tfp2.inv(tctx, tx))).tolist() \
        == [1] * 6
    assert tfp2.eq(tx, tx).tolist() == [1] * 6
    bits = np.random.default_rng(7).integers(0, 2, size=(9, 6))
    _same(tfp2.pow_bits(tctx, tx, bits),
          jfp2.pow_bits(jctx, jx, jnp.asarray(bits.astype(np.uint32))))
    _same(tfp2.pow_bits(tctx, tx[:, :, 0], bits),
          jfp2.pow_bits(jctx, jx[:, :, 0], jnp.asarray(bits.astype(np.uint32))))


def _pts(jpk, tpk, pts):
    return (jconvert.affine_from_host(jpk.dev.ctx, pts),
            tconvert.affine_from_host(tpk.dev.ctx, pts))


def _same_jac(got, want):
    for g, w in zip(got, want):
        _same(g, w)


def test_curve_ops_match_jax(keys):
    """dbl, madd in its four special cases (v = O, b = O, v = b, v = -b)
    beside general lanes, normalize (through mont_inv_rns), fixed_base_mul
    over Q's limb table and scalar_mul with shared and per-element bits,
    against the JAX package (Jacobian limbs) and hostmath (affine)."""
    jpk, tpk = keys
    jctx, tctx = jpk.dev.ctx, tpk.dev.ctx
    p, P = jpk.p, jpk.P_host
    mul = [3, None, 5, 7, 9, 11, None, 13]      # v = 2 * mul[i] * P
    add = [4, 6, None, 14, -18, 2, None, 1]     # b = add[i] * P
    cs = [None if m is None else hm.ec_mul(m, P, p) for m in mul]
    bs = [None if a is None else hm.ec_mul(a, P, p) for a in add]
    (jc, tc), (jb, tb) = _pts(jpk, tpk, cs), _pts(jpk, tpk, bs)
    jv = jcurve.dbl(jctx, jcurve.to_jac(jctx, jc))
    tv = tcurve.dbl(tctx, tcurve.to_jac(tctx, tc))
    _same_jac(tv, jv)
    tsum = tcurve.madd(tctx, tv, tb)
    _same_jac(tsum, jcurve.madd(jctx, jv, jb))
    want = [hm.ec_add(hm.ec_dbl(c, p) if c else None, b, p)
            for c, b in zip(cs, bs)]
    assert want[3] == hm.ec_mul(28, P, p) and want[4] is None
    aff = tcurve.normalize(tctx, tsum, rns=tpk.dev.rns)
    assert tconvert.affine_to_host(tctx, aff) == want
    jaff = jcurve.normalize(jctx, jcurve.madd(jctx, jv, jb))
    for f in ("x", "y", "inf"):
        _same(getattr(aff, f), getattr(jaff, f))
    assert tcurve.eq_affine(aff, aff).tolist() == [1] * 8

    dig = np.random.default_rng(11).integers(0, 256, size=(3, 8))
    dig[:, 1] = 0
    dig[1:, 2] = 0
    tfix = tcurve.fixed_base_mul(tctx, tpk.dev.q_tab, dig)
    _same_jac(tfix, jcurve.fixed_base_mul(jctx, jpk.dev.q_win,
                                          jnp.asarray(dig.astype(np.uint32))))
    es = [int(sum(int(d) << (8 * j) for j, d in enumerate(dig[:, i])))
          for i in range(8)]
    assert tconvert.affine_to_host(tctx, tcurve.normalize(tctx, tfix)) == \
        [hm.ec_mul(e, jpk.Q_host, p) for e in es]

    # per-element bits against the JAX package; shared bits (additions
    # only on set bits) against the per-element form of the same bits
    kb = np.random.default_rng(13).integers(0, 2, size=(10, 8))
    kb[:, 3] = 0
    tr = tcurve.scalar_mul(tctx, tb, kb)
    _same_jac(tr, jcurve.scalar_mul(jctx, jb, jnp.asarray(kb.astype(np.uint32))))
    shared = tcurve.scalar_mul(tctx, tb, kb[:, 0])
    _same_jac(shared, tcurve.scalar_mul(tctx, tb, np.repeat(kb[:, :1], 8, 1)))
    for bits, r in ((kb, tr), (np.repeat(kb[:, :1], 8, 1), shared)):
        ks = [int("".join(map(str, col)), 2) for col in bits.T]
        assert tconvert.affine_to_host(tctx, tcurve.normalize(tctx, r)) == \
            [hm.ec_mul(k, b, p) if b else None for k, b in zip(ks, bs)]


def test_mont_mul_wrapper_refuses_other_devices(keys):
    _, tpk = keys
    x = tpk.dev.ctx.one.reshape(-1, 1)
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_mont.mont_mul(tpk.dev.ctx, x.to("meta"), x.to("meta"))
