"""The port's limb-path scheme ops (bgn_torch/scheme.py) against the JAX
package, exactly, on the shared 64-bit key (msg space 1021) carried
across from the JAX arrays: L2 and mixed-level Add/Sub, every op of a
non-deterministic key (re-randomized by Q^r or e(Q, Q)^r with r drawn
from a seeded random.Random in the JAX package's order), MultConst by
n - 1 (the complete limb ladder) and encrypt_device.

A non-deterministic op is the deterministic op followed by the
re-randomization; the deterministic ops are held against the JAX package
in test_torch_scheme_l1.py and test_torch_scheme.py, so here each
re-randomized result is held against the JAX package's own
re-randomization kernel applied to the port's deterministic result with
the same r (one compile per level), and Add at both levels against the
JAX package's whole op.  Every result is also decrypted.  Everything runs
on the CPU.
"""
import _torch_threads  # noqa: F401  (first: one torch thread per process)
import copy
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_carry import port_public_key, port_tables
from bgn_torch import scheme as tscheme
from bgn_torch.fieldcore import limbs as tlb
from bgn_torch.utils import rng as trng
from bgn_tpu import scheme as jscheme
from bgn_tpu.fieldcore import montgomery as jmg
from bgn_tpu.ops import curve as jcurve
from bgn_tpu.utils import rng as jrng

MS = [0, 1, 7, -5, 30, -20, 2, 13]
KS = [3, 0, -7, 5, 30, 25, -2, 11]


@pytest.fixture(scope="module")
def keys(shared_keypair):
    """The JAX key, the port's key and tables built from its arrays (the
    secret key from the same q1 and R), and non-deterministic copies of
    both public keys."""
    jpk, jsk, jtables = shared_keypair
    pk = port_public_key(jpk)
    sk = tscheme.BGNSecretKey(jsk.a1_params, jsk.r, jsk.poly_base)
    jr, pr = copy.copy(jpk), copy.copy(pk)
    jr.deterministic = pr.deterministic = False
    return jpk, pk, sk, port_tables(jtables), jr, pr


def _u32(t):
    return t.cpu().numpy().astype(np.uint32)


def _same(ct, jct):
    assert ct.level2 == jct.level2
    if ct.level2:
        np.testing.assert_array_equal(_u32(ct.data), np.asarray(jct.data))
        return
    for f in ("x", "y", "inf"):
        np.testing.assert_array_equal(_u32(getattr(ct.data, f)),
                                      np.asarray(getattr(jct.data, f)))


def _jax_ct(ct):
    """The JAX package's Ciphertext holding the port's limbs."""
    if ct.level2:
        return jscheme.Ciphertext(jnp.asarray(_u32(ct.data)), True)
    return jscheme.Ciphertext(jcurve.AffinePoint(
        *(jnp.asarray(_u32(getattr(ct.data, f))) for f in ("x", "y", "inf"))),
        False)


def _jax_rerand(jr, ct, seed):
    """The JAX package's re-randomization (non-deterministic key jr) of
    ct, r drawn from random.Random(seed) in its own order."""
    jct, rng = _jax_ct(ct), random.Random(seed)
    rerand = jr._rerandomize_l2 if ct.level2 else jr._rerandomize_l1
    return jscheme.Ciphertext(rerand(jct.data, rng), ct.level2)


def test_l2_and_mixed_level_add_sub(keys):
    """Deterministic key: L2 Add/Sub equal the JAX package's; an L1
    operand is promoted by MakeL2 first (both orders), so mixed-level
    results equal the L2 ones; Neg of an L2 ciphertext; all decrypt."""
    jpk, pk, sk, tables, _, _ = keys
    a, b = pk.encrypt_deterministic(MS), pk.encrypt_deterministic(KS)
    la, lb = pk.make_l2(a), pk.make_l2(b)
    for op, jop, want in ((pk.add, jpk.add, [m + k for m, k in zip(MS, KS)]),
                          (pk.sub, jpk.sub, [m - k for m, k in zip(MS, KS)])):
        got = op(la, lb)
        _same(got, jop(_jax_ct(la), _jax_ct(lb)))
        assert torch.equal(op(a, lb).data, got.data)
        assert torch.equal(op(la, b).data, got.data)
        assert list(sk.decrypt(got, pk, tables)) == want
    assert list(sk.decrypt(pk.neg(la), pk, tables)) == [-m for m in MS]


def test_nondeterministic_ops_match_jax(keys):
    """Non-deterministic key: Add, Sub, Neg, MultConst at level 1 and Add,
    Sub, Neg, Mult, MultConst at level 2, each re-randomized with r from a
    seeded rng: bit-identical to the JAX package's re-randomization of the
    same deterministic result, different from that result, and decrypting
    to the plaintext's value.  Add at both levels is also held against
    the JAX package's whole op."""
    _, pk, sk, tables, jr, pr = keys
    a = pk.encrypt_deterministic(MS)
    b = pk.encrypt_with_randomness(KS, [5, 6, 0, 9, 1, 2, 3, 4])
    la, lb = pk.make_l2(a), pk.make_l2(b)
    cases = [
        ("add", lambda k, r: k.add(a, b, rng=r), [m + k for m, k in
                                                   zip(MS, KS)]),
        ("sub", lambda k, r: k.sub(a, b, rng=r), [m - k for m, k in
                                                   zip(MS, KS)]),
        ("neg", lambda k, r: k.neg(a, rng=r), [-m for m in MS]),
        ("mult_const", lambda k, r: k.mult_const(a, 3, rng=r),
         [3 * m for m in MS]),
        ("add L2", lambda k, r: k.add(la, lb, rng=r), [m + k for m, k in
                                                        zip(MS, KS)]),
        ("sub L2", lambda k, r: k.sub(la, b, rng=r), [m - k for m, k in
                                                      zip(MS, KS)]),
        ("neg L2", lambda k, r: k.neg(la, rng=r), [-m for m in MS]),
        ("mult", lambda k, r: k.mult(a, b, rng=r), [m * k for m, k in
                                                     zip(MS, KS)]),
        ("mult_const L2", lambda k, r: k.mult_const(la, -2, rng=r),
         [-2 * m for m in MS]),
    ]
    for seed, (name, fn, want) in enumerate(cases):
        det = fn(pk, None)
        got = fn(pr, random.Random(seed))
        _same(got, _jax_rerand(jr, det, seed))
        moved = (got.data != det.data) if got.level2 else \
            (got.data.x != det.data.x)
        assert bool(moved.any()), name
        assert list(sk.decrypt(got, pk, tables)) == want, name
    for x, y in ((a, b), (la, lb)):
        _same(pr.add(x, y, rng=random.Random(99)),
              jr.add(_jax_ct(x), _jax_ct(y), rng=random.Random(99)))


def test_mult_const_by_n_minus_1_matches_jax(keys):
    """k = n - 1 is wider than key_bits//2 - 2 bits: the complete limb
    ladder, equal to the JAX package's, and C^(n-1) decrypts to -m."""
    jpk, pk, sk, tables, _, _ = keys
    a = pk.encrypt_with_randomness(MS, [3, 1, 4, 1, 5, 9, 2, 6])
    got = pk.mult_const(a, pk.n - 1)
    _same(got, jpk.mult_const(_jax_ct(a), jpk.n - 1))
    assert list(sk.decrypt(got, pk, tables)) == [-m for m in MS]


def test_encrypt_device(keys):
    """encrypt_device with a seeded torch.Generator decrypts, and equals
    encrypt_with_randomness with the r that the same seed draws; the mod-n
    reduction of raw limbs (made with numpy) equals the JAX package's
    device_random_below reduction and host ints."""
    jpk, pk, sk, tables, _, _ = keys
    ct = pk.encrypt_device(MS, torch.Generator().manual_seed(3))
    assert list(sk.decrypt(ct, pk, tables)) == MS
    sctx = pk._sampler_ctx
    rs = tlb.limbs_to_ints(trng.device_random_below(
        sctx, torch.Generator().manual_seed(3), (8,)))
    assert all(r < pk.n for r in rs)
    _same(ct, _jax_ct(pk.encrypt_with_randomness(MS, rs)))
    jsctx = jrng.make_device_sampler_ctx(jpk.n)
    assert sctx.L == jsctx.L
    raw = np.random.default_rng(9).integers(0, 1 << 16, size=(sctx.L, 12))
    raw[:, 0] = 0xFFFF
    raw[:, 1] = 0
    got = trng.reduce_below(sctx, torch.as_tensor(raw))
    want = jmg.from_mont(jsctx, jmg.to_mont(jsctx, jnp.asarray(
        raw.astype(np.uint32))))
    np.testing.assert_array_equal(_u32(got), np.asarray(want))
    assert tlb.limbs_to_ints(got) == [v % pk.n for v in
                                      tlb.limbs_to_ints(torch.as_tensor(raw))]
