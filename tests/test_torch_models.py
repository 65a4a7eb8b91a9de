"""The port's models (bgn_torch/models/) on the shared 64-bit key carried
across from the JAX arrays, on the CPU, at D = 3 coordinates and B = 2
vectors (one identity lane among the inputs): encrypted_dot equal to
pk.mult followed by aggregate and to bgn_tpu.models.encrypted_dot (its
CPU limb branch; the port's key without RNS takes the port's limb branch
and gives the same limbs); aggregate at both levels equal to the JAX
package's and to Adds composed by hand; and weighted_aggregate pinned
where the port departs from bgn_tpu/models/aggregation.py:79 (a
non-deterministic key called without an rng: the JAX package returns
the fused value un-re-randomized, the port re-randomizes it).
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
from bgn_torch.models import aggregation as tagg
from bgn_torch.models import encrypted_dot as tdot
from bgn_tpu import scheme as jscheme
from bgn_tpu.models import aggregation as jagg
from bgn_tpu.models import encrypted_dot as jdot
from bgn_tpu.ops import curve as jcurve

XS = [[3, 0, 2], [1, 2, 0]]        # B = 2 vectors of D = 3 coordinates
YS = [[2, 5, 1], [4, 0, 3]]


@pytest.fixture(scope="module")
def keys(shared_keypair):
    jpk, jsk, jtables = shared_keypair
    pk = port_public_key(jpk)
    sk = tscheme.BGNSecretKey(jsk.a1_params, jsk.r, jsk.poly_base)
    return jpk, pk, sk, port_tables(jtables)


def _u32(t):
    return t.cpu().numpy().astype(np.uint32)


def _jax_ct(ct):
    if ct.level2:
        return jscheme.Ciphertext(jnp.asarray(_u32(ct.data)), True)
    return jscheme.Ciphertext(jcurve.AffinePoint(
        *(jnp.asarray(_u32(getattr(ct.data, f))) for f in ("x", "y", "inf"))),
        False)


def _same_jax(ct, jct):
    assert ct.level2 == jct.level2
    if ct.level2:
        np.testing.assert_array_equal(_u32(ct.data), np.asarray(jct.data))
        return
    for f in ("x", "y", "inf"):
        np.testing.assert_array_equal(_u32(getattr(ct.data, f)),
                                      np.asarray(getattr(jct.data, f)))


def _equal(a, b):
    assert a.level2 == b.level2
    if a.level2:
        return torch.equal(a.data, b.data)
    return all(torch.equal(u, v) for u, v in zip(a.data, b.data))


@pytest.fixture(scope="module")
def vectors(keys):
    """[D, B] L1 batches; x's coordinate (1, 0) is E(0) with r = 0, the
    identity, so its pairings are trivial lanes."""
    _, pk, _, _ = keys
    g = random.Random(4)
    xm = [XS[b][i] for i in range(3) for b in range(2)]
    ym = [YS[b][i] for i in range(3) for b in range(2)]
    xr = [0 if m == 0 else g.randrange(pk.n) for m in xm]
    yr = [g.randrange(pk.n) for _ in ym]
    x = pk.encrypt_with_randomness(xm, xr).reshape((3, 2))
    y = pk.encrypt_with_randomness(ym, yr).reshape((3, 2))
    assert int(x.data.inf[1, 0]) == 1
    return x, y


def _column(ct, b):
    """Vector b of a [D, B] L1 batch, as a [D] batch."""
    return tscheme.Ciphertext(tscheme.AffinePoint(
        ct.data.x[:, :, b], ct.data.y[:, :, b], ct.data.inf[:, b]), False)


def _dots():
    return [sum(a * b for a, b in zip(u, v)) for u, v in zip(XS, YS)]


def test_encrypted_dot_matches_mult_aggregate_and_jax(keys, vectors):
    jpk, pk, sk, tables = keys
    x, y = vectors
    dot = tdot.encrypted_dot(pk, x, y)
    assert dot.level2 and dot.batch_shape == (2,)
    assert _equal(dot, tagg.aggregate(pk, pk.mult(x, y)))
    _same_jax(dot, jdot.encrypted_dot(jpk, _jax_ct(x), _jax_ct(y)))
    assert [int(v) for v in sk.decrypt(dot, pk, tables)] == _dots()
    one = tdot.encrypted_dot(pk, _column(x, 0), _column(y, 0))  # one [D]
    assert one.batch_shape == () and torch.equal(one.data, dot.data[:, :, 0])
    with pytest.raises(ValueError, match="level-1"):
        tdot.encrypted_dot(pk, dot, y)


def test_encrypted_dot_limb_branch(shared_keypair, keys, vectors):
    """A key without RNS: the limb Miller loop and limb F_p^2 tree give
    the RNS branch's limbs."""
    jpk, pk, _, _ = keys
    x, y = vectors
    limb = port_public_key(jpk, with_rns=False)
    assert limb.dev.rns is None
    assert _equal(tdot.encrypted_dot(limb, x, y),
                  tdot.encrypted_dot(pk, x, y))


def test_aggregate_matches_jax_and_by_hand(keys, vectors):
    jpk, pk, sk, tables = keys
    x, y = vectors
    l1 = tagg.aggregate(pk, x)
    assert not l1.level2 and l1.batch_shape == (2,)
    _same_jax(l1, jagg.aggregate(jpk, _jax_ct(x)))
    assert _equal(l1, pk.add(pk.add(x[0], x[1]), x[2]))
    assert [int(v) for v in sk.decrypt(l1, pk, tables)] == \
        [sum(u) for u in XS]
    prods = pk.mult(x, y)
    l2 = tagg.aggregate(pk, prods)               # N = 3: an odd tail
    _same_jax(l2, jagg.aggregate(jpk, _jax_ct(prods)))
    assert _equal(l2, pk.add(pk.add(prods[0], prods[1]), prods[2]))


def test_weighted_aggregate_pins(keys, vectors):
    """Deterministic key: bit-identical to the JAX package (the fused
    dot).  Non-deterministic key with an rng: the port's Mult (each
    product re-randomized from the rng in the JAX package's order, held
    bit for bit to the JAX Mult in test_torch_scheme_rand.py) then
    aggregate, bit-identical to the JAX package's aggregate of those
    products, which is its weighted_aggregate with that rng (the JAX
    re-randomized Mult is not compiled again here: ~20 s).
    Non-deterministic key without an rng: the JAX package returns the
    fused value un-re-randomized (bgn_tpu/models/aggregation.py:79); the
    port re-randomizes it, so the value differs and decrypts the same."""
    jpk, pk, sk, tables = keys
    x, y = vectors
    jx, jy = _jax_ct(x), _jax_ct(y)
    fused = tdot.encrypted_dot(pk, x, y)
    det = tagg.weighted_aggregate(pk, x, y)
    assert _equal(det, fused)
    _same_jax(det, jagg.weighted_aggregate(jpk, jx, jy))
    pkr, jpkr = copy.copy(pk), copy.copy(jpk)
    pkr.deterministic = jpkr.deterministic = False
    seeded = tagg.weighted_aggregate(pkr, x, y, rng=random.Random(9))
    prods = pkr.mult(x, y, rng=random.Random(9))
    assert _equal(seeded, tagg.aggregate(pkr, prods))
    _same_jax(seeded, jagg.aggregate(jpkr, _jax_ct(prods)))
    fresh = tagg.weighted_aggregate(pkr, x, y)
    jfresh = jagg.weighted_aggregate(jpkr, jx, jy)
    _same_jax(fused, jfresh)                    # JAX: fused, not re-randomized
    assert not np.array_equal(_u32(fresh.data), np.asarray(jfresh.data))
    assert not np.array_equal(_u32(fresh.data), _u32(seeded.data))
    for ct in (det, seeded, fresh):
        assert [int(v) for v in sk.decrypt(ct, pk, tables)] == _dots()
