"""Private aggregation: homomorphic sums over encrypted contributions.

The port's counterpart of `bgn_tpu/models/aggregation.py`.  The classic
additive-HE deployment (secure surveys, federated counters, e-voting
tallies): many parties submit E(x_i); the aggregator computes E(sum x_i)
without the secret key.  With BGN each contribution can also be weighted
by an encrypted weight through one Mult: sum_i E(x_i) * E(w_i), an
encrypted weighted sum at level 2.

Pure composition of scheme primitives (Add bgn.go:442, Mult bgn.go:294),
batched over the contribution axis: the L1 sum is a fold of complete
mixed additions (Jacobian accumulator) with ONE final normalize, the GT
product a log-depth halving tree of batched F_p^2 products.

One departure from the JAX package, deliberately: its weighted_aggregate
returns the fused value un-re-randomized when a non-deterministic key is
called without an rng (bgn_tpu/models/aggregation.py:79), unlike the
reference's Mult (bgn.go:294, 462-475).  Here the fused value is
re-randomized by the key's own e(Q, Q)^r (fresh randomness when no rng is
given), so the result is a re-randomized L2 ciphertext either way.
"""

from __future__ import annotations

from ..ops import curve
from ..ops.curve import AffinePoint
from ..scheme import BGNPublicKey, Ciphertext, PublicDeviceKey
from .encrypted_dot import encrypted_dot, prod_gt


def _sum_l1_kernel(dev: PublicDeviceKey, pts: AffinePoint) -> AffinePoint:
    """Sum a [N, *batch] batch of L1 points over axis 0: a fold of
    complete madds (no per-step inversion), one normalize."""
    return curve.sum_affine(dev.ctx, (AffinePoint(pts.x[:, i], pts.y[:, i],
                                                  pts.inf[i])
                                      for i in range(pts.inf.shape[0])),
                            pts.inf.shape[1:], rns=dev.rns)


def aggregate(pk: BGNPublicKey, contributions: Ciphertext) -> Ciphertext:
    """E(x_0..x_{N-1}) [N, *batch] -> E(sum x_i) [*batch]."""
    if contributions.level2:
        return Ciphertext(prod_gt(pk.dev.ctx, contributions.data),
                          level2=True)
    return Ciphertext(_sum_l1_kernel(pk.dev, contributions.data),
                      level2=False)


def weighted_aggregate(pk: BGNPublicKey, values: Ciphertext,
                       weights: Ciphertext, rng=None) -> Ciphertext:
    """E(x_i), E(w_i) [N, *batch] -> E_L2(sum x_i * w_i): the 2-DNF
    weighted tally.

    A deterministic key takes the fused encrypted_dot (N Miller loops,
    one final exponentiation per output: the group element of
    Mult-then-aggregate).  A non-deterministic key with an rng runs
    Mult (each product re-randomized from rng, in the JAX package's
    order) then aggregate; without an rng it takes the fused value and
    re-randomizes it once with e(Q, Q)^r from fresh randomness."""
    if pk.deterministic:
        return encrypted_dot(pk, values, weights)
    if rng is None:
        fused = encrypted_dot(pk, values, weights)
        return Ciphertext(pk._rerandomize_l2(fused.data, None), level2=True)
    return aggregate(pk, pk.mult(values, weights, rng=rng))
