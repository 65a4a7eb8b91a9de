"""miller_loop_roofline (%): the Miller loop kernel's share of its
roofline: the least time the card could take for the loop's work at this
key and batch, over the device time of the kernels named *miller_loop*
in the traced stretch.

The work is what the algorithm needs, whatever implements it: F_p
products and squares of w bits, w = bits of p, counted from the
reference's formulas (portbench/reference/pairing.py) and frozen here,
from the key's sizes alone:
  - the loop runs over the NAF of n, most significant digit first
    (`miller`, pairing.py:116-131): one doubling for every digit after
    the first, one addition for every nonzero digit but the first and
    the last (the last reaches n*A = O on a vertical line);
  - a doubling, `dbl_step` (pairing.py:57-75), makes DBL_PRODUCTS = 18:
    the point in Jacobian coordinates with a = 1 (XX, YY, YYYY, ZZ,
    X*YY, ZZ^2, M^2, M*(S - X3), Y*Z: 9), the tangent at phi(Q) (xq*ZZ,
    M*(xq*ZZ + X), Z3*ZZ, yq*Z3*ZZ: 4), f^2 (2) and f^2 * line (3);
  - an addition, `add_step` (pairing.py:78-95), makes ADD_PRODUCTS = 17:
    the mixed addition (ZZ, xa*ZZ, Z*ZZ, ya*Z*ZZ, HH, H*HH, X*HH, r^2,
    r*(V2 - X3), Y*HHH, Z*H: 11), the chord at phi(Q) (r*(xq + xa),
    ya*Z3, yq*Z3: 3) and f * line (3).
No RNS channel, limb or word enters the count, so a change of the
port's representation does not move it.

Operations: a w-bit product is 2 * ceil(w/8)^2 byte multiply-accumulates
(the product and its reduction), 2 operations each, at the card's int8
tensor-core peak.  Bytes: each lane's inputs read once (A and B, 4
elements of F_p) and its output written once (f, 2), ceil(w/8) bytes an
element, at the card's memory bandwidth.  The bound is the larger time.
"""

DBL_PRODUCTS = 18
ADD_PRODUCTS = 17


def products(n: int) -> int:
    """F_p products and squares of one Miller loop over the NAF of n."""
    n3 = 3 * n
    c = n3 ^ n
    digits, weight = ((n3 & c) >> 1).bit_length(), c.bit_count()
    return (digits - 1) * DBL_PRODUCTS + (weight - 2) * ADD_PRODUCTS


def work(n: int, p: int):
    """(operations, bytes) of one lane's Miller loop."""
    wb = -(-p.bit_length() // 8)
    return products(n) * 2 * 2 * wb * wb, 6 * wb


def read(t):
    ns = t.op_ns(lambda name: "miller_loop" in name)
    if ns == 0 or t.peaks is None or t.requests == 0:
        return None
    ops, nbytes = work(t.key.n, t.key.p)
    lanes = t.lanes * t.requests
    bound_s = max(ops * lanes / t.peaks["int8_ops_per_s"],
                  nbytes * lanes / t.peaks["hbm_bytes_per_s"])
    return 100.0 * bound_s / (ns / 1e9)
