"""The reference's keys, curve and pairing against the port's host oracle
(bgn_torch/hostmath.py), and the roofline's frozen work counts against
the products the reference's Miller loop makes."""

import math
import random

import pytest

from bgn_torch import hostmath as port_hm
from portbench import harness
from portbench.conftest import HERE
from portbench.reference import hostmath as hm
from portbench.reference import keys, pairing

ROOFLINE = harness.load(HERE / "metrics" / "miller_loop_roofline.py")


def _key(bits, seed):
    return keys.keygen(bits, 1021, random.Random(seed))


def _params(k):
    return port_hm.A1Params(q1=k.q1, q2=k.q2, n=k.n, l=k.l, p=k.p)


@pytest.mark.parametrize("bits,seed", [(64, 1), (64, 2), (128, 3), (512, 4)])
def test_keygen(bits, seed):
    k = _key(bits, seed)
    assert pairing.naf_shape(k.n) == keys.naf_target(bits) == \
        (bits, round(bits / 3))
    assert tuple(pairing.naf(k.n)) == k.naf
    assert sum(d << i for i, d in enumerate(reversed(k.naf))) == k.n
    assert not keys.chain_degenerate(k.naf, (k.q1, k.q2, k.n))
    assert k.n == k.q1 * k.q2 and k.q1.bit_length() == bits // 2
    assert k.p == k.l * k.n - 1 and k.l % 4 == 0 and k.p % 4 == 3
    assert port_hm.is_probable_prime_plain(k.p)
    assert port_hm.is_probable_prime_plain(k.q2)
    assert port_hm.on_curve(k.P, k.p) and port_hm.on_curve(k.Q, k.p)
    assert port_hm.ec_mul(k.n, k.P, k.p) is None
    assert port_hm.ec_mul(k.q1, k.Q, k.p) is None
    assert port_hm.ec_mul(k.q1, k.P, k.p) is not None
    assert _key(bits, seed) == k


def test_naf_shape():
    rng = random.Random(5)
    for _ in range(500):
        e = rng.getrandbits(rng.randrange(1, 1100)) | 1
        digits = pairing.naf(e)
        assert sum(d << i for i, d in enumerate(reversed(digits))) == e
        assert all(a == 0 or b == 0 for a, b in zip(digits, digits[1:]))
        assert pairing.naf_shape(e) == (len(digits),
                                        sum(1 for d in digits if d))


@pytest.mark.parametrize("bits,seed", [(64, 6), (128, 7), (512, 8)])
def test_ec_mul_and_encrypt(bits, seed):
    k = _key(bits, seed)
    rng = random.Random(seed)
    for _ in range(4):
        m, r = rng.randrange(340), rng.randrange(1, k.n)
        for e in (m, r, k.q1 - 1, k.n - 1, k.q1 + 1):
            assert hm.ec_mul(e, k.Q, k.p) == port_hm.ec_mul(e, k.Q, k.p)
        gk = port_hm.GoldenKey(_params(k), k.P, k.Q, k.R, 1021)
        assert pairing.encrypt(m, r, k.P, k.Q, k.p) == \
            port_hm.golden_encrypt(gk, m, r)


@pytest.mark.parametrize("bits,seed", [(64, 9), (128, 10), (512, 11)])
def test_pairing(bits, seed):
    k = _key(bits, seed)
    rng = random.Random(seed)
    cases = [(rng.randrange(340), rng.randrange(1, k.n), rng.randrange(1, 4),
              rng.randrange(1, k.n)) for _ in range(3)]
    cases += [(0, rng.randrange(1, k.n), 2, rng.randrange(1, k.n)),
              (5, 0, 0, rng.randrange(1, k.n)), (0, 0, 1, 1)]
    for m, ra, kk, rb in cases:
        A = pairing.encrypt(m, ra, k.P, k.Q, k.p)
        B = pairing.encrypt(kk, rb, k.P, k.Q, k.p)
        want = port_hm.tate_pairing(A, B, _params(k))
        assert pairing.pairing(A, B, k.n, k.l, k.p, k.naf) == want
        assert pairing.product_lane(
            (k.p, k.n, k.l, k.P, k.Q, k.naf, m, kk, ra, rb)) == (A, B, want)


class _Counting(pairing.Fp):
    def __init__(self, p):
        super().__init__(p)
        self.count = 0

    def mul(self, a, b):
        self.count += 1
        return super().mul(a, b)


@pytest.mark.parametrize("bits,seed", [(64, 12), (128, 13), (512, 14),
                                       (1024, 15)])
def test_roofline_counts(bits, seed):
    """The metric's count, from the key's sizes alone, equals the F_p
    products the reference's Miller loop makes."""
    rng = random.Random(seed)
    weight = round(bits / 3) + rng.randrange(-3, 4)
    half = bits // 2
    while True:   # any n of the shape; the count needs no key
        n = (rng.getrandbits(half) | 1 << (half - 1) | 1) * \
            (rng.getrandbits(half) | 1 << (half - 1) | 1)
        if pairing.naf_shape(n) == (bits, weight):
            break
    p = 4 * n - 1
    F = _Counting(p)
    pairing.miller(F, (3, 5), (7, 11), pairing.naf(n))
    assert F.count == ROOFLINE.products(n) == \
        (bits - 1) * 18 + (weight - 2) * 17
    F = _Counting(p)
    pairing.dbl_step(F, (2, 3, 5), (7, 11), 13, 17)
    assert F.count == ROOFLINE.DBL_PRODUCTS
    F = _Counting(p)
    pairing.add_step(F, (2, 3, 5), 19, 23, (7, 11), 13, 17)
    assert F.count == ROOFLINE.ADD_PRODUCTS
    wb = math.ceil(p.bit_length() / 8)
    assert ROOFLINE.work(n, p) == (ROOFLINE.products(n) * 4 * wb * wb,
                                   6 * wb)
