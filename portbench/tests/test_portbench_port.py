"""The reference against the port on the CPU at 64 bits, for each request
kind: the port's outputs read through its public text form equal what
the reference works out from the same host parts."""

import random

import pytest
import torch

from bgn_torch import scheme
from portbench import conftest, harness
from portbench.conftest import HERE
from portbench.reference import keys, pairing

torch.set_num_threads(1)

MULT = harness.load(HERE / "requests" / "mult.py")
MULT_REF = harness.load(HERE / "reference" / "mult.py")
TRAFFIC = dict(conftest.TINY_TRAFFIC, batch=12, pool=2, check_lanes=12)


def _every_lane(state, out, j):
    lanes = list(range(state.lanes))
    b = state.pool[j]
    want = MULT_REF.expect(state.key, [
        (j, x, b.ms[x], b.ks[x], b.ra[x], b.rb[x]) for x in lanes])
    assert MULT.read_points(state, b.a, lanes) == [want[j, x][0]
                                                   for x in lanes]
    assert MULT.read_points(state, b.b, lanes) == [want[j, x][1]
                                                   for x in lanes]
    assert MULT.read_gt(state, out, lanes) == [want[j, x][2] for x in lanes]


def test_mult_against_reference():
    cfg = conftest.TINY_CONFIG
    key = keys.keygen(64, 1021, random.Random(21))
    pk = harness.deploy(cfg, key, "cpu")
    state = MULT.setup(pk, key, TRAFFIC, random.Random(22))
    outs = [(j, MULT.call(state, j)) for j in (0, 1, 0)]
    for j, out in outs[:2]:
        _every_lane(state, out, j)
    window = [(j, MULT.keep(state, j, out)) for j, out in outs]
    assert [same for _, same in window] == [True, True, True]
    assert state.first == {0: outs[0][1], 1: outs[1][1]}
    checks = MULT.judge(state, window, MULT_REF, random.Random(23), TRAFFIC)
    assert checks == {"lanes_wrong": (0, 0), "requests_unstable": (0, 0)}


@pytest.mark.parametrize("B,n", [(8192, 288), (2112, 96), (2109, 20),
                                 (12, 3), (1, 1)])
def test_sample_lanes(B, n):
    """Every pool batch checks the ends, the last block (partly filled
    where B is not a multiple of BLOCK) and one more whole block; the
    pool's batches together check a lane of every block."""
    pool, blk = 4, MULT.BLOCK
    blocks = -(-B // blk)
    seen = set()
    for j in range(pool):
        lanes = MULT.sample_lanes(B, j, pool, n, random.Random(j))
        assert lanes == MULT.sample_lanes(B, j, pool, n, random.Random(j))
        assert lanes == sorted(set(lanes)) and 0 <= lanes[0]
        assert len(lanes) >= min(n, B) and lanes[-1] == B - 1
        assert {0, *range((blocks - 1) * blk, B)} <= set(lanes)
        whole = [b for b in range(blocks)
                 if set(range(b * blk, min(B, (b + 1) * blk))) <= set(lanes)]
        assert len(whole) >= (2 if blocks > 8 else 1)   # b may be the last
        seen.update(x // blk for x in lanes)
    assert seen == set(range(blocks))


def test_port_keygen_against_reference():
    """A key from the port's own keygen(64, ...): its Mult equals the
    reference pairing on the key's host parts."""
    pk, sk = scheme.keygen(64, 1021, rng=random.Random(24), device="cpu")
    rng = random.Random(25)
    ms = [rng.randrange(340) for _ in range(6)]
    ks = [rng.randrange(1, 4) for _ in range(6)]
    ra = [rng.randrange(1, pk.n) for _ in range(6)]
    rb = [rng.randrange(1, pk.n) for _ in range(6)]
    out = pk.mult(pk.encrypt_with_randomness(ms, ra),
                  pk.encrypt_with_randomness(ks, rb))
    state = MULT.State(pk, None, [], 6)
    got = MULT.read_gt(state, out, range(6))
    digits = pairing.naf(pk.n)
    for x in range(6):
        A = pairing.encrypt(ms[x], ra[x], pk.P_host, pk.Q_host, pk.p)
        B = pairing.encrypt(ks[x], rb[x], pk.P_host, pk.Q_host, pk.p)
        assert got[x] == pairing.pairing(A, B, pk.n, pk.l, pk.p, digits)
