"""Request kind `mult`: one BGNPublicKey.mult (Mult, bgn.go:294) of a
batch of L1 ciphertext pairs, the server's product (BenchmarkMult,
bgn_test.go:87-140).

Set-up draws `pool` input batches from the seed: messages m < m_below,
second factors k from k_values (so m*k stays below the message space),
and the randomness r < n of each encryption; the port encrypts them with
encrypt_with_randomness.  Request i multiplies batch i mod pool.

Keeping (in the window, after each request has been timed): the output
is compared at once, on the card, with the first output of the same
input batch, which is kept whole (one output a pool batch, the warm-up's
included); only that verdict is kept, so the window holds no outputs.

Judging (after the window): in every pool batch, `check_lanes` lanes
or more drawn from the seed (sample_lanes): whole blocks of BLOCK lanes,
one lane of every block across the pool, and single lanes.  The reference
works each sampled lane's two ciphertexts out again from (m, r) and
(k, r') and pairs them.  Two numbers, each with limit 0:
  lanes_wrong: sampled lanes of the set-up's L1 ciphertexts, and of
    every window request's product that equals its batch's first, that
    differ from the reference, and the sampled lanes of a request that
    raised;
  requests_unstable: window requests whose output differs in any bit
    from the kept first output of the same input batch (a deterministic
    key's product is a function of its inputs).
"""

from __future__ import annotations

import dataclasses

import torch

SPAN = "scheme.mult"
BLOCK = 8     # lanes in one block of the port's RNS kernels (TcLanes)


@dataclasses.dataclass
class Batch:
    ms: list
    ks: list
    ra: list
    rb: list
    a: object          # the port's L1 ciphertexts of ms
    b: object          # ... and of ks


@dataclasses.dataclass
class State:
    pk: object
    key: object
    pool: list
    lanes: int
    first: dict = dataclasses.field(default_factory=dict)


def setup(pk, key, traffic, rng) -> State:
    B = int(traffic["batch"])
    pool = []
    for _ in range(int(traffic["pool"])):
        ms = [rng.randrange(traffic["m_below"]) for _ in range(B)]
        ks = [rng.choice(traffic["k_values"]) for _ in range(B)]
        ra = [rng.randrange(1, key.n) for _ in range(B)]
        rb = [rng.randrange(1, key.n) for _ in range(B)]
        pool.append(Batch(ms, ks, ra, rb, pk.encrypt_with_randomness(ms, ra),
                          pk.encrypt_with_randomness(ks, rb)))
    return State(pk, key, pool, B)


def call(state: State, j: int):
    batch = state.pool[j]
    return state.pk.mult(batch.a, batch.b)


def keep(state: State, j: int, out) -> bool:
    """Whether out equals, bit for bit, the first output of input batch
    j (True for that first output, which is kept)."""
    base = state.first.setdefault(j, out)
    return base is out or torch.equal(out.data, base.data)


def sample_lanes(B: int, j: int, pool: int, n: int, rng) -> list:
    """At least n lanes of input batch j of a batch of B, drawn by rng:
    the first and the last lane, the last block of BLOCK lanes (which may
    be partly filled), one more whole block, one lane of every block b
    with b = j mod pool (so that the pool's batches together check every
    block), and single lanes."""
    blocks = -(-B // BLOCK)
    lanes = {0, B - 1, *range((blocks - 1) * BLOCK, B)}
    b = rng.randrange(blocks)
    lanes.update(range(b * BLOCK, min(B, (b + 1) * BLOCK)))
    lanes.update(rng.randrange(b * BLOCK, min(B, (b + 1) * BLOCK))
                 for b in range(j % pool, blocks, pool))
    rest = sorted(set(range(B)) - lanes)
    lanes.update(rng.sample(rest, min(max(n - len(lanes), 0), len(rest))))
    return sorted(lanes)

def _hex_pair(line: str):
    a, b = line.strip()[1:-1].split(",")
    return int(a, 16), int(b, 16)


def read_points(state: State, ct, lanes) -> list:
    """Host points of an L1 ciphertext's lanes, through the port's
    canonical text form (Ciphertext.string)."""
    return [None if s.strip() == "O" else _hex_pair(s)
            for s in ct[list(lanes)].string(state.pk).splitlines()]


def read_gt(state: State, ct, lanes) -> list:
    """Host F_p^2 values of an L2 ciphertext's lanes."""
    return [_hex_pair(s)
            for s in ct[list(lanes)].string(state.pk).splitlines()]


def judge(state: State, window, ref, rng, traffic) -> dict:
    """window: (input batch, keep()'s verdict, or None where the request
    raised) of every window request."""
    B = state.lanes
    lanes = {j: sample_lanes(B, j, len(state.pool),
                             int(traffic["check_lanes"]), rng)
             for j in range(len(state.pool))}
    want = ref.expect(state.key, [
        (j, x, b.ms[x], b.ks[x], b.ra[x], b.rb[x])
        for j, b in enumerate(state.pool) for x in lanes[j]])
    wrong, base_wrong = 0, {}
    for j, b in enumerate(state.pool):
        for side, ct in ((0, b.a), (1, b.b)):
            got = read_points(state, ct, lanes[j])
            wrong += sum(g != want[(j, x)][side]
                         for g, x in zip(got, lanes[j]))
        if j in state.first:
            got = read_gt(state, state.first[j], lanes[j])
            base_wrong[j] = sum(g != want[(j, x)][2]
                                for g, x in zip(got, lanes[j]))
    unstable = 0
    for j, same in window:
        if same is None:
            wrong += len(lanes[j])
        elif same:
            wrong += base_wrong[j]     # the same bits: the same lanes
        else:
            unstable += 1
    return {"lanes_wrong": (wrong, 0), "requests_unstable": (unstable, 0)}
