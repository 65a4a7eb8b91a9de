"""The benchmark's BGN key, drawn from the run's seed on the host.

`keygen` follows the port's `hostmath.golden_keygen` (NewKeyGen,
bgn.go:65-138): q1, q2 primes of key_bits/2 bits, n = q1*q2, the least
l = 4k with p = l*n - 1 prime, P = 4l * (a generator of the order-n
subgroup), Q = q2 * (R * P).  One condition is the benchmark's own: q2 is
drawn until the NAF of n has the shape `naf_target(key_bits)`: key_bits
digits (3 keys in 4 have it), round(key_bits / 3) of them nonzero (the
mode of a random n's weight).  The Miller loop doubles once per digit after
the first and adds once per nonzero digit but the first and the last, so
every seed gives the pairing the same work and two seeds differ only in
the numbers.  The draw screens a candidate for q2 by the NAF of q1 * q2
before testing it for primality, so the condition costs about one prime
search.  Imports nothing of the program.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Tuple

from . import hostmath as hm
from .pairing import naf, naf_shape


@dataclass(frozen=True)
class Key:
    """The host parts of a key: the public (n, l, p, P, Q) and the
    secret (q1, q2, R), with the Miller digits of n."""

    key_bits: int
    msg_space: int
    q1: int
    q2: int
    n: int
    l: int
    p: int
    P: Tuple[int, int]
    Q: Tuple[int, int]
    R: int
    naf: Tuple[int, ...]


def chain_degenerate(digits, mods) -> bool:
    """True where the MSB-first signed-digit chain meets a degenerate
    addition for a base point whose order divides one of `mods` (V equal
    to the addend, or to its negative before the last step); a copy of
    the port's scheme._chain_degenerate, whose NAF keys run the Miller
    loop over these digits."""
    started = False
    c = 0
    nz = [i for i, d in enumerate(digits) if d]
    last = nz[-1] if nz else -1
    for i, d in enumerate(digits):
        if not started:
            if d:
                started = True
                c = d
            continue
        c *= 2
        if d:
            for ordc in mods:
                if ordc <= 1:
                    continue
                if (c - d) % ordc == 0:
                    return True
                if (c + d) % ordc == 0 and i != last:
                    return True
            c += d
    return False


def naf_target(key_bits: int) -> Tuple[int, int]:
    """(digits, nonzero digits) of the NAF of every key's n."""
    return key_bits, round(key_bits / 3)


def keygen(key_bits: int, msg_space: int, rng: random.Random) -> Key:
    """A key whose n has the NAF shape naf_target(key_bits)."""
    target = naf_target(key_bits)
    half = key_bits // 2
    q1 = hm.gen_prime(half, rng)
    while True:
        q2 = hm.prime_candidate(half, rng)
        if q2 == q1 or hm.has_small_factor(q2):
            continue
        n = q1 * q2
        if naf_shape(n) != target:
            continue
        if not hm.is_probable_prime(q2):
            continue
        digits = naf(n)
        if not chain_degenerate(digits, (q1, q2, n)):
            break
    if q1 < msg_space or q2 < msg_space:
        raise ValueError("message space is greater than the group order")
    l = hm.find_cofactor(n)
    p = l * n - 1
    params = hm.A1Params(q1=q1, q2=q2, n=n, l=l, p=p)
    P = hm.ec_mul(4 * l, hm.find_generator(params, rng), p)
    while True:
        R = rng.randrange(n)
        Q = hm.ec_mul(q2, hm.ec_mul(R, P, p), p)
        if Q is not None:
            break
    return Key(key_bits=key_bits, msg_space=msg_space, q1=q1, q2=q2, n=n,
               l=l, p=p, P=P, Q=Q, R=R, naf=tuple(digits))
