"""Plain-Python number theory for the benchmark's keys: primes, the A1
parameters, F_p^2 and the curve E: y^2 = x^3 + x over F_p.

A frozen copy of the plain loops of the port's `bgn_torch/hostmath.py`
(`is_probable_prime_plain`, `gen_prime`, `find_cofactor_plain`,
`A1Params`, the F_p^2 arithmetic, `ec_add`, `ec_mul`,
`random_curve_point`, `find_generator`; keys.py follows
`golden_keygen`), so that neither the keys nor the reference change when
the program does.  Three departures: the Miller-Rabin witnesses come
from a `random.Random` seeded with the candidate (the same verdict on
every run, where the original draws them from `secrets`), `ec_mul` runs
in Jacobian coordinates (the same k*P with one inversion in all, where
the original inverts at every step), and nothing calls a native library.
Imports nothing of the program.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Optional, Tuple

Fp2 = Tuple[int, int]              # a + b*i, i^2 = -1
Point = Optional[Tuple[int, int]]  # affine (x, y), None for the identity

_SMALL_PRIMES = [2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53,
                 59, 61, 67, 71, 73, 79, 83, 89, 97, 101, 103, 107, 109, 113,
                 127, 131, 137, 139, 149, 151, 157, 163, 167, 173, 179, 181,
                 191, 193, 197, 199, 211, 223, 227, 229, 233, 239, 241, 251]


def has_small_factor(n: int) -> bool:
    """True when a prime below 256 divides n and n is not that prime."""
    return any(n % sp == 0 and n != sp for sp in _SMALL_PRIMES)


def is_probable_prime(n: int, rounds: int = 40) -> bool:
    """Miller-Rabin with `rounds` witnesses drawn from random.Random(n)."""
    if n < 2:
        return False
    if n in _SMALL_PRIMES:
        return True
    if has_small_factor(n):
        return False
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    rng = random.Random(n)
    for _ in range(rounds):
        x = pow(rng.randrange(2, n - 1), d, n)
        if x == 1 or x == n - 1:
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def prime_candidate(bits: int, rng: random.Random) -> int:
    """An odd number of exactly `bits` bits (rand.Prime's draw)."""
    return rng.getrandbits(bits) | (1 << (bits - 1)) | 1


def gen_prime(bits: int, rng: random.Random) -> int:
    """A random prime of exactly `bits` bits (bgn.go:153)."""
    while True:
        cand = prime_candidate(bits, rng)
        if is_probable_prime(cand):
            return cand


def find_cofactor(n: int, start_l: int = 4) -> int:
    """Smallest l = 4k with p = l*n - 1 prime (PBC's A1 search)."""
    l = start_l
    while not is_probable_prime(l * n - 1):
        l += 4
    return l


@dataclass(frozen=True)
class A1Params:
    """Type-A1 parameters: n = q1*q2, p = l*n - 1, p = 3 (mod 4)."""

    q1: int
    q2: int
    n: int
    l: int
    p: int


# F_p^2 = F_p[i] / (i^2 + 1)

def fp2_mul(x: Fp2, y: Fp2, p: int) -> Fp2:
    a, b = x
    c, d = y
    t0 = a * c % p
    t1 = b * d % p
    t2 = (a + b) * (c + d) % p
    return ((t0 - t1) % p, (t2 - t0 - t1) % p)


def fp2_sqr(x: Fp2, p: int) -> Fp2:
    a, b = x
    return ((a + b) * (a - b) % p, 2 * a * b % p)


def fp2_conj(x: Fp2, p: int) -> Fp2:
    return (x[0], (-x[1]) % p)


def fp2_inv(x: Fp2, p: int) -> Fp2:
    a, b = x
    ninv = pow((a * a + b * b) % p, -1, p)
    return (a * ninv % p, (-b) * ninv % p)


def fp2_pow(x: Fp2, e: int, p: int) -> Fp2:
    r: Fp2 = (1, 0)
    while e:
        if e & 1:
            r = fp2_mul(r, x, p)
        x = fp2_sqr(x, p)
        e >>= 1
    return r


# the curve y^2 = x^3 + x, affine

def ec_add(P: Point, Q: Point, p: int) -> Point:
    if P is None:
        return Q
    if Q is None:
        return P
    x1, y1 = P
    x2, y2 = Q
    if x1 == x2:
        if (y1 + y2) % p == 0:
            return None
        lam = (3 * x1 * x1 + 1) * pow(2 * y1, -1, p) % p
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, p) % p
    x3 = (lam * lam - x1 - x2) % p
    return (x3, (lam * (x1 - x3) - y1) % p)


def ec_mul(k: int, P: Point, p: int) -> Point:
    """k*P, k >= 0, by double-and-add in Jacobian coordinates (x = X/Z^2,
    y = Y/Z^3), one inversion at the end."""
    if P is None or k == 0:
        return None
    xa, ya = P
    V = (1, 1, 0)
    for bit in bin(k)[2:]:
        V = _jac_dbl(V, p)
        if bit == "1":
            V = _jac_add_affine(V, xa, ya, p)
    X, Y, Z = V
    if Z == 0:
        return None
    zi = pow(Z, -1, p)
    zi2 = zi * zi % p
    return (X * zi2 % p, Y * zi2 * zi % p)


def _jac_dbl(V, p: int):
    """2V (dbl-2007-bl, a = 1); Z = 0 is the identity."""
    X, Y, Z = V
    if Z == 0 or Y == 0:
        return (1, 1, 0)
    XX = X * X % p
    YY = Y * Y % p
    ZZ = Z * Z % p
    S = 4 * X * YY % p
    M = (3 * XX + ZZ * ZZ) % p
    X3 = (M * M - 2 * S) % p
    return (X3, (M * (S - X3) - 8 * YY * YY) % p, 2 * Y * Z % p)


def _jac_add_affine(V, xa: int, ya: int, p: int):
    """V + (xa, ya) in every case (V the identity, V = +-(xa, ya))."""
    X, Y, Z = V
    if Z == 0:
        return (xa, ya, 1)
    ZZ = Z * Z % p
    H = (xa * ZZ - X) % p
    r = (ya * Z * ZZ - Y) % p
    if H == 0:
        return _jac_dbl(V, p) if r == 0 else (1, 1, 0)
    HH = H * H % p
    HHH = H * HH % p
    V2 = X * HH % p
    X3 = (r * r - HHH - 2 * V2) % p
    return (X3, (r * (V2 - X3) - Y * HHH) % p, Z * H % p)


def sqrt_mod(a: int, p: int) -> Optional[int]:
    """Square root mod p = 3 (mod 4); None for a non-residue."""
    a %= p
    r = pow(a, (p + 1) // 4, p)
    return r if r * r % p == a else None


def random_curve_point(params: A1Params, rng: random.Random) -> Point:
    """A random point of the order-n subgroup: a random curve point
    times the cofactor l (PBC's element_random)."""
    p = params.p
    while True:
        x = rng.randrange(p)
        sign = rng.randrange(2)
        y = sqrt_mod((x * x * x + x) % p, p)
        if y is None:
            continue
        if sign:
            y = (-y) % p
        P = ec_mul(params.l, (x, y), p)
        if P is not None:
            return P


def find_generator(params: A1Params, rng: random.Random) -> Point:
    """A generator of the order-n subgroup (findGenerator,
    bgn.go:170-192): reject P^q1 = O and P^n != O."""
    p = params.p
    while True:
        P = random_curve_point(params, rng)
        if ec_mul(params.q1, P, p) is None:
            continue
        if ec_mul(params.n, P, p) is not None:
            continue
        return P
