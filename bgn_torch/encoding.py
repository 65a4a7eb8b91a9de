"""Plaintext polynomial and fixed-point encodings (reference plaintext.go).

The port's copy of `bgn_tpu/encoding.py` (pure Python, host only, no
kernel): exact mirrors of the reference's encoders.
  - balanced base-b encoding with digits in {-1, 0, 1} chosen greedily by
    nearest power, negatives by global sign flip (plaintext.go:209-266);
  - unbalanced encoding with digits in {1, 2} (plaintext.go:161-207);
  - `rationalize`: brute-force num/base^pow approximation of the fractional
    part within fp_precision (plaintext.go:269-312), including its quirky
    normalization steps, mirrored operation for operation;
  - Horner evaluation `poly_eval` with FPScaleBase^ScaleFactor division
    (plaintext.go:315-335).

The reference keeps degreeTable/degreeSumTable in package globals rebuilt by
every NewKeyGen (plaintext.go:8-11, bgn.go:135); here the tables live on
the public key (pk._encoding_tables), filled by keygen and by
scheme.public_key_from_parts.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from fractions import Fraction
from typing import List, Tuple

DEGREE_BOUND = 128  # plaintext.go:11


@dataclass
class EncodingTables:
    degree_table: List[int]      # base^i
    degree_sum_table: List[int]  # sum_{j<=i} base^j


@dataclass
class Plaintext:
    """Scalar (non-polynomial) plaintext wrapper (reference Plaintext,
    plaintext.go:21-25).  Thin and barely used in the reference; provided
    for API parity."""

    pk: object                 # BGNPublicKey
    value: int


def new_plaintext(pk, m: int) -> Plaintext:
    """Mirrors PublicKey.NewPlaintext (plaintext.go:27-30)."""
    return Plaintext(pk, int(m))


@dataclass
class PolyPlaintext:
    """Polynomial-encoded value (reference PolyPlaintext, plaintext.go:14)."""

    pk: object                 # BGNPublicKey
    coefficients: List[int]
    degree: int
    scale_factor: int

    def poly_eval_fraction(self) -> Fraction:
        """Exact Horner evaluation (PolyEval, plaintext.go:315-335)."""
        base = self.pk.poly_params.poly_base
        acc = Fraction(0)
        for i in range(self.degree - 1, -1, -1):
            c = self.coefficients[i] if i < len(self.coefficients) else 0
            acc = acc * base + (c if c is not None else 0)
        if self.scale_factor != 0:
            scale = self.pk.poly_params.fp_scale_base ** self.scale_factor
            acc = acc / scale
        return acc

    def poly_eval(self) -> float:
        return float(self.poly_eval_fraction())

    def __str__(self) -> str:
        return str(self.poly_eval())


def compute_encoding_table(pk) -> EncodingTables:
    """Mirror computeEncodingTable (plaintext.go:105-124)."""
    base = pk.poly_params.poly_base
    degree_table = [1]
    degree_sum_table = [1]
    s = 1
    for i in range(1, DEGREE_BOUND):
        v = base ** i
        s += v
        degree_table.append(v)
        degree_sum_table.append(s)
    tables = EncodingTables(degree_table, degree_sum_table)
    pk._encoding_tables = tables
    return tables


def _degree(tables: EncodingTables, target: int, bound: int,
            balanced: bool) -> int:
    """Mirror degree() (plaintext.go:127-150) including its quirks."""
    if target == 1:
        return 0
    if balanced:
        for i in range(1, bound + 1):
            if tables.degree_sum_table[i] >= target:
                return i
    else:
        for i in range(1, bound + 1):
            if tables.degree_table[i] > target:
                return i - 1
    return -1


def unbalanced_encode(tables: EncodingTables, target: int,
                      base: int) -> Tuple[List[int], int]:
    """Digits in {1, 2}; mirror unbalancedEncode (plaintext.go:161-207)."""
    if target == 0:
        return [0], 1
    if target < 0:
        raise ValueError("Negative encoding not supported")
    coefficients = [0] * DEGREE_BOUND
    bound = len(tables.degree_sum_table)
    last_degree = DEGREE_BOUND
    init_bound = bound
    while True:
        index = _degree(tables, target, last_degree, balanced=False)
        last_degree = index + 1
        if bound == init_bound:
            bound = index + 1
        value = tables.degree_table[index]
        value2 = value * 2
        if value2 <= target:
            value = value2
            coefficients[index] = 2
        else:
            coefficients[index] = 1
        if value == target:
            return coefficients[:bound + 1], bound + 1
        target -= value


def balanced_encode(tables: EncodingTables, target: int,
                    base: int) -> Tuple[List[int], int]:
    """Digits in {-1, 0, 1}; mirror balancedEncode (plaintext.go:209-266)."""
    if target == 0:
        return [0], 1
    is_negative = target < 0
    if is_negative:
        target = -target
    coefficients = [0] * DEGREE_BOUND
    bound = len(tables.degree_sum_table)
    init_bound = bound
    last_index = DEGREE_BOUND
    next_negative = False
    while True:
        index = _degree(tables, target, last_index, balanced=True)
        last_index = index
        if bound == init_bound:
            bound = index
        coefficients[index] = 1
        if next_negative:
            coefficients[index] *= -1
        if tables.degree_table[index] == target:
            if is_negative:
                for i in range(bound + 1):
                    coefficients[i] *= -1
            return coefficients[:bound + 1], bound + 1
        if tables.degree_table[index] > target:
            next_negative = not next_negative
            target = tables.degree_table[index] - target
        else:
            target = target - tables.degree_table[index]


def rationalize(x: float, base: int, precision: float) -> Tuple[int, int]:
    """Mirror rationalize (plaintext.go:269-312) operation-for-operation."""
    factor = math.floor(x)
    x = 1.0 + math.remainder(x, 1.0)
    if abs(x) > 1.0:
        x += 1.0
    if x >= 0.0:
        x -= float(int(x))
    elif x <= -0.0:
        x += float(int(x))
    num = 1.0
    powr = 1.0
    qmin = x - precision
    qmax = x + precision
    while True:
        denom = math.pow(base, powr)
        rat = num / denom
        if qmin <= rat <= qmax:
            while int(num) % base == 0:
                num = num / base
                powr -= 1
            denom = math.pow(base, powr)
            return int(factor * denom + num), int(powr)
        if num + 1 >= denom:
            num = 1.0
            powr += 1.0
        num += 1.0


def _encode_float(pk, m: float, balanced: bool) -> PolyPlaintext:
    tables = pk._encoding_tables
    if tables is None:
        raise RuntimeError("Encoding tables not computed!")
    pp = pk.poly_params
    if balanced and m < 0:
        raise ValueError("negative encodings not implemented")
    enc = balanced_encode if balanced else unbalanced_encode
    if math.remainder(m, 1.0) != 0.0:
        numerator, scale_factor = rationalize(
            m - math.floor(m), pp.fp_scale_base, pp.fp_precision)
        m_int = int(m)  # big.Float.Int truncates toward zero
        m_int = m_int * int(math.pow(pp.fp_scale_base, scale_factor))
        m_int += numerator
        coeffs, degree = enc(tables, m_int, pp.poly_base)
        return PolyPlaintext(pk, coeffs, degree, scale_factor)
    coeffs, degree = enc(tables, int(m), pp.poly_base)
    return PolyPlaintext(pk, coeffs, degree, 0)


def new_poly_plaintext(pk, m: float) -> PolyPlaintext:
    """Balanced encoding (NewPolyPlaintext, plaintext.go:67-103)."""
    return _encode_float(pk, float(m), balanced=True)


def new_unbalanced_plaintext(pk, m: float) -> PolyPlaintext:
    """Unbalanced encoding (NewUnbalancedPlaintext, plaintext.go:34-63)."""
    return _encode_float(pk, float(m), balanced=False)
