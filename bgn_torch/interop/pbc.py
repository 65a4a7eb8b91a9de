"""PBC byte/string codecs: the formats Stanford PBC 0.5.14 produces and the
reference consumes.  The port's copy of `bgn_tpu/interop/pbc.py` (host
ints only, no tensors).

Two artifacts:

  1. The type-A1 params string ("PairingParams" in the reference public
     key, produced by pbc.GenerateA1 at bgn.go:93 and string-parsed for
     `l` at bgn.go:583-593).  PBC's a1_out_str prints:

         type a1
         p <decimal>
         n <decimal>
         l <decimal>

     one "key value\\n" line per field, decimal mpz values.  The
     reference's parseLFromPBCParams takes the substring after the first
     'l' + 2 through len-1, i.e. it relies on exactly this layout and the
     trailing newline.

  2. Element bytes (pbc element_to_bytes, consumed via SetBytes at
     bgn.go:517-524 and produced via Bytes at bgn.go:606-608,
     ciphertext.go:79): every F_p coordinate is a fixed-width big-endian
     integer of ceil(bits(p)/8) bytes; a G1 curve point is x||y; a GT
     element (F_p^2 = F_p[i]/(i^2+1), p == 3 mod 4) is re||im.

     PBC quirk: curve_to_bytes writes whatever x, y a point holds and
     curve_from_bytes unconditionally clears the infinity flag (pbc
     ecc/curve.c), so the identity serializes as all-zero bytes and
     deserializes as the 2-torsion point (0, 0) on y^2 = x^3 + x.  We
     encode O as all-zero and map all-zero back to O: BGN never encrypts
     to the (0, 0) point (it lies outside the order-n subgroup), so the
     mapping is unambiguous for scheme data.
"""

from __future__ import annotations

from typing import Tuple

from ..hostmath import Point


# ---------------------------------------------------------------------------
# A1 params string
# ---------------------------------------------------------------------------


def a1_params_to_str(p: int, n: int, l: int) -> str:
    """Exactly PBC's a1_out_str layout (consumed by bgn.go:583-593)."""
    return f"type a1\np {p}\nn {n}\nl {l}\n"


def parse_a1_params_str(s: str) -> Tuple[int, int, int]:
    """Parse a type-A1 params string -> (p, n, l).

    Accepts exactly what PBC emits (and therefore what reference public
    keys carry in PairingParams, bgn.go:35)."""
    fields = {}
    typ = None
    for line in s.splitlines():
        line = line.strip()
        if not line:
            continue
        key, _, val = line.partition(" ")
        if key == "type":
            typ = val.strip()
        else:
            fields[key] = int(val)
    if typ != "a1":
        raise ValueError(f"not a type-a1 params string (type={typ!r})")
    missing = {"p", "n", "l"} - fields.keys()
    if missing:
        raise ValueError(f"params string missing fields: {sorted(missing)}")
    p, n, l = fields["p"], fields["n"], fields["l"]
    if p != l * n - 1:
        raise ValueError("inconsistent a1 params: p != l*n - 1")
    return p, n, l


def parse_l_from_params(s: str) -> int:
    """The reference's parseLFromPBCParams (bgn.go:583-593), faithfully:
    substring after the first 'l' + 2 through the last char (the trailing
    newline)."""
    idx = s.index("l")
    return int(s[idx + 2:len(s) - 1])


# ---------------------------------------------------------------------------
# Element bytes
# ---------------------------------------------------------------------------


def element_length_in_bytes(p: int) -> int:
    """PBC element_length_in_bytes for F_p: ceil(bits(p)/8)."""
    return (p.bit_length() + 7) // 8


def fp_to_bytes(x: int, p: int) -> bytes:
    if not 0 <= x < p:
        raise ValueError("coordinate out of range")
    return x.to_bytes(element_length_in_bytes(p), "big")


def fp_from_bytes(data: bytes, p: int) -> int:
    x = int.from_bytes(data, "big")
    if x >= p:
        raise ValueError("coordinate out of range")
    return x


def point_to_bytes(P: Point, p: int) -> bytes:
    """G1 point -> x||y fixed-width big-endian (pbc curve_to_bytes); the
    identity encodes as all zeros (see module docstring)."""
    if P is None:
        return b"\x00" * (2 * element_length_in_bytes(p))
    return fp_to_bytes(P[0], p) + fp_to_bytes(P[1], p)


def point_from_bytes(data: bytes, p: int) -> Point:
    elen = element_length_in_bytes(p)
    if len(data) != 2 * elen:
        raise ValueError(
            f"point bytes must be {2 * elen} bytes, got {len(data)}")
    x = fp_from_bytes(data[:elen], p)
    y = fp_from_bytes(data[elen:], p)
    if x == 0 and y == 0:
        return None
    return (x, y)


def gt_to_bytes(z: Tuple[int, int], p: int) -> bytes:
    """GT (F_p^2) element -> re||im (pbc fi-field element_to_bytes)."""
    return fp_to_bytes(z[0], p) + fp_to_bytes(z[1], p)


def gt_from_bytes(data: bytes, p: int) -> Tuple[int, int]:
    elen = element_length_in_bytes(p)
    if len(data) != 2 * elen:
        raise ValueError(
            f"GT bytes must be {2 * elen} bytes, got {len(data)}")
    return (fp_from_bytes(data[:elen], p), fp_from_bytes(data[elen:], p))
