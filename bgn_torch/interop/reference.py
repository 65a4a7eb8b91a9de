"""Import/export of the Go reference's serialized artifacts.

The port's counterpart of `bgn_tpu/interop/reference.py`, on the port's
scheme, serialize and utils/convert, with the same gob bytes for the same
key and ciphertexts.

Wrapper structs (all gob-encoded by the reference):
  - ciphertextWrapper{CBytes []byte, L2 bool}            ciphertext.go:17-20
  - polyCiphertextWrapper{CoeffBytes [][]byte, Degree int,
        ScaleFactor int, L2 bool}                        ciphertext.go:34-39
  - publicKeyWrapper{G1, P, Q []byte, N, MsgSpace *big.Int,
        PairingParams string, Deterministic bool,
        PolyEncodingParams *PolyEncodingParams}          bgn.go:43-55
  - PolyEncodingParams{PolyBase, FPScaleBase int,
        FPPrecision float64}                             bgn.go:20-24

Element bytes use pbc's layout (interop/pbc.py); params strings use PBC's
a1 format.  `import_reference_key` / `load_reference_vectors` consume the
JSON that tools/dump_reference.go produces from a live sachaservan/bgn
checkout.

Loaders follow serialize.py: a key is built on `device` (default "cuda"),
a ciphertext loads only on its key's device (else ValueError), and
corrupt elements raise serialize.validate_*'s ValueError.
"""

from __future__ import annotations

import base64
import json
import os
from typing import List, Optional, Tuple

from .. import hostmath as hm
from .. import serialize as ser
from ..polyct import PolyCiphertext
from ..scheme import (BGNPublicKey, BGNSecretKey, Ciphertext,
                      PolyEncodingParams, _flat, public_key_from_parts)
from ..utils import convert
from . import gob, pbc

# -- gob schemas of the reference wrapper structs --

BIG_INT_T = gob.gob_encoder_type("Int")

CIPHERTEXT_WRAPPER_T = gob.struct_of("ciphertextWrapper", [
    ("CBytes", gob.BYTES_T),
    ("L2", gob.BOOL_T),
])

POLY_CIPHERTEXT_WRAPPER_T = gob.struct_of("polyCiphertextWrapper", [
    ("CoeffBytes", gob.slice_of(gob.BYTES_T)),
    ("Degree", gob.INT_T),
    ("ScaleFactor", gob.INT_T),
    ("L2", gob.BOOL_T),
])

POLY_ENCODING_PARAMS_T = gob.struct_of("PolyEncodingParams", [
    ("PolyBase", gob.INT_T),
    ("FPScaleBase", gob.INT_T),
    ("FPPrecision", gob.FLOAT_T),
])

PUBLIC_KEY_WRAPPER_T = gob.struct_of("publicKeyWrapper", [
    ("G1", gob.BYTES_T),
    ("P", gob.BYTES_T),
    ("Q", gob.BYTES_T),
    ("N", BIG_INT_T),
    ("MsgSpace", BIG_INT_T),
    ("PairingParams", gob.STRING_T),
    ("Deterministic", gob.BOOL_T),
    ("PolyEncodingParams", POLY_ENCODING_PARAMS_T),
])


# ---------------------------------------------------------------------------
# Element <-> host value helpers
# ---------------------------------------------------------------------------


def _element_bytes(pk: BGNPublicKey, ct: Ciphertext) -> List[bytes]:
    """Per-element pbc Element.Bytes of a ciphertext batch (flattened):
    points (the identity all zeros) at level 1, re||im at level 2."""
    ctx = pk.dev.ctx
    B = _flat(ct.batch_shape)
    if ct.level2:
        return [pbc.gt_to_bytes(z, pk.p) for z in
                convert.fp2_to_host(ctx, ct.data.reshape(2, ctx.L, B))]
    return [pbc.point_to_bytes(P, pk.p) for P in
            convert.affine_to_host(ctx, ct.reshape((B,)).data)]


def _ct_from_element_bytes(pk: BGNPublicKey, blobs: List[bytes],
                           level2: bool, device) -> Ciphertext:
    ser._key_device(pk, device)
    ctx = pk.dev.ctx
    if level2:
        zs = [pbc.gt_from_bytes(b, pk.p) for b in blobs]
        # reject corrupt imports at the boundary; the reference's SetBytes
        # (bgn.go:517-524) cannot
        ser.validate_gt_values(pk, [z[0] for z in zs], [z[1] for z in zs])
        return Ciphertext(convert.fp2_from_host(ctx, zs), True)
    pts = [pbc.point_from_bytes(b, pk.p) for b in blobs]
    ser.validate_g1_values(pk,
                           [0 if P is None else P[0] for P in pts],
                           [0 if P is None else P[1] for P in pts],
                           [P is None for P in pts])
    return Ciphertext(convert.affine_from_host(ctx, pts), False)


# ---------------------------------------------------------------------------
# Ciphertexts (reference Ciphertext.Bytes / NewCiphertextFromBytes)
# ---------------------------------------------------------------------------


def ciphertext_to_gob(pk: BGNPublicKey, ct: Ciphertext) -> List[bytes]:
    """Each batch element -> one reference-layout gob blob, byte-compatible
    with Ciphertext.Bytes (ciphertext.go:76-90): the reference type holds
    a single element, so a batch exports to a list of blobs."""
    return [gob.dumps(CIPHERTEXT_WRAPPER_T, {"CBytes": eb, "L2": ct.level2})
            for eb in _element_bytes(pk, ct)]


def ciphertext_from_gob(pk: BGNPublicKey, blobs,
                        device="cuda") -> Ciphertext:
    """Reference gob blob(s) -> a ciphertext batch on `device`, the key's
    (the analog of NewCiphertextFromBytes, bgn.go:501-526)."""
    if isinstance(blobs, (bytes, bytearray)):
        blobs = [blobs]
    if not blobs or any(len(b) == 0 for b in blobs):
        raise ValueError("no data provided")
    ws = [gob.loads(bytes(b)) for b in blobs]
    l2s = {bool(w["L2"]) for w in ws}
    if len(l2s) != 1:
        raise ValueError("mixed ciphertext levels in one batch")
    return _ct_from_element_bytes(pk, [w["CBytes"] for w in ws], l2s.pop(),
                                  device)


def poly_ciphertext_to_gob(pk: BGNPublicKey, pct: PolyCiphertext) -> bytes:
    """PolyCiphertext -> gob blob (PolyCiphertext.Bytes,
    ciphertext.go:94-116): coefficient elements in pbc layout."""
    return gob.dumps(POLY_CIPHERTEXT_WRAPPER_T, {
        "CoeffBytes": _element_bytes(pk, pct.ct),
        "Degree": pct.degree,
        "ScaleFactor": pct.scale_factor,
        "L2": pct.ct.level2,
    })


def poly_ciphertext_from_gob(pk: BGNPublicKey, data: bytes,
                             device="cuda") -> PolyCiphertext:
    """gob blob -> PolyCiphertext on `device`, the key's
    (NewPolyCiphertextFromBytes, bgn.go:530-560)."""
    if len(data) == 0:
        raise ValueError("no data provided")
    w = gob.loads(bytes(data))
    ct = _ct_from_element_bytes(pk, w["CoeffBytes"], bool(w["L2"]), device)
    return PolyCiphertext(ct, int(w["Degree"]), int(w["ScaleFactor"]))


# ---------------------------------------------------------------------------
# Public keys (reference MarshalBinary / UnmarshalBinary)
# ---------------------------------------------------------------------------


def _key_gob(p: int, n: int, l: int, P_host, Q_host, msg_space: int,
             deterministic: bool, poly_params: PolyEncodingParams) -> bytes:
    """The publicKeyWrapper blob of a key's host parts.  G1 is the
    reference's group-context element (a fresh zero element, i.e. the
    all-zero point)."""
    elen = pbc.element_length_in_bytes(p)
    return gob.dumps(PUBLIC_KEY_WRAPPER_T, {
        "G1": b"\x00" * (2 * elen),
        "P": pbc.point_to_bytes(P_host, p),
        "Q": pbc.point_to_bytes(Q_host, p),
        "N": gob.big_int_gob_encode(n),
        "MsgSpace": gob.big_int_gob_encode(msg_space),
        "PairingParams": pbc.a1_params_to_str(p, n, l),
        "Deterministic": deterministic,
        "PolyEncodingParams": {
            "PolyBase": poly_params.poly_base,
            "FPScaleBase": poly_params.fp_scale_base,
            "FPPrecision": poly_params.fp_precision,
        },
    })


def public_key_to_gob(pk: BGNPublicKey) -> bytes:
    """BGNPublicKey -> reference-layout gob blob (PublicKey.MarshalBinary,
    bgn.go:597-622)."""
    return _key_gob(pk.p, pk.n, pk.l, pk.P_host, pk.Q_host, pk.msg_space,
                    pk.deterministic, pk.poly_params)


def _key_parts_from_gob(data: bytes) -> dict:
    """Reference gob blob -> public_key_from_parts' keyword arguments:
    the params string gives (p, n, l) -- including the l the reference
    itself recovers via parseLFromPBCParams -- and P/Q arrive as pbc
    element bytes.  Host ints only; public_key_from_parts validates."""
    w = gob.loads(bytes(data))
    p, n, l = pbc.parse_a1_params_str(w["PairingParams"])
    if gob.big_int_gob_decode(w["N"]) != n:
        raise ValueError("public key N disagrees with pairing params n")
    P_host = pbc.point_from_bytes(w["P"], p)
    Q_host = pbc.point_from_bytes(w["Q"], p)
    if P_host is None or Q_host is None:
        raise ValueError("public key generators cannot be the identity")
    pep = w["PolyEncodingParams"]
    return dict(
        key_bits=n.bit_length(), n=n, l=l, p=p,
        msg_space=gob.big_int_gob_decode(w["MsgSpace"]),
        deterministic=bool(w["Deterministic"]),
        poly_params=PolyEncodingParams(int(pep["PolyBase"]),
                                       int(pep["FPScaleBase"]),
                                       float(pep["FPPrecision"])),
        P_host=P_host, Q_host=Q_host)


def public_key_from_gob(data: bytes, device="cuda") -> BGNPublicKey:
    """Reference gob blob -> BGNPublicKey on `device`
    (PublicKey.UnmarshalBinary, bgn.go:626-666)."""
    return public_key_from_parts(**_key_parts_from_gob(data), device=device)


# ---------------------------------------------------------------------------
# Conformance vectors (tools/dump_reference.go output)
# ---------------------------------------------------------------------------


def _reference_parts(vec: dict) -> Tuple[dict, BGNSecretKey]:
    """A vector file's public key parts and secret key, host only.

    The secret side needs (q1, R): q1 is sk.Key, q2 = n/q1, and the
    params string supplies (p, n, l)."""
    parts = _key_parts_from_gob(base64.b64decode(vec["public_key_gob"]))
    n = parts["n"]
    q1 = int(vec["q1"], 16)
    if n % q1 != 0:
        raise ValueError("q1 does not divide n")
    params = hm.A1Params(q1=q1, q2=n // q1, n=n, l=parts["l"],
                         p=parts["p"])
    sk = BGNSecretKey(params, int(vec["r"], 16),
                      parts["poly_params"].poly_base)
    return parts, sk


def import_reference_key(vec: dict, device="cuda"
                         ) -> Tuple[BGNPublicKey, BGNSecretKey]:
    """Build a full (pk, sk) pair from a dump_reference.go vector file,
    the public key on `device`."""
    parts, sk = _reference_parts(vec)
    return public_key_from_parts(**parts, device=device), sk


def load_reference_vectors(path) -> Optional[dict]:
    """Load a dump_reference.go JSON vector file; None if absent."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)
