"""Serialization of keys and ciphertext batches (reference: gob wrappers,
bgn.go:595-666, ciphertext.go:76-116, bgn.go:501-560).

The port's counterpart of `bgn_tpu/serialize.py`, with the same formats,
so that a file written by either package loads in the other: keys as JSON
(hex ints, format version 1), ciphertext batches as npz of canonical
(non-Montgomery) 16-bit limbs stored as uint32, the identity flags of a
level-1 batch as uint32 and the level flag as int32.  The port keeps int64
inside and casts at the file boundary.  The Montgomery scaling at the
boundary runs on host ints.

Canonical element bytes (point_bytes, gt_bytes) are fixed-width
big-endian x||y / re||im, the analog of pbc's Element.Bytes.

Loaders take `device=` (default "cuda"), which must be the key's device.
"""

from __future__ import annotations

import io
import json
from typing import Tuple

import numpy as np
import torch

from . import hostmath as hm
from .fieldcore import limbs as lb
from .ops.curve import AffinePoint
from .polyct import PolyCiphertext
from .scheme import (BGNPublicKey, BGNSecretKey, Ciphertext,
                     PolyEncodingParams, public_key_from_parts)

_FORMAT_VERSION = 1


# ---------------------------------------------------------------------------
# Canonical element bytes
# ---------------------------------------------------------------------------


def coord_nbytes(pk: BGNPublicKey) -> int:
    return 2 * pk.dev.ctx.L  # 16-bit limbs -> 2 bytes each


def point_bytes(pk: BGNPublicKey, P) -> bytes:
    """Canonical bytes of a host point: x||y big-endian; O = all zeros."""
    nb = coord_nbytes(pk)
    if P is None:
        return b"\x00" * (2 * nb)
    return P[0].to_bytes(nb, "big") + P[1].to_bytes(nb, "big")


def gt_bytes(pk: BGNPublicKey, z: Tuple[int, int]) -> bytes:
    nb = coord_nbytes(pk)
    return z[0].to_bytes(nb, "big") + z[1].to_bytes(nb, "big")


# ---------------------------------------------------------------------------
# Keys
# ---------------------------------------------------------------------------


def public_key_to_json(pk: BGNPublicKey) -> str:
    """Analog of PublicKey.MarshalBinary (bgn.go:597-622)."""
    return json.dumps({
        "version": _FORMAT_VERSION,
        "key_bits": pk.key_bits,
        "n": hex(pk.n),
        "l": hex(pk.l),
        "p": hex(pk.p),
        "msg_space": pk.msg_space,
        "deterministic": pk.deterministic,
        "poly_base": pk.poly_params.poly_base,
        "fp_scale_base": pk.poly_params.fp_scale_base,
        "fp_precision": pk.poly_params.fp_precision,
        "P": [hex(pk.P_host[0]), hex(pk.P_host[1])],
        "Q": [hex(pk.Q_host[0]), hex(pk.Q_host[1])],
        # the Miller digit encoding keygen chose ("naf"/"bits"), replayed
        # on load so both views of the key run the same chain
        "n_digits": pk.n_digits_kind,
    })


def public_key_from_json(s: str, device="cuda") -> BGNPublicKey:
    """Analog of PublicKey.UnmarshalBinary (bgn.go:626-666): rebuilds the
    whole device key on `device` from the serialized parts (validated)."""
    d = json.loads(s)
    if d["version"] != _FORMAT_VERSION:
        raise ValueError("unsupported key format version")
    return public_key_from_parts(
        key_bits=d["key_bits"], n=int(d["n"], 16), l=int(d["l"], 16),
        p=int(d["p"], 16), msg_space=d["msg_space"],
        deterministic=d["deterministic"],
        poly_params=PolyEncodingParams(d["poly_base"], d["fp_scale_base"],
                                       d["fp_precision"]),
        P_host=tuple(int(v, 16) for v in d["P"]),
        Q_host=tuple(int(v, 16) for v in d["Q"]),
        n_digits=d.get("n_digits"), device=device)


def secret_key_to_json(sk: BGNSecretKey) -> str:
    a1 = sk.a1_params
    return json.dumps({
        "version": _FORMAT_VERSION,
        "q1": hex(a1.q1), "q2": hex(a1.q2), "n": hex(a1.n),
        "l": hex(a1.l), "p": hex(a1.p),
        "r": hex(sk.r), "poly_base": sk.poly_base,
    })


def secret_key_from_json(s: str) -> BGNSecretKey:
    d = json.loads(s)
    if d["version"] != _FORMAT_VERSION:
        raise ValueError("unsupported key format version")
    params = hm.A1Params(q1=int(d["q1"], 16), q2=int(d["q2"], 16),
                         n=int(d["n"], 16), l=int(d["l"], 16),
                         p=int(d["p"], 16))
    return BGNSecretKey(params, int(d["r"], 16), d["poly_base"])


# ---------------------------------------------------------------------------
# Ciphertexts
# ---------------------------------------------------------------------------


def _key_device(pk: BGNPublicKey, device) -> torch.device:
    """The key's device, which `device` must name."""
    want, have = torch.device(device), pk.dev.n_naf.device
    if want.type != have.type or (want.index is not None
                                  and want.index != have.index):
        raise ValueError(f"the key lives on {have}, not on {want}")
    return have


def _mont_scale_limbs(pk: BGNPublicKey, a: np.ndarray, factor: int
                      ) -> np.ndarray:
    """x -> x*factor mod p over a [L, *batch] limb array, on host ints;
    uint32 limbs out (the file's dtype)."""
    L = a.shape[0]
    vals = [v * factor % pk.p for v in lb.limbs_to_ints(a.reshape(L, -1))]
    return lb.ints_to_limbs(vals, L).reshape(a.shape).astype(np.uint32)


def _radix(pk: BGNPublicKey) -> int:
    return 1 << (lb.LIMB_BITS * pk.dev.ctx.L)


def _from_mont_np(pk: BGNPublicKey, a: torch.Tensor) -> np.ndarray:
    return _mont_scale_limbs(pk, a.cpu().numpy(), pow(_radix(pk), -1, pk.p))


def _to_mont_dev(pk: BGNPublicKey, a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(
        _mont_scale_limbs(pk, a, _radix(pk) % pk.p).astype(np.int64),
        device=device)


def ciphertext_to_bytes(pk: BGNPublicKey, ct: Ciphertext) -> bytes:
    """Analog of Ciphertext.Bytes (ciphertext.go:76-90): npz of canonical
    limb arrays + level flag."""
    buf = io.BytesIO()
    if ct.level2:
        np.savez(buf, level2=np.int32(1),
                 re=_from_mont_np(pk, ct.data[0]),
                 im=_from_mont_np(pk, ct.data[1]))
    else:
        np.savez(buf, level2=np.int32(0),
                 x=_from_mont_np(pk, ct.data.x),
                 y=_from_mont_np(pk, ct.data.y),
                 inf=ct.data.inf.cpu().numpy().astype(np.uint32))
    return buf.getvalue()


def validate_g1_values(pk: BGNPublicKey, xs, ys, infs) -> None:
    """Load-time checks for level-1 points: coordinates < p and on the
    curve (the reference's SetBytes, bgn.go:517-524, accepts anything).
    The order-n subgroup check is out of scope (a scalar mult per
    element)."""
    p = pk.p
    for i, (x, y, inf) in enumerate(zip(xs, ys, infs)):
        if inf:
            continue
        if not (0 <= x < p and 0 <= y < p):
            raise ValueError(f"ciphertext[{i}]: coordinate >= p")
        if (y * y - (x * x * x + x)) % p != 0:
            raise ValueError(f"ciphertext[{i}]: point not on the curve")


def validate_gt_values(pk: BGNPublicKey, res, ims) -> None:
    """Load-time checks for level-2 (GT) values: coordinates < p and
    norm(z) == 1 (GT lies in the unitary subgroup of F_p^2; a corrupted
    element fails this with overwhelming probability)."""
    p = pk.p
    for i, (re, im) in enumerate(zip(res, ims)):
        if not (0 <= re < p and 0 <= im < p):
            raise ValueError(f"ciphertext[{i}]: GT coordinate >= p")
        if (re * re + im * im) % p != 1:
            raise ValueError(f"ciphertext[{i}]: GT value not unitary "
                             "(corrupt or not a pairing value)")


def ciphertext_from_bytes(pk: BGNPublicKey, data: bytes,
                          validate: bool = True,
                          device="cuda") -> Ciphertext:
    """Analog of NewCiphertextFromBytes (bgn.go:501-526): the batch on
    `device` (the key's), Montgomery form, int64.  validate=True rejects
    off-curve, out-of-range and non-unitary material."""
    device = _key_device(pk, device)
    if len(data) == 0:
        raise ValueError("no data provided")
    z = np.load(io.BytesIO(data))
    L = pk.dev.ctx.L
    if int(z["level2"]):
        if validate:
            validate_gt_values(pk, lb.limbs_to_ints(z["re"].reshape(L, -1)),
                               lb.limbs_to_ints(z["im"].reshape(L, -1)))
        return Ciphertext(torch.stack([_to_mont_dev(pk, z["re"], device),
                                       _to_mont_dev(pk, z["im"], device)]),
                          True)
    if validate:
        validate_g1_values(pk, lb.limbs_to_ints(z["x"].reshape(L, -1)),
                           lb.limbs_to_ints(z["y"].reshape(L, -1)),
                           np.asarray(z["inf"]).reshape(-1))
    inf = torch.as_tensor(np.asarray(z["inf"]).astype(np.int64),
                          device=device)
    return Ciphertext(AffinePoint(_to_mont_dev(pk, z["x"], device),
                                  _to_mont_dev(pk, z["y"], device), inf),
                      False)


def poly_ciphertext_to_bytes(pk: BGNPublicKey, pct: PolyCiphertext) -> bytes:
    """Analog of PolyCiphertext.Bytes (ciphertext.go:94-116)."""
    inner = ciphertext_to_bytes(pk, pct.ct)
    buf = io.BytesIO()
    np.savez(buf, degree=np.int32(pct.degree),
             scale_factor=np.int32(pct.scale_factor),
             ct=np.frombuffer(inner, dtype=np.uint8))
    return buf.getvalue()


def poly_ciphertext_from_bytes(pk: BGNPublicKey, data: bytes,
                               validate: bool = True,
                               device="cuda") -> PolyCiphertext:
    """Analog of NewPolyCiphertextFromBytes (bgn.go:530-560)."""
    if len(data) == 0:
        raise ValueError("no data provided")
    z = np.load(io.BytesIO(data))
    ct = ciphertext_from_bytes(pk, z["ct"].tobytes(), validate=validate,
                               device=device)
    return PolyCiphertext(ct, int(z["degree"]), int(z["scale_factor"]))
