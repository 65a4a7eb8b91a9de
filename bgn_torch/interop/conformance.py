"""Conformance verification against reference-produced vectors.

The port's counterpart of `bgn_tpu/interop/conformance.py`.
`verify_reference_vectors` consumes the JSON tools/dump_reference.go dumps
from a live sachaservan/bgn checkout and checks, byte for byte:

  1. the public key round-trips through the gob/PBC codecs and its
     (p, n, l, P, Q) satisfy the A1 invariants;
  2. e(P, P) -- PBC's Tate pairing output -- equals the pairing of the
     hostmath golden model;
  3. every (m, r) encryption vector reproduces the reference's exact
     ciphertext bytes (EncryptWithRandomness, bgn.go:340-353);
  4. every deterministic homomorphic-op vector (Add/Mult/MultConst/Neg)
     reproduces the reference's exact result bytes;
  5. every ciphertext decrypts to the reference's decrypted value.

With device=None every check runs on the host (exact ints, no tensor is
built); device="cuda" (or "cpu") also builds the key there and re-runs
the encryption vectors through encrypt_with_randomness on that device
(the dual_ladder kernel on the card).  There is no fallback between
devices, and a failed device check raises like any other.
"""

from __future__ import annotations

import base64
import random

from .. import hostmath as hm
from ..scheme import PolyEncodingParams, public_key_from_parts, \
    validate_public_key_parts
from . import pbc
from .reference import _element_bytes, _key_gob, _reference_parts


class ConformanceError(AssertionError):
    pass


def _check(cond, msg):
    if not cond:
        raise ConformanceError(msg)


def verify_reference_vectors(vec: dict, device=None) -> dict:
    """Run all conformance checks; returns {check_name: count} on success,
    raises ConformanceError on the first mismatch."""
    counts = {}
    parts, sk = _reference_parts(vec)
    validate_public_key_parts(parts["n"], parts["l"], parts["p"],
                              parts["P_host"], parts["Q_host"])
    params = sk.a1_params
    p, n = params.p, params.n
    P, Q = parts["P_host"], parts["Q_host"]

    # 1. key material invariants + byte round-trip
    _check(p == parts["l"] * n - 1, "p != l*n - 1")
    _check(hm.is_probable_prime(params.q1), "q1 not prime")
    _check(hm.is_probable_prime(params.q2), "q2 not prime")
    _check(hm.on_curve(P, p), "P not on curve")
    _check(hm.on_curve(Q, p), "Q not on curve")
    _check(hm.ec_mul(n, P, p) is None, "P not of order | n")
    _check(hm.ec_mul(params.q1, Q, p) is None, "Q not of order | q1")
    _check(pbc.point_to_bytes(P, p) == bytes.fromhex(vec["p_bytes_hex"]),
           "P bytes mismatch")
    _check(pbc.point_to_bytes(Q, p) == bytes.fromhex(vec["q_bytes_hex"]),
           "Q bytes mismatch")
    # Q = (P^R)^q2 (bgn.go:116-119)
    _check(hm.ec_mul(params.q2 * sk.r % n, P, p) == Q, "Q != (P^R)^q2")
    counts["key"] = 1

    # 2. the pairing itself vs PBC
    gt_gen = hm.tate_pairing(P, P, params)
    _check(pbc.gt_to_bytes(gt_gen, p) == bytes.fromhex(
        vec["gt_gen_bytes_hex"]),
        "e(P, P) differs from PBC's Tate pairing")
    counts["pairing"] = 1

    # 3. encryption vectors
    gk = hm.GoldenKey(params=params, P=P, Q=Q, R=sk.r,
                      msg_space=parts["msg_space"])
    cts = []
    for i, cv in enumerate(vec["ciphertexts"]):
        m, r = int(cv["m"]), int(cv["r"], 16)
        C = hm.golden_encrypt(gk, m, r)
        cts.append(C)
        _check(not cv["l2"], f"vector {i}: expected level-1 ciphertext")
        _check(pbc.point_to_bytes(C, p) == bytes.fromhex(cv["bytes_hex"]),
               f"vector {i}: ciphertext bytes mismatch (m={m})")
        got = hm.golden_decrypt_l1(gk, C)
        _check(got == int(cv["decrypted"]),
               f"vector {i}: decrypt {got} != {cv['decrypted']}")
    counts["encrypt"] = len(vec["ciphertexts"])

    # 4. homomorphic op vectors (deterministic mode)
    for i, ov in enumerate(vec.get("ops", [])):
        got = _golden_op(gk, cts, ov)
        want = bytes.fromhex(ov["bytes_hex"])
        if ov["l2"]:
            _check(pbc.gt_to_bytes(got, p) == want,
                   f"op {i} ({ov['op']}): GT bytes mismatch")
        else:
            _check(pbc.point_to_bytes(got, p) == want,
                   f"op {i} ({ov['op']}): point bytes mismatch")
    counts["ops"] = len(vec.get("ops", []))

    if device is not None:
        pk = public_key_from_parts(**parts, device=device)
        counts["device_encrypt"] = _verify_device(vec, pk)
    return counts


def _golden_op(gk: hm.GoldenKey, cts, ov):
    """Deterministic-mode reference op semantics on host values."""
    p = gk.params.p
    op, a, b = ov["op"], ov["a"], ov["b"]
    if op == "add":
        return hm.ec_add(cts[a], cts[b], p)
    if op == "mult":
        return hm.tate_pairing(cts[a], cts[b], gk.params)
    if op == "mult_const":
        return hm.ec_mul(b, cts[a], p)
    if op == "neg":
        return hm.ec_neg(cts[a], p)
    if op == "make_l2_add":
        # Add(Mult(ct_a, ct_b), ct_3): the L1 side promotes via
        # makeL2 = e(C, P) (bgn.go:316-321), then GT multiply
        prod = hm.tate_pairing(cts[a], cts[b], gk.params)
        lifted = hm.tate_pairing(cts[3], gk.P, gk.params)
        return hm.fp2_mul(prod, lifted, p)
    raise ConformanceError(f"unknown op {op!r}")


def _verify_device(vec: dict, pk) -> int:
    """Re-run the encryption vectors through encrypt_with_randomness on
    the key's device and compare pbc bytes."""
    ms = [int(cv["m"]) for cv in vec["ciphertexts"]]
    rs = [int(cv["r"], 16) for cv in vec["ciphertexts"]]
    blobs = _element_bytes(pk, pk.encrypt_with_randomness(ms, rs))
    for i, cv in enumerate(vec["ciphertexts"]):
        _check(blobs[i] == bytes.fromhex(cv["bytes_hex"]),
               f"vector {i}: device ciphertext bytes mismatch")
    return len(ms)


def synthesize_vectors(key_bits: int = 64, msg_space: int = 101,
                       seed: int = 20260818,
                       rng=None) -> dict:
    """Produce a vectors dict in the exact dump_reference.go layout from
    the golden model, on the host -- the format-level stand-in until real
    Go-produced fixtures are dropped in (see tools/dump_reference.go)."""
    rng = rng or random.Random(seed)
    gk = hm.golden_keygen(key_bits, msg_space, rng)
    params = gk.params
    p = params.p

    ms = [0, 1, 2, msg_space // 2, msg_space - 1, 7, 23]
    cts, ct_vecs = [], []
    for i, m in enumerate(ms):
        r = pow(1000003, i + 1, params.n)
        C = hm.golden_encrypt(gk, m, r)
        cts.append(C)
        ct_vecs.append({
            "m": str(m), "r": format(r, "x"), "l2": False,
            "bytes_hex": pbc.point_to_bytes(C, p).hex(),
            "gob_base64": "",
            "decrypted": str(hm.golden_decrypt_l1(gk, C)),
        })

    def op(name, a, b, val, l2):
        enc = pbc.gt_to_bytes if l2 else pbc.point_to_bytes
        return {"op": name, "a": a, "b": b, "l2": l2,
                "bytes_hex": enc(val, p).hex()}

    ops = [
        op("add", 1, 2, hm.ec_add(cts[1], cts[2], p), False),
        op("add", 3, 4, hm.ec_add(cts[3], cts[4], p), False),
        op("mult", 1, 2, hm.tate_pairing(cts[1], cts[2], params), True),
        op("mult", 5, 6, hm.tate_pairing(cts[5], cts[6], params), True),
        op("mult_const", 5, 9, hm.ec_mul(9, cts[5], p), False),
        op("neg", 6, 0, hm.ec_neg(cts[6], p), False),
        op("make_l2_add", 1, 2,
           hm.fp2_mul(hm.tate_pairing(cts[1], cts[2], params),
                      hm.tate_pairing(cts[3], gk.P, params), p), True),
    ]
    key_gob = _key_gob(p, params.n, params.l, gk.P, gk.Q, msg_space, True,
                       PolyEncodingParams(3, 3, 0.0001))
    return {
        "key_bits": key_bits, "msg_space": msg_space,
        "poly_base": 3, "fp_scale_base": 3, "fp_precision": 0.0001,
        "pairing_params": pbc.a1_params_to_str(p, params.n, params.l),
        "n": format(params.n, "x"),
        "q1": format(params.q1, "x"), "q2": format(params.q2, "x"),
        "r": format(gk.R, "x"),
        "p_bytes_hex": pbc.point_to_bytes(gk.P, p).hex(),
        "q_bytes_hex": pbc.point_to_bytes(gk.Q, p).hex(),
        "gt_gen_bytes_hex": pbc.gt_to_bytes(gk.gt_base(), p).hex(),
        "public_key_gob": base64.b64encode(key_gob).decode(),
        "ciphertexts": ct_vecs,
        "ops": ops,
    }
