"""Sigma-protocol ZK gadgets (reference gadgets.go), batched.

The port's counterpart of `bgn_tpu/gadgets.py`:
  - DecryptionProof {Value, Randomness}: verified by re-encryption
    equality (gadgets.go:17-28, 57-61).
  - ProofOfPlaintextKnowledge {Ct, Nonce, DL}: Schnorr-style with the
    Fiat-Shamir challenge c = SHA-256(ct_bytes || nonce_bytes)
    (gadgets.go:80-96); the prover needs sk (it uses sk.R, sk.Key and
    N/q1, gadgets.go:45-48 -- a reference quirk kept here).
    Verify: P^DL == ct^c * nonce (gadgets.go:65-77).

The digest runs where the points live (ops/sha256.py) over bytes equal
to serialize.point_bytes; the group arithmetic runs batched on the key's
device, through the ported kernels (dual_ladder for the encryptions,
window_ladder_tab and pow_loop for the RNS verify, mont_mul for the
digest's Montgomery exit and the limb verify).

Two choices differ from the JAX package (ROADMAP.md, "Divergences"):
  - the verify reduces each DL mod n (Python's %) before its digits, so a
    negative DL means P^(DL mod n); the JAX package drops the sign and
    verifies P^|DL| (bgn_tpu/gadgets.py:182);
  - the fused verify, which walks the digest's 256 bits unreduced, runs
    only when n > 2^256, where c < n; other keys verify on c mod n, so
    every route gives the limb verify's answer for every input
    (bgn_tpu/gadgets.py:257-263 takes the fused route for every key).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch

from . import serialize
from .fieldcore import limbs as lb
from .fieldcore import montgomery as mg
from .fieldcore import rns as rn
from .ops import curve
from .ops import pairing as pairing_mod
from .ops import rns_pairing
from .ops.curve import AffinePoint
from .ops.sha256 import pad_words, sha256_words
from .scheme import (BGNPublicKey, BGNSecretKey, Ciphertext,
                     PublicDeviceKey, _rand_below, _signed_bits,
                     _signed_digits)

# Verify calls per route ("fused", "rns": the RNS core with the digest
# fused in or on c mod n; "limb": the complete limb verify, whether
# chosen or as the fallback of a batch with a suspicious lane).
route_counts = {"fused": 0, "rns": 0, "limb": 0}


@dataclass
class DecryptionProof:
    """Reference DecryptionProof (gadgets.go:18-21); batched."""

    values: List[int]
    randomness: List[int]


@dataclass
class ProofOfPlaintextKnowledge:
    """Reference ProofOfPlaintextKnowledge (gadgets.go:10-14); batched."""

    ct: Ciphertext
    nonce: Ciphertext
    dl: List[int]


def new_decryption_proof(vs: Sequence[int],
                         rs: Sequence[int]) -> DecryptionProof:
    """NewDecryptionProof (gadgets.go:24-28)."""
    return DecryptionProof(list(map(int, vs)), list(map(int, rs)))


def check_decryption_proof(pk: BGNPublicKey, ct: Ciphertext,
                           proof: DecryptionProof) -> np.ndarray:
    """CheckDecryptionProof (gadgets.go:57-61): re-encrypt and compare."""
    enc = pk.encrypt_with_randomness(proof.values, proof.randomness)
    return curve.eq_affine(ct.data, enc.data).cpu().numpy().astype(bool)


def _fiat_shamir(pk: BGNPublicKey, ct: Ciphertext,
                 nonce: Ciphertext) -> List[int]:
    """c = SHA-256(ct_bytes || nonce_bytes) per batch element (hash(),
    gadgets.go:80-96): the digest on the key's device (_fs_digest) when L
    is even, only the 32-byte digests read back; else on the host."""
    if pk.dev.ctx.L % 2 == 0:
        words = _fs_digest(pk.dev, ct.data, nonce.data).cpu().numpy()
        return [int.from_bytes(row.astype(">u4").tobytes(), "big")
                for row in words]
    return _fiat_shamir_host(pk, ct, nonce)


def _fiat_shamir_host(pk: BGNPublicKey, ct: Ciphertext,
                      nonce: Ciphertext) -> List[int]:
    """The digest by hashlib over serialize.point_bytes' layout (odd limb
    counts); one stacked readback."""
    ctx = pk.dev.ctx
    L = ctx.L
    arr = torch.cat([ct.data.x, ct.data.y, nonce.data.x, nonce.data.y],
                    dim=0).cpu().numpy()
    p = ctx.p_host
    rinv = pow(1 << (lb.LIMB_BITS * L), -1, p)
    nb = serialize.coord_nbytes(pk)
    planes = [[v * rinv % p for v in lb.limbs_to_ints(arr[i * L:(i + 1) * L])]
              for i in range(4)]
    out = []
    for cx, cy, nx, ny in zip(*planes):
        h = hashlib.sha256()
        h.update(cx.to_bytes(nb, "big") + cy.to_bytes(nb, "big"))
        h.update(nx.to_bytes(nb, "big") + ny.to_bytes(nb, "big"))
        out.append(int.from_bytes(h.digest(), "big"))
    return out


def _fs_digest(dev: PublicDeviceKey, ct_pt: AffinePoint,
               nonce_pt: AffinePoint) -> torch.Tensor:
    """[L, B] Montgomery coordinate planes -> [B, 8] int64 SHA-256 digest
    words, on their device.

    The exit from Montgomery form is one mont_mul by literal 1 (x*R^-1
    mod p) over all four planes; big-endian word packing pairs 16-bit
    limbs high to low (L must be even).  Identity lanes hold zero limbs,
    matching point_bytes(O) = zero bytes."""
    ctx = dev.ctx
    L = ctx.L
    B = ct_pt.inf.shape[0]
    planes = torch.cat([ct_pt.x, ct_pt.y, nonce_pt.x, nonce_pt.y], dim=1)
    one = torch.zeros_like(planes)
    one[0] = 1
    r = mg.mont_mul(ctx, planes, one).flip(0)        # MSB limb first
    w = (r[0::2] << 16) | r[1::2]                    # [L/2, 4B] BE words
    msg = w.reshape(L // 2, 4, B).permute(2, 1, 0).reshape(B, 2 * L)
    pad, _total = pad_words(8 * L)
    pad = torch.as_tensor(pad, device=msg.device).expand(B, -1)
    return sha256_words(torch.cat([msg, pad], dim=1))


def new_proof_of_plaintext_knowledge(
        pk: BGNPublicKey, sk: BGNSecretKey, vs: Sequence[int],
        zs: Sequence[int], rng=None) -> ProofOfPlaintextKnowledge:
    """NewProofOfPlaintextKnowledge (gadgets.go:32-54).

    DL = nonce1 + c*v + R*z*c*(N/q1) mod N.  Both encryptions run as one
    batch (lanes equal to two calls: Encrypt is elementwise)."""
    vs = list(map(int, vs))
    zs = list(map(int, zs))
    B = len(vs)
    nonce1s = [_rand_below(pk.n, rng) for _ in vs]
    both = pk.encrypt_with_randomness(vs + nonce1s, zs + [0] * B)
    ct, nonce = both[:B], both[B:]
    cs = _fiat_shamir(pk, ct, nonce)
    n_over_q1 = pk.n // sk.key
    dls = [(nonce1 + c * v + sk.r * z * c * n_over_q1) % pk.n
           for nonce1, c, v, z in zip(nonce1s, cs, vs, zs)]
    return ProofOfPlaintextKnowledge(ct, nonce, dls)


def check_proof_of_plaintext_knowledge(
        pk: BGNPublicKey, ct: Ciphertext,
        proof: ProofOfPlaintextKnowledge) -> np.ndarray:
    """CheckProofOfPlaintextKnoewledge [sic] (gadgets.go:65-77):
    P^DL == ct^c * nonce, one bool per lane.

    On the RNS path (pairing.use_rns, residue tables present, L even)
    both ladders and the `* nonce` addition run in RNS: the fused route
    (the digest's 256 bits straight into the ladder) when n > 2^256, else
    the RNS core on c mod n.  The RNS additions are incomplete and the
    inputs are the prover's, so a lane whose chain hit a degenerate
    addition (or whose value is the identity) comes back suspicious, and
    then the whole batch is verified again on the complete limb ladders.
    A batch with an identity nonce (which the incomplete addition cannot
    take) goes to the limb verify at once.  Honest proofs reach the
    fallback only when ct^c or P^DL is the identity (probability
    ~ 2^-|n| per lane)."""
    dev = pk.dev
    dl_digits, _ = _signed_digits([int(d) % pk.n for d in proof.dl], pk.n)
    cs = None
    if (pairing_mod.use_rns(dev.rns) and dev.p_win is not None
            and dev.ctx.L % 2 == 0
            and not bool(proof.nonce.data.inf.any())):
        if pk.n > 1 << 256:
            route_counts["fused"] += 1
            packed = _pok_verify_fused(dev, ct.data, proof.ct.data,
                                       proof.nonce.data, dl_digits)
        else:
            route_counts["rns"] += 1
            cs = _fiat_shamir(pk, proof.ct, proof.nonce)
            packed = _pok_verify_rns_core(dev, ct.data, proof.nonce.data,
                                          _signed_bits(cs, pk.n)[0],
                                          dl_digits)
        packed = packed.cpu().numpy()
        if not (packed >> 1).any():
            return (packed & 1).astype(bool)
    route_counts["limb"] += 1
    if cs is None:
        cs = _fiat_shamir(pk, proof.ct, proof.nonce)
    eq = _pok_verify_limb(dev, ct.data, proof.nonce.data,
                          _signed_bits(cs, pk.n)[0], dl_digits)
    return eq.cpu().numpy().astype(bool)


def _pok_verify_limb(dev: PublicDeviceKey, ct_pt: AffinePoint,
                     nonce_pt: AffinePoint, c_bits, dl_digits):
    """The complete limb verify: P^DL over P's limb window table, ct^c by
    the per-lane double-and-add, the `* nonce` addition, each normalized
    (exact for every input)."""
    ctx = dev.ctx
    lhs = curve.normalize(ctx, curve.fixed_base_mul(ctx, dev.p_tab,
                                                    dl_digits), rns=dev.rns)
    rhs = curve.normalize(ctx, curve.scalar_mul(ctx, ct_pt, c_bits),
                          rns=dev.rns)
    rhs2 = curve.normalize(ctx, curve.add_affine(ctx, rhs, nonce_pt),
                           rns=dev.rns)
    return curve.eq_affine(lhs, rhs2)


def _pok_verify_rns_core(dev: PublicDeviceKey, ct_pt: AffinePoint,
                         nonce_pt: AffinePoint, c_bits, dl_digits):
    """RNS verify: P^DL (window_ladder_tab), ct^c (the per-lane ladder),
    the `* nonce` mixed addition, and ONE normalize_rns (one Fermat
    inversion, pow_loop) over both sides.  Returns int64 eq |
    suspicious << 1 per lane: one readback carries both.

    Degeneracy shows as a canonical-limb zero test of each side's final
    Z: every degenerate incomplete addition gives H == 0 (mod p), hence
    Z == 0 (mod p), which stays so through later additions (Z' = Z*H) and
    doublings (Z' = 2YZ).  The raw residues of such a Z are K*p, not the
    literal zeros that normalize_rns reads as the identity; from_rns_mont
    reduces them.  An identity nonce (the incomplete addition has no
    identity operand) is flagged directly."""
    ctx, rns = dev.ctx, dev.rns
    B = ct_pt.inf.shape[0]
    Xd, Yd, Zd = rns_pairing.fixed_base_mul_rns(ctx, rns, dev.p_win,
                                                dl_digits, raw=True)
    Xc, Yc, Zc = rns_pairing.scalar_mul_vec_rns(ctx, rns, ct_pt, c_bits)
    nx = rn.to_rns_mont(rns, nonce_pt.x)
    ny = rn.to_rns_mont(rns, nonce_pt.y)
    X2, Y2, Z2 = rns_pairing._add_pt(rns, Xc.v, Yc.v, Zc.v, nx, ny)

    dead_l = lb.is_zero(rn.from_rns_mont(rns, rn.RVal(Zd.v, 6)))
    dead_r = lb.is_zero(rn.from_rns_mont(rns, rn.RVal(Z2, 6)))
    suspicious = dead_l | dead_r | nonce_pt.inf

    aff = rns_pairing.normalize_rns(ctx, rns, torch.cat([Xd.v, X2], dim=-1),
                                    torch.cat([Yd.v, Y2], dim=-1),
                                    torch.cat([Zd.v, Z2], dim=-1))
    lhs = AffinePoint(aff.x[:, :B], aff.y[:, :B], aff.inf[:B])
    rhs = AffinePoint(aff.x[:, B:], aff.y[:, B:], aff.inf[B:])
    return curve.eq_affine(lhs, rhs) | (suspicious << 1)


def _pok_verify_fused(dev: PublicDeviceKey, ct_pt: AffinePoint,
                      fs_ct_pt: AffinePoint, nonce_pt: AffinePoint,
                      dl_digits):
    """The RNS verify with the Fiat-Shamir digest fused in: _fs_digest on
    the device and its 256 bits, MSB first, straight into the ct^c
    ladder.  Valid only when n > 2^256 (then c mod n == c); the caller
    checks."""
    words = _fs_digest(dev, fs_ct_pt, nonce_pt)            # [B, 8]
    B = words.shape[0]
    shifts = torch.arange(31, -1, -1, device=words.device)
    c_bits = ((words[:, :, None] >> shifts) & 1).reshape(B, 256).T
    return _pok_verify_rns_core(dev, ct_pt, nonce_pt, c_bits, dl_digits)
