"""The port's gadgets (bgn_torch/gadgets.py, ops/sha256.py) against
hashlib, hostmath and the JAX package's (bgn_tpu/gadgets.py): SHA-256 of
1, 2 and 5 blocks, the Fiat-Shamir digest on the device against the host
hash and the JAX package's, decryption proofs, proofs of plaintext
knowledge with a seeded rng (the proof and the verdicts equal the JAX
package's), the RNS routes against the limb verify, the fallback of a
degenerate lane, and the two pinned divergences (ROADMAP.md queue 3).

The JAX side runs only its digest and its fused verify (forced with
pairing._RNS_MODE = "1", as tests/test_gadgets_serialize.py does); its
ciphertexts are built from hostmath's points.  On the CPU.
"""
import _torch_threads  # noqa: F401  (first: one torch thread per process)
import hashlib
import random

import numpy as np
import pytest
import torch

from bgn_torch import gadgets as tg
from bgn_torch import hostmath as thm
from bgn_torch import scheme as tscheme
from bgn_torch.ops.curve import AffinePoint
from bgn_torch.ops.sha256 import pad_words, sha256_words
from bgn_torch.utils import convert as tconvert
from bgn_tpu import gadgets as jg
from bgn_tpu import scheme as jscheme
from bgn_tpu.ops import pairing as jpairing
from bgn_tpu.utils import convert as jconvert

B = 16   # lanes of the one seeded proof that every verify here reads


@pytest.fixture(scope="module")
def keys(shared_keypair64):
    jpk, jsk = shared_keypair64
    pk, sk = tscheme.keygen(64, 101, rng=random.Random(5), device="cpu")
    assert (pk.n, pk.P_host, pk.Q_host, sk.r) == \
        (jpk.n, jpk.P_host, jpk.Q_host, jsk.r)
    gk = thm.GoldenKey(params=sk.a1_params, P=pk.P_host, Q=pk.Q_host,
                       R=sk.r, msg_space=pk.msg_space)
    return jpk, jsk, pk, sk, gk


def _jct(jpk, gk, ms, rs):
    """The JAX package's ciphertext of (m, r) lanes, from hostmath."""
    return jscheme.Ciphertext(jconvert.affine_from_host(
        jpk.dev.ctx, [thm.golden_encrypt(gk, m % gk.params.n, r)
                      for m, r in zip(ms, rs)]), False)


def _limbs(a):
    return tuple(np.asarray(t) for t in a)


@pytest.fixture(scope="module")
def proofs(keys):
    """One seeded proof in each package for B lanes: the JAX prover with
    its encryption supplied by hostmath (its Encrypt is held to hostmath
    elsewhere), so that only its digest and its arithmetic run."""
    jpk, jsk, pk, sk, gk = keys
    rng = random.Random(77)
    vs = [rng.randrange(pk.n) for _ in range(B)]
    zs = [rng.randrange(pk.n) for _ in range(B)]
    proof = tg.new_proof_of_plaintext_knowledge(pk, sk, vs, zs,
                                                rng=random.Random(9))
    mp = pytest.MonkeyPatch()
    mp.setattr(jpk, "encrypt_with_randomness",
               lambda ms, rs: _jct(jpk, gk, ms, rs))
    try:
        jproof = jg.new_proof_of_plaintext_knowledge(jpk, jsk, vs, zs,
                                                     rng=random.Random(9))
    finally:
        mp.undo()
    ct = pk.encrypt_with_randomness(vs, zs)
    return vs, zs, ct, proof, jproof


@pytest.mark.parametrize("nbytes", [4, 60, 272])
def test_sha256_matches_hashlib(nbytes):
    """1, 2 and 5 blocks; 272 bytes is the digest input of a 512-bit key
    (8 L, L = 34)."""
    rng = random.Random(nbytes)
    msgs = [bytes(rng.randrange(256) for _ in range(nbytes))
            for _ in range(5)]
    words = np.stack([np.frombuffer(m, dtype=">u4").astype(np.int64)
                      for m in msgs])
    pad, total = pad_words(nbytes)
    padded = np.concatenate([words, np.broadcast_to(pad, (5, len(pad)))],
                            axis=1)
    assert padded.shape[1] == total == 16 * {4: 1, 60: 2, 272: 5}[nbytes]
    got = sha256_words(torch.as_tensor(padded)).numpy()
    for row, m in zip(got, msgs):
        assert row.astype(">u4").tobytes() == hashlib.sha256(m).digest()
    with pytest.raises(ValueError):
        pad_words(6)
    with pytest.raises(ValueError):
        sha256_words(torch.zeros((1, 15), dtype=torch.int64))


def test_fs_digest_matches_host_and_jax(keys):
    """Identity lanes included: E(0, 0) and E_det(0) are the identity."""
    jpk, _, pk, _, gk = keys
    ms, rs = [3, 0, 9, 0, 44, 7], [5, 0, 8, 2, 0, 6]
    ns, nr = [1, 0, 5, 0, 2, 3], [0, 0, 4, 0, 1, 0]
    ct = pk.encrypt_with_randomness(ms, rs)
    nonce = pk.encrypt_with_randomness(ns, nr)
    assert ct.data.inf.tolist() == [0, 1, 0, 0, 0, 0]
    assert nonce.data.inf.tolist() == [0, 1, 0, 1, 0, 0]
    dev = tg._fiat_shamir(pk, ct, nonce)
    assert dev == tg._fiat_shamir_host(pk, ct, nonce)
    assert dev == jg._fiat_shamir(jpk, _jct(jpk, gk, ms, rs),
                                  _jct(jpk, gk, ns, nr))
    pts = [thm.golden_encrypt(gk, m, r) for m, r in zip(ms, rs)]
    npts = [thm.golden_encrypt(gk, m, r) for m, r in zip(ns, nr)]
    nb = 2 * pk.dev.ctx.L

    def pb(P):
        return b"\x00" * (2 * nb) if P is None else \
            P[0].to_bytes(nb, "big") + P[1].to_bytes(nb, "big")

    assert dev == [int.from_bytes(hashlib.sha256(pb(a) + pb(b)).digest(),
                                  "big") for a, b in zip(pts, npts)]


def test_decryption_proofs(keys):
    """gadgets_test.go:8-69: honest, aggregated, and tampered value or
    randomness."""
    _, _, pk, _, _ = keys
    rng = random.Random(31)
    vs = [rng.randrange(pk.n) for _ in range(4)]
    rs = [rng.randrange(pk.n) for _ in range(4)]
    ct = pk.encrypt_with_randomness(vs, rs)
    ok = tg.check_decryption_proof(pk, ct, tg.new_decryption_proof(vs, rs))
    assert ok.dtype == bool and ok.tolist() == [True] * 4
    agg = pk.add(ct[:2], ct[2:])
    assert tg.check_decryption_proof(pk, agg, tg.new_decryption_proof(
        [vs[0] + vs[2], vs[1] + vs[3]], [rs[0] + rs[2], rs[1] + rs[3]])).all()
    bad_r = tg.new_decryption_proof(vs, [rs[0] + 1] + rs[1:])
    bad_v = tg.new_decryption_proof([vs[0], vs[1] + 1] + vs[2:], rs)
    assert tg.check_decryption_proof(pk, ct, bad_r).tolist() == \
        [False, True, True, True]
    assert tg.check_decryption_proof(pk, ct, bad_v).tolist() == \
        [True, False, True, True]


# Lanes of the verify batch (B = 16 proofs of one seeded prover):
HONEST = (0, 9, 11, 14, 15)
BAD_DL, BAD_NONCE, BAD_CT = 1, 8, 10   # DL + 1; lane 9's nonce; lane 11's ct
NEG_DL, DL_MINUS_N = 2, 3               # -DL; DL - n (divergence (a))
OFF = (4, 5, 6, 7)                      # ct + (0, 0) (divergence (b))
ZERO_DL, O_NONCE = 12, 13               # degenerate: DL = 0; identity nonce


@pytest.fixture(scope="module")
def verdicts(keys, proofs):
    """Every verify of the file, once: the port's RNS route on the batch
    above without its degenerate lanes (12, 13 honest), its fused core
    on the same lanes, the JAX package's fused route on them (forced with
    pairing._RNS_MODE = "1", as tests/test_gadgets_serialize.py does), the
    port's check of the batch with DL = 0 in lane 12, which falls back to
    the limb verify, the port's RNS core with lane 13's nonce the identity
    too, and the port's check of lanes 0 and 13 then, which goes to the
    limb verify at once."""
    jpk, _, pk, _, gk = keys
    vs, zs, ct, proof, jproof = proofs
    p, n = gk.params.p, pk.n
    dl = list(proof.dl)
    dl[BAD_DL] = (dl[BAD_DL] + 1) % n
    dl[NEG_DL] = -dl[NEG_DL]
    dl[DL_MINUS_N] = dl[DL_MINUS_N] - n
    # verify bases: lane BAD_CT against lane 11's ciphertext, lanes OFF
    # against ct + (0, 0), a point of order 2 off the order-n subgroup
    pts = [thm.golden_encrypt(gk, v, z) for v, z in zip(vs, zs)]
    pts[BAD_CT] = pts[11]
    for i in OFF:
        pts[i] = thm.ec_add(pts[i], (0, 0), p)
        assert thm.ec_mul(n, pts[i], p) is not None
    base = tscheme.Ciphertext(tconvert.affine_from_host(pk.dev.ctx, pts),
                              False)
    nonce = AffinePoint(*(t.clone() for t in proof.nonce.data))
    nonce.x[:, BAD_NONCE], nonce.y[:, BAD_NONCE] = \
        nonce.x[:, 9].clone(), nonce.y[:, 9].clone()
    forged = tg.ProofOfPlaintextKnowledge(
        proof.ct, tscheme.Ciphertext(nonce, False), dl)
    out = {"cs": tg._fiat_shamir(pk, forged.ct, forged.nonce)}
    before = dict(tg.route_counts)
    out["rns"] = tg.check_proof_of_plaintext_knowledge(pk, base, forged)
    out["rns_routes"] = {r: tg.route_counts[r] - before[r] for r in before}
    reduced, _ = tscheme._signed_digits([d % n for d in dl], n)
    out["fused"] = tg._pok_verify_fused(pk.dev, base.data, forged.ct.data,
                                        forged.nonce.data, reduced)
    jn = jproof.nonce.data
    jforged = jg.ProofOfPlaintextKnowledge(jproof.ct, jscheme.Ciphertext(
        jn._replace(x=jn.x.at[:, BAD_NONCE].set(jn.x[:, 9]),
                    y=jn.y.at[:, BAD_NONCE].set(jn.y[:, 9])), False), dl)
    mp = pytest.MonkeyPatch()
    mp.setattr(jpairing, "_RNS_MODE", "1")
    try:
        out["jax"] = jg.check_proof_of_plaintext_knowledge(
            jpk, jscheme.Ciphertext(jconvert.affine_from_host(
                jpk.dev.ctx, pts), False), jforged)
    finally:
        mp.undo()
    # the degenerate lanes: P^0 = O, then also an identity nonce
    dl[ZERO_DL] = 0
    before = dict(tg.route_counts)
    out["limb"] = tg.check_proof_of_plaintext_knowledge(pk, base, forged)
    out["limb_routes"] = {r: tg.route_counts[r] - before[r] for r in before}
    nonce.x[:, O_NONCE], nonce.y[:, O_NONCE], nonce.inf[O_NONCE] = 0, 0, 1
    out["degenerate_cs"] = tg._fiat_shamir(pk, forged.ct, forged.nonce)
    digits, _ = tscheme._signed_digits([d % n for d in dl], n)
    out["core"] = tg._pok_verify_rns_core(
        pk.dev, base.data, nonce, tscheme._signed_bits(
            out["degenerate_cs"], n)[0], digits)
    two = [HONEST[0], O_NONCE]
    before = dict(tg.route_counts)
    out["o_nonce"] = tg.check_proof_of_plaintext_knowledge(
        pk, base[two], tg.ProofOfPlaintextKnowledge(
            forged.ct[two], forged.nonce[two], [dl[i] for i in two]))
    out["o_nonce_routes"] = {r: tg.route_counts[r] - before[r]
                             for r in before}
    return out


def test_pok_proof_matches_jax(keys, proofs):
    """With the same rng the proof's ct and nonce limbs and its DL equal
    the JAX package's."""
    vs, zs, ct, proof, jproof = proofs
    for ours, theirs in ((proof.ct, jproof.ct), (proof.nonce, jproof.nonce)):
        for a, b in zip(_limbs(ours.data), _limbs(theirs.data)):
            np.testing.assert_array_equal(a, b.astype(np.int64))
    assert proof.dl == jproof.dl
    assert len(set(proof.dl)) == B and all(0 <= d < keys[2].n
                                           for d in proof.dl)


def test_pok_verdicts_match_jax(verdicts):
    """Honest lanes true; a tampered DL, a nonce swapped for another
    lane's and a verify against another lane's ciphertext false; the same
    answers as the JAX package's on every lane outside the two
    divergences.  The port took its RNS route, no fallback."""
    rns, jax = verdicts["rns"], verdicts["jax"]
    assert rns.dtype == bool and jax.dtype == bool
    assert verdicts["rns_routes"] == {"fused": 0, "rns": 1, "limb": 0}
    assert all(rns[i] for i in HONEST + (ZERO_DL, O_NONCE))
    assert not any(rns[i] for i in (BAD_DL, BAD_NONCE, BAD_CT))
    same = [i for i in range(B) if i not in OFF + (NEG_DL, DL_MINUS_N)]
    assert rns[same].tolist() == jax[same].tolist()


def test_rns_routes_equal_limb_route(verdicts):
    """The RNS route (c mod n, the route of every key with n < 2^256)
    and the limb verify agree on every lane; the fused core agrees with
    both on every lane whose ciphertext lies in the order-n subgroup."""
    rns, limb = verdicts["rns"], verdicts["limb"]
    lanes = [i for i in range(B) if i not in (ZERO_DL, O_NONCE)]
    assert rns[lanes].tolist() == limb[lanes].tolist()
    fused = verdicts["fused"]
    assert not (fused >> 1).any()
    inside = [i for i in range(B) if i not in OFF]
    assert (fused[inside] & 1).bool().tolist() == rns[inside].tolist()


def test_degenerate_lanes_fall_back_to_limbs(verdicts):
    """DL = 0 (P^0 = O) and an identity nonce flag exactly their lanes
    suspicious in the RNS core.  A batch with DL = 0 is verified again on
    limbs (one RNS route, one limb verify), where that lane is false and
    every other lane keeps its answer; a batch with an identity nonce goes
    to the limb verify at once (no RNS route), where that lane is
    false."""
    core = verdicts["core"]
    assert ((core >> 1) == 1).nonzero().flatten().tolist() == \
        [ZERO_DL, O_NONCE]
    assert verdicts["limb_routes"] == {"fused": 0, "rns": 1, "limb": 1}
    limb = verdicts["limb"]
    assert not limb[ZERO_DL] and limb[O_NONCE]
    assert all(limb[i] for i in HONEST)
    assert verdicts["o_nonce_routes"] == {"fused": 0, "rns": 0, "limb": 1}
    assert verdicts["o_nonce"].tolist() == [True, False]


def test_negative_dl_is_reduced_mod_n(verdicts):
    """Divergence (a), bgn_tpu/gadgets.py:182: the port verifies
    P^(DL mod n), the JAX package P^|DL|.  A negated DL fails in the port
    (RNS route, fused core and limb verify) and passes in the JAX
    package; DL - n (negative, the same group element as DL) passes in
    the port and fails in the JAX package."""
    lanes = [NEG_DL, DL_MINUS_N]
    for route in ("rns", "limb"):
        assert verdicts[route][lanes].tolist() == [False, True], route
    assert (verdicts["fused"][lanes] & 1).tolist() == [0, 1]
    assert verdicts["jax"][lanes].tolist() == [True, False]


def test_unreduced_challenge_off_subgroup(keys, verdicts):
    """Divergence (b), bgn_tpu/gadgets.py:257-263: against ct + T, T =
    (0, 0) of order 2, the equation holds exactly when the exponent that
    multiplies ct is even.  The port (n < 2^256: the RNS core on c mod n)
    answers (c mod n) even, as its limb verify does; the JAX package's
    fused route walks the unreduced c and answers c even, as the port's
    fused core does, which the port therefore runs only when n > 2^256."""
    n = keys[2].n
    assert n < 1 << 256
    cs = [verdicts["cs"][i] for i in OFF]
    reduced = [c % n % 2 == 0 for c in cs]
    unreduced = [c % 2 == 0 for c in cs]
    assert reduced != unreduced                    # ct^c != ct^(c mod n)
    lanes = list(OFF)
    for route in ("rns", "limb"):
        assert verdicts[route][lanes].tolist() == reduced, route
    assert (verdicts["fused"][lanes] & 1).bool().tolist() == unreduced
    assert verdicts["jax"][lanes].tolist() == unreduced
