"""The scheme in bgn_torch's limb-domain configuration,
config.BGNParams(rns_miller="0"), with fused_miller on and off, against
the JAX package on the shared 64-bit key (msg space 1021), exactly.  On
the CPU the JAX package's use_rns is false, so it runs the same limb
algorithms: the window chains over P's and Q's limb tables, complete limb
additions and normalizes, the limb pairing, limb powers and the limb
giant-step scans.

Every test runs in limb mode (monkeypatch restores the modes) with every
RNS kernel wrapper of ops/cuda_rns.py replaced by one that raises, so
that no op reaches the RNS path; the ops that pair run with the fused
Miller loop and with the limb one.  Inputs of the JAX ops are the port's
limbs.  A JAX kernel's first compile on the CPU costs 2-22 s, so each op
is held against a JAX op whose kernel another comparison compiles
already, where one computes the same canonical value: Sub = Add of the
negation, Neg = MultConst by -1 (one MultConst call covers negative,
zero, small and n - 1 exponents), MakeL2 = Mult by P, and the
re-randomized L1 Add = Add of Q^r (JAX's Encrypt of 0 with the r that
its own re-randomization draws from the same rng).  Every Encrypt uses
full-width r, so that all of them share one JAX compile.  Everything
runs on the CPU.
"""
import _torch_threads  # noqa: F401  (first: one torch thread per process)
import copy
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_carry import port_public_key, port_tables
from bgn_torch import scheme as tscheme
from bgn_torch.config import BGNParams
from bgn_torch.fieldcore import limbs as tlb
from bgn_torch.ops import cuda_rns
from bgn_torch.ops import curve as tcurve
from bgn_torch.ops import pairing as tpairing
from bgn_torch.utils import rng as trng
from bgn_tpu import scheme as jscheme
from bgn_tpu.ops import curve as jcurve

MS = [0, 1, 7, -5, 30, -20, 2, 13]
KS = [3, 0, -7, 5, 30, 25, -2, 11]
RS = [5, 6, 0, 9, 1, 2, 3, 4]


def _wide(n, seed):
    """One full-width r per lane, drawn as the JAX package draws it from
    a seeded rng (scheme._rand_below)."""
    rng = random.Random(seed)
    return [rng.randrange(n) for _ in MS]


@pytest.fixture(scope="module")
def keys(shared_keypair):
    """The JAX key and tables, the port's built from their arrays, and
    non-deterministic copies of both public keys."""
    jpk, jsk, jtables = shared_keypair
    pk = port_public_key(jpk)
    sk = tscheme.BGNSecretKey(jsk.a1_params, jsk.r, jsk.poly_base)
    jr, pr = copy.copy(jpk), copy.copy(pk)
    jr.deterministic = pr.deterministic = False
    return jpk, jsk, jtables, pk, sk, port_tables(jtables), jr, pr


def _refuse(name):
    def fn(*args, **kwargs):
        raise AssertionError(f"RNS kernel {name} called in limb mode")
    return fn


def _limb_mode(monkeypatch, fused: bool):
    """BGNParams(rns_miller="0", fused_miller=fused) applied and every RNS
    wrapper refused; monkeypatch restores both."""
    for name in ("_RNS_MODE", "_USE_FUSED"):
        monkeypatch.setattr(tpairing, name, getattr(tpairing, name))
    BGNParams(rns_miller="0", fused_miller=fused).apply_kernel_modes()
    assert not tpairing.use_rns(object())
    assert tpairing._USE_FUSED is fused
    for w in cuda_rns.WRAPPERS:
        monkeypatch.setattr(cuda_rns, w.__name__, _refuse(w.__name__))


@pytest.fixture
def limb_mode(monkeypatch):
    _limb_mode(monkeypatch, True)


PAIRING_MODES = pytest.mark.parametrize("fused", [True, False],
                                        ids=["fused", "limb_miller"])


def _u32(t):
    return t.cpu().numpy().astype(np.uint32)


def _same(ct, jct):
    assert ct.level2 == jct.level2
    if ct.level2:
        np.testing.assert_array_equal(_u32(ct.data), np.asarray(jct.data))
        return
    for f in ("x", "y", "inf"):
        np.testing.assert_array_equal(_u32(getattr(ct.data, f)),
                                      np.asarray(getattr(jct.data, f)))


def _jax_ct(ct):
    """The JAX package's Ciphertext holding the port's limbs."""
    if ct.level2:
        return jscheme.Ciphertext(jnp.asarray(_u32(ct.data)), True)
    return jscheme.Ciphertext(jcurve.AffinePoint(
        *(jnp.asarray(_u32(getattr(ct.data, f))) for f in ("x", "y", "inf"))),
        False)


def test_rns_wrappers_refused_outside_limb_mode(keys, monkeypatch):
    """The refusal the limb-mode tests rely on: in the default mode the
    same op reaches an RNS wrapper and raises."""
    _, _, _, pk, _, _, _, _ = keys
    for w in cuda_rns.WRAPPERS:
        monkeypatch.setattr(cuda_rns, w.__name__, _refuse(w.__name__))
    with pytest.raises(AssertionError, match="RNS kernel"):
        pk.encrypt_deterministic(MS)


def test_encrypt_limbmode_matches_jax(keys, limb_mode):
    """Encrypt (a non-deterministic key's, host r), EncryptDeterministic,
    encrypt_device: the split limb encryption (P's and Q's limb window
    chains, madd, normalize)."""
    jpk, _, _, pk, sk, tables, jr, pr = keys
    ct = pr.encrypt(MS, rng=random.Random(1))
    _same(ct, jr.encrypt(MS, rng=random.Random(1)))
    det = pk.encrypt_deterministic(MS)
    _same(det, jpk.encrypt_deterministic(MS))
    dv = pk.encrypt_device(MS, torch.Generator().manual_seed(3))
    rs = tlb.limbs_to_ints(trng.device_random_below(
        pk._sampler_ctx, torch.Generator().manual_seed(3), (8,)))
    _same(dv, jpk.encrypt_with_randomness(MS, rs))
    for c in (ct, det, dv):
        assert list(sk.decrypt(c, pk, tables)) == MS


def test_l1_ops_limbmode_match_jax(keys, limb_mode):
    """L1 Add, Sub, Neg and MultConst (negative, zero, small and n - 1
    exponents in one batch): complete limb additions and the limb
    double-and-add, then the limb normalize; and the L1 decrypt (limb
    C^q1, limb giant steps)."""
    jpk, _, _, pk, sk, tables, _, _ = keys
    a = pk.encrypt_with_randomness(MS, RS)
    b = pk.encrypt_deterministic(KS)
    ja, jb = _jax_ct(a), _jax_ct(b)
    nb = tscheme.Ciphertext(tcurve.neg_affine(pk.dev.ctx, b.data), False)
    ks = KS[:3] + [pk.n - 1] + KS[4:]
    minus_one = [-1] * 7 + [pk.n - 1]
    outs = {"Add": (pk.add(a, b), jpk.add(ja, jb),
                    [m + k for m, k in zip(MS, KS)]),
            "Sub": (pk.sub(a, b), jpk.add(ja, _jax_ct(nb)),
                    [m - k for m, k in zip(MS, KS)]),
            "Neg": (pk.neg(a), jpk.mult_const(ja, minus_one),
                    [-m for m in MS]),
            "MultConst": (pk.mult_const(a, ks), jpk.mult_const(ja, ks),
                          [m * k for m, k in zip(MS, KS[:3] + [-1]
                                                  + KS[4:])])}
    for name, (got, want, vals) in outs.items():
        _same(got, want)
        assert list(sk.decrypt(got, pk, tables)) == vals, name


@PAIRING_MODES
def test_l2_ops_limbmode_match_jax(keys, monkeypatch, fused):
    """Mult and MakeL2 (the limb pairing: fused or limb Miller loop, limb
    final exponentiation), L2 Add/Sub, L2 MultConst with negative k, and
    the L2 decrypt (limb power by q1, limb giant steps)."""
    _limb_mode(monkeypatch, fused)
    jpk, jsk, jtables, pk, sk, tables, _, _ = keys
    a = pk.encrypt_with_randomness(MS, RS)
    b = pk.encrypt_deterministic(KS)
    ja, jb = _jax_ct(a), _jax_ct(b)
    prod = pk.mult(a, b)
    _same(prod, jpk.mult(ja, jb))
    l2 = pk.make_l2(a)
    P = tscheme.Ciphertext(tcurve.AffinePoint(
        *(t.reshape(t.shape + (1,)).expand(t.shape + (8,))
          for t in pk.dev.P)), False)
    _same(l2, jpk.mult(ja, _jax_ct(P)))
    jprod, jl2 = _jax_ct(prod), _jax_ct(l2)
    ks2 = [2, 0, -3, 1, 4, -1, 0, 2]
    outs = {"Mult": (prod, None, [m * k for m, k in zip(MS, KS)]),
            "MakeL2": (l2, None, MS),
            "AddL2": (pk.add(prod, l2), jpk.add(jprod, jl2),
                      [m * k + m for m, k in zip(MS, KS)]),
            "SubL2": (pk.sub(prod, l2), jpk.sub(jprod, jl2),
                      [m * k - m for m, k in zip(MS, KS)]),
            "MultConstL2": (pk.mult_const(l2, ks2),
                            jpk.mult_const(jl2, ks2),
                            [m * k for m, k in zip(MS, ks2)])}
    for name, (got, want, vals) in outs.items():
        if want is not None:
            _same(got, want)
        assert list(sk.decrypt(got, pk, tables)) == vals, name
    vals, ok = sk.decrypt_with_status(prod, pk, tables)
    jvals, jok = jsk.decrypt_with_status(jprod, jpk, jtables)
    np.testing.assert_array_equal(vals, jvals)
    np.testing.assert_array_equal(ok, jok)


@PAIRING_MODES
def test_rerandomized_ops_limbmode_match_jax(keys, monkeypatch, fused):
    """A non-deterministic key's L1 Add and Mult, re-randomized with r
    from a seeded random.Random in the JAX package's order: Mult against
    the JAX package's whole op, Add against JAX's Add of Q^r."""
    _limb_mode(monkeypatch, fused)
    jpk, _, _, _, sk, tables, jr, pr = keys
    a = pr.encrypt(MS, rng=random.Random(1))
    b = pr.encrypt_deterministic(KS)
    ja, jb = _jax_ct(a), _jax_ct(b)
    add = pr.add(a, b, rng=random.Random(2))
    q_r = jpk.encrypt_with_randomness([0] * len(MS), _wide(pr.n, 2))
    _same(add, jpk.add(jpk.add(ja, jb), q_r))
    prod = pr.mult(a, b, rng=random.Random(3))
    _same(prod, jr.mult(ja, jb, rng=random.Random(3)))
    assert list(sk.decrypt(add, pr, tables)) == [m + k for m, k in
                                                  zip(MS, KS)]
    assert list(sk.decrypt(prod, pr, tables)) == [m * k for m, k in
                                                   zip(MS, KS)]
