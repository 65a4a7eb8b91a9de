"""Keys that the RNS kernels cannot serve: a modulus beyond the 12-bit RNS
prime pool, or more than cuda_rns.K_KERNEL_MAX = 192 channels per base,
gets no RNS context (scheme._make_rns), and every op of such a key takes
its limb branch, the one BGNParams(rns_miller="0") runs.  On the CPU, at
the smallest cost: _make_rns on hand-made primes at 2100, 2150 and 2200
bits, then a 64-bit key whose RNS context is withheld (make_rns_ctx made
to raise, so keygen's own branch runs) against the same seed's key in
limb mode, op by op with torch.equal, with every RNS kernel wrapper
refused; and a JAX-package key carried across without its RNS context.
"""
import _torch_threads  # noqa: F401  (first: one torch thread per process)
import math
import random

import pytest
import torch

from _torch_carry import port_public_key
from bgn_torch import scheme as tscheme
from bgn_torch.config import BGNParams
from bgn_torch.fieldcore import limbs as tlb
from bgn_torch.fieldcore import rns as trn
from bgn_torch.ops import cuda_rns
from bgn_torch.ops import pairing as tpairing
from bgn_tpu import scheme as jscheme

MS = [0, 1, 7, -5, 30, -20, 2, 13]
KS = [3, 0, -7, 5, 30, 25, -2, 11]
C1 = [-3, 2, -1, 0, 5, -7, 1, 4]           # MultConst (L1)
C2 = [2, -1, 0, 3, 1, 1, 1, -4]            # MultConst (L2)


# p = 2^bits + offset: the least p = 3 mod 4 above 2^bits with no factor
# below 2000 that passes Fermat tests to six bases (found by a search)
PRIMES = {2100: 9703, 2150: 4515, 2200: 3327}


@pytest.mark.parametrize("bits, k", [(2100, 188), (2150, 193), (2200, None)])
def test_make_rns_none_beyond_the_kernels(bits, k):
    """An RNSCtx at 2100 bits (k = 188); None at 2150 bits (k = 193, no
    kernel instantiation) and at 2200 bits (beyond the prime pool, where
    the JAX package's _make_rns gives None too)."""
    p = (1 << bits) + PRIMES[bits]
    assert p % 4 == 3 and math.gcd(p, math.prod(trn._primes_desc(3, 2000))) \
        == 1 and all(pow(a, p - 1, p) == 1 for a in (2, 3, 5, 7, 11, 13))
    L = tlb.num_limbs_for_bits(bits + 32)
    if k is None:
        with pytest.raises(ValueError, match="prime pool"):
            trn.select_channels(p)
    else:
        assert trn.select_channels(p)[2] == k
    rns = tscheme._make_rns(p, L, "cpu")
    if k is not None and k <= cuda_rns.K_KERNEL_MAX:
        assert isinstance(rns, trn.RNSCtx) and rns.k == k
    else:
        assert rns is None
    if k is None:
        assert jscheme._make_rns(p, L) is None


def _refuse(name):
    def fn(*args, **kwargs):
        raise AssertionError(f"RNS kernel {name} called for a key "
                             "without an RNS context")
    return fn


def _refuse_rns_wrappers(monkeypatch):
    for w in cuda_rns.WRAPPERS:
        monkeypatch.setattr(cuda_rns, w.__name__, _refuse(w.__name__))


def _no_pool(*args, **kwargs):
    raise ValueError("modulus too large for the 12-bit RNS prime pool")


def _keygen(withhold: bool):
    """The seeded 64-bit key, with its RNS context withheld or not."""
    with pytest.MonkeyPatch.context() as mp:
        if withhold:
            mp.setattr(trn, "make_rns_ctx", _no_pool)
        return tscheme.keygen(64, 1021, rng=random.Random(7), device="cpu")


def _ops(pk):
    """Every op on one seeded set of inputs."""
    a = pk.encrypt(MS, rng=random.Random(1))
    b = pk.encrypt_deterministic(KS)
    prod = pk.mult(a, b)
    l2 = pk.make_l2(a)
    return {"Encrypt": a, "EncryptDeterministic": b,
            "Add": pk.add(a, b), "Sub": pk.sub(a, b), "Neg": pk.neg(a),
            "MultConst": pk.mult_const(a, C1),
            "Mult": prod, "MakeL2": l2, "AddL2": pk.add(prod, l2),
            "SubL2": pk.sub(prod, l2), "NegL2": pk.neg(prod),
            "MultConstL2": pk.mult_const(prod, C2)}


def _decrypt_all(pk, sk, tables, cts):
    """The values of every ciphertext, one decrypt per level (the
    ciphertexts of a level side by side in one batch)."""
    vals = {}
    for level2 in (False, True):
        names = [n for n, ct in cts.items() if ct.level2 == level2]
        if level2:
            data = torch.cat([cts[n].data for n in names], dim=-1)
        else:
            data = type(cts[names[0]].data)(*(
                torch.cat([getattr(cts[n].data, f) for n in names], dim=-1)
                for f in cts[names[0]].data._fields))
        got = list(sk.decrypt(tscheme.Ciphertext(data, level2), pk, tables))
        for i, n in enumerate(names):
            vals[n] = got[i * len(MS):(i + 1) * len(MS)]
    return vals


def _equal(u, v):
    if u.level2:
        return torch.equal(u.data, v.data)
    return all(torch.equal(x, y) for x, y in zip(u.data, v.data))


def test_key_without_rns_equals_limb_mode(monkeypatch):
    """Every op of the key without an RNS context, in the default mode,
    is torch.equal to the same op of the same seed's key under
    BGNParams(rns_miller="0"), no RNS wrapper is reached, and every lane
    of both decrypts (L1 and L2) gives its value."""
    pk, _ = _keygen(False)
    pn, sn = _keygen(True)
    assert pk.dev.rns is not None
    assert pn.dev.rns is None and pn.dev.p_win is None \
        and pn.dev.q_win is None
    assert pn.p == pk.p and pn.n == pk.n
    _refuse_rns_wrappers(monkeypatch)
    got = _ops(pn)
    for name in ("_RNS_MODE", "_USE_FUSED"):
        monkeypatch.setattr(tpairing, name, getattr(tpairing, name))
    BGNParams(rns_miller="0").apply_kernel_modes()
    want = _ops(pk)
    for name, ct in got.items():
        assert _equal(ct, want[name]), name
    vals = _decrypt_all(pn, sn, pn.setup_decryption(sn, random.Random(7)),
                        got)
    assert vals == {
        "Encrypt": MS, "EncryptDeterministic": KS,
        "Add": [m + k for m, k in zip(MS, KS)],
        "Sub": [m - k for m, k in zip(MS, KS)], "Neg": [-m for m in MS],
        "MultConst": [m * c for m, c in zip(MS, C1)],
        "Mult": [m * k for m, k in zip(MS, KS)], "MakeL2": MS,
        "AddL2": [m * k + m for m, k in zip(MS, KS)],
        "SubL2": [m * k - m for m, k in zip(MS, KS)],
        "NegL2": [-m * k for m, k in zip(MS, KS)],
        "MultConstL2": [m * k * c for m, k, c in zip(MS, KS, C2)]}


def test_jax_key_without_rns_carries_across(shared_keypair64, monkeypatch):
    """The JAX package's shared 64-bit key carried across with its RNS
    context dropped: the port's key has rns None and encrypts, multiplies
    and decrypts on limbs."""
    jpk, jsk = shared_keypair64
    pk = port_public_key(jpk, with_rns=False)
    sk = tscheme.BGNSecretKey(jsk.a1_params, jsk.r, jsk.poly_base)
    tables = pk.setup_decryption(sk, rng=random.Random(5))
    assert pk.dev.rns is None and pk.dev.p_win is None
    _refuse_rns_wrappers(monkeypatch)
    ms, ks = [0, 3, -4, 9], [2, -3, 5, 1]
    a = pk.encrypt(ms, rng=random.Random(2))
    b = pk.encrypt_deterministic(ks)
    assert list(sk.decrypt(a, pk, tables)) == ms
    assert list(sk.decrypt(pk.mult(a, b), pk, tables)) == \
        [m * k for m, k in zip(ms, ks)]
