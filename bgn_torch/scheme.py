"""The BGN scheme on PyTorch: keygen, Encrypt, Mult, Decrypt and the
homomorphic ops at both levels.

The port's counterpart of `bgn_tpu/scheme.py`: keygen (host) ->
encrypt_with_randomness / encrypt_device / encrypt_deterministic ->
add / sub / neg / mult / mult_const / make_l2 -> decrypt, for
deterministic and non-deterministic keys.  Layouts match the JAX package:
an L1 ciphertext is AffinePoint(x [L, *B], y [L, *B], inf [*B]) of
canonical 16-bit Montgomery limbs (int64 here), an L2 ciphertext is
[2, L, *B].

Two field domains, as in the JAX package on the TPU: the pairing, the
ladders, the L1 Add/Sub and the decrypts run in RNS (ops/rns_pairing.py);
L2 Add/Sub, the re-randomization of a non-deterministic key (Q^r and
e(Q, Q)^r), the complete L1 MultConst ladder and encrypt_device's
sampler run on limbs through the CIOS product (fieldcore/montgomery.py).
Under config.BGNParams(rns_miller="0") (pairing.use_rns false) every op
takes its limb branch, where the JAX package takes it: the limb
pairing (ops/pairing.py, the fused digit-domain Miller loop or the limb
one), the limb window chains over P's and Q's limb tables, complete limb
additions, limb powers and the limb giant-step scans.

Entry points take `device=` and default to "cuda"; tests pass
device="cpu", where the kernel wrappers run their plain PyTorch versions.
Randomness comes from a `random.Random` the caller passes, as in the JAX
package, drawn in the same order, so a seeded keygen gives the same key
and a seeded op the same ciphertext in both packages.

The key also carries what the plaintext encodings need (encoding.py):
PolyEncodingParams and the degree tables, filled at keygen as the
reference's NewKeyGen does (bgn.go:135).  public_key_from_parts rebuilds
the whole device key from its host parts (serialize.py loads keys through
it), with the Miller digit encoding that keygen chose replayed.
"""

from __future__ import annotations

import dataclasses
import secrets
from typing import Any, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from . import encoding
from . import hostmath as hm
from .fieldcore import limbs as lb
from .fieldcore import montgomery as mg
from .fieldcore import rns as rn
from .fieldcore.montgomery import MontCtx
from .fieldcore.rns import RNSCtx
from .ops import bsgs as bsgs_mod
from .ops import cuda_rns
from .ops import curve
from .ops import fp2
from .ops import pairing as pairing_mod
from .ops import rns_pairing
from .ops.curve import AffinePoint
from .utils import convert
from .utils import profiling
from .utils import rng as rng_mod

# Limb head-room beyond key_bits for the cofactor l (p = l*n - 1).
_L_MARGIN_BITS = 32
_WINDOW_BITS = 8
_WINDOW_RADIX = 1 << _WINDOW_BITS


# ---------------------------------------------------------------------------
# Key material
# ---------------------------------------------------------------------------


class PublicDeviceKey(nn.Module):
    """Device-resident public key material.  Buffers: the generators P, Q
    (limbs), the bits of n (key_bits of them, MSB first: the limb Miller
    loops) and its Miller digits n_naf (the RNS loop), the bits of l
    (final exp), pair_qq = e(Q, Q) [2, L] (L2 re-randomization), the
    radix-256 window tables of P and Q as RNS residues [J, R, 2k] (row d
    of window j = base^(d*256^j), row 0 the identity), laid out so that
    the dual_ladder kernel reads a row as one contiguous run, and the same
    tables as limbs, p_tab and q_tab = AffinePoint [L, J, R] (the limb
    fixed-base ladders: the L1 re-randomization, and Encrypt under
    rns_miller="0").  A key without an RNS context (rns None, see
    _make_rns) has no residue tables: p_win and q_win are None."""

    def __init__(self, ctx: MontCtx, rns: RNSCtx | None, P: AffinePoint,
                 Q: AffinePoint, n_bits, n_naf, l_bits, pair_qq, p_win,
                 q_win, p_tab: AffinePoint, q_tab: AffinePoint):
        super().__init__()
        self.ctx = ctx
        self.rns = rns
        for name, pt in (("P", P), ("Q", Q), ("p_tab", p_tab),
                         ("q_tab", q_tab)):
            for f in AffinePoint._fields:
                self.register_buffer(f"{name}_{f}", getattr(pt, f))
        self.register_buffer("n_bits",
                             torch.as_tensor(n_bits, dtype=torch.int64))
        self.register_buffer("n_naf", torch.as_tensor(n_naf, dtype=torch.int64))
        self.register_buffer("l_bits",
                             torch.as_tensor(l_bits, dtype=torch.int64))
        self.register_buffer("pair_qq",
                             torch.as_tensor(pair_qq, dtype=torch.int64))
        for name, win in (("p_win", p_win), ("q_win", q_win)):
            for f, t in zip("xy", win or (None, None)):
                self.register_buffer(
                    f"{name}_{f}",
                    None if t is None else torch.as_tensor(t).contiguous())

    @property
    def P(self) -> AffinePoint:
        return AffinePoint(self.P_x, self.P_y, self.P_inf)

    @property
    def Q(self) -> AffinePoint:
        return AffinePoint(self.Q_x, self.Q_y, self.Q_inf)

    @property
    def p_tab(self) -> AffinePoint:
        return AffinePoint(self.p_tab_x, self.p_tab_y, self.p_tab_inf)

    @property
    def q_tab(self) -> AffinePoint:
        return AffinePoint(self.q_tab_x, self.q_tab_y, self.q_tab_inf)

    @property
    def p_win(self):
        return None if self.p_win_x is None else (self.p_win_x, self.p_win_y)

    @property
    def q_win(self):
        return None if self.q_win_x is None else (self.q_win_x, self.q_win_y)


@dataclasses.dataclass
class PolyEncodingParams:
    """Reference PolyEncodingParams (bgn.go:20-24)."""

    poly_base: int
    fp_scale_base: int
    fp_precision: float


class BGNPublicKey:
    """Public key: host metadata + device arrays + op methods
    (reference PublicKey, bgn.go:28-41).  poly_params: the plaintext
    encodings' parameters; n_digits_kind: the Miller digit encoding keygen
    chose ("naf" or "bits"), which serialization records."""

    def __init__(self, key_bits: int, n: int, l: int, p: int,
                 msg_space: int, deterministic: bool,
                 P_host: Tuple[int, int], Q_host: Tuple[int, int],
                 dev: PublicDeviceKey,
                 poly_params: PolyEncodingParams | None = None,
                 n_digits_kind: str | None = None):
        self.key_bits = key_bits
        self.n = n
        self.l = l
        self.p = p
        self.msg_space = msg_space
        self.deterministic = deterministic
        self.P_host = P_host
        self.Q_host = Q_host
        self.dev = dev
        self.poly_params = poly_params
        self.n_digits_kind = n_digits_kind
        self._encoding_tables = None  # encoding.compute_encoding_table
        self._sampler_ctx = None      # lazy MontCtx mod n (encrypt_device)

    @profiling.traced("scheme")
    def encrypt(self, ms: Sequence[int], rng=None) -> "Ciphertext":
        """Randomized encryption of a batch of ints (Encrypt, bgn.go:334)."""
        ms = _to_list(ms)
        rs = [_rand_below(self.n, rng) for _ in ms]
        return self.encrypt_with_randomness(ms, rs)

    @profiling.traced("scheme")
    def encrypt_with_randomness(self, ms, rs) -> "Ciphertext":
        """C = P^m * Q^r (EncryptWithRandomness, bgn.go:340-353).  The
        batch is padded to a power of two (min 8) as in the JAX package;
        padding lanes encrypt 0 and are sliced off."""
        ms = _to_list(ms)
        rs = _to_list(rs)
        B = len(ms)
        Bp = _bucket(B)
        m_digits, m_neg = _signed_digits(ms + [0] * (Bp - B), self.n)
        r_digits, r_neg = _signed_digits(rs + [0] * (Bp - B), self.n)
        if np.any(r_neg):
            raise ValueError("randomness must be non-negative")
        pt = _encrypt_kernel(self.dev, m_digits, m_neg, r_digits)
        return Ciphertext(pt, level2=False)[:B]

    @profiling.traced("scheme")
    def encrypt_device(self, ms, generator: torch.Generator) -> "Ciphertext":
        """Randomized encryption with the randomness drawn on the device:
        the exponent r of Q^r is 16-bit limbs from `generator` (a
        torch.Generator on the key's device) reduced mod n with < 2^-64
        bias (utils/rng.py).  The host-random `encrypt` remains the default
        (crypto/rand, bgn.go:567)."""
        ms = _to_list(ms)
        B = len(ms)
        Bp = _bucket(B)
        m_digits, m_neg = _signed_digits(ms + [0] * (Bp - B), self.n)
        if self._sampler_ctx is None:
            self._sampler_ctx = rng_mod.make_device_sampler_ctx(
                self.n, device=self.dev.n_naf.device)
        J = -(-self.n.bit_length() // _WINDOW_BITS)
        r_digits = _device_r_digits(self._sampler_ctx, generator, Bp, J)
        pt = _encrypt_kernel(self.dev, m_digits, m_neg, r_digits)
        return Ciphertext(pt, level2=False)[:B]

    @profiling.traced("scheme")
    def encrypt_deterministic(self, ms) -> "Ciphertext":
        """C = P^m (EncryptDeterministic, bgn.go:325-331); the batch is
        padded to a power of two (min 8) as in encrypt_with_randomness."""
        ms = _to_list(ms)
        B = len(ms)
        m_digits, m_neg = _signed_digits(ms + [0] * (_bucket(B) - B), self.n)
        return Ciphertext(_encrypt_det_kernel(self.dev, m_digits, m_neg),
                          level2=False)[:B]

    @profiling.traced("scheme")
    def encrypt_zero(self, batch: int = 1) -> "Ciphertext":
        """E_det(0) = O (encryptZero, bgn.go:562-564)."""
        return self.encrypt_deterministic([0] * batch)

    @profiling.traced("scheme")
    def add(self, a: "Ciphertext", b: "Ciphertext", rng=None) -> "Ciphertext":
        """Homomorphic addition with level promotion (Add, bgn.go:442).
        rng: the re-randomization's source, which a deterministic key
        skips."""
        a, b = self._promote(a, b)
        if a.level2:
            out = _add_l2_kernel(self.dev, a.data, b.data)
            return Ciphertext(self._rerandomize_l2(out, rng), level2=True)
        out = _add_l1_kernel(self.dev, a.data, b.data)
        return Ciphertext(self._rerandomize_l1(out, rng), level2=False)

    @profiling.traced("scheme")
    def sub(self, a: "Ciphertext", b: "Ciphertext", rng=None) -> "Ciphertext":
        """Homomorphic subtraction (Sub, bgn.go:375-433; the bgn.go:411
        level-flag bug is not replicated)."""
        a, b = self._promote(a, b)
        if a.level2:
            out = _sub_l2_kernel(self.dev, a.data, b.data)
            return Ciphertext(self._rerandomize_l2(out, rng), level2=True)
        out = _sub_l1_kernel(self.dev, a.data, b.data)
        return Ciphertext(self._rerandomize_l1(out, rng), level2=False)

    @profiling.traced("scheme")
    def neg(self, a: "Ciphertext", rng=None) -> "Ciphertext":
        """Additive inverse: Sub(E_det(0), c) (Neg, bgn.go:436-439)."""
        zero = self.encrypt_zero(batch=_flat(a.batch_shape)) \
            .reshape(a.batch_shape)
        return self.sub(zero, a, rng=rng)

    @profiling.traced("scheme")
    def mult(self, a: "Ciphertext", b: "Ciphertext", rng=None) -> "Ciphertext":
        """Ciphertext-ciphertext multiply via the pairing (Mult,
        bgn.go:294): two L1 inputs, one L2 result."""
        if a.level2 or b.level2:
            raise ValueError("Mult requires two level-1 ciphertexts")
        out = _mult_kernel(self.dev, a.data, b.data)
        return Ciphertext(self._rerandomize_l2(out, rng), level2=True)

    @profiling.traced("scheme")
    def mult_const(self, a: "Ciphertext", ks, rng=None) -> "Ciphertext":
        """Multiply by plaintext constant(s): C^k (MultConst, bgn.go:253).

        ks: a scalar or [batch] ints (negative allowed, via negation).
        Per-element RNS ladders (rns_pairing.scalar_mul_vec_rns /
        fp2_pow_vec_rns).  The G1 ladder's incomplete additions are safe
        only while 2^nbits < min(q1, q2); an L1 exponent wider than
        key_bits//2 - 2 bits (only |k| ~ n) takes the complete limb
        ladder (curve.scalar_mul), as every exponent does, at both
        levels, under rns_miller="0"."""
        ks = _const_list(ks, a.batch_shape)
        k_bits, k_neg = _signed_bits(ks, self.n)
        k_bits = k_bits.reshape((k_bits.shape[0],) + tuple(a.batch_shape))
        k_neg = k_neg.reshape(tuple(a.batch_shape))
        rns = pairing_mod.use_rns(self.dev.rns)
        if a.level2:
            kern = (_mult_const_l2_rns_kernel if rns
                    else _mult_const_l2_kernel)
            out = kern(self.dev, a.data, k_bits, k_neg)
            return Ciphertext(self._rerandomize_l2(out, rng), level2=True)
        kern = (_mult_const_l1_rns_kernel
                if rns and k_bits.shape[0] <= self.key_bits // 2 - 2
                else _mult_const_l1_kernel)
        out = kern(self.dev, a.data, k_bits, k_neg)
        return Ciphertext(self._rerandomize_l1(out, rng), level2=False)

    @profiling.traced("scheme")
    def make_l2(self, a: "Ciphertext") -> "Ciphertext":
        """Promote L1 -> L2 via e(C, P) (makeL2, bgn.go:316-321)."""
        if a.level2:
            return a
        return Ciphertext(_make_l2_kernel(self.dev, a.data), level2=True)

    def _promote(self, a: "Ciphertext", b: "Ciphertext"):
        if a.level2 and not b.level2:
            b = self.make_l2(b)
        if b.level2 and not a.level2:
            a = self.make_l2(a)
        return a, b

    def _rerandomize_l1(self, pt: AffinePoint, rng) -> AffinePoint:
        """Multiply by Q^r unless deterministic (e.g. bgn.go:484-496); one
        r per lane from rng, in the JAX package's order."""
        if self.deterministic:
            return pt
        r_digits, _ = _signed_digits(
            [_rand_below(self.n, rng) for _ in range(_flat(pt.inf.shape))],
            self.n)
        r_digits = r_digits.reshape((r_digits.shape[0],)
                                    + tuple(pt.inf.shape))
        return _rerand_l1_kernel(self.dev, pt, r_digits)

    def _rerandomize_l2(self, z, rng):
        """Multiply by e(Q, Q)^r unless deterministic (e.g.
        bgn.go:462-475)."""
        if self.deterministic:
            return z
        shape = tuple(z.shape[2:])
        r_bits, _ = _signed_bits([_rand_below(self.n, rng)
                                  for _ in range(_flat(shape))], self.n)
        r_bits = r_bits.reshape((r_bits.shape[0],) + shape)
        return _rerand_l2_kernel(self.dev, z, r_bits)

    def setup_decryption(self, sk: "BGNSecretKey",
                         rng=None) -> bsgs_mod.DecryptTables:
        """Precompute gsk values + BSGS tables (SetupDecryption,
        bgn.go:195-201)."""
        import random as _random
        rng = rng or _random.Random(secrets.randbits(64))
        gk = hm.GoldenKey(params=sk.a1_params, P=self.P_host, Q=self.Q_host,
                          R=sk.r, msg_space=self.msg_space)
        return bsgs_mod.build_decrypt_tables(gk, self.dev.ctx, rng)


class BGNSecretKey:
    """Secret key {q1, R, poly_base} (reference SecretKey, bgn.go:57-62)."""

    def __init__(self, a1_params: hm.A1Params, r: int, poly_base: int):
        self.a1_params = a1_params
        self.key = a1_params.q1
        self.r = r
        self.poly_base = poly_base
        nb = a1_params.q1.bit_length()
        self.q1_bits = lb.int_to_bits(a1_params.q1, nb)
        self.q1_naf, _ = _exp_digits(
            a1_params.q1, nb, (a1_params.q1, a1_params.q2, a1_params.n))

    @profiling.traced("scheme")
    def decrypt(self, ct: "Ciphertext", pk: BGNPublicKey,
                tables: bsgs_mod.DecryptTables):
        """Batched decrypt; raises if any element is out of range."""
        vals, ok = self.decrypt_with_status(ct, pk, tables)
        if not bool(np.all(ok)):
            raise ValueError("cannot find discrete log; out of bounds")
        return vals

    @profiling.traced("scheme")
    def decrypt_failsafe(self, ct: "Ciphertext", pk: BGNPublicKey,
                         tables: bsgs_mod.DecryptTables):
        """Failed lanes decrypt to 0 (DecryptFailSafe, bgn.go:210-216)."""
        vals, ok = self.decrypt_with_status(ct, pk, tables)
        return np.where(ok, vals, 0)

    @profiling.traced("scheme")
    def decrypt_with_status(self, ct: "Ciphertext", pk: BGNPublicKey,
                            tables: bsgs_mod.DecryptTables):
        """Returns (values int64 [batch], ok bool [batch])."""
        kern = _decrypt_l2_kernel if ct.level2 else _decrypt_l1_kernel
        found, m = kern(pk.dev, tables, self.q1_bits, ct.data, self.q1_naf)
        with profiling.span("wait.decrypt_status"):
            return (np.atleast_1d(m.cpu().numpy()).astype(np.int64),
                    np.atleast_1d(found.cpu().numpy()).astype(bool))


@dataclasses.dataclass(frozen=True)
class Ciphertext:
    """A batch of BGN ciphertexts: data is an AffinePoint (level 1) or a
    [2, L, *batch] tensor (level 2)."""

    data: Any
    level2: bool

    @property
    def batch_shape(self):
        if self.level2:
            return tuple(self.data.shape[2:])
        return tuple(self.data.inf.shape)

    def reshape(self, batch_shape) -> "Ciphertext":
        batch_shape = tuple(batch_shape)
        if self.level2:
            return Ciphertext(self.data.reshape(self.data.shape[:2]
                                                + batch_shape), True)
        L = self.data.x.shape[0]
        return Ciphertext(AffinePoint(self.data.x.reshape((L,) + batch_shape),
                                      self.data.y.reshape((L,) + batch_shape),
                                      self.data.inf.reshape(batch_shape)),
                          False)

    def __getitem__(self, idx) -> "Ciphertext":
        """Slice along the leading batch axis."""
        if self.level2:
            return Ciphertext(self.data[:, :, idx], True)
        return Ciphertext(AffinePoint(self.data.x[:, idx],
                                      self.data.y[:, idx],
                                      self.data.inf[idx]), False)

    def string(self, pk) -> str:
        """Canonical hex of every batch element, one per line (the analog
        of Ciphertext.String, ciphertext.go:60-62; needs pk to leave the
        Montgomery domain)."""
        flat = self.reshape((_flat(self.batch_shape) or 1,))
        nb = 2 * pk.dev.ctx.L
        if self.level2:
            vals = convert.fp2_to_host(pk.dev.ctx, flat.data)
            return "\n".join(f"[{re:0{2 * nb}x}, {im:0{2 * nb}x}]"
                             for re, im in vals)
        pts = convert.affine_to_host(pk.dev.ctx, flat.data)
        return "\n".join("O" if P is None
                         else f"[{P[0]:0{2 * nb}x}, {P[1]:0{2 * nb}x}]"
                         for P in pts)


# ---------------------------------------------------------------------------
# Keygen
# ---------------------------------------------------------------------------


def keygen(key_bits: int, msg_space: int, poly_base: int = 3,
           fp_scale_base: int = 3, fp_precision: float = 0.0001,
           deterministic: bool = True, rng=None, device="cuda"
           ) -> Tuple[BGNPublicKey, BGNSecretKey]:
    """Generate a BGN key pair (NewKeyGen, bgn.go:65-138) on `device`.

    The host does the number theory; the device arrays are uploaded once.
    Pass a random.Random for a reproducible key: the same seed gives the
    JAX package's key.  The encoding tables are computed as the reference
    does at the end of NewKeyGen (bgn.go:135)."""
    device = _check_device(device)
    gk = hm.golden_keygen(key_bits, msg_space, rng)
    params = gk.params
    L = lb.num_limbs_for_bits(key_bits + _L_MARGIN_BITS)
    if params.p.bit_length() > 16 * L:
        raise ValueError("cofactor l unexpectedly large; retry keygen")
    n_naf, n_digits_kind = _exp_digits(params.n, key_bits,
                                       (params.q1, params.q2, params.n))
    dev = _device_key(key_bits, params.n, params.l, params.p, L, gk.P, gk.Q,
                      n_naf, hm.tate_pairing(gk.Q, gk.Q, params), device)
    pk = BGNPublicKey(key_bits=key_bits, n=params.n, l=params.l, p=params.p,
                      msg_space=msg_space, deterministic=deterministic,
                      P_host=gk.P, Q_host=gk.Q, dev=dev,
                      poly_params=PolyEncodingParams(poly_base,
                                                     fp_scale_base,
                                                     fp_precision),
                      n_digits_kind=n_digits_kind)
    sk = BGNSecretKey(params, gk.R, poly_base)
    encoding.compute_encoding_table(pk)
    return pk, sk


def validate_public_key_parts(n: int, l: int, p: int, P_host,
                              Q_host) -> None:
    """Structural A1 invariants of loaded key material: p = l*n - 1 prime
    with p == 3 (mod 4), l a positive multiple of 4, generators on the
    curve with coordinates < p and annihilated by n.  The reference's
    SetBytes path (bgn.go:501-560) checks none of this; a corrupted key
    file raises here instead of decrypting garbage.  (Membership of Q in
    the order-q1 subgroup needs the secret factorization.)"""
    if p != l * n - 1:
        raise ValueError("invalid key: p != l*n - 1")
    if p % 4 != 3:
        raise ValueError("invalid key: p != 3 (mod 4)")
    if l % 4 != 0 or l <= 0:
        raise ValueError("invalid key: cofactor l not a positive "
                         "multiple of 4")
    if not hm.is_probable_prime(p):
        raise ValueError("invalid key: p is not prime")
    for name, pt in (("P", P_host), ("Q", Q_host)):
        if pt is None:
            raise ValueError(f"invalid key: generator {name} is the "
                             "identity")
        x, y = pt
        if not (0 <= x < p and 0 <= y < p):
            raise ValueError(f"invalid key: {name} coordinate >= p")
        if not hm.on_curve((x, y), p):
            raise ValueError(f"invalid key: {name} not on the curve")
        if hm.ec_mul(n, (x, y), p) is not None:
            raise ValueError(f"invalid key: {name} order does not "
                             "divide n")


def public_key_from_parts(key_bits: int, n: int, l: int, p: int,
                          msg_space: int, deterministic: bool,
                          poly_params: PolyEncodingParams,
                          P_host: Tuple[int, int],
                          Q_host: Tuple[int, int],
                          n_digits: str | None = None,
                          validate: bool = True,
                          device="cuda") -> BGNPublicKey:
    """Rebuild a whole public key on `device` from its host parts (the
    pairing re-binding of UnmarshalBinary, bgn.go:626-666, plus the
    invariant checks of validate_public_key_parts; validate=False skips
    them): the Montgomery and RNS contexts, the window tables, the Miller
    digits and the encoding tables.  n_digits replays the digit encoding
    keygen chose; without it the chain check runs mod n only (the public
    view has no q1, q2).  For the parts of a keygen key every tensor
    equals keygen's."""
    device = _check_device(device)
    if validate:
        validate_public_key_parts(n, l, p, P_host, Q_host)
    L = lb.num_limbs_for_bits(max(key_bits + _L_MARGIN_BITS,
                                  p.bit_length()))
    params = hm.A1Params(q1=0, q2=0, n=n, l=l, p=p)  # public view
    n_naf, n_digits_kind = _exp_digits(n, key_bits, (n,), force=n_digits)
    dev = _device_key(key_bits, n, l, p, L, tuple(P_host), tuple(Q_host),
                      n_naf, hm.tate_pairing(tuple(Q_host), tuple(Q_host),
                                             params), device)
    pk = BGNPublicKey(key_bits=key_bits, n=n, l=l, p=p, msg_space=msg_space,
                      deterministic=deterministic, P_host=tuple(P_host),
                      Q_host=tuple(Q_host), dev=dev, poly_params=poly_params,
                      n_digits_kind=n_digits_kind)
    encoding.compute_encoding_table(pk)
    return pk


def _check_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "plain PyTorch versions")
    return device


def _device_key(key_bits: int, n: int, l: int, p: int, L: int, P_host,
                Q_host, n_naf, pair_qq, device) -> PublicDeviceKey:
    """The device half of a public key from host parts: contexts, points,
    digit vectors, e(Q, Q) and the window tables (RNS residues and
    limbs)."""
    ctx = mg.make_mont_ctx(p, L=L, device=device)
    rns = _make_rns(p, L, device)
    p_rows = _window_table(P_host, p, key_bits)
    q_rows = _window_table(Q_host, p, key_bits)

    def limb_table(rows):
        return convert.affine_from_host(
            ctx, rows, batch_shape=(len(rows) // _WINDOW_RADIX,
                                    _WINDOW_RADIX))

    return PublicDeviceKey(
        ctx=ctx, rns=rns,
        P=convert.point_from_host(ctx, P_host),
        Q=convert.point_from_host(ctx, Q_host),
        n_bits=lb.int_to_bits(n, key_bits),
        n_naf=n_naf,
        l_bits=lb.int_to_bits(l, 32),
        pair_qq=convert.fp2_single_from_host(ctx, pair_qq),
        p_win=None if rns is None else _win_rns(p, L, p_rows),
        q_win=None if rns is None else _win_rns(p, L, q_rows),
        p_tab=limb_table(p_rows),
        q_tab=limb_table(q_rows),
    ).to(device)


def _make_rns(p: int, L: int, device) -> RNSCtx | None:
    """RNS context for the key, or None where the RNS path cannot serve
    it: p beyond the 12-bit prime pool (make_rns_ctx raises, and the JAX
    package's _make_rns returns None) or more than
    cuda_rns.K_KERNEL_MAX channels per base (no RNS kernel is
    instantiated there).  The rule is the same on every device.  Without
    a context pairing.use_rns is false, so every op takes its limb branch
    (the one rns_miller="0" runs); values are canonical, so the results
    are those of the RNS path.  On the card the kernels' constants are
    uploaded here, with the key, so that no op uploads them."""
    try:
        if rn.select_channels(p)[2] > cuda_rns.K_KERNEL_MAX:
            return None
        rns = rn.make_rns_ctx(p, L=L, device=device)
    except ValueError:
        return None
    if rns.m.is_cuda:
        cuda_rns.kernel_consts(rns)
    return rns


def _window_table(base, p: int, key_bits: int) -> list:
    """Host rows of the radix-2^w fixed-base table: entry (j, d) =
    base^(d*R^j), R = _WINDOW_RADIX, row-major over (j, d); d = 0 is the
    identity (None).  The J windows advance together (entry d = entry
    d-1 + base^(R^j)), so each step shares one inversion."""
    R = _WINDOW_RADIX
    J = -(-key_bits // _WINDOW_BITS)
    gens = [base]
    for _ in range(J - 1):
        gen = gens[-1]
        for _ in range(_WINDOW_BITS):
            gen = hm.ec_dbl(gen, p)
        gens.append(gen)
    cols = [[None] * J, gens]
    for _ in range(2, R):
        cols.append(_batch_ec_add(cols[-1], gens, p))
    return [cols[d][j] for j in range(J) for d in range(R)]


def _batch_ec_add(Ps, Qs, p: int) -> list:
    """[hm.ec_add(P, Q, p) for P, Q in zip(Ps, Qs)] with one modular
    inversion for the batch (Montgomery's trick); lanes with the identity
    or opposite points go to hm.ec_add itself."""
    dens = []
    for P, Q in zip(Ps, Qs):
        if P is None or Q is None or (P[0] == Q[0]
                                      and (P[1] + Q[1]) % p == 0):
            dens.append(None)
        else:
            dens.append((2 * P[1] if P[0] == Q[0] else Q[0] - P[0]) % p)
    live = [d for d in dens if d is not None]
    pre = [1]
    for d in live:
        pre.append(pre[-1] * d % p)
    inv = pow(pre[-1], -1, p)
    invs = [0] * len(live)
    for i in range(len(live) - 1, -1, -1):
        invs[i] = inv * pre[i] % p
        inv = inv * live[i] % p
    out, it = [], iter(invs)
    for P, Q, d in zip(Ps, Qs, dens):
        if d is None:
            out.append(hm.ec_add(P, Q, p))
            continue
        (x1, y1), (x2, y2) = P, Q
        lam = (3 * x1 * x1 + 1 if x1 == x2 else y2 - y1) * next(it) % p
        x3 = (lam * lam - x1 - x2) % p
        out.append((x3, (lam * (x1 - x3) - y1) % p))
    return out


def _win_rns(p: int, L: int, rows) -> Tuple[np.ndarray, np.ndarray]:
    """RNS-Montgomery residues (v*A mod p, bound 1) of a window table's
    host rows, as float32 [J, R, 2k] for x and y (host math + one numpy
    digit matmul; the identity rows are residues of 0)."""
    A_list, B_list, _ = rn.select_channels(p)
    m = np.array(A_list + B_list, dtype=np.int64)
    A = 1
    for v in A_list:
        A *= v
    d8 = 2 * L
    pow2 = np.array([[pow(256, d, int(mc)) for d in range(d8)]
                     for mc in m], dtype=np.int64)          # [2k, D8]
    R = _WINDOW_RADIX
    J = len(rows) // R

    def residues(vals):
        buf = bytearray(d8 * len(vals))
        for b, v in enumerate(vals):
            buf[b * d8:(b + 1) * d8] = (v * A % p).to_bytes(d8, "little")
        digits = np.frombuffer(bytes(buf), dtype=np.uint8)
        digits = digits.reshape(len(vals), d8).astype(np.float64)  # [B, D8]
        # exact in float64: every partial sum is below 2 L * 2^8 * 2^12
        S = (digits @ pow2.T.astype(np.float64)).astype(np.int64)  # [B, 2k]
        return (S % m[None, :]).astype(np.float32).reshape(J, R, -1)

    xs = [0 if P is None else P[0] for P in rows]
    ys = [0 if P is None else P[1] for P in rows]
    return residues(xs), residues(ys)


def _signed_digits(values, n: int):
    """Host ints -> (radix-2^w digits [J, B] int64 of |v| mod n, neg mask
    [B] int64).  J follows _bits_width, as in the JAX package."""
    values = [int(v) for v in values]
    neg = np.asarray([1 if v < 0 else 0 for v in values], dtype=np.int64)
    mags = [abs(v) % n for v in values]
    nbits = min(_bits_width(mags), n.bit_length())
    J = -(-nbits // _WINDOW_BITS)
    buf = b"".join(v.to_bytes(J, "little") for v in mags)
    digits = np.frombuffer(buf, dtype=np.uint8) \
        .reshape(len(mags), J).T.astype(np.int64)
    return digits, neg


def _signed_bits(values, n: int):
    """Host ints -> (bits [nbits, B] int64 MSB-first of |v| mod n, neg
    mask [B] int64); nbits follows _bits_width, as in the JAX package."""
    values = [int(v) for v in values]
    neg = np.asarray([1 if v < 0 else 0 for v in values], dtype=np.int64)
    mags = [abs(v) % n for v in values]
    nbits = min(_bits_width(mags), n.bit_length())
    nbytes = -(-nbits // 8)
    buf = b"".join(v.to_bytes(nbytes, "big") for v in mags)
    arr = np.unpackbits(np.frombuffer(buf, dtype=np.uint8)
                        .reshape(len(mags), nbytes), axis=1)
    return arr[:, 8 * nbytes - nbits:].T.astype(np.int64), neg


def _const_list(ks, batch_shape) -> list:
    """A scalar or one constant per element of the batch, as a list."""
    arr = np.asarray(ks, dtype=object).reshape(-1)
    B = _flat(batch_shape)
    if arr.size == 1:
        arr = np.repeat(arr, B)
    if arr.size != B:
        raise ValueError("constant batch mismatch")
    return list(arr)


def _flat(shape) -> int:
    return int(np.prod(shape, dtype=np.int64))


def _rand_below(n: int, rng=None) -> int:
    """Uniform random int < n (newCryptoRandom, bgn.go:567-574)."""
    if rng is None:
        return secrets.randbelow(n)
    return rng.randrange(n)


def _to_list(values):
    return [int(v) for v in np.atleast_1d(np.asarray(values, dtype=object))]


def _bucket(b: int) -> int:
    """Next power of two >= b (min 8)."""
    n = 8
    while n < b:
        n *= 2
    return n


def _bits_width(values) -> int:
    """Power-of-two-ish bit-width bucket of the largest value."""
    m = max((int(abs(v)).bit_length() for v in values), default=1)
    m = max(m, 1)
    w = 16
    while w < m:
        w *= 2
    return w


def _chain_degenerate(digits, mods) -> bool:
    """True if the MSB-first signed-digit double-and-add chain hits a
    degenerate mixed addition for a base point whose order divides one of
    `mods` (V == addend anywhere, or V == -addend before the last step)."""
    started = False
    c = 0
    nz = [i for i, d in enumerate(digits) if d]
    last = nz[-1] if nz else -1
    for i, d in enumerate(digits):
        d = int(d)
        if not started:
            if d:
                started = True
                c = d
            continue
        c *= 2
        if d:
            for ordc in mods:
                if ordc <= 1:
                    continue
                if (c - d) % ordc == 0:
                    return True
                if (c + d) % ordc == 0 and i != last:
                    return True
            c += d
    return False


def _exp_digits(e: int, width: int, mods, force=None):
    """Signed MSB-first ladder digits for exponent e: NAF when the chain
    is safe for every point order in `mods`, else plain bits; leading
    zeros stripped.  force="naf"/"bits" replays a choice recorded at
    keygen instead of deciding it again (the public view has no q1, q2,
    so a check mod n alone could pick NAF for a key whose keygen fell
    back to bits).  Returns (int64 digits, kind in {"naf", "bits"})."""
    if force is not None:
        if force not in ("naf", "bits"):
            raise ValueError(f"unknown digit encoding {force!r}")
        digits = (lb.int_to_naf(e, width) if force == "naf"
                  else lb.int_to_bits(e, width))
        kind = force
    else:
        naf = lb.int_to_naf(e, width)
        if not _chain_degenerate(naf, mods):
            digits, kind = naf, "naf"
        else:  # pragma: no cover -- probability ~2^-240 per key
            digits = lb.int_to_bits(e, width)
            kind = "bits"
            if _chain_degenerate(digits, mods):
                raise ValueError("degenerate addition chain; regenerate key")
    nz = np.nonzero(digits)[0]
    return (digits[nz[0]:] if nz.size else digits[-1:]), kind


# ---------------------------------------------------------------------------
# Device paths
# ---------------------------------------------------------------------------


def _device_r_digits(sampler_ctx: MontCtx, generator, batch: int, J: int):
    """Device-sampled exponents r < n as radix-2^w window digits
    [J, batch] int64, least significant first."""
    r = rng_mod.device_random_below(sampler_ctx, generator, (batch,))
    per = lb.LIMB_BITS // _WINDOW_BITS          # digits per 16-bit limb
    nl = -(-J // per)
    limbs = r[:nl]
    parts = [(limbs >> (_WINDOW_BITS * i)) & (_WINDOW_RADIX - 1)
             for i in range(per)]
    return torch.stack(parts, dim=1).reshape(-1, batch)[:J]


def _fixed_base(dev: PublicDeviceKey, base: str, digits) -> curve.JacPoint:
    """base^e (base "p" or "q") from its window table: the RNS window
    chain (rns_pairing.fixed_base_mul_rns) on the RNS path, complete limb
    additions over the limb table otherwise."""
    if pairing_mod.use_rns(dev.rns):
        return rns_pairing.fixed_base_mul_rns(
            dev.ctx, dev.rns, getattr(dev, f"{base}_win"), digits)
    return curve.fixed_base_mul(dev.ctx, getattr(dev, f"{base}_tab"), digits)


def _p_pow(dev: PublicDeviceKey, m_digits, m_neg) -> curve.JacPoint:
    """P^m: P^|m| from _fixed_base, Y negated where m < 0."""
    g = _fixed_base(dev, "p", m_digits)
    neg = torch.as_tensor(m_neg, device=g.Y.device)
    return curve.JacPoint(g.X, lb.select(neg, mg.mod_neg(dev.ctx, g.Y), g.Y),
                          g.Z)


def _encrypt_kernel(dev: PublicDeviceKey, m_digits, m_neg, r_digits):
    """Both window chains + the g +- h combine (dual_ladder kernel), then
    the RNS normalize (batch-inversion scans + one pow_loop).  In step
    mode (rns_pallas="1") and under rns_miller="0" the JAX package's split
    path instead: the two window chains apart (_fixed_base), h
    normalized, one complete limb madd and the normalize; the canonical
    affine result is the same.  Digits: host arrays or device tensors."""
    if rns_pairing._mode() == "step" or not pairing_mod.use_rns(dev.rns):
        ctx = dev.ctx
        h_aff = curve.normalize(ctx, _fixed_base(dev, "q", r_digits),
                                rns=dev.rns)
        return curve.normalize(
            ctx, curve.madd(ctx, _p_pow(dev, m_digits, m_neg), h_aff),
            rns=dev.rns)
    device = dev.n_naf.device
    Jm = m_digits.shape[0]
    dig = torch.cat([torch.as_tensor(m_digits, device=device),
                     torch.as_tensor(r_digits, device=device)], dim=0)
    mneg = torch.as_tensor(m_neg, device=device)
    X, Y, Z = cuda_rns.dual_ladder(dev.rns, dev.p_win, dev.q_win, Jm, dig,
                                   mneg)
    return rns_pairing.normalize_rns(dev.ctx, dev.rns, X, Y, Z)


def _encrypt_det_kernel(dev: PublicDeviceKey, m_digits, m_neg):
    """P^|m| from P's window table (window_ladder_tab kernel), Y negated
    where m < 0, then the RNS normalize; under rns_miller="0" the limb
    chain over P's limb table and the limb normalize."""
    if not pairing_mod.use_rns(dev.rns):
        return curve.normalize(dev.ctx, _p_pow(dev, m_digits, m_neg),
                               rns=dev.rns)
    X, Y, Z = rns_pairing.fixed_base_mul_rns(dev.ctx, dev.rns, dev.p_win,
                                             m_digits, raw=True)
    Yn = rns_pairing.neg_y_rns(dev.rns, Y.v, Y.bound, m_neg)
    return rns_pairing.normalize_rns(dev.ctx, dev.rns, X.v, Yn, Z.v)


def _add_l1_kernel(dev: PublicDeviceKey, a: AffinePoint, b: AffinePoint):
    """The complete group law in RNS; under rns_miller="0" the complete
    limb addition and the limb normalize."""
    if pairing_mod.use_rns(dev.rns):
        return rns_pairing.add_complete_rns(dev.ctx, dev.rns, a, b)
    return curve.normalize(dev.ctx, curve.add_affine(dev.ctx, a, b),
                           rns=dev.rns)


def _sub_l1_kernel(dev: PublicDeviceKey, a: AffinePoint, b: AffinePoint):
    return _add_l1_kernel(dev, a, curve.neg_affine(dev.ctx, b))


def _add_l2_kernel(dev: PublicDeviceKey, a, b):
    return fp2.mul(dev.ctx, a, b)


def _sub_l2_kernel(dev: PublicDeviceKey, a, b):
    """GT division; GT is unitary, so b^-1 = conj(b)."""
    return fp2.mul(dev.ctx, a, fp2.conj(dev.ctx, b))


def _make_l2_kernel(dev: PublicDeviceKey, a: AffinePoint):
    return pairing_mod.pairing(dev.ctx, a, dev.P, dev.n_bits, dev.l_bits,
                               rns=dev.rns, n_naf=dev.n_naf)


def _mult_const_l1_kernel(dev: PublicDeviceKey, a: AffinePoint, k_bits,
                          k_neg):
    """The complete limb double-and-add (curve.scalar_mul, per-element
    bits) for exponents too wide for the RNS ladder, Y negated where
    k < 0, then the limb normalize."""
    ctx = dev.ctx
    r = curve.scalar_mul(ctx, a, k_bits)
    neg = torch.as_tensor(k_neg, device=r.Y.device)
    r = curve.JacPoint(r.X, lb.select(neg, mg.mod_neg(ctx, r.Y), r.Y), r.Z)
    return curve.normalize(ctx, r, rns=dev.rns)


def _mult_const_l1_rns_kernel(dev: PublicDeviceKey, a: AffinePoint, k_bits,
                              k_neg):
    """Per-element RNS double-and-add; negation and the normalize stay in
    RNS."""
    X, Y, Z = rns_pairing.scalar_mul_vec_rns(dev.ctx, dev.rns, a, k_bits)
    Yn = rns_pairing.neg_y_rns(dev.rns, Y.v, Y.bound, k_neg.reshape(-1))
    aff = rns_pairing.normalize_rns(dev.ctx, dev.rns, X.v, Yn, Z.v)
    return AffinePoint(aff.x.reshape(a.x.shape), aff.y.reshape(a.y.shape),
                       aff.inf.reshape(a.inf.shape))


def _mult_const_l2_rns_kernel(dev: PublicDeviceKey, a, k_bits, k_neg):
    r = rns_pairing.fp2_pow_vec_rns(dev.ctx, dev.rns, a, k_bits)
    mask = torch.as_tensor(k_neg, device=r.device)
    return fp2.select(mask, fp2.conj(dev.ctx, r), r)


def _mult_const_l2_kernel(dev: PublicDeviceKey, a, k_bits, k_neg):
    """a^k on limbs (per-element square-and-multiply), conjugated where
    k < 0 (GT is unitary)."""
    r = fp2.pow_bits(dev.ctx, a, k_bits)
    mask = torch.as_tensor(k_neg, device=r.device)
    return fp2.select(mask, fp2.conj(dev.ctx, r), r)


def _mult_kernel(dev: PublicDeviceKey, a: AffinePoint, b: AffinePoint):
    return pairing_mod.pairing(dev.ctx, a, b, dev.n_bits, dev.l_bits,
                               rns=dev.rns, n_naf=dev.n_naf)


def _rerand_l1_kernel(dev: PublicDeviceKey, pt: AffinePoint, r_digits):
    """pt + Q^r: Q^r from Q's limb window table, normalized, then one
    complete limb addition and the normalize."""
    ctx = dev.ctx
    h = curve.normalize(ctx, curve.fixed_base_mul(ctx, dev.q_tab, r_digits),
                        rns=dev.rns)
    return curve.normalize(ctx, curve.add_affine(ctx, pt, h), rns=dev.rns)


def _rerand_l2_kernel(dev: PublicDeviceKey, z, r_bits):
    """z * e(Q, Q)^r on limbs (per-element square-and-multiply)."""
    mask = fp2.pow_bits(dev.ctx, dev.pair_qq, r_bits)
    return fp2.mul(dev.ctx, z, mask)


def _decrypt_l2_kernel(dev: PublicDeviceKey, tables, q1_bits, z, q1_naf):
    """csk = z^q1 (fp2_pow_loop over the signed digits: L2 ciphertexts
    are unitary), then the RNS giant-step scan and digest lookup; under
    rns_miller="0" the limb power over the bits of q1 and the limb scan."""
    if not pairing_mod.use_rns(dev.rns):
        return bsgs_mod.bsgs_gt(dev.ctx, tables,
                                fp2.pow_bits(dev.ctx, z, q1_bits))
    batch_shape = tuple(z.shape[2:])
    L = dev.ctx.L
    zf = z.reshape(2, L, -1)
    zr, zi = rns_pairing.fp2_pow_rns(dev.ctx, dev.rns, zf, q1_naf,
                                     unitary=True, raw=True)
    found, m = bsgs_mod.bsgs_gt_rns(dev.ctx, dev.rns, tables, zr, zi)
    return found.reshape(batch_shape), m.reshape(batch_shape)


def _decrypt_l1_kernel(dev: PublicDeviceKey, tables, q1_bits,
                       pt: AffinePoint, q1_naf):
    """csk = C^q1 (ladder_loop kernel), then the RNS giant-step scan and
    digest lookup; only the final affine candidates leave RNS.  Under
    rns_miller="0": C^q1 by the complete limb double-and-add over the
    bits of q1 (bgn.go:223), then the limb scan."""
    if not pairing_mod.use_rns(dev.rns):
        return bsgs_mod.bsgs_g1(dev.ctx, tables,
                                curve.scalar_mul(dev.ctx, pt, q1_bits))
    batch_shape = tuple(pt.inf.shape)
    Xr, Yr, Zr = rns_pairing.scalar_mul_rns(dev.ctx, dev.rns, pt, q1_naf)
    found, m = bsgs_mod.bsgs_g1_rns(dev.ctx, dev.rns, tables, Xr, Yr, Zr,
                                    pt.inf.reshape(-1))
    return found.reshape(batch_shape), m.reshape(batch_shape)
