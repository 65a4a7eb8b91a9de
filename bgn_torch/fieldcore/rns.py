"""RNS (residue number system) Montgomery arithmetic in PyTorch.

The port's counterpart of `bgn_tpu/fieldcore/rns.py`, which holds the full
derivation and exactness audit.  An F_p element is a float32 tensor
[2k, N] of residues modulo 12-bit primes, CHANNEL-MAJOR: base A = m[:k],
base B = m[k:].  Montgomery domain R_rns = A = prod(m[:k]).  `RVal` pairs
the residues with a static bound (value < bound * p); `r_mul` checks
bound_x * bound_y <= h.

One r_mul: d = x*y (channelwise), two base extensions as matmuls of a
[3k+1, 2k] constant against the 6-bit digit split of the source residues,
and one-sided reductions (`_red`).  Every fp32 value is an integer below
2^24, so the float32 products and sums are exact in any order.

The one exception is the alpha estimate of the narrow path (row 3k of
the extension matrix): its sum exceeds 2^24, so an fp32 sum would round
in an order-dependent way.  Here it is summed in float64, where it is
exact; the CUDA kernels (ops/cuda_rns.py) sum it in int32.  The port's
kernels and this plain version therefore agree bit for bit on raw
residues.  Against the JAX package they agree in the value mod p (its
fp32 alpha may read a value as value + p, which its audit allows).

Integer matmuls (the limb <-> residue conversions) run in float64: every
partial sum is an integer below 2^53.  float32 matmuls run with TF32 off
(ops/cuda_rns.py asserts it); bf16 is never used (a bf16 torch matmul
rounds its output).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from . import limbs as lb

_ALPHA_SCALE = 19          # alpha weights w = round(2^19 / m): 8-bit values
_EPS_UNDER = -0.4          # ext1: bias alpha DOWN so the error is {0,+1}*A
_EPS_EXACT = 0.5           # ext2/CRT: centered -> exact (value/base small)
_KC = 128                  # C = KC*m bias in _combine_ext; needs alpha < KC
_H_MIN = 1024              # required headroom A/p
_K_NARROW = 64             # narrow (k <= 64) vs wide channel-count path
_KMAX = 32                 # largest bound ever passed to r_sub as K


def _kc(k: int) -> int:
    """The C = KC*m bias constant: must exceed the largest alpha (<= k)."""
    return _KC if k <= _K_NARROW else 1 << max(7, (k + 1).bit_length())


def _primes_desc(lo: int = 1031, hi: int = 4096) -> list:
    """11/12-bit channel primes, descending (host, tiny sieve)."""
    sieve = np.ones(hi, dtype=bool)
    sieve[:2] = False
    for i in range(2, int(hi ** 0.5) + 1):
        if sieve[i]:
            sieve[i * i::i] = False
    ps = np.nonzero(sieve)[0]
    ps = ps[ps >= lo]
    return [int(v) for v in ps[::-1]]


def select_channels(p: int):
    """Deterministic channel choice for modulus p: interleave the prime
    pool between the bases, growing k until both have headroom >= _H_MIN."""
    if p <= 1:
        raise ValueError(f"select_channels needs a modulus > 1, got {p}")
    primes = _primes_desc()
    A, B, k = 1, 1, 0
    target = p * _H_MIN
    while A < target or B < target:
        if 2 * k + 1 >= len(primes):
            raise ValueError(
                "modulus too large for the 12-bit RNS prime pool")
        A *= primes[2 * k]
        B *= primes[2 * k + 1]
        k += 1
    return primes[0:2 * k:2], primes[1:2 * k:2], k


_BUFFERS = ("m", "recip", "kp", "qc_a", "w1", "p_mod_b", "ainv_b",
            "crt_inv_b", "w2", "b_mod_a", "crt_inv_a", "w_alpha_a",
            "one_rns", "c_in", "c_out", "pow2_8", "crt_rows", "a_rows",
            "p_limbs")


class RNSCtx(nn.Module):
    """Device constants for one modulus p, as buffers (same fields and
    meanings as the JAX RNSCtx).  Per-channel vectors are [*, 1] columns.

    m, recip, one_rns, c_in, c_out: f32 [2k, 1]; kp: f32 [2k, KMAX+1];
    qc_a, p_mod_b, ainv_b, crt_inv_b, b_mod_a, crt_inv_a, w_alpha_a:
    f32 [k, 1]; w1, w2: f32 [3k+1, 2k] split extension matrices (bf16-exact
    values); pow2_8: int64 [2k, 2L]; crt_rows: int64 [D8, k]; a_rows:
    int64 [D8, 1]; p_limbs: int64 [L+1]."""

    def __init__(self, k: int, h: int, L: int, **arrays):
        super().__init__()
        for name in _BUFFERS:
            a = arrays[name]
            t = torch.as_tensor(np.asarray(a))
            if t.is_floating_point():
                t = t.to(torch.float32)
            else:
                t = t.to(torch.int64)
            self.register_buffer(name, t.contiguous())
        self.k, self.h, self.L = k, h, L
        self.kernel_blobs = {}     # device -> constants packed for the kernels


def make_rns_ctx(p: int, L: int | None = None, device="cuda") -> RNSCtx:
    """Build the RNS context for modulus p (host-side, exact python ints).

    L: limb count of the companion MontCtx (R = 2^(16L))."""
    if L is None:
        L = lb.num_limbs_for_bits(p.bit_length())
    R = 1 << (16 * L)
    if not (p % 2 and p > (1 << 13)):
        raise ValueError("modulus must be an odd prime > 2^13")

    A_list, B_list, k = select_channels(p)
    A, B = 1, 1
    for a in A_list:
        A *= a
    for b in B_list:
        B *= b
    h = A // p
    assert h >= _H_MIN and B // p >= _H_MIN

    m_all = A_list + B_list
    f32 = np.float32
    m_np = np.array(m_all, dtype=np.int64)

    def col(vals) -> np.ndarray:
        return np.asarray(vals, dtype=f32).reshape(-1, 1)

    def residues(x: int) -> np.ndarray:
        return col([x % m for m in m_all])

    Ainv_mod_b = [pow(A % b, -1, b) for b in B_list]
    AoverAi = [A // a for a in A_list]
    qc_a = [((-pow(p, -1, a)) % a) * pow(AoverAi[i] % a, -1, a) % a
            for i, a in enumerate(A_list)]
    mat1 = np.array(
        [[AoverAi[i] % b * p % b * Ainv_mod_b[j] % b
          for i in range(k)] for j, b in enumerate(B_list)],
        dtype=np.int64)                       # [k(dst j), k(src i)]
    w1a = np.array([round((1 << _ALPHA_SCALE) / a) for a in A_list],
                   dtype=np.int64)

    BoverBj = [B // b for b in B_list]
    crt_inv_b = [pow(BoverBj[j] % B_list[j], -1, B_list[j])
                 for j in range(k)]
    mat2 = np.array([[BoverBj[j] % a for j in range(k)]
                     for a in A_list], dtype=np.int64)
    w2a = np.array([round((1 << _ALPHA_SCALE) / b) for b in B_list],
                   dtype=np.int64)

    def split_w(mat: np.ndarray, w: np.ndarray) -> np.ndarray:
        """[k_dst, k_src] int matrix + [k_src] alpha weights -> f32
        [3k+1, 2k]: rows S = 4096*O1 + 64*O2 + O3 plus the alpha row
        (zero on the wide path, which sums alpha separately)."""
        hi, lo = mat >> 6, mat & 63
        W = np.zeros((3 * k + 1, 2 * k), dtype=np.float32)
        W[0:k, :k] = hi
        W[k:2 * k, :k] = lo
        W[k:2 * k, k:] = hi
        W[2 * k:3 * k, k:] = lo
        if k <= _K_NARROW:
            W[3 * k, :k] = w * 64
            W[3 * k, k:] = w
        return W

    d8_in = 2 * L
    pow2_8 = np.array([[pow(256, d, m) for d in range(d8_in)]
                       for m in m_all], dtype=np.int64)
    D8 = -(-(12 * k) // 8) + 1

    def rows8(x: int, n: int) -> np.ndarray:
        return np.array([(x >> (8 * d)) & 0xFF for d in range(n)],
                        dtype=np.int64)

    crt_rows = np.stack([rows8(AoverAi[i], D8) for i in range(k)], axis=1)
    kmax_p = np.array(
        [[(K * p) % m for K in range(_KMAX + 1)] for m in m_all], dtype=f32)
    # downward-biased reciprocal: see _red
    recip = ((1.0 - 2.0 ** -21) / m_np.astype(np.float64)) \
        .astype(f32).reshape(-1, 1)

    return RNSCtx(
        k, h, L,
        m=col(m_np), recip=recip, kp=kmax_p, qc_a=col(qc_a),
        w1=split_w(mat1, w1a), p_mod_b=col([p % b for b in B_list]),
        ainv_b=col(Ainv_mod_b), crt_inv_b=col(crt_inv_b),
        w2=split_w(mat2, w2a), b_mod_a=col([B % a for a in A_list]),
        crt_inv_a=col([pow(AoverAi[i] % A_list[i], -1, A_list[i])
                       for i in range(k)]),
        w_alpha_a=col(w1a), one_rns=residues(A % p),
        c_in=residues((A * A * pow(R, -1, p)) % p), c_out=residues(R % p),
        pow2_8=pow2_8, crt_rows=crt_rows,
        a_rows=rows8(A, D8).reshape(-1, 1),
        p_limbs=lb.int_to_limbs(p, L + 1),
    ).to(device)


# ---------------------------------------------------------------------------
# Channelwise primitives (all fp32, all values exact integers < 2^24)
# ---------------------------------------------------------------------------


def _red(v, m, recip):
    """v mod m for integer-valued fp32 v <= 2^24 - 2^12.  recip is the
    DOWNWARD-BIASED reciprocal, so q is floor(v/m) or one less and one
    conditional subtraction restores the canonical residue."""
    q = torch.floor(v * recip)
    r = v - q * m
    return torch.where(r >= m, r - m, r)


class RVal(NamedTuple):
    """Residues [2k, N] + static value bound (value < bound * p)."""
    v: torch.Tensor
    bound: int


def _split6(x):
    """6-bit digit split for the extension matmul: [k, N] -> [2k, N]."""
    hi = torch.floor(x * (1.0 / 64.0))
    lo = x - hi * 64.0
    return torch.cat([hi, lo], dim=0)


def _ext_dot(W, x):
    """[3k+1, 2k] @ [2k, N] -> (O [3k, N] float32, alpha sum [N] float64).

    Rows 0..3k-1 are exact in float32 (partial sums < 2^24).  The alpha
    row (row 3k) is summed in float64, where it is exact."""
    k3 = W.shape[0] - 1
    O = W[:k3] @ x
    Sa = (W[k3:].double() @ x.double())[0]
    return O, Sa


def _alpha_sum(digits, recip_src, eps):
    """Wide-path alpha estimate: floor(sum_i digits_i * recip_i + eps),
    summed in float64 against the biased fp32 reciprocals."""
    s = (digits.double() * recip_src.double()).sum(dim=0)
    return torch.floor(s + eps).to(torch.float32)


def _combine_ext(rns: RNSCtx, O, Sa, m_dst, recip_dst, base_mod_dst, eps,
                 alpha=None):
    """Matmul output -> destination-base residues of (value + e*base);
    see the JAX module for the derivation.  Sa is the exact alpha sum
    (narrow path); the wide path passes alpha instead."""
    k = rns.k
    O1, O2, O3 = O[:k], O[k:2 * k], O[2 * k:3 * k]
    if alpha is None:
        assert k <= _K_NARROW, "wide path must pass a precomputed alpha"
        alpha = torch.floor(Sa * (1.0 / (1 << _ALPHA_SCALE)) + eps) \
            .to(torch.float32)
    if k <= _K_NARROW:
        v = _red(O1 * 64.0 + O2, m_dst, recip_dst)
    else:
        v1 = _red(O1, m_dst, recip_dst)
        v2 = _red(O2, m_dst, recip_dst)
        v = _red(v1 * 64.0 + v2, m_dst, recip_dst)
    KC = _kc(k)
    T = v * 64.0 + O3 + (KC * m_dst - alpha[None] * base_mod_dst)
    return _red(T, m_dst, recip_dst), alpha


def r_mul(rns: RNSCtx, x: RVal, y: RVal) -> RVal:
    """RNS Montgomery product: value (x*y/A) mod-ish p, bound 3.
    Requires x.bound * y.bound <= h."""
    assert x.bound * y.bound <= rns.h, (x.bound, y.bound, rns.h)
    k = rns.k
    mA, mB = rns.m[:k], rns.m[k:]
    rA_m, rB_m = rns.recip[:k], rns.recip[k:]

    d = _red(x.v * y.v, rns.m, rns.recip)
    dA, dB = d[:k], d[k:]
    qhat = _red(dA * rns.qc_a, mA, rA_m)
    O, Sa = _ext_dot(rns.w1, _split6(qhat))
    wide = k > _K_NARROW
    a1 = _alpha_sum(qhat, rA_m, _EPS_UNDER) if wide else None
    qpa, _ = _combine_ext(rns, O, Sa, mB, rB_m, rns.p_mod_b, _EPS_UNDER, a1)

    u = _red(dB * rns.ainv_b, mB, rB_m) + qpa
    r = torch.where(u >= mB, u - mB, u)

    rhat = _red(r * rns.crt_inv_b, mB, rB_m)
    O2, Sa2 = _ext_dot(rns.w2, _split6(rhat))
    a2 = _alpha_sum(rhat, rB_m, _EPS_EXACT) if wide else None
    r_a, _ = _combine_ext(rns, O2, Sa2, mA, rA_m, rns.b_mod_a, _EPS_EXACT,
                          a2)
    return RVal(torch.cat([r_a, r], dim=0), 3)


def r_mul_many(rns: RNSCtx, pairs) -> list:
    """r_mul over independent (x, y) pairs of equal shape, stacked along
    the lane axis into one product."""
    for x, y in pairs:
        assert x.bound * y.bound <= rns.h, (x.bound, y.bound, rns.h)
    if len(pairs) == 1:
        return [r_mul(rns, *pairs[0])]
    n = pairs[0][0].v.shape[-1]
    xs = torch.cat([x.v for x, _ in pairs], dim=-1)
    ys = torch.cat([y.v for _, y in pairs], dim=-1)
    out = r_mul(rns, RVal(xs, 1), RVal(ys, 1)).v
    return [RVal(out[:, i * n:(i + 1) * n], 3) for i in range(len(pairs))]


def r_add(rns: RNSCtx, x: RVal, y: RVal) -> RVal:
    s = x.v + y.v
    s = torch.where(s >= rns.m, s - rns.m, s)
    return RVal(s, x.bound + y.bound)


def r_sub(rns: RNSCtx, x: RVal, y: RVal) -> RVal:
    """x - y + K*p with K = y.bound, keeping the value nonnegative."""
    K = y.bound
    assert K <= _KMAX, K
    t = x.v + rns.kp[:, K:K + 1] - y.v
    t = torch.where(t < 0, t + rns.m, t)
    t = torch.where(t >= rns.m, t - rns.m, t)
    return RVal(t, x.bound + K)


def r_one(rns: RNSCtx, n: int) -> RVal:
    return RVal(rns.one_rns.expand(-1, n), 1)


def r_zero(rns: RNSCtx, n: int) -> RVal:
    return RVal(torch.zeros((2 * rns.k, n), dtype=torch.float32,
                            device=rns.m.device), 1)


def r_pow_bits(rns: RNSCtx, x: RVal, bits) -> RVal:
    """x^e in F_p, e as shared MSB-first bits; x [2k, *batch], bound <= 16.

    The square-and-multiply chain makes the same r_muls, in the same
    operand order, as the pow_loop kernel's plain version, so it runs as
    that kernel (one launch on the card instead of thousands of small
    ops; the plain version on the CPU)."""
    from ..ops import cuda_rns
    assert x.bound <= 16, x.bound
    flat = x.v.reshape(x.v.shape[0], -1).contiguous()
    return RVal(cuda_rns.pow_loop(rns, flat, bits).reshape(x.v.shape), 3)


def r_batch_inv(rns: RNSCtx, zs: torch.Tensor, pm2_bits) -> torch.Tensor:
    """Montgomery batch inversion of a [C, 2k, *batch] stack of nonzero
    values (each bound <= 6): prefix products along the leading axis, ONE
    Fermat inversion of the total, then a backward pass (~3 r_muls per
    element; zero entries must be substituted by the caller).  Returns
    [C, 2k, *batch] residues of the inverses, bound 3."""
    acc = rns.one_rns.reshape((-1,) + (1,) * (zs.dim() - 2)) \
        .expand(zs.shape[1:])
    pres = []
    for z in zs:                          # pre[i] = z_0 * ... * z_{i-1}
        pres.append(acc)
        acc = r_mul(rns, RVal(acc, 3), RVal(z, 6)).v
    t = r_pow_bits(rns, RVal(acc, 3), pm2_bits).v        # total^-1
    invs = [None] * len(pres)
    for i in range(len(pres) - 1, -1, -1):
        invs[i] = r_mul(rns, RVal(t, 3), RVal(pres[i], 3)).v
        t = r_mul(rns, RVal(t, 3), RVal(zs[i], 6)).v
    return torch.stack(invs, dim=0)


# ---------------------------------------------------------------------------
# Conversions
# ---------------------------------------------------------------------------


def limbs_to_rns(rns: RNSCtx, x: torch.Tensor) -> torch.Tensor:
    """Canonical 16-bit limbs [L, N] (< p) -> residues [2k, N] float32."""
    L, n = x.shape
    d8 = torch.stack([x & 0xFF, x >> 8], dim=1).reshape(2 * L, n)
    S = (rns.pow2_8.double() @ d8.double()).to(torch.int64)
    return torch.remainder(S, rns.m.to(torch.int64)).to(torch.float32)


def rns_to_limbs(rns: RNSCtx, x: RVal) -> torch.Tensor:
    """Exact CRT: residues (value < 8p) -> int64 limbs [L, N] of the value
    less p at most twice: canonical (< p) for a value below 3p, as every
    r_mul output is.

    x = sum_i xhat_i*(A/a_i) - alpha*A with alpha exact, assembled in
    8-bit digit rows with a signed carry ripple, then reduced by up to two
    conditional subtractions of p."""
    assert x.bound <= 8, x.bound
    k, L = rns.k, rns.L
    mA, rA_m = rns.m[:k], rns.recip[:k]
    xhat = _red(x.v[:k] * rns.crt_inv_a, mA, rA_m)
    if k <= _K_NARROW:
        s = (xhat.double() * rns.w_alpha_a.double()).sum(dim=0)
        alpha = torch.floor(s * (1.0 / (1 << _ALPHA_SCALE)) + _EPS_EXACT) \
            .to(torch.int64)
    else:
        alpha = _alpha_sum(xhat, rA_m, _EPS_EXACT).to(torch.int64)
    S = (rns.crt_rows.double() @ xhat.double()).to(torch.int64)
    T = S - alpha[None] * rns.a_rows
    D8 = T.shape[0]
    digits = []
    carry = torch.zeros_like(T[0])
    for j in range(D8):
        t = T[j] + carry
        carry = t >> 8                             # arithmetic shift: floor
        digits.append(t - (carry << 8))
    n16 = L + 1
    rows = digits + [torch.zeros_like(digits[0])] * (2 * n16 - D8)
    rows = rows[:2 * n16]
    lim = torch.stack([rows[2 * i] + (rows[2 * i + 1] << 8)
                       for i in range(n16)], dim=0)
    p_ext = lb.expand_to(rns.p_limbs, lim.shape)
    for _ in range(2):
        dsub, borrow = lb.sub(lim, p_ext)
        lim = lb.select(borrow, lim, dsub)
    return lim[:L]


def to_rns_mont(rns: RNSCtx, x_mont_limbs: torch.Tensor) -> RVal:
    """Limb Montgomery form (x*R mod p, [L, N]) -> RNS Montgomery form
    (residues of x*A mod-ish p, bound 3)."""
    v = limbs_to_rns(rns, x_mont_limbs)
    return r_mul(rns, RVal(v, 1), RVal(rns.c_in.expand_as(v), 1))


def from_rns_mont(rns: RNSCtx, x: RVal, y: RVal | None = None
                  ) -> torch.Tensor:
    """RNS Montgomery form -> limb Montgomery form (x*R mod p): canonical
    int64 limbs [L, N]; with y, [2, L, N] of x and y (an F_p^2 element's
    real and imaginary parts).  r_mul by c_out, then rns_to_limbs: on CUDA
    tensors one launch of the exit kernel for both (ops/cuda_rns.py
    rns_exit), on CPU tensors those torch ops."""
    from ..ops import cuda_rns
    halves = (x,) if y is None else (x, y)
    for h in halves:
        assert h.bound <= rns.h, (h.bound, rns.h)
    out = cuda_rns.rns_exit(rns, *(h.v.contiguous() for h in halves))
    return out[0] if y is None else out
