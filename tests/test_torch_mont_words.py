"""The Montgomery product of csrc/mont_mul.cu, held on the CPU: an integer
emulation of both of its kernels, word for word (the limb pairs packed
into 32-bit words, -p^-1 mod 2^32 by Newton steps, the two carry chains
of each word step, the split of a lane over G threads with its shuffled
words and pending carries, the 16-bit half step of odd L, the carry
ripple and the borrow rounds of the final subtraction), against
cuda_mont.mont_mul_plain and against a*b*R^-1 mod p in host ints.  Every
bound the kernel's comments claim (a carry word that must be 0 or below
2) is asserted where the kernel relies on it.  No JAX.

The kernel's dispatch (L -> W words, G threads per lane) is read from
the source, so the emulation follows it.  The word product
(words_product, loop_product) and the final subtraction (sub_p_if_ge)
are mont_words.cuh's, which the digit-domain Miller steps share;
tests/test_torch_digits_words.py runs them there.
"""
import _torch_threads  # noqa: F401  (first: one torch thread per process)
import random
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from bgn_torch.fieldcore import cuda_mont
from bgn_torch.fieldcore import limbs as lb
from bgn_torch.fieldcore import montgomery as mg

SRC = Path(cuda_mont.__file__).resolve().parent.parent / "csrc" / "mont_mul.cu"
M32 = np.uint64(0xFFFFFFFF)
SH32 = np.uint64(32)
SH16 = np.uint64(16)


def _dispatch() -> dict:
    """{L: (W, G)} of bgn_mont_mul's register kernels, from the source."""
    return {int(L): (int(W), int(G)) for L, W, G in re.findall(
        r"case (\d+):\s*return bgn_mont_words_launch<(\d+), (\d+)>",
        SRC.read_text())}


def _neg_inv32(p0: int) -> int:
    """bgn_neg_inv32: four Newton steps from x = p0, negated."""
    x = p0
    for _ in range(4):
        x = x * (2 - p0 * x) & 0xFFFFFFFF
    return -x & 0xFFFFFFFF


def _words(limbs: np.ndarray, W: int) -> np.ndarray:
    """[n, L] 16-bit limbs -> [n, W] words (BgnWords: limb 2w + 1 is 0
    past L)."""
    n, L = limbs.shape
    pad = np.zeros((n, 2 * W), dtype=np.uint64)
    pad[:, :L] = limbs
    return pad[:, 0::2] | (pad[:, 1::2] << SH16)


def _chain(T, x, y, c):
    """bgn_mad_chain: T[..., j] += x * y[..., j] with the carry word; x, c
    broadcast over the slice's words.  Every sum fits 64 bits."""
    carry = np.broadcast_to(np.asarray(c, dtype=np.uint64),
                            T.shape[:-1]).copy()
    for j in range(T.shape[-1]):
        v = x * y[..., j] + T[..., j] + carry
        T[..., j] = v & M32
        carry = v >> SH32
    return carry


def _from_below(v):
    """__shfl_up_sync(v, 1, G) with thread 0 masked to 0: [n, G]."""
    out = np.zeros_like(v)
    out[:, 1:] = v[:, :-1]
    return out


def _store(words: np.ndarray, L: int) -> np.ndarray:
    """[n, >= ceil(L/2)] words -> [L, n] int64 limbs."""
    lo, hi = words & np.uint64(0xFFFF), words >> SH16
    limbs = np.stack([lo, hi], axis=2).reshape(words.shape[0], -1)[:, :L]
    return limbs.T.astype(np.int64)


def sub_p_if_ge(T, pv):
    """bgn_sub_p_if_ge: T [n, G, S] < 2p -> T mod p in place, through the
    borrow rounds of T - p (b0 / b1: a slice's borrow out for a borrow in
    of 0 / 1)."""
    n, G, S = T.shape
    s = T.astype(np.int64) - pv.astype(np.int64)
    b0 = np.zeros((n, G), dtype=bool)
    eq = np.ones((n, G), dtype=bool)
    for j in range(S):
        d = s[..., j] - b0
        b0 = d < 0
        eq &= (d & 0xFFFFFFFF) == 0
    b1 = b0 | eq
    bin_ = np.zeros((n, G), dtype=bool)
    for _ in range(G - 1):
        bin_ = _from_below(np.where(bin_, b1, b0))
    ge = ~np.where(bin_, b1, b0)[:, -1]
    borrow = bin_.astype(np.int64)
    for j in range(S):
        d = s[..., j] - borrow
        borrow = (d < 0).astype(np.int64)
        T[..., j] = np.where(ge[:, None], (d & 0xFFFFFFFF).astype(np.uint64),
                              T[..., j])


def words_product(av, bv, pv, W):
    """bgn_mont_words<W, G, S>: a*b*R^-1 mod p, R = 2^(32W), on operands
    split over G threads ([n, G, S]: thread t, word j; pv [1, G, S]);
    returns T [n, G, S]."""
    n, G, S = av.shape
    pinv = np.uint64(_neg_inv32(int(pv[0, 0, 0])))
    T = np.zeros((n, G, S), dtype=np.uint64)
    P = np.zeros((n, G), dtype=np.uint64)
    for i in range(W):
        ai = av[:, i // S, i % S][:, None]           # the shuffle from i / S
        cA = _chain(T, ai, bv, P)
        m = (T[:, 0, 0] * pinv) & M32                # thread 0's m
        assert not (T[:, 0, 0] + m * pv[:, 0, 0] & M32).any()
        cB = _chain(T, m[:, None], pv, 0)
        up = np.zeros((n, G), dtype=np.uint64)
        up[:, :-1] = T[:, 1:, 0]                     # thread t + 1's word 0
        T[:, :, :-1] = T[:, :, 1:].copy()
        y = up + cA + cB
        T[:, :, -1] = y & M32
        assert (y >> SH32).max() <= 2
        assert not (y[:, -1] >> SH32).any()          # the top thread's
        P = _from_below(y >> SH32)
    for _ in range(G):                               # the carry ripple
        if G == 1 or not P.any():
            break
        carry = _chain(T, np.uint64(0), np.zeros_like(T), P)
        assert not carry[:, -1].any()
        P = _from_below(carry)
    assert not P.any()
    sub_p_if_ge(T, pv)
    return T


def emulate_words_kernel(L, G, a, b, p):
    """bgn_mont_words_kernel<W = L/2, G> on lanes a, b ([L, n] limbs),
    modulus p; returns [L, n] limbs."""
    W = L // 2
    assert L == 2 * W and 32 % G == 0
    S = (W + G) // G
    assert G * S >= W + 1
    n = a.shape[1]

    def sliced(limbs):                   # [n, G, S]: thread t, word j
        w = np.zeros((limbs.shape[0], G * S), dtype=np.uint64)
        w[:, :W] = _words(limbs, W)
        return w.reshape(-1, G, S)

    av, bv = sliced(a.T.astype(np.uint64)), sliced(b.T.astype(np.uint64))
    pv = sliced(lb.ints_to_limbs([p], L).T.astype(np.uint64))
    T = words_product(av, bv, pv, W)
    return _store(T.reshape(n, G * S)[:, :W], L)


def loop_product(aw, bv, ps, L):
    """bgn_mont_loop_steps + bgn_loop_sub_p: aw [n, W] words of a, bv
    [n, S] and ps [S] words (a zero word W); returns [n, S] words."""
    W = (L + 1) // 2
    S = W + 1
    n = aw.shape[0]
    pinv = np.uint64(_neg_inv32(int(ps[0])))
    T = np.zeros((n, S), dtype=np.uint64)
    for i in range(L // 2):
        cA = _chain(T, aw[:, i], bv, 0)
        cB = _chain(T, (T[:, 0] * pinv) & M32, ps, 0)
        assert not T[:, 0].any()
        T[:, :-1] = T[:, 1:].copy()
        T[:, -1] = cA + cB
        assert (cA + cB).max() < 2
    if L & 1:                            # a.half(): limb L - 1 alone
        ah = aw[:, W - 1]
        assert not (ah >> SH16).any()
        cA = _chain(T, ah, bv, 0)
        m = (T[:, 0] * pinv) & np.uint64(0xFFFF)
        cB = _chain(T, m, ps, 0)
        assert not (T[:, 0] & np.uint64(0xFFFF)).any()
        T[:, :-1] = (T[:, :-1] >> SH16) | ((T[:, 1:] << SH16) & M32)
        T[:, -1] = (T[:, -1] >> SH16) | (((cA + cB) << SH16) & M32)
        assert not (cA + cB).any()
    s = T.astype(np.int64) - ps.astype(np.int64)
    borrow = np.zeros(n, dtype=np.int64)
    diff = np.zeros_like(T)
    for j in range(S):
        d = s[:, j] - borrow
        borrow = (d < 0).astype(np.int64)
        diff[:, j] = d & 0xFFFFFFFF
    return np.where(borrow[:, None].astype(bool), T, diff)


def emulate_loop_kernel(L, a, b, p):
    """bgn_mont_loop_kernel at any L, odd included; returns [L, n]."""
    W = (L + 1) // 2
    S = W + 1
    n = a.shape[1]
    bv = np.zeros((n, S), dtype=np.uint64)
    bv[:, :W] = _words(b.T.astype(np.uint64), W)
    ps = np.zeros(S, dtype=np.uint64)
    ps[:W] = _words(lb.ints_to_limbs([p], L).T.astype(np.uint64), W)[0]
    aw = _words(a.T.astype(np.uint64), W)
    return _store(loop_product(aw, bv, ps, L), L)


def _modulus(rng, L, full):
    """An odd p < R = 2^(16L): a key's width (16L - 32 bits, as keys have
    L = bits/16 + 2) or the full width (top bit of R set)."""
    bits = 16 * L if full else max(16 * L - 32, 3)
    return rng.getrandbits(bits) | (1 << (bits - 1)) | 1


def _operands(rng, L, p):
    """Edge lanes (a in {0, 1, p - 1, R - 1} x b in {0, 1, p - 1}) and
    random lanes (a < R, b < p): [L, n] limbs each, and the ints."""
    R = 1 << (16 * L)
    edges = [(x, y) for x in (0, 1, p - 1, R - 1) for y in (0, 1, p - 1)]
    rand = [(rng.randrange(R), rng.randrange(p)) for _ in range(9)]
    xs, ys = zip(*(edges + rand))
    return lb.ints_to_limbs(xs, L), lb.ints_to_limbs(ys, L), xs, ys


def _want(L, p, xs, ys):
    rinv = pow(1 << (16 * L), -1, p)
    return lb.ints_to_limbs([x * y * rinv % p for x, y in zip(xs, ys)], L)


def test_dispatch_covers_the_keys_widths():
    """A register kernel for each key width L = 34, 66, 130, 258 (L = 2W),
    one thread per lane at W = 17, and G dividing the warp with G * S
    covering W + 1 words."""
    d = _dispatch()
    assert sorted(d) == [34, 66, 130, 258]
    for L, (W, G) in d.items():
        assert L == 2 * W and 32 % G == 0
        assert G * ((W + G) // G) >= W + 1
    assert d[34][1] == 1


def test_neg_inv32():
    rng = random.Random(5)
    for p0 in [1, 3, 0xFFFFFFFF] + [rng.getrandbits(32) | 1
                                    for _ in range(50)]:
        assert _neg_inv32(p0) * p0 % (1 << 32) == (1 << 32) - 1


@pytest.mark.parametrize("full", [False, True], ids=["key", "full"])
@pytest.mark.parametrize("L", [34, 66, 130, 258, 35, 1, 3])
def test_kernels_equal_plain_and_host_ints(L, full):
    """The kernel that bgn_mont_mul runs at L (the register kernel at a
    key's width, the loop kernel elsewhere) and the loop kernel at every
    L equal a*b*R^-1 mod p and mont_mul_plain, limb for limb, on edge and
    random lanes."""
    rng = random.Random(1000 * L + full)
    p = _modulus(rng, L, full)
    a, b, xs, ys = _operands(rng, L, p)
    want = _want(L, p, xs, ys)
    ctx = mg.make_mont_ctx(p, L=L, device="cpu")
    plain = cuda_mont.mont_mul_plain(ctx, torch.as_tensor(a),
                                     torch.as_tensor(b)).numpy()
    np.testing.assert_array_equal(plain, want)
    np.testing.assert_array_equal(emulate_loop_kernel(L, a, b, p), want)
    if L in _dispatch():
        W, G = _dispatch()[L]
        np.testing.assert_array_equal(emulate_words_kernel(L, G, a, b, p),
                                      want)


@pytest.mark.parametrize("G", [1, 2, 4, 8, 16, 32])
def test_thread_split_at_any_G(G):
    """The split over G threads is exact for every G that divides the
    warp, at W = 65 (slices of 66 words down to 3), on full-width moduli
    whose carries cross every slice boundary."""
    rng = random.Random(G)
    L = 130
    p = _modulus(rng, L, True)
    a, b, xs, ys = _operands(rng, L, p)
    np.testing.assert_array_equal(emulate_words_kernel(L, G, a, b, p),
                                  _want(L, p, xs, ys))
