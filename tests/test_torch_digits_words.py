"""The two digit-domain Miller step kernels (csrc/miller_dbl_digits.cu,
csrc/miller_add_digits.cu) held on the CPU: an integer emulation of both
of their forms, word for word, against the plain versions
(ops/cuda_pairing.py dbl_step_plain / add_step_plain) and against host
ints.  No JAX.

The emulation runs the fields of csrc/digits.cuh: the load of four digit
rows into a 32-bit word and the store back; the register form
BgnWordField<W, G> (a lane's words split over G threads, the word product
of test_torch_mont_words.words_product, mod add and mod sub with their
carry-select and borrow-select shuffle rounds, lanes past n on lane 0's
digits) and the loop form BgnLoopField (one thread per lane,
test_torch_mont_words.loop_product, odd L's half step).  The statements
of each step (F.load, F.mul, F.add, F.sub, F.store) are read from the
kernel's source and run in its order on the emulated field, and every op
is checked against host ints as it runs.  The dispatch (L -> W, G, and
the threads per block) is read from the sources too.  Every carry bound
that a comment of mont_words.cuh claims is asserted where the kernel
relies on it.
"""
import _torch_threads  # noqa: F401  (first: one torch thread per process)
import random
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import test_torch_mont_words as tmw
from bgn_torch.fieldcore import limbs as lb
from bgn_torch.fieldcore import montgomery as mg
from bgn_torch.ops import cuda_pairing

CSRC = Path(cuda_pairing.__file__).resolve().parent.parent / "csrc"
KERNELS = {"dbl": "miller_dbl_digits.cu", "add": "miller_add_digits.cu"}
M32 = tmw.M32
SH32 = tmw.SH32
# the sweep of scripts/kernel_variants.py --kernels digits: G per L
SWEPT_G = {34: (1, 2, 4, 8, 16), 64: (2, 4, 8, 16, 32)}
LOOP_L = (6, 33, 35)


def _dispatch(kind: str) -> dict:
    """{L: (W, G)} of a kernel's register form, from its source."""
    return {int(L): (int(W), int(G)) for L, W, G in re.findall(
        rf"case (\d+): return {kind}_launch<(\d+), (\d+)>",
        (CSRC / KERNELS[kind]).read_text())}


def _threads() -> int:
    return int(re.search(r"#define BGN_DIGITS_THREADS (\d+)",
                         (CSRC / "digits.cuh").read_text()).group(1))


def _statements(kind: str):
    """The step body's parameters (inputs, outputs, in order) and its
    field ops [(op, args)], from the kernel's source."""
    src = (CSRC / KERNELS[kind]).read_text()
    start = src.index(f"bgn_miller_{kind}_body(")
    body = src[start:src.index("\n}\n", start)]
    head = body[:body.index(")")]
    ins = re.findall(r"const float\* (\w+)", head)
    outs = re.findall(r"(?<!const )float\* (\w+)", head)
    ops = [(op, [a.strip() for a in args.split(",")]) for op, args in
           re.findall(r"F\.(load|store|mul|add|sub)\(([^)]*)\);", body)]
    return ins, outs, ops


class WordField:
    """BgnWordField<W, G>: every value [lanes, G, S] (thread t, word j) over
    the launch's lanes; lanes past n read lane 0's digits."""

    def __init__(self, p, W, G, n, threads):
        self.p, self.W, self.G, self.n = p, W, G, n
        self.L = 2 * W
        self.S = S = (W + G) // G
        assert G * S >= W + 1 and 32 % G == 0
        lanes = -(-n * G // threads) * threads // G     # the grid's lanes
        self.src = np.where(np.arange(lanes) < n, np.arange(lanes), 0)
        self.pv = self._slice(tmw._words(
            lb.ints_to_limbs([p], self.L).T.astype(np.uint64), W))

    def _slice(self, words):
        out = np.zeros((words.shape[0], self.G * self.S), dtype=np.uint64)
        out[:, :self.W] = words
        return out.reshape(-1, self.G, self.S)

    def load(self, d):
        """Word w of a lane: digit rows 4w .. 4w + 3 (exact: < 256)."""
        u = d[:, self.src].astype(np.uint64)          # [2L, lanes]
        assert (u == d[:, self.src]).all() and u.max() < 256
        words = u[0::4] | u[1::4] << 8 | u[2::4] << 16 | u[3::4] << 24
        return self._slice(words.T)

    def store(self, x):
        """The live lanes' words back to digit rows; every lane past n
        holds lane 0's value."""
        words = x.reshape(x.shape[0], -1)
        assert not words[:, self.W:].any()
        assert (words[self.n:] == words[0]).all()
        rows = [(words[:self.n, :self.W] >> np.uint64(8 * k)) & np.uint64(0xFF)
                for k in range(4)]
        return np.stack(rows, axis=2).reshape(self.n, -1).T.astype(np.float32)

    def ints(self, x):
        words = x.reshape(x.shape[0], -1)
        return [sum(int(v) << (32 * j) for j, v in enumerate(row))
                for row in words]

    def mul(self, a, b):
        return tmw.words_product(a, b, self.pv, self.W)

    def _add_split(self, a, y):
        """bgn_add_split: a + y over the lane's words with the carry-select
        rounds; returns (sum, the carry dropped out of the top thread)."""
        s = a.copy()
        c0 = tmw._chain(s, np.uint64(1), y, 0)        # s += y
        c1 = c0 | (s == M32).all(axis=-1)
        cin = np.zeros_like(c0)
        for _ in range(self.G - 1):
            cin = tmw._from_below(np.where(cin.astype(bool), c1, c0))
        out = c0 | tmw._chain(s, np.uint64(0), np.zeros_like(s), cin)
        # each slice's carry out with its carry in is the one selected
        np.testing.assert_array_equal(out, np.where(cin.astype(bool), c1, c0))
        return s, out[:, -1]

    def add(self, a, b):
        s, top = self._add_split(a, b)
        assert not top.any()                # a + b < 2p fits W words + 1
        tmw.sub_p_if_ge(s, self.pv)
        return s

    def sub(self, a, b):
        n, G, S = a.shape
        diff = a.astype(np.int64) - b.astype(np.int64)
        b0 = np.zeros((n, G), dtype=bool)
        eq = np.ones((n, G), dtype=bool)
        d = np.zeros_like(a)
        for j in range(S):
            v = diff[..., j] - b0
            b0 = v < 0
            d[..., j] = (v & 0xFFFFFFFF).astype(np.uint64)
            eq &= d[..., j] == 0
        b1 = b0 | eq
        bin_ = np.zeros((n, G), dtype=bool)
        for _ in range(G - 1):
            bin_ = tmw._from_below(np.where(bin_, b1, b0))
        neg = np.where(bin_, b1, b0)[:, -1]           # a < b
        borrow = bin_.astype(np.int64)
        for j in range(S):
            v = d[..., j].astype(np.int64) - borrow
            borrow = (v < 0).astype(np.int64)
            d[..., j] = (v & 0xFFFFFFFF).astype(np.uint64)
        # each slice's borrow out with its borrow in is the one selected
        np.testing.assert_array_equal(b0 | borrow.astype(bool),
                                      np.where(bin_, b1, b0))
        q = self.pv * neg[:, None, None].astype(np.uint64)
        s, top = self._add_split(d, q)
        np.testing.assert_array_equal(top, neg)      # the wrap, dropped
        return s


class LoopField:
    """BgnLoopField: one thread per lane, S = W + 1 words per value."""

    def __init__(self, p, L, n):
        self.p, self.L, self.n = p, L, n
        self.W = (L + 1) // 2
        self.S = self.W + 1
        self.ps = np.zeros(self.S, dtype=np.uint64)
        self.ps[:self.W] = tmw._words(
            lb.ints_to_limbs([p], L).T.astype(np.uint64), self.W)[0]

    def load(self, d):
        u = np.zeros((4 * self.S, self.n), dtype=np.uint64)
        u[:2 * self.L] = d.astype(np.uint64)          # rows past 2L: 0
        assert (u[:2 * self.L] == d).all() and u.max() < 256
        return (u[0::4] | u[1::4] << 8 | u[2::4] << 16 | u[3::4] << 24).T

    def store(self, x):
        assert not x[:, self.W:].any()
        rows = [(x[:, :self.W] >> np.uint64(8 * k)) & np.uint64(0xFF)
                for k in range(4)]
        d = np.stack(rows, axis=2).reshape(self.n, -1).T
        assert not d[2 * self.L:].any()
        return d[:2 * self.L].astype(np.float32)

    def ints(self, x):
        return [sum(int(v) << (32 * j) for j, v in enumerate(row))
                for row in x]

    def mul(self, a, b):
        return tmw.loop_product(a[:, :self.W], b, self.ps, self.L)

    def add(self, a, b):
        s = a.copy()
        assert not tmw._chain(s, np.uint64(1), b, 0).any()
        diff = s.astype(np.int64) - self.ps.astype(np.int64)
        borrow = np.zeros(self.n, dtype=np.int64)
        d = np.zeros_like(s)
        for j in range(self.S):
            v = diff[:, j] - borrow
            borrow = (v < 0).astype(np.int64)
            d[:, j] = (v & 0xFFFFFFFF).astype(np.uint64)
        return np.where(borrow[:, None].astype(bool), s, d)

    def sub(self, a, b):
        diff = a.astype(np.int64) - b.astype(np.int64)
        borrow = np.zeros(self.n, dtype=np.int64)
        d = np.zeros_like(a)
        for j in range(self.S):
            v = diff[:, j] - borrow
            borrow = (v < 0).astype(np.int64)
            d[:, j] = (v & 0xFFFFFFFF).astype(np.uint64)
        q = self.ps[None, :] * borrow[:, None].astype(np.uint64)
        carry = tmw._chain(d, np.uint64(1), q, 0)
        np.testing.assert_array_equal(carry, borrow)  # the wrap, dropped
        return d


def _field(kind, L, G, p, n):
    """The field of the kernel's form at L: register at the dispatch's
    widths (threads per lane G, the shipped one when None), else loop."""
    if L in _dispatch(kind):
        W, G0 = _dispatch(kind)[L]
        return WordField(p, W, G or G0, n, _threads())
    assert G is None
    return LoopField(p, L, n)


def _checked_op(F, op, a, b):
    """One field op, checked against host ints lane by lane."""
    out = getattr(F, op)(a, b)
    x, y, got = F.ints(a), F.ints(b), F.ints(out)
    rinv = pow(1 << (16 * F.L), -1, F.p)
    for u, v, w in zip(x, y, got):
        assert u < F.p and v < F.p
        want = {"mul": u * v * rinv % F.p, "add": (u + v) % F.p,
                "sub": (u - v) % F.p}[op]
        assert w == want, (op, u, v, w, want)
    return out


def run_step(kind, F, digits):
    """The kernel's step body on the emulated field: digits in (the
    inputs of the body, in order), digits out."""
    ins, outs, ops = _statements(kind)
    inputs, env, result = dict(zip(ins, digits)), {}, {}
    for op, args in ops:
        if op == "load":
            env[args[0]] = F.load(inputs[args[1]])
        elif op == "store":
            result[args[0]] = F.store(env[args[1]])
        else:
            env[args[0]] = _checked_op(F, op, env[args[1]], env[args[2]])
    return [result[o] for o in outs]


def _modulus(rng, L, full=False):
    """An odd p < 2^(16L): a key's width (16L - 32 bits; at odd L 16L - 20,
    a 540-bit p at L = 35) or the full width (top bit of R set)."""
    bits = 16 * L if full else 16 * L - (32 if L % 2 == 0 else 20)
    return rng.getrandbits(bits) | (1 << (bits - 1)) | 1


def _values(rng, p, n):
    """n canonical values: 0, 1, p - 1 and a pair summing to p first."""
    a = rng.randrange(2, p - 1)
    return ([0, 1, p - 1, a, p - a] + [rng.randrange(p) for _ in range(n)])[:n]


def _digits(ints, L):
    return cuda_pairing.to_digits(torch.as_tensor(
        lb.ints_to_limbs(ints, L))).numpy()


def _plain(kind, p, L, digits):
    ctx = mg.make_mont_ctx(p, L=L, device="cpu")
    t = [torch.as_tensor(d) for d in digits]
    if kind == "dbl":
        V, f = cuda_pairing.dbl_step_plain(ctx, t[:3], t[3:5], t[5:7])
    else:
        V, f = cuda_pairing.add_step_plain(ctx, t[:3], t[3:5], t[5:7],
                                           t[7:9])
    return [x.numpy() for x in V + f]


def _forms():
    """(L, G) of every register form the sweep tries, then the loop form
    at odd and even L."""
    return [(L, G) for L, gs in SWEPT_G.items() for G in gs] + \
        [(L, None) for L in LOOP_L]


def test_dispatch():
    """Both kernels: the register form at exactly L = 34 and 64 (L = 2W,
    G a divisor of the warp, among the swept G, G * S >= W + 1), the loop
    form at every other L <= 64; threads per block a multiple of 32 and
    of G."""
    for kind in KERNELS:
        d = _dispatch(kind)
        assert sorted(d) == [34, 64]
        for L, (W, G) in d.items():
            assert L == 2 * W and G in SWEPT_G[L]
            assert G * ((W + G) // G) >= W + 1
            assert _threads() % 32 == 0 and _threads() % G == 0
        src = (CSRC / KERNELS[kind]).read_text()
        assert f"bgn_miller_{kind}_digits_loop_kernel<<<" in src
    assert _statements("dbl")[0] == ["vx", "vy", "vz", "fr", "fi", "bx", "by"]
    assert _statements("add")[0] == ["vx", "vy", "vz", "fr", "fi", "ax", "ay",
                                     "bx", "by"]
    for kind, products in (("dbl", 21), ("add", 17)):
        ops = [op for op, _ in _statements(kind)[2]]
        assert ops.count("mul") == products
        assert ops.count("store") == 5


@pytest.mark.parametrize("full", [False, True], ids=["key", "full"])
@pytest.mark.parametrize("L,G", _forms())
def test_field_ops_at_edges(L, G, full):
    """mul, add and sub of the emulated field against host ints on every
    pair of 0, 1, p - 1, a and p - a (a + b = p exactly, a = b among
    them), at every swept G and in the loop form, on key-width and
    full-width moduli (the sum's carry word W, the borrow across every
    slice)."""
    rng = random.Random(100 * L + 10 * (G or 0) + full)
    p = _modulus(rng, L, full)
    vals = _values(rng, p, 5)
    xs, ys = zip(*[(x, y) for x in vals for y in vals])
    F = _field("dbl", L, G, p, len(xs))
    a, b = F.load(_digits(xs, L)), F.load(_digits(ys, L))
    for op in ("mul", "add", "sub"):
        out = _checked_op(F, op, a, b)
        got = F.store(out)
        want = {"mul": [x * y * pow(1 << (16 * L), -1, p) % p
                        for x, y in zip(xs, ys)],
                "add": [(x + y) % p for x, y in zip(xs, ys)],
                "sub": [(x - y) % p for x, y in zip(xs, ys)]}[op]
        np.testing.assert_array_equal(got, _digits(want, L))


@pytest.mark.parametrize("n", [1, 13])
@pytest.mark.parametrize("L,G", _forms())
def test_steps_equal_plain(L, G, n):
    """Each step's statements, read from its kernel, on the emulated field
    equal dbl_step_plain / add_step_plain bit for bit, on edge and random
    lanes; at n = 1 and 13 the launch's lanes past n run lane 0's digits
    and store nothing."""
    rng = random.Random(1000 * L + 10 * (G or 0) + n)
    p = _modulus(rng, L)
    for kind, arrays in (("dbl", 7), ("add", 9)):
        digits = [_digits(rng.sample(_values(rng, p, n + 5), n), L)
                  for _ in range(arrays)]
        got = run_step(kind, _field(kind, L, G, p, n), digits)
        for g, w in zip(got, _plain(kind, p, L, digits)):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("L", [34, 64] + list(LOOP_L))
def test_chain_of_steps(L):
    """dbl, add, dbl, dbl, add on the shipped form, each step's outputs the
    next one's V and f, equal to the plain chain."""
    rng = random.Random(L)
    p = _modulus(rng, L)
    n = 5
    rnd = lambda: _digits([rng.randrange(p) for _ in range(n)], L)
    V, f = [rnd() for _ in range(3)], [rnd() for _ in range(2)]
    A, Bq = [rnd(), rnd()], [rnd(), rnd()]
    Vp, fp = V, f
    for kind in ("dbl", "add", "dbl", "dbl", "add"):
        extra = Bq if kind == "dbl" else A + Bq
        out = run_step(kind, _field(kind, L, None, p, n), V + f + extra)
        want = _plain(kind, p, L, Vp + fp + extra)
        for g, w in zip(out, want):
            np.testing.assert_array_equal(g, w)
        V, f, Vp, fp = out[:3], out[3:], want[:3], want[3:]
