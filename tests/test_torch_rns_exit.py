"""The exit conversion's kernel (csrc/rns_exit.cu), held on the CPU: an
integer emulation of its CRT steps, word for word over its constant blob
(cuda_rns.exit_blob, read by the offsets of cuda_rns.exit_layout),
against the plain version's rns_to_limbs, bit for bit, and through the
plain r_mul by c_out (whose tensor-core form test_torch_package.py and
test_torch_tc_ext.py hold) against host integers; the blob's layout
against the kernel source's; the wrapper's CPU dispatch and launch count;
from_rns_mont's two-half form.  The source's C entry and its barriers are
test_torch_step_tc.py's.  No JAX.

Moduli: p of 515, 1036 and 2070 bits, k = 45, 90 and 185 channels per
base (the 512-, 1024- and 2048-bit keys' slot counts S = 4, 6, 12; k = 90
and 185 take the wide alpha).  Lanes: 0, 1, p - 1, p and the largest
values each step takes (8p - 1 into the CRT, h*p - 1 into the exit), the
lanes of largest alpha among a few hundred, and random values.
"""
import _torch_threads  # noqa: F401  (first: one torch thread per process)
import math
import random
import re

import numpy as np
import pytest
import torch

from bgn_torch import _build
from bgn_torch.fieldcore import rns as trn
from bgn_torch.ops import cuda_rns

SOURCE = (_build.CSRC / "rns_exit.cu").read_text()
BITS = {515: 45, 1036: 90, 2070: 185}


def _ctx(bits):
    rng = random.Random(bits)
    small = math.prod(trn._primes_desc(3, 2000))
    while True:
        p = rng.getrandbits(bits) | (1 << (bits - 1)) | 1
        if math.gcd(p, small) == 1 and \
                all(pow(a, p - 1, p) == 1 for a in (2, 3, 5, 7, 11, 13)):
            ctx = trn.make_rns_ctx(p, device="cpu")
            assert ctx.k == BITS[bits]
            return ctx, p


@pytest.fixture(scope="module", params=sorted(BITS))
def key(request):
    return _ctx(request.param)


def _moduli(ctx):
    return [int(v) for v in ctx.m.reshape(-1).tolist()]


def _residues(ctx, values):
    """float32 [2k, N] residues of host ints."""
    ms = _moduli(ctx)
    return torch.tensor([[v % m for v in values] for m in ms],
                        dtype=torch.float32)


def _limbs(values, L):
    return np.array([[(v >> (16 * j)) & 0xFFFF for v in values]
                     for j in range(L)], dtype=np.int64)


def _alpha_host(ctx, values):
    """The CRT's alpha of each value (< A): (sum_i xhat_i (A/a_i) - v) / A."""
    a = _moduli(ctx)[:ctx.k]
    A = math.prod(a)
    out = []
    for v in values:
        s = sum((v * pow(A // ai, -1, ai)) % ai * (A // ai) for ai in a)
        out.append((s - v) // A)
    return out


def _red(v, m, r):
    """csrc/rns.cuh bgn_red in float32."""
    q = np.floor((v * r).astype(np.float32))
    x = (v - q * m).astype(np.float32)
    return np.where(x >= m, x - m, x)


def _emulated_crt(ctx, r):
    """Steps 2-5 of csrc/rns_exit.cu over its blob, line for line, all
    lanes at once: xhat, the narrow (int32 weights) or wide (float64
    against the fp32 reciprocals) alpha, the rows T in int32 (checked),
    the carry ripple from row to row, the packing into L + 1 limbs and the
    two conditional subtractions of p.  r: float32 [2k, N] residues.
    Returns (int64 limbs [L, N], alpha [N])."""
    k, L = ctx.k, ctx.L
    off = cuda_rns.exit_layout(k, L)
    xb = cuda_rns.exit_blob(ctx).numpy()
    xf = xb.view(np.float32)
    coff = cuda_rns.blob_layout(k)
    cf = cuda_rns.const_blob(ctx).numpy().view(np.float32)
    m = cf[coff["m"]:coff["m"] + k][:, None]
    recip = cf[coff["recip"]:coff["recip"] + k][:, None]
    crt_inv = xf[off["crt_inv_a"]:off["crt_inv_a"] + k][:, None]
    q = _red((r[:k] * crt_inv).astype(np.float32), m, recip).astype(np.int64)
    if k > trn._K_NARROW:
        alpha = np.floor((q * recip.astype(np.float64)).sum(0) + 0.5)
    else:
        w = xb[off["w_alpha"]:off["w_alpha"] + k].astype(np.int64)[:, None]
        s = (w * q).sum(0)
        assert s.max() < 2 ** 31
        alpha = np.floor(s / 524288.0 + 0.5)
    alpha = alpha.astype(np.int64)
    d8, n16 = off["d8"], L + 1
    crt = xb[off["crt"]:].view(np.uint8).reshape(k, off["crt_stride"])
    a_rows = xb[off["a_rows"]:off["a_rows"] + d8].astype(np.int64)[:, None]
    T = crt[:, :d8].astype(np.int64).T @ q - alpha[None] * a_rows
    assert np.abs(T).max() < 2 ** 31
    lim = np.zeros((n16, r.shape[1]), dtype=np.int64)
    carry = np.zeros(r.shape[1], dtype=np.int64)
    for j in range(d8):
        t = T[j] + carry
        carry = t >> 8
        if j < 2 * n16:
            lim[j >> 1] += (t - carry * 256) << (8 * (j & 1))
    p = xb[off["p_limbs"]:off["p_limbs"] + n16].astype(np.int64)
    for _ in range(2):
        borrow = np.zeros_like(carry)
        for i in range(n16):
            borrow = (lim[i] - p[i] - borrow < 0).astype(np.int64)
        diff, b = np.empty_like(lim), np.zeros_like(carry)
        for i in range(n16):
            t = lim[i] - p[i] - b
            b = (t < 0).astype(np.int64)
            diff[i] = t + b * 65536
        lim = np.where(borrow[None] == 0, diff, lim)
    return lim[:L], alpha


def _crt_lanes(ctx, p, n_rand):
    """Values below 8p (the CRT's input bound): the edges, the 8 of
    largest alpha among 256 random ones, then n_rand random ones."""
    rng = random.Random(ctx.k)
    pool = [rng.randrange(8 * p) for _ in range(256)]
    al = _alpha_host(ctx, pool)
    top = [v for _, v in sorted(zip(al, pool), reverse=True)[:8]]
    return [0, 1, p - 1, p, 2 * p, 3 * p - 1, 8 * p - 1] + top + \
        [rng.randrange(8 * p) for _ in range(n_rand)]


def test_emulated_crt_matches_rns_to_limbs(key):
    """The kernel's steps 2-5 equal rns_to_limbs bit for bit on values up
    to the bound-8 limit, and both give v less p at most twice (v mod p
    below 3p, the exit's inputs); alpha is the host's and reaches its
    largest lanes."""
    ctx, p = key
    values = _crt_lanes(ctx, p, 40)
    r = _residues(ctx, values)
    got, alpha = _emulated_crt(ctx, r.numpy())
    want = trn.rns_to_limbs(ctx, trn.RVal(r, 8)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, _limbs([v - min(v // p, 2) * p for v in values], ctx.L))
    assert alpha.tolist() == _alpha_host(ctx, values)
    assert alpha.max() >= ctx.k // 2


def test_exit_emulation_matches_plain_and_host(key):
    """The whole exit: r_mul by c_out (the plain product, which the
    kernel's tensor-core product equals), then the emulated CRT, equals
    rns_exit_plain and from_rns_mont bit for bit on values up to h*p - 1,
    and gives v * R / A mod p."""
    ctx, p = key
    rng = random.Random(ctx.k + 1)
    hp = ctx.h * p
    values = [0, 1, p - 1, p, 3 * p - 1, 9 * p - 1, 27 * p - 1, hp - 1] + \
        [rng.randrange(hp) for _ in range(8)] + \
        [rng.randrange(9 * p) for _ in range(16)]
    x = _residues(ctx, values)
    c_out = trn.RVal(ctx.c_out.expand_as(x), 1)
    r = trn.r_mul(ctx, trn.RVal(x, ctx.h), c_out).v
    got, _ = _emulated_crt(ctx, r.numpy())
    want = cuda_rns.rns_exit_plain(ctx, x)
    assert want.shape == (1, ctx.L, len(values))
    np.testing.assert_array_equal(got, want[0].numpy())
    assert torch.equal(trn.from_rns_mont(ctx, trn.RVal(x, ctx.h)), want[0])
    A = math.prod(_moduli(ctx)[:ctx.k])
    scale = (1 << (16 * ctx.L)) * pow(A, -1, p) % p
    np.testing.assert_array_equal(
        got, _limbs([v * scale % p for v in values], ctx.L))


def test_exit_wrapper_dispatches_cpu_to_plain(key):
    """rns_exit on CPU tensors: its plain version, one or two halves,
    no launch counted; from_rns_mont's two-half form stacks the two
    one-half exits; other devices are refused."""
    ctx, p = key
    rng = random.Random(ctx.k + 2)
    xs = [_residues(ctx, [rng.randrange(3 * p) for _ in range(5)])
          for _ in range(2)]
    before = cuda_rns.rns_exit.launches
    one = cuda_rns.rns_exit(ctx, xs[0])
    two = cuda_rns.rns_exit(ctx, *xs)
    assert cuda_rns.rns_exit.launches == before
    assert one.dtype == two.dtype == torch.int64
    assert one.shape == (1, ctx.L, 5) and two.shape == (2, ctx.L, 5)
    assert torch.equal(two, cuda_rns.rns_exit_plain(ctx, *xs))
    assert torch.equal(two[0], one[0])
    pair = trn.from_rns_mont(ctx, trn.RVal(xs[0], 3), trn.RVal(xs[1], 3))
    assert torch.equal(pair, torch.stack([
        trn.from_rns_mont(ctx, trn.RVal(x, 3)) for x in xs]))
    assert cuda_rns.rns_exit.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_rns.rns_exit(ctx, xs[0].to("meta"))


def _c_layout(k, L):
    """bgn_exit_layout of csrc/rns_exit.cu, its statements run as Python
    (integer division for `/`)."""
    body = re.search(r"bgn_exit_layout\(int k, int L\) \{\n(.*?)\n  return e;",
                     SOURCE, re.S).group(1)
    env = {"k": k, "L": L, "o": 0}
    for stmt in body.replace("e.", "e_").replace("/", "//").split(";"):
        stmt = stmt.strip()
        if stmt and not stmt.startswith(("ExitLayout", "int o")):
            exec(stmt, {}, env)
    return {name[2:]: v for name, v in env.items() if name.startswith("e_")}


def test_exit_blob_layout(key):
    """The blob holds the context's constants at exit_layout's offsets,
    exit_layout equals the kernel source's bgn_exit_layout, d8 is the
    context's row count, and the blob is cached and its size is the
    layout's."""
    ctx, _ = key
    k, L = ctx.k, ctx.L
    off = cuda_rns.exit_layout(k, L)
    assert _c_layout(k, L) == off
    assert off["d8"] == ctx.crt_rows.shape[0]
    blob = cuda_rns.exit_blob(ctx)
    assert blob is cuda_rns.exit_blob(ctx)
    assert blob.dtype == torch.int32 and blob.numel() == off["words"]
    b = blob.numpy()
    f = b.view(np.float32)

    def at(name, n):
        return off[name], off[name] + n

    np.testing.assert_array_equal(f[slice(*at("c_out", 2 * k))],
                                  ctx.c_out.reshape(-1).numpy())
    np.testing.assert_array_equal(f[slice(*at("crt_inv_a", k))],
                                  ctx.crt_inv_a.reshape(-1).numpy())
    for name, t, n in (("w_alpha", ctx.w_alpha_a, k),
                       ("a_rows", ctx.a_rows, off["d8"]),
                       ("p_limbs", ctx.p_limbs, L + 1)):
        np.testing.assert_array_equal(b[slice(*at(name, n))],
                                      t.reshape(-1).numpy().astype(np.int32))
    crt = b[off["crt"]:].view(np.uint8).reshape(k, off["crt_stride"])
    np.testing.assert_array_equal(crt[:, :off["d8"]],
                                  ctx.crt_rows.numpy().T)
    assert not crt[:, off["d8"]:].any()

