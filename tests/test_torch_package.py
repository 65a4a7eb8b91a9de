"""Package rules of bgn_torch: no JAX and nothing of bgn_tpu in the port,
chip_smoke.py or the port's scripts/; entry points default to the card;
every kernel wrapper counts launches and sends CPU tensors to its plain
version; and the kernels' integer base extension (csrc/rns.cuh r_mul,
emulated here in numpy over the same constant blob) equals the plain
r_mul bit for bit.
"""
import _torch_threads  # noqa: F401  (first: one torch thread per process)
import ast
import math
import random
from pathlib import Path

import numpy as np
import pytest
import torch

from bgn_torch import scheme
from bgn_torch.fieldcore import montgomery as tmg
from bgn_torch.fieldcore import rns as trn
from bgn_torch.ops import cuda_pairing
from bgn_torch.ops import cuda_rns

ROOT = Path(__file__).resolve().parent.parent


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("where", ["bgn_torch", "chip_smoke.py", "scripts"])
def test_no_jax_and_no_bgn_tpu(where):
    files = sorted((ROOT / where).rglob("*.py")) if where != "chip_smoke.py" \
        else [ROOT / where]
    assert files and all(f.exists() for f in files)
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "bgn_tpu"), (f, name)


def test_keygen_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises((RuntimeError, AssertionError)):
        scheme.keygen(64, 101, rng=random.Random(5))


def _small_ctx(bits=80):
    rng = random.Random(3)
    small = math.prod(trn._primes_desc(3, 2000))   # cheap sieve first
    while True:
        p = rng.getrandbits(bits) | (1 << (bits - 1)) | 1
        if math.gcd(p, small) == 1 and \
                all(pow(a, p - 1, p) == 1 for a in (2, 3, 5, 7, 11, 13)):
            return trn.make_rns_ctx(p, device="cpu")


def _residues(ctx, n, seed):
    g = np.random.default_rng(seed)
    m = ctx.m.numpy().astype(np.int64)
    return torch.tensor((g.integers(0, 1 << 30, size=(2 * ctx.k, n)) % m)
                        .astype(np.float32))


def test_wrappers_count_and_dispatch_cpu_to_plain():
    ctx = _small_ctx()
    x, y = _residues(ctx, 3, 1), _residues(ctx, 3, 2)
    bits = [1, 0, 1, 1]
    naf = [1, 0, -1, 0, 1]
    tab = (torch.tensor(np.stack([_residues(ctx, 4, 3 + j).numpy().T
                                  for j in range(2)])),
           torch.tensor(np.stack([_residues(ctx, 4, 5 + j).numpy().T
                                  for j in range(2)])))
    dig = torch.tensor([[1, 0, 3], [2, 2, 0]])
    mneg = torch.tensor([0, 1, 0])
    gx, gy = cuda_rns._gather_rows(tab, dig)
    calls = [
        (cuda_rns.miller_loop, cuda_rns.miller_loop_plain,
         (ctx, x, y, y, x, naf)),
        (cuda_rns.pow_loop, cuda_rns.pow_loop_plain, (ctx, x, bits)),
        (cuda_rns.fp2_pow_loop, cuda_rns.fp2_pow_loop_plain,
         (ctx, x, y, naf)),
        (cuda_rns.dual_ladder, cuda_rns.dual_ladder_plain,
         (ctx, tab, tab, 1, dig, mneg)),
        (cuda_rns.ladder_loop, cuda_rns.ladder_loop_plain,
         (ctx, x, y, x, y, x, naf)),
        (cuda_rns.window_ladder_tab, cuda_rns.window_ladder_tab_plain,
         (ctx, tab, dig)),
        (cuda_rns.window_ladder, cuda_rns.window_ladder_plain,
         (ctx, gx, gy, dig == 0)),
        (cuda_rns.dbl_step, cuda_rns.dbl_step_plain,
         (ctx, x, y, x, y, x, y, x)),
        (cuda_rns.add_step, cuda_rns.add_step_plain,
         (ctx, x, y, x, y, x, y, x, y, x)),
        (cuda_rns.pt_dbl, cuda_rns.pt_dbl_plain, (ctx, x, y, x)),
        (cuda_rns.pt_add, cuda_rns.pt_add_plain, (ctx, x, y, x, y, x)),
        (cuda_rns.pow_step, cuda_rns.pow_step_plain, (ctx, x, y, 1)),
        (cuda_rns.fp2_pow_step, cuda_rns.fp2_pow_step_plain,
         (ctx, x, y, y, x, 1)),
        (cuda_rns.rns_exit, cuda_rns.rns_exit_plain, (ctx, x, y)),
    ]
    assert len(cuda_rns.WRAPPERS) == 14
    assert set(cuda_rns.WRAPPERS) == {c[0] for c in calls}
    for wrapper, plain, args in calls:
        assert isinstance(wrapper.launches, int)
        before = wrapper.launches
        got, want = wrapper(*args), plain(*args)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert wrapper.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_rns.pow_loop(ctx, x.to("meta"), bits)


def test_digit_wrappers_count_and_dispatch_cpu_to_plain():
    """The two digit-domain Miller step wrappers run their plain versions
    for CPU tensors without counting a launch, and refuse other devices."""
    ctx = tmg.make_mont_ctx((1 << 89) - 1, device="cpu")
    g = np.random.default_rng(4)

    def digits():
        v = [int(a) * int(b) % ctx.p_host
             for a, b in g.integers(1, 1 << 62, size=(5, 2))]
        limbs = torch.tensor([[(x >> (16 * j)) & 0xFFFF for x in v]
                              for j in range(ctx.L)])
        return cuda_pairing.to_digits(limbs)

    V, f, A, Bq = (digits(), digits(), digits()), (digits(), digits()), \
        (digits(), digits()), (digits(), digits())
    assert cuda_pairing.WRAPPERS == (cuda_pairing.dbl_step,
                                     cuda_pairing.add_step)
    for wrapper, plain, args in (
            (cuda_pairing.dbl_step, cuda_pairing.dbl_step_plain, (V, f, Bq)),
            (cuda_pairing.add_step, cuda_pairing.add_step_plain,
             (V, f, A, Bq))):
        before = wrapper.launches
        got, want = wrapper(ctx, *args), plain(ctx, *args)
        assert all(torch.equal(u, w) for u, w in zip(got[0] + got[1],
                                                     want[0] + want[1]))
        assert all(t.dtype == torch.float32 and t.shape == V[0].shape
                   for t in got[0] + got[1])
        assert wrapper.launches == before
        meta = tuple(tuple(t.to("meta") for t in a) for a in args)
        with pytest.raises(ValueError, match="unsupported device"):
            wrapper(ctx, *meta)


def _emulated_kernel_r_mul(ctx, x, y):
    """csrc/rns.cuh r_mul, line for line, over the kernels' constant blob
    (numpy, all lanes at once): the narrow alpha (k <= 64) from the int
    weights, the wide one as a float64 sum against the fp32 reciprocals,
    the bias KC = _kc(k), the matrices in the blob's layout for k (rows
    per source above k = 96), and the extension sums in 32-bit arithmetic
    (int32 up to k = 96, checked below 2^31; unsigned above, mod 2^32,
    checked exact)."""
    k = ctx.k
    wide = k > trn._K_NARROW
    KC = trn._kc(k)
    off = cuda_rns.blob_layout(k)
    blob = cuda_rns.const_blob(ctx).numpy()
    f = blob.view(np.float32)
    rs = off["rs"]

    def fld(name, n):
        return f[off[name]:off[name] + n][:, None]

    def ints(name, n):
        return blob[off[name]:off[name] + n].astype(np.int64)

    m, recip = fld("m", 2 * k), fld("recip", 2 * k)

    def red(v, mm, rr):
        q = np.floor((v * rr).astype(np.float32))
        r = (v - q * mm).astype(np.float32)
        return np.where(r >= mm, r - mm, r)

    x, y = x.numpy(), y.numpy()
    if k > cuda_rns.K_SMEM_MAX:                             # [src, dst ch]
        mat1 = ints("mat1", k * rs).reshape(k, rs)[:, k:2 * k].T
        mat2 = ints("mat2", k * rs).reshape(k, rs)[:, :k].T
    else:
        mat1 = ints("mat1", k * rs).reshape(k, rs)[:, :k]   # [dst j, src i]
        mat2 = ints("mat2", k * rs).reshape(k, rs)[:, :k]   # [dst i, src j]

    def u32_mod(acc, bias, alpha, base_mod, mm):
        """(acc + bias - alpha * base_mod) mod 2^32, then mod m: the
        kernel's 32-bit sum, exact while the true value is in range."""
        true = acc + bias - alpha.astype(np.int64) * base_mod
        top = 2 ** 31 if k <= cuda_rns.K_SMEM_MAX else 2 ** 32
        assert true.min() >= 0 and true.max() < top
        wrapped = (acc % 2 ** 32 + bias - alpha.astype(np.int64) * base_mod
                   ) % 2 ** 32
        assert np.array_equal(wrapped, true)
        return wrapped % mm
    d = red((x * y).astype(np.float32), m, recip)
    qh = red((d[:k] * fld("qc_a", k)).astype(np.float32), m[:k], recip[:k])
    qh = qh.astype(np.int64)

    def alpha(digits, w, rec, eps):
        if wide:
            return np.floor((digits * rec.astype(np.float64)).sum(0) + eps)
        return np.floor((w[:, None] * digits).sum(0) / 524288.0 + eps)

    a1 = alpha(qh, ints("w1a", k), recip[:k], -0.4)
    mB = m[k:].astype(np.int64)
    qpa = u32_mod(mat1 @ qh, KC * mB, a1, fld("p_mod_b", k).astype(np.int64),
                  mB).astype(np.float32)
    u = red((d[k:] * fld("ainv_b", k)).astype(np.float32), m[k:],
            recip[k:]) + qpa
    r = np.where(u >= m[k:], u - m[k:], u)
    rh = red((r * fld("crt_inv_b", k)).astype(np.float32), m[k:],
             recip[k:]).astype(np.int64)
    a2 = alpha(rh, ints("w2a", k), recip[k:], 0.5)
    mA = m[:k].astype(np.int64)
    ra = u32_mod(mat2 @ rh, KC * mA, a2, fld("b_mod_a", k).astype(np.int64),
                 mA)
    return np.concatenate([ra.astype(np.float32), r], axis=0)


@pytest.mark.parametrize("bits", [80, 515, 800, 1036, 2070])
def test_kernel_integer_extension_matches_plain_r_mul(bits):
    """The kernels compute each base extension as an exact unsigned 32-bit
    dot product and an integer mod; that is the canonical residue of the
    same integer the plain version reduces, so raw residues agree bit for
    bit (p of 80 bits; 515 bits: k = 45, the 512-bit key's layout; 800 and
    1036 bits: the wide path, k = 69 and k = 90, the 1024-bit key's;
    2070 bits: k = 185, the 2048-bit key's, S = 12 with the matrices in
    device memory, where a signed int32 sum would overflow)."""
    ctx = _small_ctx(bits)
    k = ctx.k
    assert cuda_rns.slots_for(k) == (4 if k <= 64 else 6 if k <= 96 else 12)
    if bits == 2070:
        assert k == 185 and k * 4092 ** 2 > 2 ** 31
    x, y = _residues(ctx, 64, 7), _residues(ctx, 64, 8)
    got = _emulated_kernel_r_mul(ctx, x, y)
    want = trn.r_mul(ctx, trn.RVal(x, 3), trn.RVal(y, 3)).v.numpy()
    np.testing.assert_array_equal(got, want)
    assert cuda_rns.blob_layout(ctx.k)["words"] == \
        cuda_rns.const_blob(ctx).numel()
