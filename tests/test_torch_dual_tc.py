"""csrc/dual_ladder.cu and csrc/window_ladder_tab.cu on the tensor-core
block product, held on the CPU without JAX: dual_ladder_plain (two
window chains, every window's addition computed for every lane and
selected, then the combine) and window_ladder_tab_plain (one such chain)
with every product's extension sums routed through test_torch_tc_ext.py's
integer emulation of rns_tc.cuh's block product, over n lanes padded to
whole blocks of G with the lanes the kernels run past n (digits 0, so
row 0 of every window, and m_neg 0), equal to the unpadded plain output
bit for bit.  The tables are small and random (a few windows of R rows,
values below p, row 0 of each window the identity's residues of 0, as
scheme._win_rns makes them).  dual_ladder's first lanes are the cases of
test_torch_kernels.py's test_dual_ladder_matches_jax: m < 0 with r != 0
(the only lane at n = 1), m = 0, r = 0, and the identity m = r = 0,
whose Z must be 0; window_ladder_tab's are a lane whose only live window
is the last (the only lane at n = 1), the identity m = 0 and a lane whose
only live window is the first, then random digits, or all digits zero
(E_det(0), every Z 0).  The moduli are test_torch_tc_ext.py's: k = 47
(S = 4), 92 (S = 6) and 186 (S = 12).
"""
import _torch_threads  # noqa: F401  (first: one torch thread per process)
import random

import numpy as np
import pytest
import torch

import test_torch_pow_tc as tpc
import test_torch_tc_ext as tce
from bgn_torch.fieldcore import rns as trn
from bgn_torch.ops import cuda_rns

G = tpc.G
R = 4                      # rows per window
JM, JR = 2, 3              # windows of m (P's table) and of r (Q's)
IDENT = 3                  # the identity lane at n = 13


@pytest.fixture(scope="module", params=sorted(tce.WIDTHS),
                ids=lambda b: f"{b}b")
def ctx(request):
    return tce._ctx(request.param)


def _table(ctx, J, seed):
    """(x, y) [J, R, 2k] float32 residues of random values below p, row
    0 of every window zeros."""
    out = []
    for i in range(2):
        v = tpc._values(ctx, J * R, seed + i).T.reshape(J, R, 2 * ctx.k)
        v[:, 0] = 0
        out.append(v.contiguous())
    return tuple(out)


def _lanes(n, seed):
    """digits [JM + JR, n] in [0, R) and m_neg [n]: lane 0 m < 0 with both
    chains live; at n = 13 also lane 1 m = 0, lane 2 r = 0 (m < 0), lane
    IDENT the identity, and random digits (dead windows among them)."""
    rng = np.random.default_rng(seed)
    dig = rng.integers(0, R, (JM + JR, n))
    m_neg = rng.integers(0, 2, n)
    dig[:, 0] = np.maximum(dig[:, 0], 1)
    m_neg[0] = 1
    if n > IDENT:
        dig[:JM, 1] = 0
        dig[JM:, 1] = np.maximum(dig[JM:, 1], 1)
        m_neg[1] = 0
        dig[:JM, 2] = np.maximum(dig[:JM, 2], 1)
        dig[JM:, 2] = 0
        m_neg[2] = 1
        dig[:, IDENT] = 0
        m_neg[IDENT] = 0
    return torch.as_tensor(dig), torch.as_tensor(m_neg)


@pytest.mark.parametrize("n", [1, 13])
def test_dual_ladder_on_the_block_product(ctx, n, monkeypatch):
    """n lanes padded to whole blocks of G = 8 with digits 0 and m_neg 0
    (what the kernel runs lanes past n on), every product's extensions
    on the emulated block product: the n lanes of (X, Y, Z) equal the
    unpadded plain output bit for bit; the identity lane's Z is 0."""
    p_tab = _table(ctx, JM, 7 * ctx.k)
    q_tab = _table(ctx, JR, 7 * ctx.k + 2)
    dig, m_neg = _lanes(n, random.Random(ctx.k).getrandbits(32))
    want = cuda_rns.dual_ladder_plain(ctx, p_tab, q_tab, JM, dig, m_neg)
    width = -(-n // G) * G
    pad_dig = torch.cat([dig, dig.new_zeros(dig.shape[0], width - n)], dim=1)
    pad_neg = torch.cat([m_neg, m_neg.new_zeros(width - n)])
    monkeypatch.setattr(trn, "_ext_dot", tpc._routed_ext_dot(
        ctx, lambda mat, q: tpc._tc_sums(ctx, mat, q)))
    got = cuda_rns.dual_ladder_plain(ctx, p_tab, q_tab, JM, pad_dig, pad_neg)
    assert all(torch.equal(g[:, :n], w) for g, w in zip(got, want))
    zero = torch.all(want[2] == 0, dim=0).tolist()
    assert zero == [i == IDENT for i in range(n)]


@pytest.mark.parametrize("n", [1, 13])
@pytest.mark.parametrize("digits", ["lanes", "all zero"])
def test_window_ladder_tab_on_the_block_product(ctx, digits, n,
                                                monkeypatch):
    """window_ladder_tab.cu's design: n lanes padded to whole blocks of
    G = 8 with digit-0 lanes (row 0 of every window, as the kernel runs
    lanes past n), every product's extensions on the emulated block
    product: the n lanes of (X, Y, Z) equal the unpadded plain output bit
    for bit.  "lanes": lane 0's only live window is the last, lane 1 is
    m = 0 (Z = 0), lane 2's only live window is the first, the rest
    random digits (dead windows among them); "all zero": E_det(0), every
    Z = 0."""
    tab = _table(ctx, JR, 5 * ctx.k)
    dig = torch.as_tensor(np.random.default_rng(ctx.k + n).integers(
        0, R, (JR, n)))
    dig[:, 0] = torch.tensor([0] * (JR - 1) + [R - 1])
    if n > 2:
        dig[:, 1] = 0
        dig[:, 2] = torch.tensor([1] + [0] * (JR - 1))
    if digits == "all zero":
        dig.zero_()
    want = cuda_rns.window_ladder_tab_plain(ctx, tab, dig)
    width = -(-n // G) * G
    pad = torch.cat([dig, dig.new_zeros(JR, width - n)], dim=1)
    monkeypatch.setattr(trn, "_ext_dot", tpc._routed_ext_dot(
        ctx, lambda mat, q: tpc._tc_sums(ctx, mat, q)))
    got = cuda_rns.window_ladder_tab_plain(ctx, tab, pad)
    assert all(torch.equal(g[:, :n], w) for g, w in zip(got, want))
    zero = torch.all(want[2] == 0, dim=0).tolist()
    assert zero == torch.all(dig == 0, dim=0).tolist()
    assert zero[:3] == ([True] * 3 if digits == "all zero"
                        else [False, True, False])[:n]
