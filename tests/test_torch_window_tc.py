"""csrc/window_ladder.cu on the tensor-core block product, held on the CPU
without JAX: a model of the kernel's chain (window_ladder.cu
win_chain_rows) against window_ladder_plain.  The model takes n lanes
padded to whole blocks of G with the lanes the kernel runs past n (zero
rows, dead flags), loads zeros for every dead row, as the kernel does, and
runs each block of G lanes on its own: at every window where some lane of
the block is live, the addition for every lane of the block (pt_add_plain)
and a select on the flags; a window dead in every lane of the block is
skipped by the block.  Every product's extension sums go through
test_torch_tc_ext.py's integer emulation of rns_tc.cuh's block product.
The n lanes must equal window_ladder_plain on the unpadded stream, whose
dead rows stay nonzero, bit for bit.  Cases: random flags (lane 0 with
only the last window live, lane 1 with none, lane 2 with only the first),
every window dead (every Z = 0, every window skipped), and windows dead in
every lane of one block while the other block's lanes are live there.  The
moduli are test_torch_tc_ext.py's: k = 47 (S = 4), 92 (S = 6) and 186
(S = 12).
"""
import _torch_threads  # noqa: F401  (first: one torch thread per process)
import numpy as np
import pytest
import torch

import test_torch_pow_tc as tpc
import test_torch_tc_ext as tce
from bgn_torch.fieldcore import rns as trn
from bgn_torch.ops import cuda_rns

G = tpc.G
JD = 3                     # windows of the stream


@pytest.fixture(scope="module", params=sorted(tce.WIDTHS),
                ids=lambda b: f"{b}b")
def ctx(request):
    return tce._ctx(request.param)


def _stream(ctx, n, seed):
    """Rows gx, gy [JD, 2k, n]: residues of random values below p."""
    return tuple(tpc._values(ctx, JD * n, seed + i).reshape(
        2 * ctx.k, JD, n).permute(1, 0, 2).contiguous() for i in range(2))


def _flags(n, case, seed):
    """ginf [JD, n], nonzero where the window is dead, for a case."""
    ginf = np.random.default_rng(seed).integers(0, 2, (JD, n))
    if case == "all dead":
        ginf[:] = 1
    elif case == "block dead":
        # lanes 0-7 (block 0) dead at window 1, lanes 8.. (block 1, and
        # the padded lanes past n) dead at window 2, every other lane live
        ginf[:] = 0
        ginf[1, :G] = 1
        ginf[2, G:] = 1
    else:
        ginf[:, 0] = [1] * (JD - 1) + [0]
        if n > 2:
            ginf[:, 1] = 1
            ginf[:, 2] = [0] + [1] * (JD - 1)
    return torch.as_tensor(ginf)


def _kernel_chain(ctx, gx, gy, ginf, n):
    """window_ladder.cu's chain over the stream padded to whole blocks of
    G lanes: per block, the windows where some lane of the block is live,
    dead rows and lanes past n on zeros, computed for every lane of the
    block and selected (window_ladder_plain over those windows, which is
    _window_chain's compute-then-select).  Returns (X, Y, Z) [2k, width]
    and the windows skipped per block."""
    width = -(-n // G) * G
    live = torch.zeros((JD, width), dtype=torch.bool)
    live[:, :n] = ginf == 0
    rows = [torch.zeros((JD, 2 * ctx.k, width)) for _ in range(2)]
    for r, g in zip(rows, (gx, gy)):
        r[:, :, :n] = torch.where(live[:, None, :n], g, torch.zeros(()))
    outs, skipped = [], []
    for b in range(0, width, G):
        lv = live[:, b:b + G]
        keep = lv.any(dim=1)
        skipped.append([j for j in range(JD) if not keep[j]])
        outs.append(cuda_rns.window_ladder_plain(
            ctx, rows[0][keep, :, b:b + G].contiguous(),
            rows[1][keep, :, b:b + G].contiguous(), ~lv[keep]))
    return tuple(torch.cat(v, dim=1) for v in zip(*outs)), skipped


@pytest.mark.parametrize("n", [1, 13])
@pytest.mark.parametrize("case", ["random", "all dead", "block dead"])
def test_window_ladder_on_the_block_product(ctx, case, n, monkeypatch):
    """window_ladder.cu's design: the n lanes of the kernel's chain on the
    emulated block product, over zeroed dead rows and padded lanes, with
    windows dead in a whole block skipped, equal window_ladder_plain's
    output bit for bit; Z = 0 exactly on the lanes with no live window."""
    gx, gy = _stream(ctx, n, 13 * ctx.k + n)
    ginf = _flags(n, case, ctx.k + n)
    want = cuda_rns.window_ladder_plain(ctx, gx, gy, ginf)
    monkeypatch.setattr(trn, "_ext_dot", tpc._routed_ext_dot(
        ctx, lambda mat, q: tpc._tc_sums(ctx, mat, q)))
    got, skipped = _kernel_chain(ctx, gx, gy, ginf, n)
    assert all(torch.equal(g[:, :n], w) for g, w in zip(got, want))
    zero = torch.all(want[2] == 0, dim=0).tolist()
    assert zero == torch.all(ginf != 0, dim=0).tolist()
    if case == "all dead":
        assert all(zero) and skipped == [list(range(JD))] * len(skipped)
    elif case == "block dead":
        assert skipped == [[1], [2]][:len(skipped)]
    else:
        assert zero[:3] == [False, True, False][:n]
