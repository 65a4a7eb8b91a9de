"""csrc/dbl_step.cu and csrc/pow_step.cu on the tensor-core block
product, held on the CPU without JAX: a chain of dbl_step_plain launches
with every product's extension sums routed through test_torch_tc_ext.py's
integer emulation of rns_tc.cuh's block product, over n lanes padded to
whole blocks of G with the zero inputs the kernel gives lanes past n
(n = 1: seven of eight warps on zeros; n = 13: a short last block), equal
to the plain steps at every step (pow_step's chain is one of
test_torch_pow_tc.py's).  Both sources are read for the deadlock of a
block-wide product (a warp that returns before the kernel's last product
leaves its block's barriers waiting), and their C entries against the
ctypes argument types.  The moduli are test_torch_tc_ext.py's: k = 47
(S = 4), 92 (S = 6) and 186 (S = 12).
"""
import ctypes
import re

import pytest
import torch

import test_torch_pow_tc as tpc
import test_torch_tc_ext as tce
from bgn_torch import _build
from bgn_torch.fieldcore import rns as trn
from bgn_torch.ops import cuda_rns

G = tpc.G
# kernel -> (source, kernel function, its products, C entry)
KERNELS = {
    "dbl_step": ("dbl_step.cu", "bgn_dbl_step_kernel",
                 r"dbl_step<S, MulTc<S>>\(", "bgn_dbl_step"),
    "pow_step": ("pow_step.cu", "bgn_pow_step_kernel", r"MulTc<S>::mul\(",
                 "bgn_pow_step"),
}


@pytest.fixture(scope="module", params=sorted(tce.WIDTHS),
                ids=lambda b: f"{b}b")
def ctx(request):
    return tce._ctx(request.param)


def _dbl_chain(ctx, X, Y, Z, fr, fi, xb, yb):
    """Two Miller doubling steps, as _miller_chain launches them; the
    outputs of each step."""
    outs = []
    for _ in range(2):
        X, Y, Z, fr, fi = cuda_rns.dbl_step_plain(ctx, X, Y, Z, fr, fi, xb,
                                                  yb)
        outs.append((X, Y, Z, fr, fi))
    return outs


@pytest.mark.parametrize("n", [1, 13])
def test_steps_on_the_block_product(ctx, n, monkeypatch):
    """n lanes padded to whole blocks of G = 8 with the zeros dbl_step.cu
    loads for lanes past n, every product's extensions on the emulated
    block product: each step's n lanes equal the unpadded plain step's
    bit for bit (from random X, Y, Z, f < p, then the state bounds 27p,
    6p, 9p after the first step)."""
    ins = [tpc._values(ctx, n, 3 * ctx.k + i) for i in range(7)]
    want = _dbl_chain(ctx, *ins)
    width = -(-n // G) * G
    pad = [torch.cat([v, v.new_zeros(v.shape[0], width - n)], dim=1)
           for v in ins]
    monkeypatch.setattr(trn, "_ext_dot", tpc._routed_ext_dot(
        ctx, lambda mat, q: tpc._tc_sums(ctx, mat, q)))
    got = _dbl_chain(ctx, *pad)
    assert len(got) == len(want)
    for g_step, w_step in zip(got, want):
        assert all(torch.equal(g[:, :n], w) for g, w in zip(g_step, w_step))


def _source(name: str) -> str:
    """A kernel source without its comments."""
    text = (_build.CSRC / name).read_text()
    return re.sub(r"//[^\n]*|/\*.*?\*/", "", text, flags=re.S)


def _body(text: str, head: str) -> str:
    """The brace-matched body of the function whose definition starts at
    `head(`."""
    start = text.index("{", re.search(rf"\b{head}\(", text).end())
    depth = 0
    for i in range(start, len(text)):
        depth += {"{": 1, "}": -1}.get(text[i], 0)
        if depth == 0:
            return text[start:i + 1]
    raise ValueError(f"unbalanced braces after {head}")


def test_no_warp_returns_before_the_last_product():
    """r_mul_tc waits at four __syncthreads per product for every warp of
    the block, so a kernel that lets a warp (a lane past n) return before
    its last product deadlocks: neither kernel body has a `return` before
    its last product call, and both call the tensor-core product."""
    for source, kernel, product, _ in KERNELS.values():
        body = _body(_source(source), kernel)
        calls = [m.start() for m in re.finditer(product, body)]
        assert calls, f"{kernel} calls no tensor-core product"
        early = [m.start() for m in re.finditer(r"\breturn\b", body)
                 if m.start() < calls[-1]]
        assert not early, f"{kernel}: a return before its last product"


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_c_entry_matches_its_ctypes_signature(kernel):
    """The C entry's parameters (the matrix planes after the blob) in the
    order and kinds of _build._SIGNATURES: a pointer or the stream as
    c_void_p, an int as c_int."""
    source, _, _, entry = KERNELS[kernel]
    m = re.search(rf'extern "C" int {entry}\(([^)]*)\)', _source(source))
    kinds = [ctypes.c_void_p if "*" in p or "cudaStream_t" in p
             else ctypes.c_int for p in m.group(1).split(",")]
    assert kinds == _build._SIGNATURES[entry]
    assert kinds[:4] == [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                         ctypes.c_int]
