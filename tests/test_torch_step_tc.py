"""csrc/dbl_step.cu, csrc/add_step.cu, csrc/pt_dbl.cu, csrc/pt_add.cu,
csrc/pow_step.cu, csrc/fp2_pow_step.cu, csrc/dual_ladder.cu,
csrc/window_ladder_tab.cu and csrc/window_ladder.cu on the tensor-core
block product, held on the CPU without JAX: chains of dbl_step_plain,
add_step_plain, pt_dbl_plain and pt_add_plain launches with every
product's extension sums routed through test_torch_tc_ext.py's integer
emulation of rns_tc.cuh's block product, over n lanes padded to whole
blocks of G with the zero inputs the kernels give lanes past n (n = 1:
seven of eight warps on zeros; n = 13: a short last block), equal to the
plain steps at every step (pow_step's and fp2_pow_step's chains are
test_torch_pow_tc.py's, dual_ladder's and window_ladder_tab's
test_torch_dual_tc.py's, window_ladder's test_torch_window_tc.py's).  The
nine sources and csrc/rns_exit.cu, and the compute-then-select window
chains that
dual_ladder.cu and window_ladder_tab.cu (rns.cuh win_chain_sel) and
window_ladder.cu (win_chain_rows) run, are read for the deadlock of a
block-wide product (a warp that returns, continues or breaks before the
kernel's last product leaves its block's barriers waiting, or
desynchronises them), and their C entries against the ctypes argument
types.  The moduli are test_torch_tc_ext.py's: k = 47 (S = 4), 92
(S = 6) and 186 (S = 12).
"""
import _torch_threads  # noqa: F401  (first: one torch thread per process)
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
    "add_step": ("add_step.cu", "bgn_add_step_kernel",
                 r"add_step<S, MulTc<S>>\(", "bgn_add_step"),
    "pt_dbl": ("pt_dbl.cu", "bgn_pt_dbl_kernel", r"dbl_pt<S, MulTc<S>>\(",
               "bgn_pt_dbl"),
    "pt_add": ("pt_add.cu", "bgn_pt_add_kernel", r"add_pt<S, MulTc<S>>\(",
               "bgn_pt_add"),
    "pow_step": ("pow_step.cu", "bgn_pow_step_kernel", r"MulTc<S>::mul\(",
                 "bgn_pow_step"),
    "fp2_pow_step": ("fp2_pow_step.cu", "bgn_fp2_pow_step_kernel",
                     r"fp2_(?:sqr|mul)<S, MulTc<S>>\(", "bgn_fp2_pow_step"),
    "dual_ladder": ("dual_ladder.cu", "bgn_dual_ladder_kernel",
                    r"<S, MulTc<S>>\(", "bgn_dual_ladder"),
    "window_ladder_tab": ("window_ladder_tab.cu",
                          "bgn_window_ladder_tab_kernel",
                          r"win_chain_sel<S, MulTc<S>>\(",
                          "bgn_window_ladder_tab"),
    "window_ladder": ("window_ladder.cu", "bgn_window_ladder_kernel",
                      r"win_chain_rows<S, MulTc<S>>\(", "bgn_window_ladder"),
    "rns_exit": ("rns_exit.cu", "bgn_rns_exit_kernel", r"r_mul_tc<S>\(",
                 "bgn_rns_exit"),
}
# device functions with products that a kernel above calls through the
# tensor-core policy: (header, function, its products)
HELPERS = {
    "win_chain_sel": ("rns.cuh", "win_chain_sel", r"add_pt<S, Mul>\("),
    "win_chain_rows": ("window_ladder.cu", "win_chain_rows",
                       r"add_pt<S, Mul>\("),
}


@pytest.fixture(scope="module", params=sorted(tce.WIDTHS),
                ids=lambda b: f"{b}b")
def ctx(request):
    return tce._ctx(request.param)


def _two_steps(step, ctx, n_state, *ins):
    """Two steps of one kind, as the host loops launch them: the first
    n_state inputs are the state, carried from step to step (Miller
    steps: X, Y, Z, fr, fi; G1 steps: X, Y, Z), the rest the step's fixed
    points (dbl_step_plain: xb, yb; add_step_plain: ax, ay, xb, yb;
    pt_add_plain: ax, ay); the outputs of each step."""
    state, points = tuple(ins[:n_state]), ins[n_state:]
    outs = []
    for _ in range(2):
        state = step(ctx, *state, *points)
        outs.append(state)
    return outs


def _steps_on_the_block_product(ctx, n, monkeypatch, step, ins, n_state):
    """The inputs ins on n lanes, padded to whole blocks of G with zero
    lanes, two steps on the emulated block product against the unpadded
    plain steps, bit for bit at each step."""
    want = _two_steps(step, ctx, n_state, *ins)
    width = -(-n // G) * G
    pad = [torch.cat([v, v.new_zeros(v.shape[0], width - n)], dim=1)
           for v in ins]
    monkeypatch.setattr(trn, "_ext_dot", tpc._routed_ext_dot(
        ctx, lambda mat, q: tpc._tc_sums(ctx, mat, q)))
    got = _two_steps(step, ctx, n_state, *pad)
    assert len(got) == len(want) == 2
    for g_step, w_step in zip(got, want):
        assert all(torch.equal(g[:, :n], w) for g, w in zip(g_step, w_step))


def _random_inputs(ctx, n, nin, seed):
    """nin random residue arrays of values < p on n lanes."""
    return [tpc._values(ctx, n, seed + i) for i in range(nin)]


@pytest.mark.parametrize("n", [1, 13])
def test_steps_on_the_block_product(ctx, n, monkeypatch):
    """n lanes padded to whole blocks of G = 8 with the zeros dbl_step.cu
    loads for lanes past n, every product's extensions on the emulated
    block product: each step's n lanes equal the unpadded plain step's
    bit for bit (from random X, Y, Z, f < p, then the state bounds 27p,
    6p, 9p after the first step)."""
    _steps_on_the_block_product(ctx, n, monkeypatch, cuda_rns.dbl_step_plain,
                                _random_inputs(ctx, n, 7, 3 * ctx.k), 5)


@pytest.mark.parametrize("n", [1, 13])
def test_add_steps_on_the_block_product(ctx, n, monkeypatch):
    """add_step.cu's design, as for dbl_step: the zeros add_step.cu loads
    for lanes past n (all nine inputs), each step's n lanes equal to the
    unpadded plain step's bit for bit (from random X, Y, Z, f, A, B < p,
    then the Miller state's bounds after the first step)."""
    _steps_on_the_block_product(ctx, n, monkeypatch, cuda_rns.add_step_plain,
                                _random_inputs(ctx, n, 9, 5 * ctx.k), 5)


@pytest.mark.parametrize("n", [1, 13])
def test_pt_dbl_on_the_block_product(ctx, n, monkeypatch):
    """pt_dbl.cu's design, as for dbl_step: the zeros pt_dbl.cu loads for
    lanes past n, two doublings in a row as _ladder_chain launches them
    for a zero digit, each one's n lanes equal to the unpadded plain
    doubling's bit for bit (from random X, Y, Z < p, then the ladder
    state's bounds (27, 27, 6))."""
    _steps_on_the_block_product(ctx, n, monkeypatch, cuda_rns.pt_dbl_plain,
                                _random_inputs(ctx, n, 3, 7 * ctx.k), 3)


@pytest.mark.parametrize("n", [1, 13])
@pytest.mark.parametrize("start", ["random", "window-chain start"])
def test_pt_add_on_the_block_product(ctx, start, n, monkeypatch):
    """pt_add.cu's design: the zeros pt_add.cu loads for lanes past n (all
    five inputs), two additions of a random A < p in a row as
    _window_chain launches them, each one's n lanes equal to the
    unpadded plain addition's bit for bit; from random X, Y, Z < p, or
    from the state of a window chain's lane that has not started
    (X = Y = 0, Z = one)."""
    ins = _random_inputs(ctx, n, 5, 11 * ctx.k)
    if start != "random":
        ins[:3] = [torch.zeros_like(ins[0]), torch.zeros_like(ins[0]),
                   ctx.one_rns.expand(-1, n).contiguous()]
    _steps_on_the_block_product(ctx, n, monkeypatch, cuda_rns.pt_add_plain,
                                ins, 3)


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
    the block, so a kernel that lets a warp (a lane past n, a dead window)
    return, continue or break before its last product deadlocks its block
    or runs its warps' products out of step: no kernel body, and no
    helper with products that one calls (the window chains of
    dual_ladder.cu, window_ladder_tab.cu and window_ladder.cu), has a
    `return`, `continue` or `break` before its last product call, and
    every kernel calls the tensor-core product."""
    bodies = [(kernel, _body(_source(source), kernel), product)
              for source, kernel, product, _ in KERNELS.values()]
    bodies += [(head, _body(_source(source), head), product)
               for source, head, product in HELPERS.values()]
    for name, body, product in bodies:
        calls = [m.start() for m in re.finditer(product, body)]
        assert calls, f"{name} calls no product"
        early = [m.group(0) for m in re.finditer(
            r"\b(?:return|continue|break)\b", body) if m.start() < calls[-1]]
        assert not early, f"{name}: {early[0]} before its last product"
    dual = _body(_source("dual_ladder.cu"), "bgn_dual_ladder_kernel")
    assert "win_chain_sel<S, MulTc<S>>(" in dual
    assert "jac_add_full<S, MulTc<S>>(" in dual
    fp2 = _body(_source("fp2_pow_step.cu"), "bgn_fp2_pow_step_kernel")
    assert "fp2_sqr<S, MulTc<S>>(" in fp2
    assert "fp2_mul<S, MulTc<S>>(" in fp2


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
