"""csrc/pow_loop.cu, csrc/fp2_pow_loop.cu, csrc/pow_step.cu and
csrc/fp2_pow_step.cu on the tensor-core block product, held on the CPU
without JAX: whole pow_loop_plain and fp2_pow_loop_plain chains, and
chains of pow_step_plain and fp2_pow_step_plain launches, with every
product's extension sums routed through test_torch_tc_ext.py's integer
emulation of rns_tc.cuh's block product, over n lanes padded to whole
blocks of G with the zero inputs the kernels give lanes past n (n = 1:
the lone Fermat inversion of normalize_rns and mont_inv_rns, one live
lane of eight; n = 13: a short last block), equal to the plain chains.
The moduli are test_torch_tc_ext.py's: k = 47 (S = 4), 92 (S = 6) and
186 (S = 12).
"""
import _torch_threads  # noqa: F401  (first: one torch thread per process)
import random

import numpy as np
import pytest
import torch

import test_torch_tc_ext as tce
from bgn_torch.fieldcore import limbs as lb
from bgn_torch.fieldcore import rns as trn
from bgn_torch.ops import cuda_rns

G = 8                                        # rns_tc.cuh TcLanes<S>::G


@pytest.fixture(scope="module", params=sorted(tce.WIDTHS),
                ids=lambda b: f"{b}b")
def ctx(request):
    return tce._ctx(request.param)


def _tc_sums(ctx, mat, q):
    """The tensor-core block product (test_torch_tc_ext.py's emulation of
    rns_tc.cuh bgn_tc_extend) over q [k, N], N a multiple of G."""
    assert q.shape[1] % G == 0
    return tce._block_extension(ctx, mat, q, G).T.astype(np.int64)


def _routed_ext_dot(ctx, sums_of):
    """A stand-in for fieldcore/rns.py _ext_dot whose extension sums come
    from sums_of(mat, q) (q: the source residues of the product, [k, N]):
    they must equal the plain sums bit for bit, and they are returned
    recombined as O = (S // 4096, S // 64 % 64, S % 64), so the product
    goes on from the emulated sums.  The alpha row is the plain one."""
    real, k = trn._ext_dot, ctx.k

    def ext_dot(W, x):
        mat = 0 if W is ctx.w1 else 1
        O, Sa = real(W, x)
        q = (x[:k] * 64 + x[k:]).numpy().astype(np.int64)
        assert q.min() >= 0 and q.max() < 4096
        S = sums_of(mat, q)
        Oi = O.numpy().astype(np.int64)
        np.testing.assert_array_equal(
            S, Oi[:k] * 4096 + Oi[k:2 * k] * 64 + Oi[2 * k:])
        return torch.tensor(np.concatenate([S // 4096, S // 64 % 64,
                                            S % 64]),
                            dtype=torch.float32), Sa
    return ext_dot


def _values(ctx, n, seed):
    """Residues [2k, n] of n seeded random values below p."""
    p = lb.limbs_to_ints(ctx.p_limbs.reshape(-1, 1))[0]
    rng = random.Random(seed)
    return trn.limbs_to_rns(ctx, torch.as_tensor(lb.ints_to_limbs(
        [rng.randrange(p) for _ in range(n)], ctx.L)))


def _pow_steps(ctx, acc, x):
    """Square-and-multiply steps at bit 1, then bit 0, one launch each as
    cuda_rns._pow_chain makes them; the output of each step."""
    outs = []
    for bit in (1, 0):
        acc = cuda_rns.pow_step_plain(ctx, acc, x, bit)
        outs.append(acc)
    return tuple(outs)


def _chains(ctx):
    """(name, plain chain on lanes, its inputs [2k, n] each): a short
    pow_loop chain (bits 1, 0, 1, 1, 0, 1), fp2_pow_loop chain (digits
    1, -1, 0, 1: a square per digit, a product with x or conj(x) on the
    nonzero ones) and pow_step chain (bits 1, 0, from a random acc)."""
    return (("pow_loop", lambda *a: (cuda_rns.pow_loop_plain(
                ctx, *a, [1, 0, 1, 1, 0, 1]),), 1),
            ("fp2_pow_loop", lambda *a: cuda_rns.fp2_pow_loop_plain(
                ctx, *a, [1, -1, 0, 1]), 2),
            ("pow_step", lambda *a: _pow_steps(ctx, *a), 2))


@pytest.mark.parametrize("n", [1, 13])
@pytest.mark.parametrize("kernel", ["pow_loop", "fp2_pow_loop", "pow_step"])
def test_chains_on_the_block_product(ctx, kernel, n, monkeypatch):
    """n lanes padded to whole blocks of G = 8 with the zero inputs the
    kernel gives lanes past n (X = 0, and for fp2_pow_loop conj(x)'s
    10p - 0; the loop kernels' accumulators start at one, pow_step's acc
    is 0), every product's extensions on the emulated block product; the
    padded chains' n lanes equal the unpadded plain chains bit for bit,
    pow_step's after each step."""
    name, chain, nin = next(c for c in _chains(ctx) if c[0] == kernel)
    ins = [_values(ctx, n, 2 * ctx.k + i) for i in range(nin)]
    want = chain(*ins)
    width = -(-n // G) * G
    pad = [torch.cat([v, v.new_zeros(v.shape[0], width - n)], dim=1)
           for v in ins]
    monkeypatch.setattr(trn, "_ext_dot", _routed_ext_dot(
        ctx, lambda mat, q: _tc_sums(ctx, mat, q)))
    got = chain(*pad)
    assert all(torch.equal(g[:, :n], w) for g, w in zip(got, want))


def _padded(n, step):
    """step on its inputs' n lanes padded to whole blocks of G with zeros,
    the inputs a step kernel gives lanes past n at every launch, and the
    outputs cut back to n lanes."""
    width = -(-n // G) * G

    def padded(rns, *args):
        ins = [torch.cat([v, v.new_zeros(v.shape[0], width - n)], dim=1)
               if isinstance(v, torch.Tensor) else v for v in args]
        return tuple(o[:, :n] for o in step(rns, *ins))
    return padded


@pytest.mark.parametrize("n", [1, 13])
def test_fp2_pow_steps_on_the_block_product(ctx, n, monkeypatch):
    """fp2_pow_step.cu's design: a chain of fp2_pow_step_plain launches
    as cuda_rns._fp2_chain makes them (digits 1, -1, 0, 1: from the
    chain's start ar = one, ai = 0, a product with x, with conj(x) =
    (xr, 10p - xi), none, then x), each launch on n lanes padded with the
    zeros fp2_pow_step.cu loads for lanes past n (all four inputs), every
    product's extensions on the emulated block product; each step's n
    lanes equal the unpadded plain step's bit for bit."""
    xr, xi = (_values(ctx, n, 3 * ctx.k + i) for i in range(2))

    def chain(step):
        outs = []

        def record(rns, *args):
            outs.append(step(rns, *args))
            return outs[-1]
        cuda_rns._fp2_chain(ctx, xr, xi, [1, -1, 0, 1], record)
        return outs

    want = chain(cuda_rns.fp2_pow_step_plain)
    monkeypatch.setattr(trn, "_ext_dot", _routed_ext_dot(
        ctx, lambda mat, q: _tc_sums(ctx, mat, q)))
    got = chain(_padded(n, cuda_rns.fp2_pow_step_plain))
    assert len(got) == len(want) == 4
    for g_step, w_step in zip(got, want):
        assert all(torch.equal(g, w) for g, w in zip(g_step, w_step))
