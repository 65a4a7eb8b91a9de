"""Pipeline parallelism (PP) for the pairing: the port's counterpart of
`bgn_tpu/parallel/pipeline.py`.  The Miller loop's bit range is split
into per-stage segments, one stage per rank of a 'stage' mesh, and
microbatches flow through the stages.

Each rank holds one microbatch's loop state (V, f and the inputs) while
it advances its bit segment; at every tick the state moves to the next
rank (one `batch_isend_irecv` per tick: the finished carry to rank s+1
and the next one from rank s-1, posted together so that no rank blocks
on a send).  Stage 0 seeds a fresh microbatch per tick, stage S-1
finishes the last Miller bits AND runs the final exponentiation, so a
batch of M microbatches completes in M + S - 1 ticks.  Which microbatch
a stage holds at a tick, whether the loop has started (the bits before
the MSB are skipped) and the -1 padding of the plan are all known on the
host from the plan, so they are Python control flow here where the JAX
package carries them as tensors.

Segment balance: bit segments are sized on the host so every stage costs
about the same in r_mul units, charging the final exponentiation to the
last stage (plan_segments, the JAX package's planner).

The steps are the Miller step kernels' wrappers (ops/cuda_rns.py
dbl_step and add_step: dbl_step.cu and add_step.cu on the card, their
plain versions on a CPU tensor) and the final exponentiation's loop
kernels, so the result equals rns_pairing.pairing_rns over the bits of
n limb for limb.  The reference has no pairing pipeline (a single pbc
Element.Pair call, bgn.go:294-314).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..fieldcore import limbs as lb
from ..fieldcore import rns as rn
from ..fieldcore.rns import RVal
from ..ops import cuda_rns
from ..ops import rns_pairing as rp
from .mesh import axis_rank, axis_size, mesh_ranks

STAGE_AXIS = "stage"

# r_mul-unit costs per Miller bit and for the final exponentiation
# (ops/rns_pairing.py step audits)
_DBL, _ADD = 21, 17


def _fexp_rmul(nbits: int, pbits: int) -> float:
    """final exp ~ conj/inv (fp2 pow over l) + Fermat inversion pow."""
    return nbits * (2 + 1.5) + pbits * 1.5 + 10


def plan_segments(n: int, nbits: int, stages: int, pbits: int) -> np.ndarray:
    """[S, seg] int32 bit-op rows, -1 = skip.

    The global op string is n_bits[:-1] followed by one 0 (the tail
    doubling with the final addition elided -- a 0 bit is exactly 'double,
    no add').  Splits are chosen so stage costs balance with the final
    exponentiation charged to the last stage."""
    bits = [int(b) for b in lb.int_to_bits(n, nbits)]  # MSB first
    ops = bits[:-1] + [0]
    # cost of each op position (leading zeros before the MSB are free:
    # the started flag skips them)
    msb = bits.index(1)
    cost = [0.0 if i < msb else (_DBL + _ADD * ops[i]) for i in
            range(len(ops))]
    fexp = _fexp_rmul(nbits, pbits)
    total = sum(cost) + fexp
    per = total / stages
    # greedy boundaries: stage s takes ops until its budget is spent;
    # the last stage's budget is reduced by the final-exp charge
    rows, start = [], 0
    for s in range(stages):
        budget = per - (fexp if s == stages - 1 else 0.0)
        acc, end = 0.0, start
        while end < len(ops) and (acc < budget or s == stages - 1):
            acc += cost[end]
            end += 1
        rows.append(ops[start:end])
        start = end
    assert start == len(ops), (start, len(ops))
    seg = max(len(r) for r in rows)
    out = np.full((stages, seg), -1, dtype=np.int32)
    for s, r in enumerate(rows):
        out[s, :len(r)] = r
    return out


# the carry's rows, one [2k, mb] residue tensor each
_CARRY = ("X", "Y", "Z", "fr", "fi", "ax", "ay", "xb", "yb")


def _advance(rns, carry: torch.Tensor, ops, started: bool) -> torch.Tensor:
    """Run one stage's bit ops over a carry [9, 2k, mb]: before the MSB
    (started False) an op only sets started; after it a doubling step,
    and an addition step on a 1."""
    X, Y, Z, fr, fi, ax, ay, xb, yb = carry.unbind(0)
    for op in ops:
        if not started:
            started = op > 0
            continue
        X, Y, Z, fr, fi = cuda_rns.dbl_step(rns, X, Y, Z, fr, fi, xb, yb)
        if op > 0:
            X, Y, Z, fr, fi = cuda_rns.add_step(rns, X, Y, Z, fr, fi, ax, ay,
                                                xb, yb)
    return torch.stack([X, Y, Z, fr, fi, ax, ay, xb, yb])


def pairing_pipeline(dev, a, b, mesh, microbatches: int):
    """Batched Tate pairing through the stage pipeline.

    dev: PublicDeviceKey with an RNS context; a, b: AffinePoint batches
    [L, B] (the whole batch on every rank) with B divisible by
    `microbatches`; mesh: 1-D DeviceMesh over STAGE_AXIS.  Returns [2, L, B]
    limb-Montgomery GT elements on every rank (broadcast from the last
    stage), equal to rns_pairing.pairing_rns(ctx, rns, a, b, dev.n_bits,
    dev.l_bits)."""
    ctx, rns = dev.ctx, dev.rns
    if rns is None:
        raise ValueError("the pipeline needs the key's RNS context")
    S = axis_size(mesh, STAGE_AXIS)
    s = axis_rank(mesh, STAGE_AXIS)
    ranks = mesh_ranks(mesh)
    group = mesh.get_group(STAGE_AXIS)
    M = int(microbatches)
    B = a.x.shape[1]
    if B % M:
        raise ValueError(f"batch {B} is not a multiple of {M} microbatches")
    mb = B // M
    ch = 2 * rns.k
    device = a.x.device

    # n is public; recover it from the device bits for the host planner
    bits = [int(v) for v in dev.n_bits.tolist()]
    n_int = int("".join(map(str, bits)), 2)
    rows = plan_segments(n_int, len(bits), S, 16 * ctx.L)
    mine = [int(v) for v in rows[s] if v >= 0]
    started = any(int(v) > 0 for r in rows[:s] for v in r)
    if s == 0:
        ins = [rn.to_rns_mont(rns, x).v for x in (a.x, a.y, b.x, b.y)]
        one = rns.one_rns.expand(ch, mb)

    # the first call on the group is a whole-group collective (NCCL sets
    # up its communicator on it; a p2p call may not be the first)
    dist.barrier(group=group)
    outs, prev = [], None
    for t in range(M + S - 1):
        j = t - s                      # the microbatch this stage holds
        ops, carry = [], None
        if prev is not None:           # last tick's carry, to stage s+1
            ops.append(dist.P2POp(dist.isend, prev, ranks[s + 1], group))
        if 0 <= j < M and s > 0:       # this tick's, from stage s-1
            carry = torch.empty((len(_CARRY), ch, mb), dtype=torch.float32,
                                device=device)
            ops.append(dist.P2POp(dist.irecv, carry, ranks[s - 1], group))
        if ops:
            for w in dist.batch_isend_irecv(ops):
                w.wait()
        prev = None
        if not 0 <= j < M:
            continue
        if s == 0:                     # seed microbatch j
            ax, ay, xb, yb = (v[:, j * mb:(j + 1) * mb] for v in ins)
            carry = torch.stack([ax, ay, one, one, torch.zeros_like(ax),
                                 ax, ay, xb, yb])
        carry = _advance(rns, carry, mine, started)
        if s < S - 1:
            prev = carry
            continue
        # last stage: final exponentiation of the finished Miller f
        zr, zi = rp.final_exponentiation_rns(
            ctx, rns, (RVal(carry[3], rp._BF), RVal(carry[4], rp._BF)),
            dev.l_bits)
        outs.append(torch.stack([zr.v, zi.v]))
    if s == S - 1:
        z = torch.cat(outs, dim=-1)    # [2, 2k, B], microbatch-major lanes
        out = rn.from_rns_mont(rns, RVal(z[0], rp._BF), RVal(z[1], rp._BF))
    else:
        out = torch.empty((2, ctx.L, B), dtype=torch.int64, device=device)
    dist.broadcast(out, src=ranks[S - 1], group=group)
    return out
