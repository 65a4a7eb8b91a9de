"""Sharded scheme operations: data-parallel batches and giant-step-
parallel BSGS decryption.  The port's counterpart of
`bgn_tpu/parallel/sharded.py`, on torch.distributed (parallel/mesh.py).

Two scaling axes:
  - DP (batch sharding): each rank holds its own rows of a ciphertext
    batch; the scheme kernels are elementwise over the batch, so every op
    runs on the local rows with no communication.  The helpers here place
    the rows and keep the key replicated.
  - Giant-step sharding: the BSGS lookup loop scales as sqrt(msg_space);
    the i-range i in [0, bound] is split into one chunk per rank.  Every
    rank takes the WHOLE batch (the JAX package's replicated input),
    computes csk for all of it, starts its chunk at
    csk * (gamma_inv^chunk)^d (its own offset, computed on limbs at batch
    shape ()), scans its slice against the baby-step table, and the first
    hit is combined with one all_reduce(MIN) over the mesh axis: every hit
    for a given csk encodes the same m, so the minimum is exact first-hit
    semantics (gsbs.go:98).

Both the positive and the negative lane (the reference's decrypt-then-
retry-Neg order, bgn.go:235-242) ride ONE giant-step scan, stacked on an
extra axis exactly as in the single-device scans, whose chains
(ops/bsgs.py g1_scan, gt_scan, g1_rns_scan, gt_rns_scan) run here from
the rank's offset over its chunk.  Both groups are covered: G1 (level-1
ciphertexts) and GT (level-2), in RNS on a key with an RNS context and on
limbs under BGNParams(rns_miller="0") or on a key without one.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..fieldcore import limbs as lb
from ..fieldcore import rns as rn
from ..ops import bsgs as bsgs_mod
from ..ops import curve as cv
from ..ops import fp2
from ..ops import pairing as pairing_mod
from ..ops import rns_pairing as rp
from ..ops.curve import AffinePoint
from .mesh import DATA_AXIS, axis_rank, axis_size, replicate, \
    shard_ciphertext

_NOT_FOUND = 2 ** 31 - 1            # int32


# ---------------------------------------------------------------------------
# Data-parallel scheme ops
# ---------------------------------------------------------------------------
# The scheme kernels are batch-elementwise, so DP needs no special
# kernels: shard the inputs, replicate the key, and run the ops on the
# local rows.


def encrypt_sharded(pk, ms, mesh, rng=None):
    """Encrypt a host batch, then keep this rank's rows: every rank draws
    the whole batch's randomness from `rng`, so the rows equal the
    unsharded Encrypt's."""
    return shard_ciphertext(pk.encrypt(ms, rng=rng), mesh)


def mult_sharded(pk, a, b, mesh, rng=None):
    """Pairing EMult on the local rows: pure DP, no collective beyond the
    key's replication."""
    replicate(pk.dev, mesh)
    return pk.mult(a, b, rng=rng)


# ---------------------------------------------------------------------------
# Giant-step-sharded BSGS decryption
# ---------------------------------------------------------------------------


def _device_chunk(bound: int, ndev: int) -> int:
    return -(-(bound + 1) // ndev)


def _chunk_bits(chunk: int, device) -> torch.Tensor:
    return torch.as_tensor(lb.int_to_bits(chunk, max(chunk.bit_length(), 1)),
                           device=device)


def _encode_candidates(hits, vals, d: int, chunk: int, bound: int):
    """hits/vals [chunk, 2, *batch] -> candidate m or NOT_FOUND, min over
    the local chunk; reference indexing m = i*bound + val + 1
    (gsbs.go:98).  int32 [2, *batch]."""
    shape = (chunk,) + (1,) * (hits.dim() - 1)
    i_global = (d * chunk + torch.arange(chunk, dtype=torch.int64,
                                         device=hits.device)).reshape(shape)
    in_range = i_global <= bound
    cand = torch.where(hits.to(torch.bool) & in_range,
                       i_global * bound + vals + 1,
                       torch.full_like(vals, _NOT_FOUND))
    return cand.min(dim=0).values.to(torch.int32)


def _combine_lanes(best, is_zero):
    """best [2, *batch] int32 (pos lane, neg lane) -> (m, found), matching
    the reference's positive-then-negative preference (bgn.go:235-242) and
    identity => 0 (bgn.go:359-362)."""
    found_p = best[0] != _NOT_FOUND
    found_n = best[1] != _NOT_FOUND
    m = torch.where(found_p, best[0], -best[1])
    m = torch.where(is_zero, torch.zeros_like(m), m)
    found = is_zero | found_p | found_n
    return torch.where(found, m, torch.zeros_like(m)), found


def _pmin(local, mesh):
    dist.all_reduce(local, op=dist.ReduceOp.MIN,
                    group=mesh.get_group(DATA_AXIS))
    return local


def _chunk_of(mesh, bound: int):
    """(this rank's index d, the chunk length)."""
    return (axis_rank(mesh, DATA_AXIS),
            _device_chunk(bound, axis_size(mesh, DATA_AXIS)))


def _offset_gt(ctx, gamma_inv, chunk: int, d: int):
    """(gamma_inv^chunk)^d in F_p^2 limbs [2, L], by the JAX package's
    chain of d products from one."""
    gi_chunk = fp2.pow_bits(ctx, gamma_inv,
                            _chunk_bits(chunk, gamma_inv.device))
    z = fp2.one(ctx, ())
    for _ in range(d):
        z = fp2.mul(ctx, z, gi_chunk)
    return z


def _offset_g1(ctx, gamma_inv: AffinePoint, chunk: int, d: int):
    """(gamma_inv^chunk)^d in G1, affine limbs [L] (the identity for
    d = 0), by the JAX package's chain of d complete mixed additions."""
    gi_chunk = cv.normalize(ctx, cv.scalar_mul(
        ctx, gamma_inv, _chunk_bits(chunk, gamma_inv.x.device)))
    v = cv.jac_infinity(ctx, ())
    for _ in range(d):
        v = cv.madd(ctx, v, gi_chunk)
    return cv.normalize(ctx, v)


# Degenerate-addition audit for the incomplete _add_pt at the per-rank
# offset entry point of the RNS G1 scan: with off_d = -(d*chunk*bound)*gsk,
# V == +off_d needs lane-value == -(d*chunk*bound) (impossible for the
# small in-range magnitudes both lanes carry), and V == -off_d means the
# true aux0 IS the identity -- _add_pt then encodes Z = 0, every later
# candidate stays Z = 0 and is masked; the lane's true hit (if any) lies
# at a giant-step index < d*chunk, i.e. on an earlier rank, so no hit is
# lost (the single-device audit of ops/bsgs.py, applied per rank).


def _bsgs_g1_rns_sharded(ctx, rns, tables, Xr, Yr, Zr, base_inf, mesh):
    """RNS giant-step-sharded G1 scan; Xr/Yr/Zr the raw RVals [2k, B] of
    rns_pairing.scalar_mul_rns.  Returns (best [2, B], is_zero [B])."""
    d, chunk = _chunk_of(mesh, tables.bound)
    k2, L = 2 * rns.k, ctx.L
    B = Xr.v.shape[-1]
    X0, Y0, Z0 = bsgs_mod.g1_rns_lanes(rns, Xr, Yr, Zr)
    off = _offset_g1(ctx, tables.point("gamma_inv_g1"), chunk, d)
    if bool(off.inf):
        aX, aY, aZ = X0, Y0, Z0          # offset identity (d = 0): csk
    else:
        orx = rn.to_rns_mont(rns, off.x.reshape(L, 1)).v.expand(k2, 2 * B)
        ory = rn.to_rns_mont(rns, off.y.reshape(L, 1)).v.expand(k2, 2 * B)
        aX, aY, aZ = rp._add_pt(rns, X0, Y0, Z0, rp._pt(orx), rp._pt(ory))
    inf2 = torch.cat([base_inf, base_inf], dim=-1).to(torch.int64)
    hits, vals, _ = bsgs_mod.g1_rns_scan(ctx, rns, tables, aX, aY, aZ, inf2,
                                         chunk)
    # is_zero (m = 0): canonical limb Z of the raw csk == 0, or input inf
    Zl0 = rn.from_rns_mont(rns, rn.RVal(Zr.v, rp._BZ))
    is_zero = (lb.is_zero(Zl0) | base_inf.to(torch.int64)).to(torch.bool)
    local = _encode_candidates(hits, vals, d, chunk, tables.bound)
    return _pmin(local, mesh), is_zero


def _bsgs_gt_rns_sharded(ctx, rns, tables, zr, zi, mesh):
    """RNS giant-step-sharded GT scan; zr/zi the raw RVals [2k, B] of
    rns_pairing.fp2_pow_rns(raw=True), bound 9.  Returns (best [2, B],
    is_zero [B])."""
    d, chunk = _chunk_of(mesh, tables.bound)
    k2, L = 2 * rns.k, ctx.L
    B = zr.v.shape[-1]
    R0, I0 = bsgs_mod.gt_rns_lanes(rns, zr, zi)
    off = _offset_gt(ctx, tables.gamma_inv_gt, chunk, d)
    orr = rn.to_rns_mont(rns, off[0].reshape(L, 1)).v.expand(k2, 2 * B)
    ori = rn.to_rns_mont(rns, off[1].reshape(L, 1)).v.expand(k2, 2 * B)
    a0 = rp._fp2_mul(rns, (rn.RVal(R0, 9), rn.RVal(I0, 9)),
                     (rn.RVal(orr, 3), rn.RVal(ori, 3)))
    hits, vals, _, _ = bsgs_mod.gt_rns_scan(ctx, rns, tables, a0[0].v,
                                            a0[1].v, chunk)
    # is_zero (m = 0): canonical csk == 1
    rl0 = rn.from_rns_mont(rns, rn.RVal(zr.v, 9))
    il0 = rn.from_rns_mont(rns, rn.RVal(zi.v, 9))
    one_ext = lb.expand_to(ctx.one, rl0.shape)
    is_zero = (lb.eq(rl0, one_ext) & lb.is_zero(il0)).to(torch.bool)
    local = _encode_candidates(hits, vals, d, chunk, tables.bound)
    return _pmin(local, mesh), is_zero


def _bsgs_g1_sharded(ctx, tables, csk, mesh):
    """Limb giant-step-sharded G1 scan; csk = C^q1 (Jacobian [L, *batch]).
    Returns best [2, *batch]."""
    d, chunk = _chunk_of(mesh, tables.bound)
    batch = tuple(csk.Z.shape[1:])
    off = _offset_g1(ctx, tables.point("gamma_inv_g1"), chunk, d)
    shape = (ctx.L, 2) + batch
    off = AffinePoint(lb.expand_to(off.x, shape), lb.expand_to(off.y, shape),
                      off.inf.reshape((1,) * (1 + len(batch)))
                      .expand((2,) + batch))
    v = cv.madd(ctx, bsgs_mod.g1_lanes(ctx, csk), off)
    hits, vals = bsgs_mod.g1_scan(ctx, tables, v, chunk)
    return _pmin(_encode_candidates(hits, vals, d, chunk, tables.bound),
                 mesh)


def _bsgs_gt_sharded(ctx, tables, csk, mesh):
    """Limb giant-step-sharded GT scan; csk [2, L, *batch] = c^q1.
    Returns best [2, *batch]."""
    d, chunk = _chunk_of(mesh, tables.bound)
    batch = tuple(csk.shape[2:])
    off = _offset_gt(ctx, tables.gamma_inv_gt, chunk, d)
    both = torch.stack([csk, fp2.conj(ctx, csk)], dim=2)  # [2, L, 2, *b]
    z = fp2.mul(ctx, both, off.reshape((2, ctx.L, 1) + (1,) * len(batch)))
    hits, vals = bsgs_mod.gt_scan(ctx, tables, z, chunk)
    return _pmin(_encode_candidates(hits, vals, d, chunk, tables.bound),
                 mesh)


def _host(m, found, batch_shape):
    return (np.atleast_1d(m.reshape(batch_shape).cpu().numpy())
            .astype(np.int64),
            np.atleast_1d(found.reshape(batch_shape).cpu().numpy())
            .astype(bool))


def decrypt_gt_sharded(pk, sk, tables, ct, mesh):
    """Sharded L2 decryption of the whole batch `ct` (on every rank): the
    giant-step range is split over the mesh, one scan covers both the
    positive and the negative lane (bgn.go:235-242).  On a key with an
    RNS context (pairing.use_rns) the scan runs in RNS, else on limbs.
    Returns (values int64, found bool) of the batch shape, on every
    rank."""
    ctx = pk.dev.ctx
    batch_shape = tuple(ct.data.shape[2:])
    z = ct.data.reshape(2, ctx.L, -1)
    if pairing_mod.use_rns(pk.dev.rns):
        zr, zi = rp.fp2_pow_rns(ctx, pk.dev.rns, z, sk.q1_naf,
                                unitary=True, raw=True)
        best, is_zero = _bsgs_gt_rns_sharded(ctx, pk.dev.rns, tables, zr, zi,
                                             mesh)
    else:
        csk = fp2.pow_bits(ctx, z, sk.q1_bits)
        best = _bsgs_gt_sharded(ctx, tables, csk, mesh)
        is_zero = fp2.is_one(ctx, csk).to(torch.bool)
    return _host(*_combine_lanes(best, is_zero), batch_shape)


def decrypt_g1_sharded(pk, sk, tables, ct, mesh):
    """Sharded L1 decryption of the whole batch `ct` (the reference's getDL
    also serves G1, gsbs.go:54-106): csk = C^q1, then the giant-step-
    sharded scan, in RNS on a key with an RNS context, else on limbs."""
    ctx = pk.dev.ctx
    batch_shape = tuple(ct.data.inf.shape)
    flat = ct.reshape((int(np.prod(batch_shape, dtype=np.int64)),)).data
    if pairing_mod.use_rns(pk.dev.rns):
        Xr, Yr, Zr = rp.scalar_mul_rns(ctx, pk.dev.rns, flat, sk.q1_naf)
        best, is_zero = _bsgs_g1_rns_sharded(ctx, pk.dev.rns, tables, Xr, Yr,
                                             Zr, flat.inf, mesh)
    else:
        csk = cv.scalar_mul(ctx, flat, sk.q1_bits)
        best = _bsgs_g1_sharded(ctx, tables, csk, mesh)
        is_zero = lb.is_zero(csk.Z).to(torch.bool)
    return _host(*_combine_lanes(best, is_zero), batch_shape)
