"""Carry a key built by the JAX package across to the port.

Each function takes the JAX package's key material as numpy arrays (the
caller extracts them with `np.asarray`) plus host ints, and builds the
port's objects on `device`.  Nothing here imports JAX: the arrays are
plain numpy (bf16 arrays are read through `astype(float32)`).

Layout changes: limbs become int64 (the MontCtx's pinv a host int); the
window residues go from the JAX [2k, J, R] layout to the port's
[J, R, 2k]; the bf16 extension matrices w1, w2 become float32 (their
values are bf16-exact).  The limb window tables of P and Q (the JAX key's
p_win and q_win) become the port's p_tab and q_tab.
"""

from __future__ import annotations

import numpy as np
import torch

from . import encoding
from .fieldcore.montgomery import MontCtx
from .fieldcore.rns import _BUFFERS, RNSCtx
from .ops.bsgs import DecryptTables, GroupTable
from .ops.curve import AffinePoint
from .scheme import BGNPublicKey, PolyEncodingParams, PublicDeviceKey


def _ints(a) -> np.ndarray:
    return np.asarray(a).astype(np.int64)


def mont_ctx(p_limbs, pinv, r2, one, pm2_bits, pp1d4_bits, p_host: int,
             device="cuda") -> MontCtx:
    """MontCtx from the JAX MontCtx's fields (pinv a uint32 scalar)."""
    return MontCtx(_ints(p_limbs), int(np.asarray(pinv)), _ints(r2),
                   _ints(one), _ints(pm2_bits), _ints(pp1d4_bits),
                   int(p_host)).to(device)


def rns_ctx(arrays: dict, k: int, h: int, L: int, device="cuda") -> RNSCtx:
    """RNSCtx from every array field of the JAX RNSCtx (by name)."""
    fields = {}
    for name in _BUFFERS:
        a = np.asarray(arrays[name])
        # float32, or bfloat16 (a numpy extension dtype of kind "V")
        fields[name] = a.astype(np.float32) if a.dtype.kind in "fV" \
            else _ints(a)
    return RNSCtx(int(k), int(h), int(L), **fields).to(device)


def affine_point(x, y, inf, device="cuda") -> AffinePoint:
    return AffinePoint(*(torch.as_tensor(_ints(a), device=device)
                         for a in (x, y, inf)))


def device_key(ctx: MontCtx, rns: RNSCtx | None, P, Q, n_bits, n_naf,
               l_bits, pair_qq, p_win_rns, q_win_rns, p_win, q_win,
               device="cuda") -> PublicDeviceKey:
    """PublicDeviceKey from the JAX key: P, Q and the limb window tables
    p_win, q_win ([L, J, R]) as (x, y, inf) arrays; n_bits, n_naf and
    l_bits as digit vectors; pair_qq as [2, L] limbs; p_win_rns,
    q_win_rns as (rx, ry) residues [2k, J, R].  A JAX key whose rns is
    None (a modulus beyond the RNS prime pool) has no residue tables:
    pass rns, p_win_rns and q_win_rns as None, and every op of the port's
    key takes its limb branch."""
    def win(t):
        if t is None:
            return None
        return tuple(np.ascontiguousarray(
            np.moveaxis(np.asarray(a, dtype=np.float32), 0, -1)) for a in t[:2])

    return PublicDeviceKey(
        ctx=ctx, rns=rns,
        P=affine_point(*P, device=device), Q=affine_point(*Q, device=device),
        n_bits=_ints(n_bits), n_naf=_ints(n_naf), l_bits=_ints(l_bits),
        pair_qq=_ints(pair_qq), p_win=win(p_win_rns), q_win=win(q_win_rns),
        p_tab=affine_point(*p_win, device=device),
        q_tab=affine_point(*q_win, device=device)).to(device)


def public_key(key_bits: int, n: int, l: int, p: int, msg_space: int,
               deterministic: bool, P_host, Q_host,
               dev: PublicDeviceKey, poly_params=None,
               n_digits_kind: str | None = None) -> BGNPublicKey:
    """BGNPublicKey from the JAX key's host fields and the device key;
    poly_params as (poly_base, fp_scale_base, fp_precision), from which
    the encoding tables are rebuilt as keygen builds them, and the Miller
    digit encoding n_digits_kind, so that the key encodes and serializes
    as the JAX key does."""
    pk = BGNPublicKey(key_bits=key_bits, n=n, l=l, p=p, msg_space=msg_space,
                      deterministic=deterministic, P_host=tuple(P_host),
                      Q_host=tuple(Q_host), dev=dev,
                      poly_params=None if poly_params is None
                      else PolyEncodingParams(*poly_params),
                      n_digits_kind=n_digits_kind)
    if poly_params is not None:
        encoding.compute_encoding_table(pk)
    return pk


def group_table(digests, values, keys, salts) -> GroupTable:
    return GroupTable(digests=_ints(digests), values=_ints(values),
                      keys=_ints(keys), salts=_ints(salts))


def decrypt_tables(table_g1: dict, table_gt: dict, gsk_g1, gamma_inv_g1,
                   gsk_gt, gamma_inv_gt, bound: int, bound_t: int,
                   device="cuda") -> DecryptTables:
    """DecryptTables from the JAX tables: each table as a dict of its
    digests, values, keys and salts; points as (x, y, inf) arrays; GT
    elements as [2, L] limb arrays."""
    return DecryptTables(
        table_g1=group_table(**table_g1), table_gt=group_table(**table_gt),
        gsk_g1=affine_point(*gsk_g1, device=device),
        gamma_inv_g1=affine_point(*gamma_inv_g1, device=device),
        gsk_gt=torch.as_tensor(_ints(gsk_gt)),
        gamma_inv_gt=torch.as_tensor(_ints(gamma_inv_gt)),
        bound=int(bound), bound_t=int(bound_t)).to(device)
