"""Carry a JAX-package key (and decrypt tables) across to bgn_torch on the
CPU, through bgn_torch.convert_from_jax, for the port's parity tests."""
import dataclasses

import numpy as np

from bgn_torch import convert_from_jax as cj


def rns_arrays(jrns) -> dict:
    return {f.name: np.asarray(getattr(jrns, f.name))
            for f in dataclasses.fields(jrns)
            if f.name not in ("k", "h", "L")}


def _pt(p):
    return tuple(np.asarray(a) for a in (p.x, p.y, p.inf))


def port_public_key(pk, device="cpu", with_rns=True):
    """The port's BGNPublicKey built from the JAX key's arrays; with_rns
    False drops the RNS context and its residue tables, as for a key
    whose modulus exceeds the RNS prime pool."""
    d = pk.dev
    c = d.ctx
    ctx = cj.mont_ctx(*(np.asarray(a) for a in (c.p, c.pinv, c.r2, c.one,
                                                 c.pm2_bits, c.pp1d4_bits)),
                      c.p_host, device)
    rns = p_win_rns = q_win_rns = None
    if with_rns:
        rns = cj.rns_ctx(rns_arrays(d.rns), d.rns.k, d.rns.h, d.rns.L,
                         device)
        p_win_rns = tuple(np.asarray(a) for a in d.p_win_rns[:2])
        q_win_rns = tuple(np.asarray(a) for a in d.q_win_rns[:2])
    dev = cj.device_key(
        ctx, rns, _pt(d.P), _pt(d.Q), np.asarray(d.n_bits),
        np.asarray(d.n_naf), np.asarray(d.l_bits), np.asarray(d.pair_qq),
        p_win_rns, q_win_rns, _pt(d.p_win), _pt(d.q_win), device)
    pp = pk.poly_params
    return cj.public_key(
        pk.key_bits, pk.n, pk.l, pk.p, pk.msg_space, pk.deterministic,
        pk.P_host, pk.Q_host, dev,
        poly_params=(pp.poly_base, pp.fp_scale_base, pp.fp_precision),
        n_digits_kind=pk.n_digits_kind)


def port_tables(tables, device="cpu"):
    """The port's DecryptTables built from the JAX tables' arrays."""
    def tab(t):
        return {f: np.asarray(getattr(t, f))
                for f in ("digests", "values", "keys", "salts")}

    return cj.decrypt_tables(
        tab(tables.table_g1), tab(tables.table_gt), _pt(tables.gsk_g1),
        _pt(tables.gamma_inv_g1), np.asarray(tables.gsk_gt),
        np.asarray(tables.gamma_inv_gt), tables.bound, tables.bound_t,
        device)
