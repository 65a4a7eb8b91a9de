"""The four RNS loop kernels of the main path, their wrappers and their
plain PyTorch versions.

Each wrapper dispatches on the device of its tensors: a CPU tensor goes to
the plain version (the same step functions of ops/rns_pairing.py under
Python loops, the counterpart of the JAX package's XLA path); a CUDA
tensor launches the hand-written kernel in `bgn_torch/csrc/` or raises.
Every wrapper counts its kernel launches in a plain integer attribute
`launches`; only a launch adds to it.

Kernels (TPU kernel replaced -> CUDA source):
  miller_loop   bgn_tpu/ops/pallas_rns.py:miller_loop_whole_pallas
                -> csrc/miller_loop.cu
  pow_loop      bgn_tpu/ops/pallas_rns.py:pow_loop_pallas
                -> csrc/pow_loop.cu
  fp2_pow_loop  bgn_tpu/ops/pallas_rns.py:fp2_pow_loop_pallas
                -> csrc/fp2_pow_loop.cu
  dual_ladder   bgn_tpu/ops/pallas_rns.py:dual_ladder_pallas
                -> csrc/dual_ladder.cu

The kernels take the narrow RNS path only (k <= 64 channels per base,
which covers keys to ~700 bits); a wrapper raises ValueError for a CUDA
tensor with k > 64.  They run one warp per lane with the loop state in
registers (each thread holds up to four channels), the RNS constants in
shared memory, and compute the base extensions as exact int32 dot
products; csrc/rns.cuh says what bounds them and why.
They agree with the plain versions bit for bit.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..fieldcore import rns as rn
from ..fieldcore.rns import RNSCtx, RVal
from . import rns_pairing as rp

# A TF32 matmul keeps a 10-bit mantissa and breaks the exact fp32 integer
# arithmetic of the plain versions on the card.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
assert not torch.backends.cuda.matmul.allow_tf32
assert not torch.backends.cudnn.allow_tf32

K_KERNEL_MAX = rn._K_NARROW        # csrc/rns.cuh BGN_KMAX
_KP_COLS = rn._KMAX + 1            # columns of RNSCtx.kp


# ---------------------------------------------------------------------------
# Constant blob for the kernels (layout mirrored by bgn_layout in rns.cuh)
# ---------------------------------------------------------------------------


def _row_stride(k: int) -> int:
    """>= k and == 1 (mod 32): csrc/rns.cuh bgn_row_stride."""
    return 1 if k <= 1 else ((k - 2) // 32 + 1) * 32 + 1


def blob_layout(k: int) -> dict:
    """Word offsets of the constant blob; one 4-byte word per entry."""
    ch, rs = 2 * k, _row_stride(k)
    off, o = {"rs": rs}, 0
    for name, size in (("m", ch), ("recip", ch), ("one", ch),
                       ("kp", ch * _KP_COLS), ("qc_a", k), ("p_mod_b", k),
                       ("ainv_b", k), ("crt_inv_b", k), ("b_mod_a", k),
                       ("w1a", k), ("w2a", k)):
        off[name] = o
        o += size
    off["mat1"] = o
    o += k * rs
    off["mat2"] = o
    o += k * rs
    off["words"] = o
    return off


def const_blob(rns: RNSCtx) -> torch.Tensor:
    """The kernels' constants as one int32 tensor on rns's device (float
    fields bit-cast), cached on the context per device (`kernel_blobs`).

    mat1[j][i] = (A/a_i)*p*A^-1 mod b_j and mat2[i][j] = B/b_j mod a_i
    are the unsplit extension matrices (destination-major rows, padded
    with zeros to the row stride); w1a, w2a are the alpha weights
    round(2^19/m).  All are read back from the split matrices w1, w2."""
    dev = rns.m.device
    if dev in rns.kernel_blobs:
        return rns.kernel_blobs[dev]
    k = rns.k
    off = blob_layout(k)
    blob = np.zeros(off["words"], dtype=np.int32)
    f32 = blob.view(np.float32)

    def host(t):
        return t.detach().cpu().numpy()

    w1, w2 = host(rns.w1).astype(np.int64), host(rns.w2).astype(np.int64)
    mat1 = w1[0:k, :k] * 64 + w1[k:2 * k, :k]          # [dst j, src i]
    mat2 = w2[0:k, :k] * 64 + w2[k:2 * k, :k]          # [dst i, src j]
    for name, vals in (("m", rns.m), ("recip", rns.recip),
                       ("one", rns.one_rns), ("kp", rns.kp),
                       ("qc_a", rns.qc_a), ("p_mod_b", rns.p_mod_b),
                       ("ainv_b", rns.ainv_b), ("crt_inv_b", rns.crt_inv_b),
                       ("b_mod_a", rns.b_mod_a)):
        v = host(vals).reshape(-1)
        f32[off[name]:off[name] + v.size] = v
    blob[off["w1a"]:off["w1a"] + k] = w1[3 * k, k:]
    blob[off["w2a"]:off["w2a"] + k] = w2[3 * k, k:]
    rs = off["rs"]
    for name, mat in (("mat1", mat1), ("mat2", mat2)):
        t = np.zeros((k, rs), dtype=np.int32)
        t[:, :k] = mat
        blob[off[name]:off[name] + k * rs] = t.reshape(-1)
    out = torch.from_numpy(blob).to(dev)
    rns.kernel_blobs[dev] = out
    return out


# ---------------------------------------------------------------------------
# Launch plumbing
# ---------------------------------------------------------------------------


def _ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def _launch(entry: str, *args):
    """Call a C entry of the kernel library on the current stream; raise
    on a nonzero cudaGetLastError()."""
    from .. import _build
    lib = _build.library()
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    err = getattr(lib, entry)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err} "
                           f"({_build.error_string(err)})")


def _check_state(rns: RNSCtx, *arrs):
    """Device, dtype, shape and contiguity checks for kernel inputs."""
    ch = 2 * rns.k
    if rns.k > K_KERNEL_MAX:
        raise ValueError(f"the CUDA kernels take k <= {K_KERNEL_MAX} "
                         f"channels per base, got k = {rns.k}")
    n = arrs[0].shape[-1]
    for a in arrs:
        if a.device != rns.m.device:
            raise ValueError(f"tensor on {a.device}, key on {rns.m.device}")
        if a.dtype != torch.float32 or a.shape != (ch, n):
            raise ValueError(f"expected float32 [{ch}, {n}], got "
                             f"{a.dtype} {tuple(a.shape)}")
        if not a.is_contiguous():
            raise ValueError("residue tensors must be contiguous")
    return n


def _digits_dev(digits, device) -> torch.Tensor:
    return torch.as_tensor(digits).to(device=device,
                                      dtype=torch.int32).contiguous()


def _digits_host(digits) -> list:
    if isinstance(digits, torch.Tensor):
        return [int(v) for v in digits.detach().cpu().tolist()]
    return [int(v) for v in np.asarray(digits).reshape(-1)]


def _is_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return False


# ---------------------------------------------------------------------------
# 1. Miller loop
# ---------------------------------------------------------------------------


def miller_loop_plain(rns: RNSCtx, ax, ay, xb, yb, digits):
    """f_{n,A}(phi(B)) over shared MSB-first digits (plain bits or signed
    NAF, first nonzero digit +1): a doubling step every step, a +-A
    addition step on nonzero digits, the final addition elided, leading
    zeros skipped.  Returns (fr, fi) residues, bound 9."""
    d = _digits_host(digits)
    nsteps = len(d)
    start = next((i for i, v in enumerate(d) if v != 0), 0)
    nay = rp._neg_coord(rns, ay)
    one = rns.one_rns.expand_as(ax)
    X, Y, Z, fr, fi = ax, ay, one, one, torch.zeros_like(ax)
    xb_, yb_ = rp._pt(xb), rp._pt(yb)
    for i in range(start + 1, nsteps):
        X, Y, Z, fr, fi = rp._dbl_step(rns, X, Y, Z, fr, fi, xb_, yb_)
        if i < nsteps - 1 and d[i] != 0:
            yv = ay if d[i] > 0 else nay
            X, Y, Z, fr, fi = rp._add_step(rns, X, Y, Z, fr, fi, rp._pt(ax),
                                           rp._pt(yv), xb_, yb_)
    return fr, fi


def miller_loop(rns: RNSCtx, ax, ay, xb, yb, digits):
    """Wrapper: the whole Miller loop as one kernel on the card.
    ax, ay, xb, yb: [2k, N] residues (bound 3); digits: [nd] shared."""
    if _is_cpu(ax):
        return miller_loop_plain(rns, ax, ay, xb, yb, digits)
    n = _check_state(rns, ax, ay, xb, yb)
    dg = _digits_dev(digits, ax.device)
    fr, fi = torch.empty_like(ax), torch.empty_like(ax)
    if n:
        _launch("bgn_miller_loop", _ptr(const_blob(rns)), rns.k,
                _ptr(ax), _ptr(ay), _ptr(xb), _ptr(yb), _ptr(dg),
                dg.numel(), _ptr(fr), _ptr(fi), n)
        miller_loop.launches += 1
    return fr, fi


miller_loop.launches = 0


# ---------------------------------------------------------------------------
# 2. F_p power
# ---------------------------------------------------------------------------


def pow_loop_plain(rns: RNSCtx, x, bits):
    """x^e in F_p by square-and-multiply over shared MSB-first bits;
    x bound <= 16; result bound 3."""
    acc = rns.one_rns.expand_as(x)
    for b in _digits_host(bits):
        acc = rn.r_mul(rns, RVal(acc, 3), RVal(acc, 3)).v
        if b:
            acc = rn.r_mul(rns, RVal(acc, 3), RVal(x, 16)).v
    return acc


def pow_loop(rns: RNSCtx, x, bits):
    """Wrapper: x^e in F_p as one kernel on the card; x [2k, N]."""
    if _is_cpu(x):
        return pow_loop_plain(rns, x, bits)
    n = _check_state(rns, x)
    bt = _digits_dev(bits, x.device)
    out = torch.empty_like(x)
    if n:
        _launch("bgn_pow_loop", _ptr(const_blob(rns)), rns.k, _ptr(x),
                _ptr(bt), bt.numel(), _ptr(out), n)
        pow_loop.launches += 1
    return out


pow_loop.launches = 0


# ---------------------------------------------------------------------------
# 3. F_p^2 power
# ---------------------------------------------------------------------------


def _conj_im(rns: RNSCtx, xi):
    """Residues of 10p - xi: the imaginary part of conj(x), bound 10."""
    t = rns.kp[:, 10:11] - xi
    return torch.where(t < 0, t + rns.m, t)


def fp2_pow_loop_plain(rns: RNSCtx, xr, xi, digits):
    """(xr + xi*i)^e in F_p^2 over shared MSB-first digits; a negative
    digit multiplies by conj(x) (x unitary).  Result bound (9, 9)."""
    nxi = _conj_im(rns, xi)
    ar = rns.one_rns.expand_as(xr)
    ai = torch.zeros_like(xr)
    for d in _digits_host(digits):
        sq = rp._fp2_sqr(rns, (RVal(ar, 9), RVal(ai, 9)))
        ar, ai = sq[0].v, sq[1].v
        if d != 0:
            mu = rp._fp2_mul(rns, (RVal(ar, 9), RVal(ai, 9)),
                             (RVal(xr, 9), RVal(xi if d > 0 else nxi, 10)))
            ar, ai = mu[0].v, mu[1].v
    return ar, ai


def fp2_pow_loop(rns: RNSCtx, xr, xi, digits):
    """Wrapper: the F_p^2 power as one kernel on the card."""
    if _is_cpu(xr):
        return fp2_pow_loop_plain(rns, xr, xi, digits)
    n = _check_state(rns, xr, xi)
    dg = _digits_dev(digits, xr.device)
    owr, owi = torch.empty_like(xr), torch.empty_like(xr)
    if n:
        _launch("bgn_fp2_pow_loop", _ptr(const_blob(rns)), rns.k, _ptr(xr),
                _ptr(xi), _ptr(dg), dg.numel(), _ptr(owr), _ptr(owi), n)
        fp2_pow_loop.launches += 1
    return owr, owi


fp2_pow_loop.launches = 0


# ---------------------------------------------------------------------------
# 4. Randomized-Encrypt dual window ladder
# ---------------------------------------------------------------------------


def _jac_add_full(rns: RNSCtx, X1, Y1, Z1, X2, Y2, Z2):
    """General Jacobian + Jacobian addition in RNS (both inputs live,
    neither the identity, not +-equal).  Returns bounds (12, 6, 3)."""
    r_sub = rn.r_sub
    x1, y1, z1 = RVal(X1, 27), RVal(Y1, 27), RVal(Z1, 6)
    x2, y2, z2 = RVal(X2, 27), RVal(Y2, 27), RVal(Z2, 6)
    Z1Z1, Z2Z2, T1, T2, Z1Z2 = rn.r_mul_many(
        rns, [(z1, z1), (z2, z2), (y1, z2), (y2, z1), (z1, z2)])
    U1, U2, S1, S2 = rn.r_mul_many(
        rns, [(x1, Z2Z2), (x2, Z1Z1), (T1, Z2Z2), (T2, Z1Z1)])
    H = r_sub(rns, U2, U1)
    Rr = r_sub(rns, S2, S1)
    HH, RR = rn.r_mul_many(rns, [(H, H), (Rr, Rr)])
    HHH, V, Z3 = rn.r_mul_many(rns, [(H, HH), (U1, HH), (Z1Z2, H)])
    X3 = r_sub(rns, r_sub(rns, r_sub(rns, RR, HHH), V), V)
    RVX3, S1HHH = rn.r_mul_many(rns, [(Rr, r_sub(rns, V, X3)), (S1, HHH)])
    Y3 = r_sub(rns, RVX3, S1HHH)
    return X3.v, Y3.v, Z3.v


def dual_ladder_plain(rns: RNSCtx, p_tab, q_tab, Jm: int, digits, m_neg):
    """C = P^(+-m) * Q^r: two radix-R fixed-base window chains (windows
    j < Jm from P's table, the rest from Q's), then the Jacobian combine.

    p_tab, q_tab: (x, y) residue tables, each [J, R, 2k] float32 (row d
    of window j is base^(d*R^j); row 0 is the identity); digits: [Jt, N]
    window digits (m's then r's, least significant first); m_neg: [N]
    {0,1}.  Returns (X, Y, Z) [2k, N]; Z = 0 encodes the identity."""
    Jt, n = digits.shape
    digits = digits.to(torch.int64)
    ch = 2 * rns.k
    one = rns.one_rns.expand(ch, n)
    zero = torch.zeros((ch, n), dtype=torch.float32, device=one.device)
    nolive = torch.zeros((n,), dtype=torch.bool, device=one.device)
    acc = [[zero, zero, one, nolive], [zero, zero, one, nolive]]
    for j in range(Jt):
        tx, ty = p_tab if j < Jm else q_tab
        jj = j if j < Jm else j - Jm
        d = digits[j]
        rx, ry = tx[jj][d].T, ty[jj][d].T           # [2k, N] gathered rows
        live = d != 0
        X, Y, Z, st = acc[0 if j < Jm else 1]
        aX, aY, aZ = rp._add_pt(rns, X, Y, Z, rp._pt(rx), rp._pt(ry))
        init = (live & ~st)[None]
        upd = (live & st)[None]
        acc[0 if j < Jm else 1] = [
            torch.where(init, rx, torch.where(upd, aX, X)),
            torch.where(init, ry, torch.where(upd, aY, Y)),
            torch.where(init, one, torch.where(upd, aZ, Z)),
            st | live]
    (X1, Y1, Z1, st1), (X2, Y2, Z2, st2) = acc
    negY = rns.kp[:, 27:28] - Y1                    # 27p - y, bound 27
    negY = torch.where(negY < 0, negY + rns.m, negY)
    Y1 = torch.where(m_neg.to(torch.bool)[None], negY, Y1)
    X3, Y3, Z3 = _jac_add_full(rns, X1, Y1, Z1, X2, Y2, Z2)
    both, l1, l2 = (st1 & st2)[None], st1[None], st2[None]
    return (torch.where(both, X3, torch.where(l1, X1, X2)),
            torch.where(both, Y3, torch.where(l1, Y1, Y2)),
            torch.where(both, Z3, torch.where(l1, Z1,
                                              torch.where(l2, Z2, zero))))


def dual_ladder(rns: RNSCtx, p_tab, q_tab, Jm: int, digits, m_neg):
    """Wrapper: the fused Encrypt core as one kernel on the card."""
    tx = p_tab[0]
    if _is_cpu(tx):
        return dual_ladder_plain(rns, p_tab, q_tab, Jm, digits, m_neg)
    ch = 2 * rns.k
    if rns.k > K_KERNEL_MAX:
        raise ValueError(f"the CUDA kernels take k <= {K_KERNEL_MAX} "
                         f"channels per base, got k = {rns.k}")
    Jt, n = digits.shape
    R = tx.shape[1]
    for t in (*p_tab, *q_tab):
        if (t.device != rns.m.device or t.dtype != torch.float32
                or t.dim() != 3 or t.shape[1:] != (R, ch)
                or not t.is_contiguous()):
            raise ValueError("window tables must be contiguous float32 "
                             f"[J, {R}, {ch}] on {rns.m.device}")
    if not (0 <= Jm <= p_tab[0].shape[0] and Jt - Jm <= q_tab[0].shape[0]):
        raise ValueError("more windows than the tables hold")
    dg = _digits_dev(digits, tx.device)
    if n and (int(dg.min()) < 0 or int(dg.max()) >= R):
        raise ValueError(f"window digits must lie in [0, {R})")
    mn = _digits_dev(m_neg, tx.device).reshape(-1)
    if mn.numel() != n:
        raise ValueError("m_neg must have one entry per lane")
    X = torch.empty((ch, n), dtype=torch.float32, device=tx.device)
    Y, Z = torch.empty_like(X), torch.empty_like(X)
    if n:
        _launch("bgn_dual_ladder", _ptr(const_blob(rns)), rns.k,
                _ptr(p_tab[0]), _ptr(p_tab[1]), _ptr(q_tab[0]),
                _ptr(q_tab[1]), R, Jm, Jt, _ptr(dg), _ptr(mn),
                _ptr(X), _ptr(Y), _ptr(Z), n)
        dual_ladder.launches += 1
    return X, Y, Z


dual_ladder.launches = 0

WRAPPERS = (miller_loop, pow_loop, fp2_pow_loop, dual_ladder)
