"""The RNS kernels of the port's paths (seven loop kernels, six step
kernels and the exit conversion), their wrappers and their plain PyTorch
versions.

Each wrapper dispatches on the device of its tensors: a CPU tensor goes to
the plain version (the step functions of ops/rns_pairing.py, under Python
loops for a loop kernel: the counterpart of the JAX package's XLA path); a
CUDA tensor launches the hand-written kernel in `bgn_torch/csrc/` or
raises.  Every wrapper counts its kernel launches in a plain integer
attribute `launches`; only a launch adds to it.  Every wrapper runs inside
a span kernels.<name> (utils/profiling.py) that counts those launches; on
the CPU the span holds the plain version.

A loop kernel runs a whole ladder, Miller loop or exponentiation; the
per-step configuration (config.BGNParams(rns_pallas="1")) runs the same
host loops (_miller_chain, _pow_chain, _fp2_chain, _ladder_chain,
_window_chain) with one step-kernel launch per step.  The plain version
of a loop kernel is that loop over the step kernels' plain versions, so
both configurations compute the same residues bit for bit.

Kernels (TPU kernel replaced -> CUDA source):
  miller_loop   bgn_tpu/ops/pallas_rns.py:miller_loop_whole_pallas
                -> csrc/miller_loop.cu
  pow_loop      bgn_tpu/ops/pallas_rns.py:pow_loop_pallas
                -> csrc/pow_loop.cu
  fp2_pow_loop  bgn_tpu/ops/pallas_rns.py:fp2_pow_loop_pallas
                -> csrc/fp2_pow_loop.cu
  dual_ladder   bgn_tpu/ops/pallas_rns.py:dual_ladder_pallas
                -> csrc/dual_ladder.cu
  ladder_loop   bgn_tpu/ops/pallas_rns.py:ladder_loop_pallas
                -> csrc/ladder_loop.cu
  window_ladder_tab
                bgn_tpu/ops/pallas_rns.py:window_ladder_tab_pallas
                -> csrc/window_ladder_tab.cu
  window_ladder bgn_tpu/ops/pallas_rns.py:window_ladder_pallas
                -> csrc/window_ladder.cu
  dbl_step      bgn_tpu/ops/pallas_rns.py:dbl_step_pallas -> csrc/dbl_step.cu
  add_step      bgn_tpu/ops/pallas_rns.py:add_step_pallas -> csrc/add_step.cu
  pt_dbl        bgn_tpu/ops/pallas_rns.py:pt_dbl_pallas -> csrc/pt_dbl.cu
  pt_add        bgn_tpu/ops/pallas_rns.py:pt_add_pallas -> csrc/pt_add.cu
  pow_step      bgn_tpu/ops/pallas_rns.py:pow_step_pallas -> csrc/pow_step.cu
  fp2_pow_step  bgn_tpu/ops/pallas_rns.py:fp2_pow_step_pallas
                -> csrc/fp2_pow_step.cu
  rns_exit      none (the JAX package's from_rns_mont runs as XLA ops)
                -> csrc/rns_exit.cu

Every kernel is built for three slot counts S (channels per thread): S = 4
for k <= 64 channels per base, S = 6 for k <= 96, which covers 1024-bit
keys (k = 90), and S = 12 for k <= 192, which covers 2048-bit keys
(k = 184 to 186); `slots_for` picks S from k, and a wrapper raises
ValueError for a CUDA tensor with k > 192 (scheme._make_rns gives such a
key no RNS context, so no path sends one).  They run one warp per lane
with the loop state in registers (a step kernel loads it from device
memory and stores it back) and the RNS constants in shared memory, in
blocks of G lanes whose warps compute the base extensions together on
the tensor cores, from the u8 planes of the extension matrices
(`tc_planes`).  csrc/rns.cuh and csrc/rns_tc.cuh say what bounds them
and why.  They agree with the plain versions bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from .._build import is_cpu as _is_cpu
from .._build import launch as _launch
from .._build import ptr as _ptr
from ..fieldcore import rns as rn
from ..fieldcore.rns import RNSCtx, RVal
from ..utils import profiling
from . import rns_pairing as rp

# A TF32 matmul keeps a 10-bit mantissa and breaks the exact fp32 integer
# arithmetic of the plain versions on the card.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
assert not torch.backends.cuda.matmul.allow_tf32
assert not torch.backends.cudnn.allow_tf32

SLOTS = (4, 6, 12)                 # csrc/rns.cuh instantiations of Fe<S>
K_KERNEL_MAX = 16 * max(SLOTS)     # 2k channels over 32 threads x S slots
K_SMEM_MAX = 96                    # rns.cuh BGN_KSMEM: matrices in smem
_KP_COLS = rn._KMAX + 1            # columns of RNSCtx.kp


def slots_for(k: int) -> int:
    """The smallest kernel instantiation S that holds 2k channels."""
    for s in SLOTS:
        if k <= 16 * s:
            return s
    raise ValueError(
        f"the CUDA kernels take k <= {K_KERNEL_MAX} channels per base, got "
        f"k = {k}")


# ---------------------------------------------------------------------------
# Constant blob for the kernels (layout mirrored by bgn_layout in rns.cuh)
# ---------------------------------------------------------------------------


def _row_stride(k: int) -> int:
    """csrc/rns.cuh bgn_row_stride: k <= 96, a destination row >= k and
    == 1 (mod 32); above, a source row of 2k destination channels rounded
    up to 32."""
    if k > K_SMEM_MAX:
        return -(-2 * k // 32) * 32
    return 1 if k <= 1 else ((k - 2) // 32 + 1) * 32 + 1


def blob_layout(k: int) -> dict:
    """Word offsets of the constant blob; one 4-byte word per entry.
    "smem": the words the kernels copy to shared memory (all of them up to
    k = 96; above, all but the two matrices, which start 128-byte
    aligned)."""
    ch, rs = 2 * k, _row_stride(k)
    off, o = {"rs": rs}, 0
    for name, size in (("m", ch), ("recip", ch), ("one", ch),
                       ("kp", ch * _KP_COLS), ("qc_a", k), ("p_mod_b", k),
                       ("ainv_b", k), ("crt_inv_b", k), ("b_mod_a", k),
                       ("w1a", k), ("w2a", k)):
        off[name] = o
        o += size
    if k > K_SMEM_MAX:
        off["smem"] = o
        o = -(-o // 32) * 32
    off["mat1"] = o
    o += k * rs
    off["mat2"] = o
    o += k * rs
    off.setdefault("smem", o)
    off["words"] = o
    return off


def _ext_mats(rns: RNSCtx):
    """The unsplit extension matrices as int64 numpy arrays, read back
    from the 6-bit split w1, w2: mat1 [dst j, src i] = (A/a_i)*p*A^-1 mod
    b_j and mat2 [dst i, src j] = B/b_j mod a_i."""
    k = rns.k
    return tuple(w[0:k, :k] * 64 + w[k:2 * k, :k] for w in (
        t.detach().cpu().numpy().astype(np.int64) for t in (rns.w1, rns.w2)))


def const_blob(rns: RNSCtx) -> torch.Tensor:
    """The kernels' constants as one int32 tensor on rns's device (float
    fields bit-cast), cached on the context per device (`kernel_blobs`).

    mat1[j][i] = (A/a_i)*p*A^-1 mod b_j and mat2[i][j] = B/b_j mod a_i
    are the unsplit extension matrices: destination-major rows padded with
    zeros to the row stride up to k = 96; above, source-major rows indexed
    by destination channel (mat1 at columns k..2k-1, mat2 at 0..k-1).
    w1a, w2a are the alpha weights round(2^19/m).  All are read back from
    the split matrices w1, w2."""
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
    mat1, mat2 = _ext_mats(rns)
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
    for name, mat, col in (("mat1", mat1, k), ("mat2", mat2, 0)):
        t = np.zeros((k, rs), dtype=np.int32)
        if k > K_SMEM_MAX:
            t[:, col:col + k] = mat.T
        else:
            t[:, :k] = mat
        blob[off[name]:off[name] + k * rs] = t.reshape(-1)
    out = torch.from_numpy(blob).to(dev)
    rns.kernel_blobs[dev] = out
    return out


def exit_layout(k: int, L: int) -> dict:
    """Word offsets of the exit kernel's blob (`exit_blob`; mirrored by
    csrc/rns_exit.cu bgn_exit_layout): c_out [2k] and crt_inv_a [k] as
    float32 bits, w_alpha [k] (RNSCtx.w_alpha_a), a_rows [d8] and p_limbs
    [L + 1] as int32, then crt: byte d of A/a_i (RNSCtx.crt_rows[d, i])
    at byte i * crt_stride + d of the words from offset crt."""
    d8 = -(-(12 * k) // 8) + 1
    off, o = {"d8": d8}, 0
    for name, size in (("c_out", 2 * k), ("crt_inv_a", k), ("w_alpha", k),
                       ("a_rows", d8), ("p_limbs", L + 1)):
        off[name] = o
        o += size
    off["crt_stride"] = -(-d8 // 4) * 4
    off["crt"] = o
    off["words"] = o + k * off["crt_stride"] // 4
    return off


def exit_blob(rns: RNSCtx) -> torch.Tensor:
    """The exit kernel's constants as one int32 tensor on rns's device,
    cached on the context beside `const_blob`."""
    dev = rns.m.device
    key = ("exit", dev)
    if key in rns.kernel_blobs:
        return rns.kernel_blobs[key]
    k, L = rns.k, rns.L
    off = exit_layout(k, L)

    def host(t):
        return t.detach().cpu().numpy().reshape(-1)

    crt_rows = rns.crt_rows.detach().cpu().numpy()
    assert crt_rows.shape == (off["d8"], k), crt_rows.shape
    blob = np.zeros(off["words"], dtype=np.int32)
    f32 = blob.view(np.float32)
    for name, vals in (("c_out", rns.c_out), ("crt_inv_a", rns.crt_inv_a)):
        v = host(vals)
        f32[off[name]:off[name] + v.size] = v
    for name, vals in (("w_alpha", rns.w_alpha_a), ("a_rows", rns.a_rows),
                       ("p_limbs", rns.p_limbs)):
        v = host(vals).astype(np.int32)
        blob[off[name]:off[name] + v.size] = v
    blob[off["crt"]:].view(np.uint8).reshape(k, off["crt_stride"])[
        :, :off["d8"]] = crt_rows.T
    out = torch.from_numpy(blob).to(dev)
    rns.kernel_blobs[key] = out
    return out


def kernel_consts(rns: RNSCtx) -> None:
    """Build and cache every constant tensor the kernels read
    (`const_blob`, `tc_planes`, `exit_blob`): the key build calls it for a
    key on the card, so that no op uploads them."""
    const_blob(rns)
    tc_planes(rns)
    exit_blob(rns)


def tc_index(k: int):
    """The documented index map of `tc_planes`: for byte b of the planes,
    (mat, plane, row, col) with mat 0 = mat1 (ext A -> B), 1 = mat2, plane
    0 = lo (bits 0-7), 1 = hi (bits 8-11), row = destination channel and
    col = source channel (>= k: padding, zero).  Byte
    ((((mat * mt + t) * kt + s) * 2 + plane) * 32 + lane) * 16 + i holds
    entry (16 t + row_i, 32 s + col_i) of the padded [16 mt, 32 kt]
    matrix, where for thread `lane` of the warp (g = lane // 4,
    q = lane % 4) and byte i of its 16-byte m16n8k32 A fragment:
    row_i = g + 8 ((i // 4) % 2), col_i = 4 q + i % 4 + 16 (i // 8)."""
    mt, kt = -(-k // 16), -(-k // 32)
    mat, t, s, plane, lane, i = np.meshgrid(
        np.arange(2), np.arange(mt), np.arange(kt), np.arange(2),
        np.arange(32), np.arange(16), indexing="ij")
    g, q = lane // 4, lane % 4
    row = 16 * t + g + 8 * ((i // 4) % 2)
    col = 32 * s + 4 * q + i % 4 + 16 * (i // 8)
    return tuple(a.reshape(-1) for a in (mat, plane, row, col))


def tc_planes(rns: RNSCtx) -> torch.Tensor:
    """The two extension matrices mat1 [dst j, src i] and mat2 [dst i,
    src j] (the unsplit matrices of `const_blob`) as u8 planes in the
    m16n8k32 A-fragment order of csrc/rns_tc.cuh (index map: `tc_index`),
    one uint8 tensor on rns's device, cached on the context beside the
    blob.  The kernel copies it to shared memory with 16-byte loads."""
    dev = rns.m.device
    key = ("tc", dev)
    if key in rns.kernel_blobs:
        return rns.kernel_blobs[key]
    k = rns.k
    mt, kt = -(-k // 16), -(-k // 32)
    mats = np.zeros((2, 16 * mt, 32 * kt), dtype=np.int64)
    mats[:, :k, :k] = _ext_mats(rns)
    mat, plane, row, col = tc_index(k)
    v = mats[mat, row, col]
    out = torch.from_numpy(
        np.where(plane == 0, v & 255, v >> 8).astype(np.uint8)).to(dev)
    rns.kernel_blobs[key] = out
    return out


# ---------------------------------------------------------------------------
# Launch plumbing
# ---------------------------------------------------------------------------


def _check_state(rns: RNSCtx, *arrs):
    """Device, dtype, shape and contiguity checks for kernel inputs."""
    ch = 2 * rns.k
    slots_for(rns.k)
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


# ---------------------------------------------------------------------------
# 1. Miller loop
# ---------------------------------------------------------------------------


def _one(rns: RNSCtx, x):
    """The Montgomery one in every lane of x's shape, as its own tensor
    (a step kernel takes contiguous inputs)."""
    return rns.one_rns.expand_as(x).contiguous()


def _miller_chain(rns: RNSCtx, ax, ay, xb, yb, digits, dbl, add):
    """f_{n,A}(phi(B)) over shared MSB-first digits (plain bits or signed
    NAF, first nonzero digit +1): a doubling step every step, a +-A
    addition step on nonzero digits, the final addition elided, leading
    zeros skipped (the host form of the JAX package's `started` scan and
    its tail).  dbl, add: the step functions (plain versions or
    wrappers).  Returns (fr, fi) residues, bound 9."""
    d = _digits_host(digits)
    nsteps = len(d)
    start = next((i for i, v in enumerate(d) if v != 0), 0)
    nay = rp._neg_coord(rns, ay)
    one = _one(rns, ax)
    X, Y, Z, fr, fi = ax, ay, one, one, torch.zeros_like(ax)
    for i in range(start + 1, nsteps):
        X, Y, Z, fr, fi = dbl(rns, X, Y, Z, fr, fi, xb, yb)
        if i < nsteps - 1 and d[i] != 0:
            X, Y, Z, fr, fi = add(rns, X, Y, Z, fr, fi, ax,
                                  ay if d[i] > 0 else nay, xb, yb)
    return fr, fi


def miller_loop_plain(rns: RNSCtx, ax, ay, xb, yb, digits):
    """The Miller loop as _miller_chain over the plain steps."""
    return _miller_chain(rns, ax, ay, xb, yb, digits, dbl_step_plain,
                         add_step_plain)


@profiling.traced("kernels", launches=True)
def miller_loop(rns: RNSCtx, ax, ay, xb, yb, digits):
    """Wrapper: the whole Miller loop as one kernel on the card, blocks of
    lanes (csrc/rns_tc.cuh TcLanes) whose base extensions run on the
    tensor cores (the planes of `tc_planes`).  ax, ay, xb, yb: [2k, N] residues (bound 3);
    digits: [nd] shared."""
    if _is_cpu(ax):
        return miller_loop_plain(rns, ax, ay, xb, yb, digits)
    n = _check_state(rns, ax, ay, xb, yb)
    dg = _digits_dev(digits, ax.device)
    fr, fi = torch.empty_like(ax), torch.empty_like(ax)
    if n:
        _launch("bgn_miller_loop", _ptr(const_blob(rns)),
                _ptr(tc_planes(rns)), rns.k, slots_for(rns.k),
                _ptr(ax), _ptr(ay), _ptr(xb), _ptr(yb), _ptr(dg),
                dg.numel(), _ptr(fr), _ptr(fi), n)
        miller_loop.launches += 1
    return fr, fi


miller_loop.launches = 0


# ---------------------------------------------------------------------------
# 2. F_p power
# ---------------------------------------------------------------------------


def _pow_chain(rns: RNSCtx, x, bits, step):
    """x^e in F_p by square-and-multiply over shared MSB-first bits, one
    step(rns, acc, x, bit) per bit; x bound <= 16; result bound 3."""
    acc = _one(rns, x)
    for b in _digits_host(bits):
        acc = step(rns, acc, x, int(b > 0))
    return acc


def pow_loop_plain(rns: RNSCtx, x, bits):
    """The F_p power as _pow_chain over the plain step."""
    return _pow_chain(rns, x, bits, pow_step_plain)


@profiling.traced("kernels", launches=True)
def pow_loop(rns: RNSCtx, x, bits):
    """Wrapper: x^e in F_p as one kernel on the card; x [2k, N]."""
    if _is_cpu(x):
        return pow_loop_plain(rns, x, bits)
    n = _check_state(rns, x)
    bt = _digits_dev(bits, x.device)
    out = torch.empty_like(x)
    if n:
        _launch("bgn_pow_loop", _ptr(const_blob(rns)), _ptr(tc_planes(rns)),
                rns.k, slots_for(rns.k), _ptr(x), _ptr(bt), bt.numel(),
                _ptr(out), n)
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


def _fp2_chain(rns: RNSCtx, xr, xi, digits, step):
    """(xr + xi*i)^e in F_p^2 over shared MSB-first digits, one
    step(rns, ar, ai, xr, xi, bit) per digit: a square, then a product
    with x on +1, with conj(x) = (xr, 10p - xi) on -1 (x unitary; JAX's
    switch picks nxi there).  Result bound (9, 9)."""
    nxi = _conj_im(rns, xi)
    ar, ai = _one(rns, xr), torch.zeros_like(xr)
    for d in _digits_host(digits):
        ar, ai = step(rns, ar, ai, xr, nxi if d < 0 else xi, int(d != 0))
    return ar, ai


def fp2_pow_loop_plain(rns: RNSCtx, xr, xi, digits):
    """The F_p^2 power as _fp2_chain over the plain step."""
    return _fp2_chain(rns, xr, xi, digits, fp2_pow_step_plain)


@profiling.traced("kernels", launches=True)
def fp2_pow_loop(rns: RNSCtx, xr, xi, digits):
    """Wrapper: the F_p^2 power as one kernel on the card."""
    if _is_cpu(xr):
        return fp2_pow_loop_plain(rns, xr, xi, digits)
    n = _check_state(rns, xr, xi)
    dg = _digits_dev(digits, xr.device)
    owr, owi = torch.empty_like(xr), torch.empty_like(xr)
    if n:
        _launch("bgn_fp2_pow_loop", _ptr(const_blob(rns)),
                _ptr(tc_planes(rns)), rns.k, slots_for(rns.k), _ptr(xr),
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


def _gather_rows(tab, digits):
    """Row d of window j of an (x, y) table, each [J, R, 2k], for per-lane
    digits [Jd, N]: the gathered stream (gx, gy), each [Jd, 2k, N]."""
    tx, ty = tab
    d = torch.as_tensor(digits).to(device=tx.device, dtype=torch.int64)
    j = torch.arange(d.shape[0], device=tx.device)[:, None]
    return tx[j, d].transpose(1, 2), ty[j, d].transpose(1, 2)


def _window_chain(rns: RNSCtx, gx, gy, live, add):
    """LSB-first fixed-base window chain over gathered rows (gx, gy
    [Jd, 2k, N], live [Jd, N] bool): the first live window sets the
    accumulator to its row (Z = 1), a later one adds it (add(rns, X, Y, Z,
    rx, ry), computed for every lane and selected, as the TPU kernels do).
    Returns (X, Y, Z, started); a lane never started keeps X = Y = 0,
    Z = 1."""
    Jd, ch, n = gx.shape
    one = rns.one_rns.expand(ch, n).contiguous()
    X = Y = torch.zeros((ch, n), dtype=torch.float32, device=one.device)
    Z = one
    st = torch.zeros((n,), dtype=torch.bool, device=one.device)
    for j in range(Jd):
        rx, ry, lv = gx[j], gy[j], live[j]
        aX, aY, aZ = add(rns, X, Y, Z, rx, ry)
        init, upd = (lv & ~st)[None], (lv & st)[None]
        X = torch.where(init, rx, torch.where(upd, aX, X))
        Y = torch.where(init, ry, torch.where(upd, aY, Y))
        Z = torch.where(init, one, torch.where(upd, aZ, Z))
        st = st | lv
    return X, Y, Z, st


def _check_tables(rns: RNSCtx, *tabs) -> int:
    """Window tables: contiguous float32 [J, R, 2k] on the key's device;
    returns R."""
    ch = 2 * rns.k
    R = tabs[0].shape[1]
    for t in tabs:
        if (t.device != rns.m.device or t.dtype != torch.float32
                or t.dim() != 3 or t.shape[1:] != (R, ch)
                or not t.is_contiguous()):
            raise ValueError("window tables must be contiguous float32 "
                             f"[J, {R}, {ch}] on {rns.m.device}")
    return R


def _window_digits(digits, R: int, device) -> torch.Tensor:
    dg = _digits_dev(digits, device)
    if dg.numel() and (int(dg.min()) < 0 or int(dg.max()) >= R):
        raise ValueError(f"window digits must lie in [0, {R})")
    return dg


def dual_ladder_plain(rns: RNSCtx, p_tab, q_tab, Jm: int, digits, m_neg):
    """C = P^(+-m) * Q^r: two radix-R fixed-base window chains (windows
    j < Jm from P's table, the rest from Q's), then the Jacobian combine.

    p_tab, q_tab: (x, y) residue tables, each [J, R, 2k] float32 (row d
    of window j is base^(d*R^j); row 0 is the identity); digits: [Jt, N]
    window digits (m's then r's, least significant first); m_neg: [N]
    {0,1}.  Returns (X, Y, Z) [2k, N]; Z = 0 encodes the identity."""
    digits = torch.as_tensor(digits).to(torch.int64)
    X1, Y1, Z1, st1 = _window_chain(rns, *_gather_rows(p_tab, digits[:Jm]),
                                    digits[:Jm] != 0, pt_add_plain)
    X2, Y2, Z2, st2 = _window_chain(rns, *_gather_rows(q_tab, digits[Jm:]),
                                    digits[Jm:] != 0, pt_add_plain)
    negY = rns.kp[:, 27:28] - Y1                    # 27p - y, bound 27
    negY = torch.where(negY < 0, negY + rns.m, negY)
    Y1 = torch.where(m_neg.to(torch.bool)[None], negY, Y1)
    X3, Y3, Z3 = _jac_add_full(rns, X1, Y1, Z1, X2, Y2, Z2)
    both, l1, l2 = (st1 & st2)[None], st1[None], st2[None]
    return (torch.where(both, X3, torch.where(l1, X1, X2)),
            torch.where(both, Y3, torch.where(l1, Y1, Y2)),
            torch.where(both, Z3, torch.where(l1, Z1, torch.where(
                l2, Z2, torch.zeros_like(Z2)))))


@profiling.traced("kernels", launches=True)
def dual_ladder(rns: RNSCtx, p_tab, q_tab, Jm: int, digits, m_neg):
    """Wrapper: the fused Encrypt core as one kernel on the card, blocks
    of lanes whose base extensions run on the tensor cores (as
    miller_loop's), every window's addition computed for every lane and
    selected, as dual_ladder_plain does."""
    tx = p_tab[0]
    if _is_cpu(tx):
        return dual_ladder_plain(rns, p_tab, q_tab, Jm, digits, m_neg)
    S = slots_for(rns.k)
    R = _check_tables(rns, *p_tab, *q_tab)
    Jt, n = digits.shape
    if not (0 <= Jm <= p_tab[0].shape[0] and Jt - Jm <= q_tab[0].shape[0]):
        raise ValueError("more windows than the tables hold")
    dg = _window_digits(digits, R, tx.device)
    mn = _digits_dev(m_neg, tx.device).reshape(-1)
    if mn.numel() != n:
        raise ValueError("m_neg must have one entry per lane")
    X = torch.empty((2 * rns.k, n), dtype=torch.float32, device=tx.device)
    Y, Z = torch.empty_like(X), torch.empty_like(X)
    if n:
        _launch("bgn_dual_ladder", _ptr(const_blob(rns)),
                _ptr(tc_planes(rns)), rns.k, S,
                _ptr(p_tab[0]), _ptr(p_tab[1]), _ptr(q_tab[0]),
                _ptr(q_tab[1]), R, Jm, Jt, _ptr(dg), _ptr(mn),
                _ptr(X), _ptr(Y), _ptr(Z), n)
        dual_ladder.launches += 1
    return X, Y, Z


dual_ladder.launches = 0


# ---------------------------------------------------------------------------
# 5. G1 double-and-add ladder (L1 decrypt: csk = C^q1)
# ---------------------------------------------------------------------------


def _ladder_chain(rns: RNSCtx, X, Y, Z, ax, ay, digits, dbl, add):
    """base^e in G1 from the start state (X, Y, Z) over shared MSB-first
    digits (plain bits or signed NAF), every digit consumed: a doubling
    dbl(rns, X, Y, Z) per digit, then add(rns, X, Y, Z, ax, ay) with A on
    +1, with -A on -1.  ax, ay: the affine base, bound 3.  Returns
    (X, Y, Z), bounds (27, 27, 6); a final V == -A gives Z = 0, the
    identity."""
    nay = rp._neg_coord(rns, ay)
    for d in _digits_host(digits):
        X, Y, Z = dbl(rns, X, Y, Z)
        if d != 0:
            X, Y, Z = add(rns, X, Y, Z, ax, ay if d > 0 else nay)
    return X, Y, Z


def ladder_loop_plain(rns: RNSCtx, X, Y, Z, ax, ay, digits):
    """The G1 ladder as _ladder_chain over the plain steps."""
    return _ladder_chain(rns, X, Y, Z, ax, ay, digits, pt_dbl_plain,
                         pt_add_plain)


@profiling.traced("kernels", launches=True)
def ladder_loop(rns: RNSCtx, X, Y, Z, ax, ay, digits):
    """Wrapper: the whole ladder as one kernel on the card, blocks of
    lanes (csrc/rns_tc.cuh TcLanes) whose base extensions run on the
    tensor cores (the planes of `tc_planes`), as miller_loop's.  X, Y, Z,
    ax, ay: [2k, N] residues; digits: [nd] shared."""
    if _is_cpu(X):
        return ladder_loop_plain(rns, X, Y, Z, ax, ay, digits)
    n = _check_state(rns, X, Y, Z, ax, ay)
    dg = _digits_dev(digits, X.device)
    ox, oy, oz = (torch.empty_like(X) for _ in range(3))
    if n:
        _launch("bgn_ladder_loop", _ptr(const_blob(rns)),
                _ptr(tc_planes(rns)), rns.k, slots_for(rns.k), _ptr(X),
                _ptr(Y), _ptr(Z), _ptr(ax), _ptr(ay), _ptr(dg), dg.numel(),
                _ptr(ox), _ptr(oy), _ptr(oz), n)
        ladder_loop.launches += 1
    return ox, oy, oz


ladder_loop.launches = 0


# ---------------------------------------------------------------------------
# 6. Fixed-base window chain from the table (EncryptDeterministic)
# ---------------------------------------------------------------------------


def window_ladder_plain(rns: RNSCtx, gx, gy, ginf):
    """The window chain over a gathered stream (the gathered-row branch of
    the JAX package's fixed_base_mul_rns): gx, gy [Jd, 2k, N] rows (bound
    3), ginf [Jd, N] nonzero where the row is the identity.  Returns
    (X, Y, Z); a lane with no live window gets X = Y = Z = 0."""
    X, Y, Z, st = _window_chain(rns, gx, gy, torch.as_tensor(ginf) == 0,
                                pt_add_plain)
    return X, Y, torch.where(st[None], Z, torch.zeros_like(Z))


def window_ladder_tab_plain(rns: RNSCtx, tab, digits):
    """base^e for per-lane radix-R digits [Jd, N] (least significant
    first) from the (x, y) table [J, R, 2k] of base: rows gathered, then
    window_ladder_plain (row 0 of every window is the identity)."""
    digits = torch.as_tensor(digits).to(torch.int64)
    return window_ladder_plain(rns, *_gather_rows(tab, digits), digits == 0)


@profiling.traced("kernels", launches=True)
def window_ladder_tab(rns: RNSCtx, tab, digits):
    """Wrapper: the chain with in-kernel row reads, one kernel on the
    card, blocks of lanes whose base extensions run on the tensor cores
    (as dual_ladder's), every window's addition computed for every lane
    and selected, as window_ladder_tab_plain does.  tab: (x, y)
    [J, R, 2k]; digits: [Jd, N], Jd <= J.  `launches_by_n` and
    `launches_by_jd` split the launches by N and by Jd."""
    tx = tab[0]
    if _is_cpu(tx):
        return window_ladder_tab_plain(rns, tab, digits)
    S = slots_for(rns.k)
    R = _check_tables(rns, *tab)
    Jd, n = digits.shape
    if Jd > tx.shape[0]:
        raise ValueError(f"{Jd} windows, the table holds {tx.shape[0]}")
    dg = _window_digits(digits, R, tx.device)
    X = torch.empty((2 * rns.k, n), dtype=torch.float32, device=tx.device)
    Y, Z = torch.empty_like(X), torch.empty_like(X)
    if n:
        _launch("bgn_window_ladder_tab", _ptr(const_blob(rns)),
                _ptr(tc_planes(rns)), rns.k, S, _ptr(tab[0]), _ptr(tab[1]),
                R, Jd, _ptr(dg), _ptr(X), _ptr(Y), _ptr(Z), n)
        window_ladder_tab.launches += 1
        for by, key in ((window_ladder_tab.launches_by_n, n),
                        (window_ladder_tab.launches_by_jd, Jd)):
            by[key] = by.get(key, 0) + 1
    return X, Y, Z


window_ladder_tab.launches = 0
window_ladder_tab.launches_by_n = {}
window_ladder_tab.launches_by_jd = {}


# ---------------------------------------------------------------------------
# 7. Fixed-base window chain over pre-gathered rows
# ---------------------------------------------------------------------------


@profiling.traced("kernels", launches=True)
def window_ladder(rns: RNSCtx, gx, gy, ginf):
    """Wrapper: the chain over a gathered stream, one kernel on the card,
    blocks of lanes whose base extensions run on the tensor cores (as
    window_ladder_tab's), every window's addition computed for every lane
    and selected, as window_ladder_plain does, but a window dead in every
    lane of a block skipped by the block.  gx, gy: contiguous float32
    [Jd, 2k, N]; ginf: [Jd, N]."""
    if _is_cpu(gx):
        return window_ladder_plain(rns, gx, gy, ginf)
    S = slots_for(rns.k)
    Jd, ch, n = gx.shape
    for g in (gx, gy):
        if (g.device != rns.m.device or g.dtype != torch.float32
                or g.shape != (Jd, 2 * rns.k, n) or not g.is_contiguous()):
            raise ValueError("gathered rows must be contiguous float32 "
                             f"[{Jd}, {2 * rns.k}, {n}] on {rns.m.device}")
    gi = _digits_dev(torch.as_tensor(ginf) != 0, gx.device)
    if gi.shape != (Jd, n):
        raise ValueError(f"ginf must be [{Jd}, {n}]")
    X = torch.empty((ch, n), dtype=torch.float32, device=gx.device)
    Y, Z = torch.empty_like(X), torch.empty_like(X)
    if n:
        _launch("bgn_window_ladder", _ptr(const_blob(rns)),
                _ptr(tc_planes(rns)), rns.k, S, _ptr(gx), _ptr(gy),
                _ptr(gi), Jd, _ptr(X), _ptr(Y), _ptr(Z), n)
        window_ladder.launches += 1
    return X, Y, Z


window_ladder.launches = 0


# ---------------------------------------------------------------------------
# 8-13. Step kernels (the per-step configuration, rns_pallas="1"): one
# launch per step of the host loops above.  The step is a plain int
# argument (the host loops run over host digits, so no step syncs), and
# every output is a fresh tensor, as the TPU kernels' are.
# ---------------------------------------------------------------------------


def _step_launch(wrapper, entry: str, rns: RNSCtx, ins, n_out: int,
                 *scalars):
    """Launch a step kernel: (blob, planes, k, S, inputs, scalars,
    outputs, n), every one a tensor-core kernel.  A wrapper with a
    `launches_by_n` dict also counts its launches per N there."""
    n = _check_state(rns, *ins)
    outs = tuple(torch.empty_like(ins[0]) for _ in range(n_out))
    if n:
        _launch(entry, _ptr(const_blob(rns)), _ptr(tc_planes(rns)), rns.k,
                slots_for(rns.k), *(_ptr(t) for t in ins), *scalars,
                *(_ptr(t) for t in outs), n)
        wrapper.launches += 1
        by_n = getattr(wrapper, "launches_by_n", None)
        if by_n is not None:
            by_n[n] = by_n.get(n, 0) + 1
    return outs


def dbl_step_plain(rns: RNSCtx, X, Y, Z, fr, fi, xb, yb):
    """One Miller doubling step (rns_pairing._dbl_step) on raw residues;
    xb, yb bound 3.  Returns (X, Y, Z, fr, fi), bounds (27, 27, 6, 9, 9)."""
    return rp._dbl_step(rns, X, Y, Z, fr, fi, rp._pt(xb), rp._pt(yb))


@profiling.traced("kernels", launches=True)
def dbl_step(rns: RNSCtx, X, Y, Z, fr, fi, xb, yb):
    """Wrapper: one Miller doubling step as one kernel on the card, blocks
    of lanes whose base extensions run on the tensor cores (as
    miller_loop's); every argument [2k, N]."""
    if _is_cpu(X):
        return dbl_step_plain(rns, X, Y, Z, fr, fi, xb, yb)
    return _step_launch(dbl_step, "bgn_dbl_step", rns,
                        (X, Y, Z, fr, fi, xb, yb), 5)


dbl_step.launches = 0


def add_step_plain(rns: RNSCtx, X, Y, Z, fr, fi, ax, ay, xb, yb):
    """One Miller addition step V + A (rns_pairing._add_step) on raw
    residues; ax, ay, xb, yb bound 3.  Returns (X, Y, Z, fr, fi)."""
    return rp._add_step(rns, X, Y, Z, fr, fi, rp._pt(ax), rp._pt(ay),
                        rp._pt(xb), rp._pt(yb))


@profiling.traced("kernels", launches=True)
def add_step(rns: RNSCtx, X, Y, Z, fr, fi, ax, ay, xb, yb):
    """Wrapper: one Miller addition step as one kernel on the card, blocks
    of lanes whose base extensions run on the tensor cores (as
    dbl_step's); every argument [2k, N].  `launches_by_n` splits the
    launches by N."""
    if _is_cpu(X):
        return add_step_plain(rns, X, Y, Z, fr, fi, ax, ay, xb, yb)
    return _step_launch(add_step, "bgn_add_step", rns,
                        (X, Y, Z, fr, fi, ax, ay, xb, yb), 5)


add_step.launches = 0
add_step.launches_by_n = {}


def pt_dbl_plain(rns: RNSCtx, X, Y, Z):
    """One Jacobian doubling (rns_pairing._dbl_pt); bounds (27, 27, 6)."""
    return rp._dbl_pt(rns, X, Y, Z)


@profiling.traced("kernels", launches=True)
def pt_dbl(rns: RNSCtx, X, Y, Z):
    """Wrapper: one Jacobian doubling as one kernel on the card, blocks of
    lanes whose base extensions run on the tensor cores (as dbl_step's);
    every argument [2k, N].  `launches_by_n` splits the launches by N."""
    if _is_cpu(X):
        return pt_dbl_plain(rns, X, Y, Z)
    return _step_launch(pt_dbl, "bgn_pt_dbl", rns, (X, Y, Z), 3)


pt_dbl.launches = 0
pt_dbl.launches_by_n = {}


def pt_add_plain(rns: RNSCtx, X, Y, Z, ax, ay):
    """One incomplete mixed addition V + A (rns_pairing._add_pt); ax, ay
    bound 3."""
    return rp._add_pt(rns, X, Y, Z, rp._pt(ax), rp._pt(ay))


@profiling.traced("kernels", launches=True)
def pt_add(rns: RNSCtx, X, Y, Z, ax, ay):
    """Wrapper: one mixed addition as one kernel on the card, blocks of
    lanes whose base extensions run on the tensor cores (as dbl_step's),
    added for every lane; every argument [2k, N].  `launches_by_n` splits
    the launches by N."""
    if _is_cpu(X):
        return pt_add_plain(rns, X, Y, Z, ax, ay)
    return _step_launch(pt_add, "bgn_pt_add", rns, (X, Y, Z, ax, ay), 3)


pt_add.launches = 0
pt_add.launches_by_n = {}


def pow_step_plain(rns: RNSCtx, acc, x, bit: int):
    """acc^2 * x^bit in F_p (acc bound 3, x bound <= 16): the two r_muls
    of the square-and-multiply body; result bound 3."""
    sq = rn.r_mul(rns, RVal(acc, 3), RVal(acc, 3))
    return rn.r_mul(rns, sq, RVal(x, 16)).v if bit > 0 else sq.v


@profiling.traced("kernels", launches=True)
def pow_step(rns: RNSCtx, acc, x, bit: int):
    """Wrapper: one F_p square-and-multiply step as one kernel on the
    card, blocks of lanes whose base extensions run on the tensor cores
    (as pow_loop's); acc, x [2k, N], bit a host int.  `launches_by_n`
    splits the launches by N."""
    if _is_cpu(acc):
        return pow_step_plain(rns, acc, x, bit)
    return _step_launch(pow_step, "bgn_pow_step", rns, (acc, x), 1,
                        int(bit))[0]


pow_step.launches = 0
pow_step.launches_by_n = {}


def fp2_pow_step_plain(rns: RNSCtx, ar, ai, xr, xi, bit: int):
    """(ar + ai i)^2 * (xr + xi i)^bit in F_p^2: rns_pairing._fp2_sqr,
    then _fp2_mul on a 1 bit.  Bounds: acc (9, 9), xr 9, xi 10; result
    (9, 9)."""
    sq = rp._fp2_sqr(rns, (RVal(ar, 9), RVal(ai, 9)))
    if bit > 0:
        sq = rp._fp2_mul(rns, sq, (RVal(xr, 9), RVal(xi, 10)))
    return sq[0].v, sq[1].v


@profiling.traced("kernels", launches=True)
def fp2_pow_step(rns: RNSCtx, ar, ai, xr, xi, bit: int):
    """Wrapper: one F_p^2 square-and-multiply step as one kernel on the
    card, blocks of lanes whose base extensions run on the tensor cores
    (as fp2_pow_loop's); ar, ai, xr, xi [2k, N], bit a host int.
    `launches_by_n` splits the launches by N."""
    if _is_cpu(ar):
        return fp2_pow_step_plain(rns, ar, ai, xr, xi, bit)
    return _step_launch(fp2_pow_step, "bgn_fp2_pow_step", rns,
                        (ar, ai, xr, xi), 2, int(bit))


fp2_pow_step.launches = 0
fp2_pow_step.launches_by_n = {}


# ---------------------------------------------------------------------------
# 14. The exit conversion: RNS Montgomery residues -> canonical limbs
# ---------------------------------------------------------------------------


def rns_exit_plain(rns: RNSCtx, x0, x1=None):
    """The torch ops of fieldcore/rns.py's exit on each half: r_mul by
    c_out, then rns_to_limbs' exact CRT.  x0, x1: residues [2k, N] (value
    below h*p); returns int64 [halves, L, N], canonical limbs < p."""
    c_out = RVal(rns.c_out.expand_as(x0), 1)
    return torch.stack([rn.rns_to_limbs(rns, rn.r_mul(rns, RVal(x, 1), c_out))
                        for x in ((x0,) if x1 is None else (x0, x1))])


@profiling.traced("kernels", launches=True)
def rns_exit(rns: RNSCtx, x0, x1=None):
    """Wrapper: fieldcore/rns.py from_rns_mont's exit of one or two halves
    (x1: an F_p^2 element's imaginary part) as one kernel launch on the
    card, blocks of lanes whose product runs its base extensions on the
    tensor cores (as pow_loop's), the CRT per warp (csrc/rns_exit.cu).
    x0, x1: contiguous float32 [2k, N]; returns int64 [halves, L, N]."""
    if _is_cpu(x0):
        return rns_exit_plain(rns, x0, x1)
    xs = (x0,) if x1 is None else (x0, x1)
    n = _check_state(rns, *xs)
    out = torch.empty((len(xs), rns.L, n), dtype=torch.int64,
                      device=x0.device)
    if n:
        _launch("bgn_rns_exit", _ptr(const_blob(rns)), _ptr(tc_planes(rns)),
                rns.k, slots_for(rns.k), _ptr(exit_blob(rns)), rns.L,
                _ptr(xs[0]), _ptr(xs[-1]), _ptr(out), n, len(xs))
        rns_exit.launches += 1
    return out


rns_exit.launches = 0

WRAPPERS = (miller_loop, pow_loop, fp2_pow_loop, dual_ladder, ladder_loop,
            window_ladder_tab, window_ladder, dbl_step, add_step, pt_dbl,
            pt_add, pow_step, fp2_pow_step, rns_exit)
