#!/usr/bin/env python3
"""Drive the bgn_torch port on one NVIDIA H100 (or another CUDA card).

    python3 chip_smoke.py [--batch 8192] [--decrypt-batch 2048] [--seed 1]

Phases, each of which raises on failure (the script then exits nonzero):
  1. the card (nvidia-smi name and power limit), torch/CUDA versions, and
     the build of every kernel in bgn_torch/csrc with nvcc's -Xptxas -v
     report (registers, shared memory, spills);
  2. keys: 512-bit key, message space 1021, seeded, on the card, plus the
     decryption tables;
  3. kernels: each of the four CUDA kernels at the shapes the main path
     gives it, against its plain PyTorch version on the same inputs
     (torch.equal: the kernels are exact integer arithmetic), with the
     kernel's and the plain version's times (CUDA events);
  4. the main path end to end: Encrypt (batch of m < 340 and k in
     {1, 2, 3}) -> Mult -> DecryptL2 (decrypt-batch lanes at a time, every
     lane of the batch), every decrypted value checked against m*k and a
     few lanes against the host oracle (hostmath); each kernel's launch
     count must rise during this phase;
  5. one call of each op under torch.profiler: device busy time, idle
     share and the costliest device kernels.
The line before the last is one JSON object {"kernels": [...]} (times,
launches, bounds); the last line is {"ok": true, "device": {...}}.
There is no CPU path: without a CUDA device the script exits nonzero
before printing any result.
"""

from __future__ import annotations

import argparse
import json
import random
import subprocess
import sys
import time
from pathlib import Path

# Published peaks of one H100 SXM (NVIDIA data sheet; dense, at 700 W).
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
PEAK_BF16_S = 989e12

# Elementwise fp32 operations per lane, counted from the plain code
# (bgn_torch/fieldcore/rns.py): a _red is 7 ops (mul, floor, mul, sub,
# compare, sub, select); an r_mul is 96 ops per base channel (k of them):
# products + reductions 16k, qhat 8k, two 6-bit splits 8k, two extension
# combines 44k, the base-B sum 9k + 3k, rhat 8k; an r_add is 4 ops per
# channel (2k channels), an r_sub 8.  The base extensions are two
# [3k+1, 2k] x [2k] products per r_mul (2 FLOPs per MAC), which a tensor
# core would run at the bf16 peak.
STEP_COUNTS = {            # (r_mul, r_add, r_sub) per step, from the code
    "r_mul": (1, 0, 0),
    "dbl_step": (21, 14, 9),
    "add_step": (17, 3, 11),
    "add_pt": (11, 0, 7),
    "jac_add_full": (16, 0, 7),
    "fp2_sqr": (2, 2, 1),
    "fp2_mul": (3, 2, 3),
}

REPLACES = {
    "miller_loop": "bgn_tpu/ops/pallas_rns.py:314",
    "pow_loop": "bgn_tpu/ops/pallas_rns.py:394",
    "fp2_pow_loop": "bgn_tpu/ops/pallas_rns.py:439",
    "dual_ladder": "bgn_tpu/ops/pallas_rns.py:675",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def ops_of(k: int, counts: dict) -> tuple:
    """(elementwise fp32 ops, extension-matmul FLOPs) of one lane."""
    n_mul = n_add = n_sub = 0
    for step, times in counts.items():
        m, a, s = STEP_COUNTS[step]
        n_mul += m * times
        n_add += a * times
        n_sub += s * times
    elem = n_mul * 96 * k + (n_add * 4 + n_sub * 8) * 2 * k
    mm = n_mul * 2 * 2 * (3 * k + 1) * (2 * k)
    return elem, mm


def bound(elem_total: float, mm_total: float, nbytes: float) -> tuple:
    t = {"bytes": nbytes / PEAK_BYTES_S,
         "operations": max(elem_total / PEAK_FP32_S, mm_total / PEAK_BF16_S)}
    by = max(t, key=t.get)
    return t[by] * 1e3, by


def cuda_ms(fn, torch, min_total_ms: float = 1500.0, max_reps: int = 50):
    """Mean ms of fn() over repeated launches (CUDA events, warmed up)."""
    fn()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    fn()
    e1.record()
    torch.cuda.synchronize()
    one = e0.elapsed_time(e1)
    reps = max(1, min(max_reps, int(min_total_ms / max(one, 1e-3))))
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def profile_op(torch, label: str, fn, card: str, top: int = 6) -> None:
    """One call of fn under torch.profiler: wall time, summed device time
    of its kernels, the device's idle share, and the costliest kernels.
    The profiler's own host overhead lengthens the wall time, so the idle
    share is an upper estimate."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.time()
        fn()
        torch.cuda.synchronize()
        wall = (time.time() - t) * 1e3
    evs = [e for e in prof.key_averages()
           if getattr(e, "self_device_time_total", 0) > 0]
    busy = sum(e.self_device_time_total for e in evs) / 1e3
    log(f"trace {label}: wall {wall:.1f} ms, device busy {busy:.1f} ms, "
        f"idle share {1 - busy / wall:.3f}, {sum(e.count for e in evs)} "
        f"device ops [{card}]")
    for e in sorted(evs, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"  {e.self_device_time_total / 1e3:9.2f} ms  x{e.count:<6d} "
            f"{e.key[:70]}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--decrypt-batch", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: no CUDA device; the port's smoke run "
                 "needs the card")
    repo = Path(__file__).resolve().parent
    sys.path.insert(0, str(repo))
    import numpy as np

    from bgn_torch import _build, hostmath as hm, scheme
    from bgn_torch.fieldcore import rns as rn
    from bgn_torch.ops import cuda_rns, rns_pairing as rp
    from bgn_torch.utils import convert

    dev = torch.device("cuda")
    # -- 1. the card and the build ------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    t0 = time.time()
    _build.build(force=True)
    _build.library()
    log(f"build: {time.time() - t0:.1f} s (nvcc, {len(list(_build.CSRC.glob('*.cu')))} "
        "sources in parallel)")
    for line in _build.BUILD_INFO["ptxas"].splitlines():
        if line.startswith("==") or "Used" in line or "spill" in line \
                or "Compiling entry" in line:
            log("  " + line.strip())

    # -- 2. keys --------------------------------------------------------
    t0 = time.time()
    rng = random.Random(args.seed)
    pk, sk = scheme.keygen(512, 1021, rng=rng, device="cuda")
    tables = pk.setup_decryption(sk, rng=rng)
    ctx, rns, dk = pk.dev.ctx, pk.dev.rns, pk.dev
    k, L = rns.k, ctx.L
    log(f"keys: 512-bit, msg space 1021, k = {k} channels per base, "
        f"L = {L} limbs, {time.time() - t0:.1f} s")
    log(f"kernel constants: {cuda_rns.blob_layout(k)['words'] * 4} B of "
        "dynamic shared memory per block")

    # -- 3. kernels against their plain versions -------------------------
    B, Bd = args.batch, args.decrypt_batch
    krng = random.Random(args.seed + 1)
    ms = [krng.randrange(340) for _ in range(B)]
    rs = [krng.randrange(pk.n) for _ in range(B)]
    m_digits, m_neg = scheme._signed_digits(ms, pk.n)
    r_digits, _ = scheme._signed_digits(rs, pk.n)
    Jm = m_digits.shape[0]
    dig_np = np.concatenate([m_digits, r_digits], axis=0)
    dig = torch.as_tensor(dig_np, device=dev)
    mneg = torch.as_tensor(m_neg, device=dev)
    n_naf = dk.n_naf.cpu().numpy()
    pm2 = ctx.pm2_bits.cpu().numpy()
    l_bits = dk.l_bits.cpu().numpy()
    q1_naf = np.asarray(sk.q1_naf)
    results = {}

    def check(name, shape, kern, plain, elem_mm, nbytes, extra=None):
        got, want = kern(), plain()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        torch.cuda.synchronize()
        equal = all(torch.equal(g, w) for g, w in zip(got, want))
        err = max(float((g - w).abs().max()) if g.numel() else 0.0
                  for g, w in zip(got, want))
        if not equal:
            raise AssertionError(f"{name} {shape}: kernel != plain "
                                 f"(max abs err {err})")
        ms_k = cuda_ms(kern, torch)
        ms_p = cuda_ms(plain, torch, min_total_ms=0.0, max_reps=1)
        b_ms, b_by = bound(*elem_mm, nbytes)
        rec = {"shape": shape, "ms": ms_k, "plain_ms": ms_p,
               "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by}
        log(f"kernel {name} {shape}: equal to plain; {ms_k:.3f} ms "
            f"(plain {ms_p:.1f} ms, bound {b_ms:.3f} ms by {b_by}) "
            f"[{card}]")
        results.setdefault(name, []).append(rec)
        return got

    f32 = 4
    ch = 2 * k
    state = ch * f32          # bytes of one residue element

    # dual ladder (Encrypt core) at B lanes
    live = dig_np != 0
    adds, combines = 0, 0
    for rows in (live[:Jm], live[Jm:]):
        adds += int(np.maximum(rows.sum(axis=0) - 1, 0).sum())
    combines = int((live[:Jm].any(axis=0) & live[Jm:].any(axis=0)).sum())
    e1, m1 = ops_of(k, {"add_pt": 1})
    e2, m2 = ops_of(k, {"jac_add_full": 1})
    tab_bytes = sum(t.numel() * f32 for t in (*dk.p_win, *dk.q_win))
    X, Y, Z = check(
        "dual_ladder", f"B={B}, Jm={Jm}, Jt={dig_np.shape[0]}",
        lambda: cuda_rns.dual_ladder(rns, dk.p_win, dk.q_win, Jm, dig, mneg),
        lambda: cuda_rns.dual_ladder_plain(rns, dk.p_win, dk.q_win, Jm, dig,
                                           mneg),
        (adds * e1 + combines * e2, adds * m1 + combines * m2),
        tab_bytes + dig_np.size * 8 + B * 8 + 3 * B * state)

    # ciphertext points -> Miller inputs (normalize runs pow_loop at N = 1)
    pt = rp.normalize_rns(ctx, rns, X, Y, Z)
    ax = rn.to_rns_mont(rns, pt.x).v
    ay = rn.to_rns_mont(rns, pt.y).v
    xb, yb = ax.roll(1, dims=1).contiguous(), ay.roll(1, dims=1).contiguous()
    nz = np.nonzero(n_naf)[0]
    start = int(nz[0]) if nz.size else 0
    nd = len(n_naf)
    n_dbl = nd - start - 1
    n_add = int(np.count_nonzero(n_naf[start + 1:nd - 1]))
    e, mm = ops_of(k, {"dbl_step": n_dbl, "add_step": n_add})
    fr, fi = check(
        "miller_loop", f"B={B}, digits={nd}",
        lambda: cuda_rns.miller_loop(rns, ax, ay, xb, yb, n_naf),
        lambda: cuda_rns.miller_loop_plain(rns, ax, ay, xb, yb, n_naf),
        (B * e, B * mm), 4 * B * state + nd * 4 + 2 * B * state)

    # pow_loop: the norm inversion of _fp2_inv (N = B) and normalize (N = 1)
    aa, bb = rn.r_mul_many(rns, [(rn.RVal(fr, 9), rn.RVal(fr, 9)),
                                 (rn.RVal(fi, 9), rn.RVal(fi, 9))])
    norm = rn.r_add(rns, aa, bb).v.contiguous()
    e, mm = ops_of(k, {"r_mul": len(pm2) + int(np.count_nonzero(pm2))})
    for n in (B, 1):
        x = norm[:, :n].contiguous()
        check("pow_loop", f"N={n}, bits={len(pm2)}",
              lambda x=x: cuda_rns.pow_loop(rns, x, pm2),
              lambda x=x: cuda_rns.pow_loop_plain(rns, x, pm2),
              (n * e, n * mm), 2 * n * state + len(pm2) * 4)

    # fp2_pow_loop: ^l (final exponentiation, B) and z^q1 (decrypt, Bd)
    f = (rn.RVal(fr, 9), rn.RVal(fi, 9))
    inv = rp._fp2_inv(rns, f, ctx.pm2_bits)
    w = rp._fp2_mul(rns, rp._fp2_conj(rns, f), inv)
    wr, wi = w[0].v.contiguous(), w[1].v.contiguous()
    z = None
    for name_d, digs, n in (("l_bits", l_bits, B), ("q1_naf", q1_naf, Bd)):
        xr = (wr if z is None else z[0])[:, :n].contiguous()
        xi = (wi if z is None else z[1])[:, :n].contiguous()
        nzd = int(np.count_nonzero(digs))
        e, mm = ops_of(k, {"fp2_sqr": len(digs), "fp2_mul": nzd})
        out = check("fp2_pow_loop", f"N={n}, {name_d}={len(digs)}",
                    lambda xr=xr, xi=xi, d=digs: cuda_rns.fp2_pow_loop(
                        rns, xr, xi, d),
                    lambda xr=xr, xi=xi, d=digs: cuda_rns.fp2_pow_loop_plain(
                        rns, xr, xi, d),
                    (n * e, n * mm), 4 * n * state + len(digs) * 4)
        z = out

    # -- 4. the main path end to end ---------------------------------------
    for wfn in cuda_rns.WRAPPERS:
        wfn.launches = 0
    mrng = random.Random(args.seed + 2)
    ms = [mrng.randrange(340) for _ in range(B)]
    ks = [mrng.randrange(1, 4) for _ in range(B)]
    rs = [mrng.randrange(pk.n) for _ in range(B)]
    krs = [mrng.randrange(pk.n) for _ in range(B)]

    def timed(fn):
        torch.cuda.synchronize()
        t = time.time()
        out = fn()
        torch.cuda.synchronize()
        return out, time.time() - t

    a, t_enc = timed(lambda: pk.encrypt_with_randomness(ms, rs))
    b, _ = timed(lambda: pk.encrypt_with_randomness(ks, krs))
    prod, t_mult = timed(lambda: pk.mult(a, b))
    got, t_dec = [], None
    for s in range(0, B, Bd):
        vals, t = timed(lambda s=s: sk.decrypt(prod[s:s + Bd], pk, tables))
        t_dec = t if t_dec is None else t_dec
        got.extend(int(v) for v in vals)
    launches = {wfn.__name__: wfn.launches for wfn in cuda_rns.WRAPPERS}
    want = [m * kk for m, kk in zip(ms, ks)]
    bad = [i for i, (g, wv) in enumerate(zip(got, want)) if g != wv]
    if bad:
        raise AssertionError(f"{len(bad)} lanes decrypt wrong, first {bad[:5]}")
    log(f"main path: {B} lanes decrypt to m*k")
    gk = hm.GoldenKey(params=sk.a1_params, P=pk.P_host, Q=pk.Q_host, R=sk.r,
                      msg_space=pk.msg_space)
    lanes = [0, 1, B // 2, B - 1]
    pa = convert.affine_to_host(ctx, a[lanes].data)
    pb = convert.affine_to_host(ctx, b[lanes].data)
    for j, i in enumerate(lanes):
        assert pa[j] == hm.golden_encrypt(gk, ms[i], rs[i]), i
        assert pb[j] == hm.golden_encrypt(gk, ks[i], krs[i]), i
    zs = convert.fp2_to_host(ctx, prod[lanes[:2]].data)
    for j in range(2):
        assert zs[j] == hm.tate_pairing(pa[j], pb[j], gk.params), lanes[j]
    log(f"main path: lanes {lanes} equal the host oracle (encrypt, pairing)")
    for name, n in launches.items():
        if n < 1:
            raise AssertionError(f"{name} was not launched on the main path")
    log(f"main-path launches: {launches}")
    # a second call of each op: the steady state after the first call
    _, t_enc2 = timed(lambda: pk.encrypt_with_randomness(ms, rs))
    _, t_mult2 = timed(lambda: pk.mult(a, b))
    _, t_dec2 = timed(lambda: sk.decrypt(prod[:Bd], pk, tables))
    for op, n, t1, t2, note in (
            ("Encrypt", B, t_enc, t_enc2, ", host digits included"),
            ("Mult", B, t_mult, t_mult2, ""),
            ("DecryptL2", Bd, t_dec, t_dec2, "")):
        log(f"{op} {n / t1:.1f} ops/s first call, {n / t2:.1f} ops/s second "
            f"call (B={n}{note}) [{card}]")

    # -- 5. where the time goes: one profiled call of each op ------------
    for label, fn in (("Encrypt", lambda: pk.encrypt_with_randomness(ms, rs)),
                      ("Mult", lambda: pk.mult(a, b)),
                      ("DecryptL2", lambda: sk.decrypt(prod[:Bd], pk, tables))):
        profile_op(torch, label, fn, card)

    kernels = []
    for name, recs in results.items():
        main = recs[0]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"bgn_torch/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None, "match": True, "shape": main["shape"],
            "other_shapes": recs[1:]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
