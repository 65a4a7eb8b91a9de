#!/usr/bin/env python3
"""Drive the bgn_torch port on one NVIDIA H100 (or another CUDA card).

    python3 chip_smoke.py [--batch 8192] [--decrypt-batch 2048] [--seed 1]
                          [--wide-batch 512]

Phases, each of which raises on failure (the script then exits nonzero):
  1. the card (nvidia-smi name and power limit), torch/CUDA versions, and
     the build of every kernel in bgn_torch/csrc with nvcc's -Xptxas -v
     report (registers, shared memory, spills) for both instantiations,
     S = 4 slots (k <= 64) and S = 6 (k <= 96);
  2. keys: 512-bit key, message space 1021, seeded, on the card, plus the
     decryption tables;
  3. kernels: each of the seven CUDA kernels at the shapes the main paths
     give it, against its plain PyTorch version on the same inputs
     (torch.equal: the kernels are exact integer arithmetic), with the
     kernel's and the plain version's times (CUDA events);
  4. the main path end to end: Encrypt (batch of m < 340 and k in
     {1, 2, 3}) -> Mult -> DecryptL2 (decrypt-batch lanes at a time, every
     lane of the batch), every decrypted value checked against m*k and a
     few lanes against the host oracle (hostmath); each kernel of the path
     must be launched during this phase;
  4b. the level-1 path end to end on phase 4's ciphertexts: Add, Sub,
     Neg, MultConst (L1), EncryptDeterministic, MakeL2 and MultConst of
     the L2 product by +-1, every lane decrypted and checked, a few lanes
     against hostmath; each kernel of the path must be launched;
  4c. a 1024-bit key (the JAX package's bench config 5, k = 90: the S = 6
     kernels): every kernel against its plain version at N = 64, then
     Encrypt -> Mult -> DecryptL2 and Encrypt -> Add -> Decrypt at
     wide-batch lanes, every lane checked;
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
import re
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
    "dbl_pt": (9, 9, 4),
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
    "ladder_loop": "bgn_tpu/ops/pallas_rns.py:359",
    "window_ladder_tab": "bgn_tpu/ops/pallas_rns.py:536",
    "window_ladder": "bgn_tpu/ops/pallas_rns.py:715",
}
# kernels each main path must launch (window_ladder is on no path: the
# JAX package has no caller of window_ladder_pallas either)
MAIN_PATH = ("miller_loop", "pow_loop", "fp2_pow_loop", "dual_ladder")
L1_PATH = ("ladder_loop", "window_ladder_tab", "pow_loop", "miller_loop",
           "fp2_pow_loop")


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


def ptxas_table(report: str) -> list:
    """Per kernel entry and slot count: registers, and the largest stack
    frame and spill sizes ptxas reports for the entry and its callees."""
    rows, cur = [], None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '_Z\d+bgn_(\w+?)_kernelILi"
                      r"(\d+)E", line)
        if m:
            cur = {"kernel": m.group(1), "S": int(m.group(2)),
                   "registers": None, "stack": 0, "spill_stores": 0,
                   "spill_loads": 0}
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            for key, v in zip(("stack", "spill_stores", "spill_loads"),
                              m.groups()):
                cur[key] = max(cur[key], int(v))
    return sorted(rows, key=lambda r: (r["kernel"], r["S"]))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--decrypt-batch", type=int, default=2048)
    ap.add_argument("--wide-batch", type=int, default=512)
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
    t_start = phase_t = time.time()

    def phase_done(name: str) -> None:
        nonlocal phase_t
        now = time.time()
        log(f"phase {name}: {now - phase_t:.1f} s (total "
            f"{now - t_start:.1f} s)")
        phase_t = now

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
        "sources in parallel, each kernel for S = 4 and S = 6 slots)")
    for r in ptxas_table(_build.BUILD_INFO["ptxas"]):
        log(f"  ptxas {r['kernel']:<18s} S={r['S']}: {r['registers']} "
            f"registers, stack {r['stack']} B, spill stores "
            f"{r['spill_stores']} B, spill loads {r['spill_loads']} B")
    for k_ in (45, 90):
        log(f"  k = {k_}: S = {cuda_rns.slots_for(k_)}, "
            f"{cuda_rns.blob_layout(k_)['words'] * 4} B of dynamic shared "
            "memory per block")
    phase_done("1 (card, build)")

    # -- 2. keys --------------------------------------------------------
    t0 = time.time()
    rng = random.Random(args.seed)
    pk, sk = scheme.keygen(512, 1021, rng=rng, device="cuda")
    tables = pk.setup_decryption(sk, rng=rng)
    ctx, rns, dk = pk.dev.ctx, pk.dev.rns, pk.dev
    k, L = rns.k, ctx.L
    log(f"keys: 512-bit, msg space 1021, k = {k} channels per base, "
        f"L = {L} limbs, {time.time() - t0:.1f} s")
    phase_done("2 (keys)")

    # -- 3. kernels against their plain versions -------------------------
    B, Bd = args.batch, args.decrypt_batch
    results = {}
    f32 = 4

    def check(name, shape, kern, plain, elem_mm, nbytes, key_bits):
        got, want = kern(), plain()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        torch.cuda.synchronize()
        equal = all(torch.equal(g, w) for g, w in zip(got, want))
        err = max(float((g - w).abs().max()) if g.numel() else 0.0
                  for g, w in zip(got, want))
        if not equal:
            raise AssertionError(f"{name} {shape} ({key_bits}-bit): kernel "
                                 f"!= plain (max abs err {err})")
        ms_k = cuda_ms(kern, torch)
        ms_p = cuda_ms(plain, torch, min_total_ms=0.0, max_reps=1)
        b_ms, b_by = bound(*elem_mm, nbytes)
        rec = {"shape": shape, "key_bits": key_bits, "ms": ms_k,
               "plain_ms": ms_p, "max_abs_err": err, "bound_ms": b_ms,
               "bound_by": b_by}
        log(f"kernel {name} {shape} ({key_bits}-bit): equal to plain; "
            f"{ms_k:.3f} ms (plain {ms_p:.1f} ms, bound {b_ms:.4f} ms by "
            f"{b_by}) [{card}]")
        results.setdefault(name, []).append(rec)
        return got

    def kernel_checks(pk, sk, B, Bd, seed):
        """Each kernel at the shapes the paths give it for this key:
        dual_ladder, miller_loop, window_ladder_tab, window_ladder at B
        lanes, ladder_loop and fp2_pow_loop (q1) at Bd, pow_loop at B and
        1."""
        ctx, rns, dk = pk.dev.ctx, pk.dev.rns, pk.dev
        k, key_bits = rns.k, pk.key_bits
        state = 2 * k * f32                # bytes of one residue element
        krng = random.Random(seed)
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

        # dual ladder (Encrypt core) at B lanes
        live = dig_np != 0
        adds = 0
        for rows in (live[:Jm], live[Jm:]):
            adds += int(np.maximum(rows.sum(axis=0) - 1, 0).sum())
        combines = int((live[:Jm].any(axis=0) & live[Jm:].any(axis=0)).sum())
        e1, m1 = ops_of(k, {"add_pt": 1})
        e2, m2 = ops_of(k, {"jac_add_full": 1})
        tab_bytes = sum(t.numel() * f32 for t in (*dk.p_win, *dk.q_win))
        X, Y, Z = check(
            "dual_ladder", f"B={B}, Jm={Jm}, Jt={dig_np.shape[0]}",
            lambda: cuda_rns.dual_ladder(rns, dk.p_win, dk.q_win, Jm, dig,
                                         mneg),
            lambda: cuda_rns.dual_ladder_plain(rns, dk.p_win, dk.q_win, Jm,
                                               dig, mneg),
            (adds * e1 + combines * e2, adds * m1 + combines * m2),
            tab_bytes + dig_np.size * 8 + B * 8 + 3 * B * state, key_bits)

        # window_ladder_tab (EncryptDeterministic) at B lanes: the bench
        # digits (m < 340) and full-width digits (m < n); window_ladder on
        # the rows gathered for the full-width digits
        full_np, _ = scheme._signed_digits(
            [krng.randrange(pk.n) for _ in range(B)], pk.n)
        for label, dnp in (("m<340", m_digits), ("m<n", full_np)):
            lv = dnp != 0
            n_add = int(np.maximum(lv.sum(axis=0) - 1, 0).sum())
            row_bytes = int(lv.sum()) * 2 * state
            dgt = torch.as_tensor(dnp, device=dev)
            tab_out = check(
                "window_ladder_tab", f"B={B}, Jd={dnp.shape[0]} ({label})",
                lambda d=dgt: cuda_rns.window_ladder_tab(rns, dk.p_win, d),
                lambda d=dgt: cuda_rns.window_ladder_tab_plain(rns, dk.p_win,
                                                               d),
                (n_add * e1, n_add * m1),
                row_bytes + dnp.size * 4 + 3 * B * state, key_bits)
        gx, gy = (g.contiguous() for g in cuda_rns._gather_rows(dk.p_win,
                                                                 dgt))
        ginf = dgt == 0
        got = check(
            "window_ladder", f"B={B}, Jd={dnp.shape[0]} (m<n, gathered)",
            lambda: cuda_rns.window_ladder(rns, gx, gy, ginf),
            lambda: cuda_rns.window_ladder_plain(rns, gx, gy, ginf),
            (n_add * e1, n_add * m1),
            row_bytes + dnp.size * 4 + 3 * B * state, key_bits)
        if not all(torch.equal(u, v) for u, v in zip(got, tab_out)):
            raise AssertionError("window_ladder != window_ladder_tab")
        del gx, gy

        # ciphertext points -> Miller inputs (normalize runs pow_loop, N=1)
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
            (B * e, B * mm), 4 * B * state + nd * 4 + 2 * B * state,
            key_bits)

        # ladder_loop (L1 decrypt: csk = C^q1) at Bd lanes
        cx, cy = ax[:, :Bd].contiguous(), ay[:, :Bd].contiguous()
        one = rns.one_rns.expand_as(cx).contiguous()
        qd = q1_naf[1:]
        e, mm = ops_of(k, {"dbl_pt": len(qd),
                           "add_pt": int(np.count_nonzero(qd))})
        check("ladder_loop", f"N={Bd}, q1_naf={len(qd)}",
              lambda: cuda_rns.ladder_loop(rns, cx, cy, one, cx, cy, qd),
              lambda: cuda_rns.ladder_loop_plain(rns, cx, cy, one, cx, cy,
                                                 qd),
              (Bd * e, Bd * mm), 5 * Bd * state + len(qd) * 4
              + 3 * Bd * state, key_bits)

        # pow_loop: the norm inversion of _fp2_inv (N = B), normalize (N = 1)
        aa, bb = rn.r_mul_many(rns, [(rn.RVal(fr, 9), rn.RVal(fr, 9)),
                                     (rn.RVal(fi, 9), rn.RVal(fi, 9))])
        norm = rn.r_add(rns, aa, bb).v.contiguous()
        e, mm = ops_of(k, {"r_mul": len(pm2) + int(np.count_nonzero(pm2))})
        for n in (B, 1):
            x = norm[:, :n].contiguous()
            check("pow_loop", f"N={n}, bits={len(pm2)}",
                  lambda x=x: cuda_rns.pow_loop(rns, x, pm2),
                  lambda x=x: cuda_rns.pow_loop_plain(rns, x, pm2),
                  (n * e, n * mm), 2 * n * state + len(pm2) * 4, key_bits)

        # fp2_pow_loop: ^l (final exponentiation, B), z^q1 (decrypt, Bd)
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
            z = check("fp2_pow_loop", f"N={n}, {name_d}={len(digs)}",
                      lambda xr=xr, xi=xi, d=digs: cuda_rns.fp2_pow_loop(
                          rns, xr, xi, d),
                      lambda xr=xr, xi=xi, d=digs:
                          cuda_rns.fp2_pow_loop_plain(rns, xr, xi, d),
                      (n * e, n * mm), 4 * n * state + len(digs) * 4,
                      key_bits)

    kernel_checks(pk, sk, B, Bd, args.seed + 1)
    phase_done("3 (kernels, 512-bit)")

    # -- 4. the main path end to end ---------------------------------------
    def zero_counts():
        for wfn in cuda_rns.WRAPPERS:
            wfn.launches = 0

    def read_counts(path_name, must):
        counts = {wfn.__name__: wfn.launches for wfn in cuda_rns.WRAPPERS}
        for name in must:
            if counts[name] < 1:
                raise AssertionError(f"{name} was not launched on the "
                                     f"{path_name} path")
        log(f"{path_name} launches: {counts}")
        return counts

    def timed(fn):
        torch.cuda.synchronize()
        t = time.time()
        out = fn()
        torch.cuda.synchronize()
        return out, time.time() - t

    def decrypt_all(sk, pk, tables, ct, want, label, Bd):
        """Decrypt every lane, Bd at a time, and check it; returns the
        seconds of the first chunk."""
        got, t_first = [], None
        for s in range(0, len(want), Bd):
            vals, t = timed(lambda s=s: sk.decrypt(ct[s:s + Bd], pk, tables))
            t_first = t if t_first is None else t_first
            got.extend(int(v) for v in vals)
        bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
        if bad:
            raise AssertionError(f"{label}: {len(bad)} lanes decrypt wrong, "
                                 f"first {bad[:5]}")
        log(f"{label}: all {len(want)} lanes decrypt correctly")
        return t_first

    zero_counts()
    mrng = random.Random(args.seed + 2)
    ms = [mrng.randrange(340) for _ in range(B)]
    ks = [mrng.randrange(1, 4) for _ in range(B)]
    rs = [mrng.randrange(pk.n) for _ in range(B)]
    krs = [mrng.randrange(pk.n) for _ in range(B)]

    a, t_enc = timed(lambda: pk.encrypt_with_randomness(ms, rs))
    b, _ = timed(lambda: pk.encrypt_with_randomness(ks, krs))
    prod, t_mult = timed(lambda: pk.mult(a, b))
    t_dec = decrypt_all(sk, pk, tables, prod,
                        [m * kk for m, kk in zip(ms, ks)],
                        "main path DecryptL2 (m*k)", Bd)
    launches_main = read_counts("main", MAIN_PATH)
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
    phase_done("4 (main path)")

    # -- 4b. the level-1 path end to end (phase 4's ciphertexts) ----------
    zero_counts()
    signs = [mrng.choice((-1, 1)) for _ in range(B)]
    ops = {}
    for op, fn in (("EncryptDeterministic",
                    lambda: pk.encrypt_deterministic(ms)),
                   ("Add", lambda: pk.add(a, b)),
                   ("Sub", lambda: pk.sub(a, b)),
                   ("Neg", lambda: pk.neg(a)),
                   ("MultConst", lambda: pk.mult_const(a, ks)),
                   ("MakeL2", lambda: pk.make_l2(a)),
                   ("MultConstL2", lambda: pk.mult_const(prod, signs))):
        ops[op] = (fn,) + timed(fn)
    t_dec1 = None
    for op, want in (("EncryptDeterministic", ms),
                     ("Add", [m + kk for m, kk in zip(ms, ks)]),
                     ("Sub", [m - kk for m, kk in zip(ms, ks)]),
                     ("Neg", [-m for m in ms]),
                     ("MultConst", [m * kk for m, kk in zip(ms, ks)]),
                     ("MakeL2", ms),
                     ("MultConstL2", [s * m * kk for s, m, kk
                                      in zip(signs, ms, ks)])):
        t = decrypt_all(sk, pk, tables, ops[op][1], want,
                        f"L1 path {op}", Bd)
        if op == "EncryptDeterministic":
            t_dec1 = t
    launches_l1 = read_counts("L1", L1_PATH)
    p = gk.params.p
    host = {
        "EncryptDeterministic": lambda i: hm.ec_mul(ms[i], gk.P, p),
        "Add": lambda i: hm.ec_add(pa[lanes.index(i)], pb[lanes.index(i)], p),
        "Sub": lambda i: hm.ec_add(pa[lanes.index(i)],
                                   hm.ec_neg(pb[lanes.index(i)], p), p),
        "Neg": lambda i: hm.ec_neg(pa[lanes.index(i)], p),
        "MultConst": lambda i: hm.ec_mul(ks[i], pa[lanes.index(i)], p),
    }
    for op, fn in host.items():
        got = convert.affine_to_host(ctx, ops[op][1][lanes].data)
        assert got == [fn(i) for i in lanes], op
    z = convert.fp2_to_host(ctx, ops["MakeL2"][1][lanes[:1]].data)
    assert z[0] == hm.tate_pairing(pa[0], gk.P, gk.params)
    log(f"L1 path: lanes {lanes} equal the host oracle (EncryptDeterministic, "
        "Add, Sub, Neg, MultConst; MakeL2 lane 0)")
    ct1 = ops["EncryptDeterministic"][1]
    _, t_dec1b = timed(lambda: sk.decrypt(ct1[:Bd], pk, tables))
    for op in ops:
        fn, _, t1 = ops[op]
        _, t2 = timed(fn)
        log(f"{op} {B / t1:.1f} ops/s first call, {B / t2:.1f} ops/s second "
            f"call (B={B}) [{card}]")
    log(f"Decrypt (L1) {Bd / t_dec1:.1f} ops/s first call, "
        f"{Bd / t_dec1b:.1f} ops/s second call (B={Bd}) [{card}]")
    phase_done("4b (L1 path)")

    # -- 4c. a 1024-bit key: the wide (S = 6) kernels ----------------------
    t0 = time.time()
    rng2 = random.Random(4321)
    pk2, sk2 = scheme.keygen(1024, 1021, rng=rng2, device="cuda")
    tables2 = pk2.setup_decryption(sk2, rng=rng2)
    k2 = pk2.dev.rns.k
    log(f"keys: 1024-bit, msg space 1021, k = {k2} channels per base "
        f"(S = {cuda_rns.slots_for(k2)}), L = {pk2.dev.ctx.L} limbs, "
        f"{time.time() - t0:.1f} s")
    kernel_checks(pk2, sk2, 64, 64, args.seed + 3)
    Bw = args.wide_batch
    wrng = random.Random(args.seed + 4)
    ms2 = [wrng.randrange(340) for _ in range(Bw)]
    ks2 = [wrng.randrange(1, 4) for _ in range(Bw)]
    zero_counts()
    a2, t_enc_w = timed(lambda: pk2.encrypt(ms2, rng=wrng))
    b2, _ = timed(lambda: pk2.encrypt(ks2, rng=wrng))
    prod2, t_mult_w = timed(lambda: pk2.mult(a2, b2))
    t_dec2_w = decrypt_all(sk2, pk2, tables2, prod2,
                           [m * kk for m, kk in zip(ms2, ks2)],
                           "1024-bit DecryptL2 (m*k)", Bw)
    add2, t_add_w = timed(lambda: pk2.add(a2, b2))
    t_dec1_w = decrypt_all(sk2, pk2, tables2, add2,
                           [m + kk for m, kk in zip(ms2, ks2)],
                           "1024-bit Decrypt of Add (m+k)", Bw)
    read_counts("1024-bit", MAIN_PATH + ("ladder_loop",))
    for op, n, t in (("Encrypt", Bw, t_enc_w), ("Mult", Bw, t_mult_w),
                     ("DecryptL2", Bw, t_dec2_w), ("Add", Bw, t_add_w),
                     ("Decrypt (L1)", Bw, t_dec1_w)):
        log(f"1024-bit {op} {n / t:.1f} ops/s first call (B={n}) [{card}]")
    del pk2, sk2, tables2, a2, b2, prod2, add2
    phase_done("4c (1024-bit)")

    # -- 5. where the time goes: one profiled call of each op ------------
    for label, fn in (("Encrypt", lambda: pk.encrypt_with_randomness(ms, rs)),
                      ("Mult", lambda: pk.mult(a, b)),
                      ("DecryptL2", lambda: sk.decrypt(prod[:Bd], pk, tables)),
                      ("Add", lambda: pk.add(a, b)),
                      ("Decrypt (L1)", lambda: sk.decrypt(ct1[:Bd], pk,
                                                          tables))):
        profile_op(torch, label, fn, card)
    phase_done("5 (profile)")

    kernels = []
    for name in REPLACES:
        recs = results[name]
        main = recs[0]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"bgn_torch/csrc/{name}.cu",
            "replaces": REPLACES[name],
            "launches": launches_main[name] + launches_l1[name],
            "launches_by_path": {"main": launches_main[name],
                                 "l1": launches_l1[name]},
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None, "match": True, "shape": main["shape"],
            "key_bits": main["key_bits"], "other_shapes": recs[1:]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
