#!/usr/bin/env python3
"""Time build variants of mont_mul.cu, ladder_loop.cu, pow_loop.cu,
fp2_pow_loop.cu, the two digit-domain Miller step kernels, the six
tensor-core step kernels (dbl_step.cu, add_step.cu, pt_dbl.cu, pt_add.cu,
pow_step.cu, fp2_pow_step.cu), dual_ladder.cu, window_ladder_tab.cu and
window_ladder.cu on one CUDA card.

    python3 scripts/kernel_variants.py [--kernels mont ladder pow digits
                                        step encrypt]
                                       [--out build/kernel_variants.json]

It builds the kernel library from bgn_torch/csrc as chip_smoke.py does
and prints nvcc's -Xptxas -v lines of the kernels swept.  Then, for each
variant, it recompiles the sources concerned from a copy of csrc/ with
one constant changed (in a source or a header), links them with the
other objects of the build into a library of its own, and times the
port's wrapper on that library (CUDA events, the timing of
chip_smoke.py), two turns in opposite orders:
  - ladder_loop.cu: the blocks per SM that __launch_bounds__ asks of the
    register budget at S = 4 and S = 6 (the shipped kernel takes
    TcLadder<S>::min_blocks; (4, 1) is the Miller kernel's TcLanes), at
    k = 45-47 (N = 2048, 255 digits), 90-92 (N = 64 and 512, 511 digits)
    and 184-186 (N = 16, 32 digits) over random residues modulo random
    primes;
  - mont_mul.cu: the threads per lane G of each register kernel (the
    shipped G and four other sets), and the local-memory loop
    (bgn_mont_mul_loop), at L = 34 (N = 8192) and L = 66, 130, 258
    (N = 512);
  - pow_loop.cu and fp2_pow_loop.cu (--kernels pow): the shipped build
    at N = 1, 16, 64, 512, 2048 and 8192, and the blocks per SM that
    __launch_bounds__ asks at S = 4 and S = 6 (rns_tc.cuh TcPow<S>,
    TcFp2Pow<S>) at N = 8192 (pow_loop) and 2048 (fp2_pow_loop), at
    k = 45-47, 90-92 and 184-186 over random residues modulo random
    primes: pow_loop over the bits of p - 2 (64 bits at k = 184-186),
    fp2_pow_loop over 64 random signed digits;
  - miller_dbl_digits.cu and miller_add_digits.cu (--kernels digits): the
    threads per lane G of the register form, G = 1, 2, 4, 8, 16 at L = 34
    (N = 8192) with 2, 4, 8, 16, 32 at L = 64 (N = 512), then the threads
    per block (digits.cuh BGN_DIGITS_THREADS) 64, 128 and 256 at the G
    that was fastest for each kernel and L, over random canonical digits
    modulo random primes of 512 and 1000 bits;
  - dbl_step.cu, add_step.cu, pt_dbl.cu, pt_add.cu, pow_step.cu and
    fp2_pow_step.cu (--kernels step): the shipped build at N = 1, 7,
    2048, 8191 and 8192 (k = 45-47), 1, 512 and 8192 (k = 90-92) and 1
    and 16 (k = 184-186), pow_step and fp2_pow_step at bit 1 and bit 0,
    and the blocks per SM that __launch_bounds__ asks at S = 4 and S = 6
    (rns_tc.cuh TcLanes<S> for dbl_step, add_step and pt_add, TcLadder<S>
    for pt_dbl, TcPow<S> for pow_step, TcFp2Pow<S> for fp2_pow_step, all
    set alike in the six sources' builds) at N = 1, 7, 2048, 8191 and
    8192 (k = 45-47) and N = 512 and 8192 (k = 90-92), over random
    residues modulo random primes;
  - dual_ladder.cu, window_ladder_tab.cu and window_ladder.cu
    (--kernels encrypt): the blocks per SM that their __launch_bounds__
    ask at S = 4 and S = 6 (1-4 and 1-3, set alike in all three; the
    shipped build is timed too): dual_ladder at k = 45-47, N = 8192,
    2 + 64 windows, and k = 90-92, N = 512 and 8192, 2 + 128 windows (the
    Encrypt shapes of the 512- and 1024-bit keys), window_ladder_tab at
    k = 45-47, N = 8192, and k = 90-92, N = 64, each over 2 windows and
    over all the table's (64, 128; the EncryptDeterministic shapes), and
    window_ladder on the rows window_ladder_tab reads there, gathered
    into its [Jd, 2k, N] stream (dead where the digit is 0), over random
    window tables (residues of random values below random primes, row 0
    of every window zeros), random 8-bit digits (dead windows among
    them) and random m_neg.
Every variant's output is torch.equal to the plain version's, or the
script raises.  The shipped sources are not changed.  The variants'
builds take most of its time (mont and ladder: ~15 minutes on the H100
machine's 8 cores; digits: ~8 minutes; step, encrypt: ~2 minutes each
in all).  Needs
the card: without one it exits nonzero before timing anything.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import random
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
LADDER_BOUNDS = ("__launch_bounds__(32 * TcLanes<S>::G, "
                 "TcLadder<S>::min_blocks)")
# (blocks per SM at S = 4, at S = 6); S = 12 keeps one block
LADDER_VARIANTS = [(1, 1), (2, 2), (3, 3), (4, 1), (5, 1), (6, 1)]
MONT_CASE = re.compile(
    r"case (\d+):\s*return bgn_mont_words_launch<(\d+), (\d+)>")
# threads per lane at L = 34, 66, 130, 258
MONT_VARIANTS = [(1, 1, 8, 16), (2, 2, 4, 8), (4, 4, 16, 32), (1, 4, 16, 32)]
POW_SOURCES = ["pow_loop.cu", "fp2_pow_loop.cu"]
# blocks per SM of the two power kernels (at S = 4, at S = 6)
POW_BLOCKS = [(1, 1), (2, 2), (3, 1), (4, 1)]
POW_N = (1, 16, 64, 512, 2048, 8192)
DIGIT_SOURCES = ["miller_dbl_digits.cu", "miller_add_digits.cu"]
DIGIT_CASE = re.compile(r"case (\d+): return (dbl|add)_launch<(\d+), (\d+)>")
DIGIT_THREADS_LINE = re.compile(r"#define BGN_DIGITS_THREADS (\d+)")
# threads per lane (at L = 34, at L = 64) of both kernels
DIGIT_G = [(1, 2), (2, 4), (4, 8), (8, 16), (16, 32)]
DIGIT_THREADS = (64, 128, 256)
# (kernel, L, lanes, prime bits) timed
DIGIT_SHAPES = [(kind, L, n, bits) for kind in ("dbl", "add")
                for L, n, bits in ((34, 8192, 512), (64, 512, 1000))]
STEP_SOURCES = ["dbl_step.cu", "add_step.cu", "pt_dbl.cu", "pt_add.cu",
                "pow_step.cu", "fp2_pow_step.cu"]
# blocks per SM of the step kernels (at S = 4, at S = 6); the shipped
# policy is timed as "shipped" ((4, 1): TcLanes', shipped by all but
# pt_dbl)
STEP_BLOCKS = [(1, 1), (2, 2), (3, 3), (4, 1), (5, 1)]
# the policies of dbl_step, add_step and pt_add (the Miller kernel's),
# pt_dbl (ladder_loop's), pow_step (pow_loop's) and fp2_pow_step
# (fp2_pow_loop's)
STEP_POLICY = re.compile(r"(struct Tc(?:Lanes|Ladder|Pow|Fp2Pow) \{\n(?:  static "
                         r"constexpr "
                         r"int G = \d+;\n)?  static constexpr int min_blocks "
                         r"= )[^;]*;")
# (prime bits, lanes timed, lanes on which the variants are timed)
STEP_SHAPES = ((528, (1, 7, 2048, 8191, 8192), (1, 7, 2048, 8191, 8192)),
               (1056, (1, 512, 8192), (512, 8192)),
               (2080, (1, 16), ()))
# the __launch_bounds__ of dual_ladder.cu, window_ladder_tab.cu and
# window_ladder.cu and their blocks per SM (at S = 4, at S = 6) swept;
# S = 12 keeps one block
ENCRYPT_SOURCES = ["dual_ladder.cu", "window_ladder_tab.cu",
                   "window_ladder.cu"]
ENCRYPT_BOUNDS = re.compile(r"__launch_bounds__\(32 \* TcLanes<S>::G, "
                            r"[^)]*\)")
ENCRYPT_BLOCKS = [(1, 1), (2, 2), (3, 3), (4, 1)]
# (prime bits, windows of r, lanes timed for dual_ladder (m takes two
# windows), lanes timed for window_ladder_tab and window_ladder)
ENCRYPT_SHAPES = ((528, 64, (8192,), (8192,)),
                  (1056, 128, (512, 8192), (64,)))


def digit_variant(g: dict, threads: int) -> tuple:
    """The two digit sources with the dispatch's G set per (kernel, L)
    (g: {(kind, L): G}) and BGN_DIGITS_THREADS set to threads."""
    csrc = ROOT / "bgn_torch" / "csrc"
    reps = [("digits.cuh", m.group(0), f"#define BGN_DIGITS_THREADS {threads}")
            for m in DIGIT_THREADS_LINE.finditer(
                (csrc / "digits.cuh").read_text())]
    for src in DIGIT_SOURCES:
        for m in DIGIT_CASE.finditer((csrc / src).read_text()):
            L, kind = int(m.group(1)), m.group(2)
            reps.append((src, m.group(0), f"case {L}: return {kind}_launch<"
                         f"{L // 2}, {g[(kind, L)]}>"))
    return DIGIT_SOURCES, reps


def time_jobs(jobs, libs, cs, torch, log) -> dict:
    """{label: {library: [ms of turn 0, ms of turn 1]}}: each job on each
    of its libraries (the wrappers' library swapped), checked against its
    plain output, in two turns of opposite order."""
    from bgn_torch import _build
    real_library = _build.library
    times = {}
    try:
        for turn in (0, 1):
            for label, names, fn, want in jobs:
                for name in (names if turn == 0 else names[::-1]):
                    _build.library = lambda lib=libs[name]: lib
                    got = fn()
                    got = got if isinstance(got, tuple) else (got,)
                    w = want if isinstance(want, tuple) else (want,)
                    if not all(torch.equal(g, v) for g, v in zip(got, w)):
                        raise AssertionError(f"{label} [{name}] != plain")
                    ms = cs.cuda_ms(fn, torch, budget_ms=300.0)
                    times.setdefault(label, {}).setdefault(name, []).append(ms)
            log(f"turn {turn} timed")
    finally:
        _build.library = real_library
    return times


def compile_variants(build_dir: Path, csrc: Path, nvcc: str, variants):
    """variants: {name: ([source files], [(file, old, new)])} -> {name:
    library}.  Each copy of csrc/ gets its replacements (each must match,
    in a source or a header), one nvcc per source and variant, all started
    together, then one link each with the other objects of the default
    build."""
    from bgn_torch import _build
    procs = {}
    for name, (srcs, reps) in variants.items():
        d = build_dir / "variants" / name
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for f in list(csrc.glob("*.cuh")) + [csrc / src for src in srcs]:
            shutil.copy(f, d / f.name)
        for fname, old, new in reps:
            text = (d / fname).read_text()
            if old not in text:
                raise ValueError(f"{name}: {old!r} not in {fname}")
            (d / fname).write_text(text.replace(old, new))
        for src in srcs:
            obj = d / (Path(src).stem + ".o")
            cmd = [nvcc, _build.ARCH, "-std=c++17", "-O3", "-Xcompiler",
                   "-fPIC", "-Xptxas", "-v", "-c", str(d / src), "-o",
                   str(obj)]
            procs.setdefault(name, []).append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    libs, reports = {}, {}
    for name, runs in procs.items():
        objs = []
        for src, obj, proc in runs:
            out, _ = proc.communicate()
            reports[name] = reports.get(name, "") + out
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for variant {name}\n{out}")
            objs.append(obj)
        stems = {o.stem for o in objs}
        others = [o for o in sorted(build_dir.glob("*.o"))
                  if o.stem not in stems]
        lib = objs[0].parent / "libvariant.so"
        subprocess.run([nvcc, _build.ARCH, "-shared", "-o", str(lib)]
                       + [str(o) for o in objs + others], check=True)
        cdll = ctypes.CDLL(str(lib))
        for entry, argtypes in _build._SIGNATURES.items():
            fn = getattr(cdll, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        cdll.bgn_error_string.argtypes = [ctypes.c_int]
        cdll.bgn_error_string.restype = ctypes.c_char_p
        libs[name] = cdll
    return libs, reports


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels", nargs="+",
                    choices=("mont", "ladder", "pow", "digits", "step",
                             "encrypt"),
                    default=["mont", "ladder", "pow", "digits", "step",
                             "encrypt"])
    ap.add_argument("--out", default=str(ROOT / "build"
                                         / "kernel_variants.json"))
    args = ap.parse_args()
    t0 = time.time()

    def log(msg):
        print(f"[{time.time() - t0:6.1f} s] {msg}", flush=True)

    import torch
    if not torch.cuda.is_available():
        sys.exit("kernel_variants.py: no CUDA device")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from bgn_torch import _build, hostmath as hm
    from bgn_torch.fieldcore import cuda_mont, limbs as lb, montgomery as mg
    from bgn_torch.fieldcore import rns as rn
    from bgn_torch.ops import cuda_pairing, cuda_rns

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(card)
    _build.build(force=True)
    shipped = _build.library()
    log(f"built the library in {_build.BUILD_INFO['seconds']:.1f} s")
    for r in cs.ptxas_table(_build.BUILD_INFO["ptxas"]):
        if r["kernel"].startswith(("mont_", "ladder_loop", "pow_loop",
                                   "fp2_pow_loop", "miller_dbl_digits",
                                   "miller_add_digits", "dbl_step",
                                   "add_step", "pt_dbl", "pt_add",
                                   "pow_step", "fp2_pow_step",
                                   "dual_ladder", "window_ladder")):
            log(f"  ptxas {r['kernel']} {r['S']} {r['G']}: "
                f"{r['registers']} registers, spill stores "
                f"{r['spill_stores']} B, spill loads {r['spill_loads']} B")
    variants = {}
    if "ladder" in args.kernels:
        for b4, b6 in LADDER_VARIANTS:
            variants[f"ladder b4={b4} b6={b6}"] = (["ladder_loop.cu"], [(
                "ladder_loop.cu", LADDER_BOUNDS,
                "__launch_bounds__(32 * TcLanes<S>::G, "
                f"S == 4 ? {b4} : S == 6 ? {b6} : 1)")])
    if "mont" in args.kernels:
        cases = sorted(((int(m.group(1)), m.group(0)) for m in
                        MONT_CASE.finditer((_build.CSRC / "mont_mul.cu")
                                           .read_text())))
        for gs in MONT_VARIANTS:
            reps = [("mont_mul.cu", text, f"case {L}: return "
                     f"bgn_mont_words_launch<{L // 2}, {g}>")
                    for (L, text), g in zip(cases, gs)]
            variants["mont G=" + ",".join(map(str, gs))] = (["mont_mul.cu"],
                                                            reps)
    if "pow" in args.kernels:
        tc_src = (_build.CSRC / "rns_tc.cuh").read_text()
        for b4, b6 in POW_BLOCKS:
            variants[f"pow b4={b4} b6={b6}"] = (POW_SOURCES, [
                ("rns_tc.cuh", m.group(0), f"{m.group(1)}S == 4 ? {b4} : "
                 f"S == 6 ? {b6} : 1;")
                for m in re.finditer(r"(struct Tc(?:Fp2)?Pow \{\n  static "
                                     r"constexpr int min_blocks = )[^;]*;",
                                     tc_src)])
    if "step" in args.kernels:
        tc_src = (_build.CSRC / "rns_tc.cuh").read_text()
        for b4, b6 in STEP_BLOCKS:
            variants[f"step b4={b4} b6={b6}"] = (STEP_SOURCES, [
                ("rns_tc.cuh", m.group(0), f"{m.group(1)}S == 4 ? {b4} : "
                 f"S == 6 ? {b6} : 1;")
                for m in STEP_POLICY.finditer(tc_src)])
    if "encrypt" in args.kernels:
        bounds = {src: ENCRYPT_BOUNDS.search(
            (_build.CSRC / src).read_text()).group(0)
            for src in ENCRYPT_SOURCES}
        for b4, b6 in ENCRYPT_BLOCKS:
            variants[f"encrypt b4={b4} b6={b6}"] = (ENCRYPT_SOURCES, [
                (src, bounds[src], "__launch_bounds__(32 * TcLanes<S>::G, "
                 f"S == 4 ? {b4} : S == 6 ? {b6} : 1)")
                for src in ENCRYPT_SOURCES])
    if "digits" in args.kernels:
        shipped_threads = int(DIGIT_THREADS_LINE.search(
            (_build.CSRC / "digits.cuh").read_text()).group(1))
        for g34, g64 in DIGIT_G:
            g = {(kind, L): G for kind in ("dbl", "add")
                 for L, G in ((34, g34), (64, g64))}
            variants[f"digits G={g34},{g64}"] = digit_variant(
                g, shipped_threads)

    def build_variants(variants):
        libs, reports = compile_variants(_build.BUILD_DIR, _build.CSRC,
                                         _build._nvcc(), variants)
        log(f"built {len(libs)} variants")
        for name, rep in reports.items():
            for r in cs.ptxas_table(rep):
                log(f"  ptxas [{name}] {r['kernel']} {r['S']} {r['G']}: "
                    f"{r['registers']} registers, spill stores "
                    f"{r['spill_stores']} B, spill loads "
                    f"{r['spill_loads']} B")
        return libs

    libs = {"shipped": shipped, **build_variants(variants)}

    dev = torch.device("cuda")
    rng = random.Random(7)
    jobs = []                          # (label, lib names, fn, want)
    if "ladder" in args.kernels:       # random residues, random primes
        for bits, shapes in ((528, ((2048, 255),)),
                             (1056, ((64, 511), (512, 511))),
                             (2080, ((16, 32),))):
            p = hm.gen_prime(bits, rng=rng)
            rns = rn.make_rns_ctx(p, device=dev)
            for n, nd in shapes:
                st = [rn.to_rns_mont(rns, torch.as_tensor(lb.ints_to_limbs(
                    [rng.randrange(p) for _ in range(n)], rns.L),
                    device=dev)).v.contiguous() for _ in range(2)]
                one = rns.one_rns.expand_as(st[0]).contiguous()
                digits = [rng.choice((-1, 0, 0, 1)) for _ in range(nd)]
                ins = (st[0], st[1], one, st[0], st[1], digits)
                names = ["shipped"] + [v for v in libs
                                       if v.startswith("ladder")]
                jobs.append((f"ladder_loop k={rns.k} N={n} digits={nd}",
                             names,
                             lambda r=rns, a=ins: cuda_rns.ladder_loop(r, *a),
                             cuda_rns.ladder_loop_plain(rns, *ins)))
        log("ladder inputs and plain outputs ready")
    if "mont" in args.kernels:         # random full-width odd moduli
        for L, n in ((34, 8192), (66, 512), (130, 512), (258, 512)):
            pm = rng.getrandbits(16 * L) | (1 << (16 * L - 1)) | 1
            ctx = mg.make_mont_ctx(pm, L=L, device=dev)
            x, y = (torch.as_tensor(lb.ints_to_limbs(
                [rng.randrange(pm) for _ in range(n)], L), device=dev)
                for _ in range(2))
            want = cuda_mont.mont_mul_plain(ctx, x, y)
            names = ["shipped"] + [v for v in libs if v.startswith("mont")]
            jobs.append((f"mont_mul L={L} N={n}", names,
                         lambda c=ctx, a=x, b=y: cuda_mont.mont_mul(c, a, b),
                         want))

            def loop(c=ctx, a=x, b=y):
                out = torch.empty_like(a)
                _build.launch("bgn_mont_mul_loop", _build.ptr(a),
                              a.stride(0), a.stride(1), _build.ptr(b),
                              b.stride(0), b.stride(1), _build.ptr(c.p), c.L,
                              _build.ptr(out), a.shape[1])
                return out
            jobs.append((f"mont_mul L={L} N={n} local-memory loop",
                         ["shipped"], loop, want))

    if "pow" in args.kernels:          # random residues, random primes
        for bits in (528, 1056, 2080):
            p = hm.gen_prime(bits, rng=rng)
            rns = rn.make_rns_ctx(p, device=dev)
            k, S = rns.k, cuda_rns.slots_for(rns.k)
            pm2 = [int(b) for b in bin(p - 2)[2:]][:64 if S == 12 else None]
            digits = [rng.choice((-1, 0, 0, 1)) for _ in range(64)]
            for n in POW_N:
                xs = [rn.to_rns_mont(rns, torch.as_tensor(lb.ints_to_limbs(
                    [rng.randrange(p) for _ in range(n)], rns.L),
                    device=dev)).v.contiguous() for _ in range(2)]
                for kern, fn, plain, tag in (
                        ("pow_loop",
                         lambda r=rns, x=xs[0], e=pm2: cuda_rns.pow_loop(
                             r, x, e),
                         cuda_rns.pow_loop_plain(rns, xs[0], pm2),
                         f"bits={len(pm2)}"),
                        ("fp2_pow_loop",
                         lambda r=rns, x=xs, d=digits:
                             cuda_rns.fp2_pow_loop(r, *x, d),
                         cuda_rns.fp2_pow_loop_plain(rns, *xs, digits),
                         "digits=64")):
                    names = ["shipped"]
                    if n == (8192 if kern == "pow_loop" else 2048) \
                            and S != 12:
                        names += [v for v in libs if v.startswith("pow")]
                    jobs.append((f"{kern} k={k} N={n} {tag}", names, fn,
                                 plain))
        log("power inputs and plain outputs ready")

    if "step" in args.kernels:         # random residues, random primes
        for bits, lanes, swept in STEP_SHAPES:
            p = hm.gen_prime(bits, rng=rng)
            rns = rn.make_rns_ctx(p, device=dev)
            for n in lanes:
                st = [rn.to_rns_mont(rns, torch.as_tensor(lb.ints_to_limbs(
                    [rng.randrange(p) for _ in range(n)], rns.L),
                    device=dev)).v.contiguous() for _ in range(7)]
                names = ["shipped"]
                if n in swept:
                    names += [v for v in libs if v.startswith("step b")]
                jobs.append((f"dbl_step k={rns.k} N={n}", names,
                             lambda r=rns, a=st: cuda_rns.dbl_step(r, *a),
                             cuda_rns.dbl_step_plain(rns, *st)))
                a9 = st + st[:2]
                jobs.append((f"add_step k={rns.k} N={n}", names,
                             lambda r=rns, a=a9: cuda_rns.add_step(r, *a),
                             cuda_rns.add_step_plain(rns, *a9)))
                for kern, a in (("pt_dbl", st[:3]), ("pt_add", st[:5])):
                    jobs.append((f"{kern} k={rns.k} N={n}", names,
                                 lambda r=rns, a=a, f=getattr(cuda_rns, kern):
                                     f(r, *a),
                                 getattr(cuda_rns, kern + "_plain")(rns, *a)))
                for bit in (1, 0):
                    for kern, a in (("pow_step", (st[0], st[1], bit)),
                                    ("fp2_pow_step", (*st[:4], bit))):
                        jobs.append((f"{kern} k={rns.k} N={n} bit={bit}",
                                     names,
                                     lambda r=rns, a=a,
                                     f=getattr(cuda_rns, kern): f(r, *a),
                                     getattr(cuda_rns, kern + "_plain")(
                                         rns, *a)))
        log("step inputs and plain outputs ready")

    if "encrypt" in args.kernels:      # random tables, digits, m_neg
        for bits, jr, lanes, tab_lanes in ENCRYPT_SHAPES:
            p = hm.gen_prime(bits, rng=rng)
            rns = rn.make_rns_ctx(p, device=dev)
            R = 256
            tabs = []
            for J in (2, jr):
                xy = []
                for _ in range(2):
                    v = rn.to_rns_mont(rns, torch.as_tensor(
                        lb.ints_to_limbs([rng.randrange(p)
                                          for _ in range(J * R)], rns.L),
                        device=dev)).v.T.reshape(J, R, 2 * rns.k)
                    v[:, 0] = 0
                    xy.append(v.contiguous())
                tabs.append(tuple(xy))
            for n in lanes:
                dig = torch.tensor([[rng.randrange(R) for _ in range(n)]
                                    for _ in range(2 + jr)], device=dev)
                mneg = torch.tensor([rng.randrange(2) for _ in range(n)],
                                    device=dev)
                a = (*tabs, 2, dig, mneg)
                jobs.append((f"dual_ladder k={rns.k} N={n} windows=2+{jr}",
                             ["shipped"] + [v for v in libs
                                            if v.startswith("encrypt")],
                             lambda r=rns, a=a: cuda_rns.dual_ladder(r, *a),
                             cuda_rns.dual_ladder_plain(rns, *a)))
            for n in tab_lanes:
                for jd in (2, jr):
                    dig = torch.tensor([[rng.randrange(R) for _ in range(n)]
                                        for _ in range(jd)], device=dev)
                    a = (tabs[1], dig)
                    jobs.append((f"window_ladder_tab k={rns.k} N={n} "
                                 f"windows={jd}",
                                 ["shipped"] + [v for v in libs
                                                if v.startswith("encrypt")],
                                 lambda r=rns, a=a:
                                     cuda_rns.window_ladder_tab(r, *a),
                                 cuda_rns.window_ladder_tab_plain(rns, *a)))
                    g = (*(v.contiguous() for v in cuda_rns._gather_rows(
                        tabs[1], dig)), dig == 0)
                    jobs.append((f"window_ladder k={rns.k} N={n} "
                                 f"windows={jd}",
                                 ["shipped"] + [v for v in libs
                                                if v.startswith("encrypt")],
                                 lambda r=rns, g=g:
                                     cuda_rns.window_ladder(r, *g),
                                 cuda_rns.window_ladder_plain(rns, *g)))
        log("encrypt inputs and plain outputs ready")

    digit_jobs = {}
    if "digits" in args.kernels:       # random digits, random primes
        for kind, L, n, bits in DIGIT_SHAPES:
            p = hm.gen_prime(bits, rng=rng)
            ctx = mg.make_mont_ctx(p, L=L, device=dev)
            arrays = [cuda_pairing.to_digits(torch.as_tensor(
                lb.ints_to_limbs([rng.randrange(p) for _ in range(n)], L),
                device=dev)) for _ in range(7 if kind == "dbl" else 9)]
            step = cuda_pairing.dbl_step if kind == "dbl" \
                else cuda_pairing.add_step
            plain = cuda_pairing.dbl_step_plain if kind == "dbl" \
                else cuda_pairing.add_step_plain
            groups = (arrays[:3], arrays[3:5], *[arrays[i:i + 2] for i in
                                                  range(5, len(arrays), 2)])
            digit_jobs[(kind, L)] = (
                f"miller_{kind}_digits L={L} N={n}",
                lambda c=ctx, a=groups, f=step: sum(f(c, *a), ()),
                sum(plain(ctx, *groups), ()))
            jobs.append((digit_jobs[(kind, L)][0],
                         ["shipped"] + [v for v in libs
                                        if v.startswith("digits")],
                         *digit_jobs[(kind, L)][1:]))
        log("digit inputs and plain outputs ready")

    times = time_jobs(jobs, libs, cs, torch, log)
    if "digits" in args.kernels:       # threads per block at the best G
        best = {}
        for (kind, L), (label, _, _) in digit_jobs.items():
            per = {name: sum(ms) for name, ms in times[label].items()
                   if name.startswith("digits")}
            gs = dict(zip((f"digits G={a},{b}" for a, b in DIGIT_G),
                          DIGIT_G))[min(per, key=per.get)]
            best[(kind, L)] = gs[0] if L == 34 else gs[1]
        log(f"fastest G per (kernel, L): {best}")
        libs.update(build_variants({
            f"threads={t}": digit_variant(best, t)
            for t in DIGIT_THREADS}))
        more = time_jobs([(label, ["shipped"] + [v for v in libs
                                                 if v.startswith("threads")],
                           fn, want)
                          for label, fn, want in digit_jobs.values()],
                         libs, cs, torch, log)
        for label, per in more.items():
            times[label].update({k: v for k, v in per.items()
                                 if k != "shipped"})
    for label, per in times.items():
        print(label, flush=True)
        for name, ms in per.items():
            print(f"  {name:<24s} {ms[0]:.4f} / {ms[1]:.4f} ms "
                  f"(equal to plain) [{card}]", flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"card": card, "ms": times},
                                         indent=1))


if __name__ == "__main__":
    main()
