#!/usr/bin/env python3
"""The port's span tracer on the card (bgn_torch/utils/profiling.py).

    python3 scripts/span_check.py [--bits 512 1024] [--batch 8192 2112]

For each key size (a key drawn from --seed, a batch of L1 pairs
encrypted, one Mult to warm up):
  1. one Mult under torch.cuda.set_sync_debug_mode("warn") with the
     spans recorded: every synchronizing call it warns of must lie inside
     a wait.* span; the sites are listed (also for the first, cold Mult);
     the host-to-device copies of the cold Mult and of a warm one (the
     kernels' constants go up with the key, so none), and the launches of
     the exit kernel in a warm Mult (one);
  2. an L1 and an L2 decrypt of 64 lanes, likewise;
  3. whether a torch.profiler with CUDA activity alone, as the benchmark
     traces, turns the tracer on;
  4. the spans of one Mult, by name.
Then what a span costs the host: ns per entry and exit with recording
off and on, and a traced function's call off.  Prints one JSON object
(the card's name and power limit with it); exits 1 where a synchronizing
call lay outside every wait span of a warm op.  Needs a CUDA card; builds
the kernels (build/kernels/) at first use.
"""

import argparse
import collections
import json
import random
import subprocess
import sys
import time
import warnings
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from bgn_torch import scheme  # noqa: E402
from bgn_torch.ops import cuda_rns  # noqa: E402
from bgn_torch.utils import profiling  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30)
    return out.stdout.strip()


def innermost(recorded, t: int):
    """The name of the innermost recorded span open at time t."""
    best = None
    for s in recorded:
        if s.start_ns <= t <= s.end_ns and (best is None
                                            or s.start_ns >= best.start_ns):
            best = s
    return best.name if best else None


def syncs_of(fn):
    """(result, [(innermost span, file:line)] of every synchronizing call
    that fn makes, the spans by name) with the spans recorded."""
    warned = []

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            warned.append((time.time_ns(), f"{filename}:{lineno}"))

    profiling.clear()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with profiling.recording():
                out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    recorded = profiling.spans()
    profiling.clear()
    names = collections.Counter(s.name for s in recorded)
    return out, [(innermost(recorded, t), where) for t, where in warned], \
        names


def uploads(prof) -> int:
    """Host-to-device copies a CUDA-activity profile recorded."""
    return sum(e.count for e in prof.key_averages() if "HtoD" in e.key)


def outside(found) -> list:
    return [f for f in found if not (f[0] or "").startswith("wait.")]


def span_cost(n: int) -> float:
    """ns per `with profiling.span(...)` entry and exit, loop included."""
    t = time.perf_counter_ns()
    for _ in range(n):
        with profiling.span("glue.fp2"):
            pass
    return (time.perf_counter_ns() - t) / n


def check_key(bits: int, batch: int, seed: int) -> dict:
    rng = random.Random(f"{seed}:{bits}")
    t = time.perf_counter()
    pk, sk = scheme.keygen(bits, 1021, rng=rng, device="cuda")
    ms = [rng.randrange(340) for _ in range(batch)]
    ks = [rng.randrange(1, 4) for _ in range(batch)]
    a = pk.encrypt_with_randomness(ms, [rng.randrange(1, pk.n)
                                        for _ in ms])
    b = pk.encrypt_with_randomness(ks, [rng.randrange(1, pk.n)
                                        for _ in ks])
    torch.cuda.synchronize()
    res = {"bits": bits, "batch": batch,
           "setup_s": round(time.perf_counter() - t, 3)}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, cold, _ = syncs_of(lambda: pk.mult(a, b))
    res["mult_cold_uploads"] = uploads(prof)
    exits = cuda_rns.rns_exit.launches
    out, warm, names = syncs_of(lambda: pk.mult(a, b))
    res["mult_rns_exit_launches"] = cuda_rns.rns_exit.launches - exits
    res["mult_cold_syncs"] = cold
    res["mult_syncs"] = warm
    res["mult_spans"] = dict(names)
    res["mult_spans_total"] = sum(names.values())
    tables = pk.setup_decryption(sk, rng=random.Random(seed))
    for level, ct in (("l1", a[:64]), ("l2", out[:64])):
        want = [m * k for m, k in zip(ms, ks)][:64] if level == "l2" \
            else ms[:64]
        sk.decrypt(ct, pk, tables)               # warm
        got, found, _ = syncs_of(lambda: sk.decrypt(ct, pk, tables))
        res[f"decrypt_{level}_syncs"] = found
        res[f"decrypt_{level}_right"] = [int(v) for v in got] == want
    profiling.clear()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        on = profiling._profiler_enabled()
        pk.mult(a, b)
        torch.cuda.synchronize()
    res["mult_uploads"] = uploads(prof)
    res["cuda_only_profiler_turns_on"] = on
    res["cuda_only_profiler_spans"] = len(profiling.spans())
    profiling.clear()
    res["outside_wait"] = (outside(warm) + outside(res["decrypt_l1_syncs"])
                           + outside(res["decrypt_l2_syncs"]))
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bits", type=int, nargs="+", default=[512, 1024])
    ap.add_argument("--batch", type=int, nargs="+", default=[8192, 2112])
    ap.add_argument("--seed", type=int, default=2**31 + 11)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("span_check: no CUDA card", file=sys.stderr)
        return 1
    result = {"card": card(), "torch": torch.__version__,
              "keys": [check_key(b, n, args.seed)
                       for b, n in zip(args.bits, args.batch)]}

    def noop():
        return None

    traced_noop = profiling.traced("kernels")(noop)
    n = 10**6
    t = time.perf_counter_ns()
    for _ in range(n):
        pass
    loop_ns = (time.perf_counter_ns() - t) / n
    result["span_off_ns"] = span_cost(n)
    with profiling.recording():
        result["span_on_ns"] = span_cost(profiling.MAX_SPANS // 2)
    profiling.clear()
    t = time.perf_counter_ns()
    for _ in range(n):
        noop()
    call_ns = (time.perf_counter_ns() - t) / n
    t = time.perf_counter_ns()
    for _ in range(n):
        traced_noop()
    result["traced_call_off_ns"] = (time.perf_counter_ns() - t) / n
    result["plain_call_ns"] = call_ns
    result["empty_loop_ns"] = loop_ns
    print(json.dumps(result))
    return 1 if any(k["outside_wait"] for k in result["keys"]) else 0


if __name__ == "__main__":
    sys.exit(main())
