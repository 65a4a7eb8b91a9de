#!/usr/bin/env python3
"""The comparison's readings over many seeds in one process, for the
program and for its control; not part of a benchmark run.

    python3 portbench/control.py --workload <name> --seconds <s> \
        --seeds <n> [<n> ...] [--control]

Each seed is one run of the cell (portbench/harness.py run_cell, the
timed path at the cell's sizes, with a short window), and prints one JSON
line: the seed, whether it ran the control, the requests, and each
compared number.  With --control the port's key is built with
deterministic=False from the same parts: the program's own re-randomized
Mult, which breaks the configuration's stated guarantee (DET=true: equal
inputs give equal products), while every product still decrypts to m*k.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def control_deploy(config, key, device):
    """The port's key with the determinism guarantee broken."""
    from portbench import harness
    return harness.deploy(dict(config, deterministic=False), key, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from portbench import harness
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 1
    torch.set_num_threads(1)
    cell = harness.Cell(ROOT, args.workload)
    hooks = {"deploy": control_deploy} if args.control else None
    for seed in args.seeds:
        t = time.perf_counter()
        r = harness.run_cell(cell, seed, args.seconds, False, t,
                             hooks=hooks,
                             log=lambda m: print(m, file=sys.stderr))
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "control": args.control, "correct": r["correct"],
            "attempted": r["attempted"], "failed": r["failed"],
            "checks": r["checks"], "metrics": r["metrics"],
            "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
