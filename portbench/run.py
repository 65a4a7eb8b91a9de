#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the card it starts on.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell's configuration, traffic mix, request kind and per-layer metrics
are found by name (portbench/harness.py).  Set-up draws the key and the
inputs from the seed, builds the port's key and input batches and warms
the request; then one closed-loop client issues requests for `--seconds`.
With --trace 0 the result carries the cell's end-to-end metrics; with
--trace 1 a stretch of the window runs under torch.profiler and the
result carries the per-layer metrics, the device's busy and window
seconds and a breakdown.  Then the reference judges the outputs.

The last line of standard output is the result, one JSON object; the last
lines of standard error give each compared number beside its limit.  Exits
1 without a result when no card (or fewer than the cell asks for) is
there, or when JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()   # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def err(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown (nvidia-smi gave nothing)"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from portbench import harness
    cell = harness.Cell(ROOT, args.workload)

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        err(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); "
            f"torch sees {torch.cuda.device_count()}")
        return 1
    torch.set_num_threads(1)
    err(f"card: {card_line()}")
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), T_START, log=err)
    found = harness.forbidden_modules()
    if found:
        err("portbench: loaded in this process: " + ", ".join(found))
        return 1
    for name, c in result["checks"].items():
        err(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
