#!/usr/bin/env python3
"""Compare the SASS of two builds of bgn_torch/csrc, function by function.

    python3 scripts/sass_diff.py OTHER_CSRC [--out build/sass_diff.json]

It compiles every *.cu of bgn_torch/csrc and of OTHER_CSRC (the csrc/ of
another tree, e.g. a parent commit unpacked with `git archive`) with the
flags of bgn_torch/_build.py into build/sass_diff/, one nvcc per source,
all started together, reads each object's SASS with cuobjdump -sass, and
prints per source the functions whose SASS is byte-identical in both
builds, the functions whose SASS differs, and those in one build only.
Needs the CUDA toolkit (nvcc, cuobjdump), not a card.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def functions(sass: str) -> dict:
    """{mangled name: its SASS lines} from cuobjdump -sass output."""
    out, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            cur = line.split("Function :", 1)[1].strip()
            out[cur] = []
        elif cur is not None and line.strip():
            out[cur].append(line.rstrip())
    return out


def build_sass(csrc: Path, work: Path, nvcc: str, arch: str) -> dict:
    """{source name: {function: SASS lines}} of every *.cu in csrc."""
    work.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in sorted(csrc.glob("*.cu")):
        obj = work / (src.stem + ".o")
        procs.append((src, obj, subprocess.Popen(
            [nvcc, arch, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-c",
             str(src), "-o", str(obj)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    cuobjdump = str(Path(nvcc).parent / "cuobjdump")
    out = {}
    for src, obj, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}\n{log}")
        out[src.name] = functions(subprocess.run(
            [cuobjdump, "-sass", str(obj)], capture_output=True, text=True,
            check=True).stdout)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", help="the other tree's bgn_torch/csrc")
    ap.add_argument("--out", default=str(ROOT / "build"
                                         / "sass_diff.json"))
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    from bgn_torch import _build
    nvcc = _build._nvcc()
    work = _build.BUILD_DIR.parent / "sass_diff"
    shutil.rmtree(work, ignore_errors=True)
    mine = build_sass(_build.CSRC, work / "this", nvcc, _build.ARCH)
    other = build_sass(Path(args.other), work / "other", nvcc, _build.ARCH)
    report = {}
    for src in sorted(set(mine) | set(other)):
        a, b = mine.get(src, {}), other.get(src, {})
        rec = {"identical": sorted(f for f in a if f in b and a[f] == b[f]),
               "differs": sorted(f for f in a if f in b and a[f] != b[f]),
               "this_only": sorted(set(a) - set(b)),
               "other_only": sorted(set(b) - set(a))}
        report[src] = rec
        print(f"{src}: {len(rec['identical'])} functions identical, "
              f"{len(rec['differs'])} differ, {len(rec['this_only'])} "
              f"only here, {len(rec['other_only'])} only in the other "
              "build", flush=True)
        for key in ("differs", "this_only", "other_only"):
            for f in rec[key]:
                print(f"  {key}: {f}", flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
