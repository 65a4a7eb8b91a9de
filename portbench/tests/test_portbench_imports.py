"""The benchmark loads nothing of JAX or the JAX package, and its
reference loads nothing of the program."""

import ast
import json
import subprocess
import sys

from portbench.conftest import HERE

REPO = HERE.parent
BANNED = {"jax", "jaxlib", "flax", "bgn_tpu"}


def _top_names(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_run_loads_no_jax():
    """run.py and every module a run loads (a traced and an untraced run
    of a CPU cell, every real cell's files, every metric reader)."""
    names = _top_names(f"""
import importlib.util, json, pathlib, sys, tempfile, time
sys.path.insert(0, {str(REPO)!r})
spec = importlib.util.spec_from_file_location("portbench_run",
                                              {str(HERE / 'run.py')!r})
spec.loader.exec_module(importlib.util.module_from_spec(spec))
import torch
torch.set_num_threads(1)
from portbench import conftest, control, harness
bench = json.loads(pathlib.Path({str(REPO / 'BENCHMARK.json')!r}).read_text())
for w in bench["workloads"]:
    cell = harness.Cell(pathlib.Path({str(REPO)!r}), w["name"])
    for m in cell.per_layer:
        cell.reader(m["name"])
root = conftest.make_root(pathlib.Path(tempfile.mkdtemp()))
cell = harness.Cell(root, "tiny.mult")
for traced in (False, True):
    harness.run_cell(cell, 3, 1.0, traced, time.perf_counter(), device="cpu")
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
""")
    assert "bgn_torch" in names and "portbench" in names
    assert not names & BANNED


def test_reference_loads_no_program():
    names = _top_names(f"""
import json, random, sys
sys.path.insert(0, {str(REPO)!r})
from portbench import harness
from portbench.reference import hostmath, keys, pairing
ref = harness.load(harness.HERE / "reference" / "mult.py")
k = keys.keygen(64, 1021, random.Random(1))
ref.expect(k, [(0, x, 3, 2, 5 + x, 7) for x in range(2 * ref.LANES_PER_WORKER)])
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
""")
    assert "portbench" in names
    assert not names & (BANNED | {"bgn_torch", "torch"})


def test_reference_sources_import_no_program():
    for path in sorted((HERE / "reference").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                tops = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                tops = {node.module.split(".")[0]}
            else:
                continue
            assert not tops & (BANNED | {"bgn_torch"}), (path, tops)
