"""pytest settings of the benchmark's own tests (portbench/tests)."""

import json
import shutil
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent

TINY_CONFIG = {
    "name": "tiny", "source": "a 64-bit key for the CPU tests",
    "key_bits": 64, "msg_space": 1021, "poly_base": 3, "fp_scale_base": 3,
    "fp_precision": 0.0001, "deterministic": True, "assumed": {},
    "reduced": [],
}
TINY_TRAFFIC = {
    "kind": "mult", "why": "CPU tests", "loop": "closed", "clients": 1,
    "batch": 8, "pool": 2, "m_below": 340, "k_values": [1, 2, 3],
    "check_lanes": 4,
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips where torch sees none")


def make_root(tmp: Path, cells=None) -> Path:
    """A copy of the benchmark's files under tmp with a 64-bit cell,
    tiny.mult, in its BENCHMARK.json (the real cells kept)."""
    shutil.copytree(HERE, tmp / "portbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    (tmp / "portbench/configs/tiny.json").write_text(json.dumps(TINY_CONFIG))
    (tmp / "portbench/traffic/tiny.json").write_text(json.dumps(TINY_TRAFFIC))
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny", "source": "CPU tests",
                             "file": "portbench/configs/tiny.json",
                             "reduced": [], "why": "CPU tests"})
    bench["workloads"].append({"name": "tiny.mult", "config": "tiny",
                               "traffic": "tiny", "chips": 1,
                               "why": "CPU tests"})
    for m in bench["per_layer"]:
        m["workloads"].append("tiny.mult")
    for c in cells or ():
        bench["workloads"].append(c)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)
