"""A configuration, a traffic mix, a request kind and a per-layer metric
added as new files, with new entries in BENCHMARK.json, run without an
edit to any file that is there."""

import hashlib
import json
import time

import torch

from portbench import harness
from portbench.conftest import HERE

torch.set_num_threads(1)

CONFIG = {"name": "tiny96", "source": "a 96-bit key for the CPU tests",
          "key_bits": 96, "msg_space": 1021, "poly_base": 3,
          "fp_scale_base": 3, "fp_precision": 0.0001, "deterministic": True,
          "assumed": {}, "reduced": []}
TRAFFIC = {"kind": "add_l1", "why": "CPU tests", "loop": "closed",
           "clients": 1, "batch": 8, "pool": 2}
KIND = '''
import dataclasses
SPAN = "scheme.add"


@dataclasses.dataclass
class State:
    pk: object
    key: object
    inputs: list
    cts: list
    lanes: int


def setup(pk, key, traffic, rng):
    B = traffic["batch"]
    inputs, cts = [], []
    for _ in range(traffic["pool"]):
        ms = [rng.randrange(100) for _ in range(2 * B)]
        rs = [rng.randrange(1, key.n) for _ in range(2 * B)]
        inputs.append((ms, rs))
        cts.append((pk.encrypt_with_randomness(ms[:B], rs[:B]),
                    pk.encrypt_with_randomness(ms[B:], rs[B:])))
    return State(pk, key, inputs, cts, B)


def call(state, j):
    return state.pk.add(*state.cts[j])


def keep(state, j, out):
    return out


def judge(state, window, ref, rng, traffic):
    wrong = 0
    for j, out in window:
        want = ref.expect(state.key, *state.inputs[j])
        got = [None if s == "O" else tuple(int(v, 16) for v in s[1:-1].split(","))
               for s in out.string(state.pk).splitlines()]
        wrong += sum(g != w for g, w in zip(got, want))
    return {"lanes_wrong": (wrong, 0)}
'''
REFERENCE = '''
from portbench.reference import pairing


def expect(key, ms, rs):
    B = len(ms) // 2
    return [pairing.encrypt(ms[x] + ms[B + x], rs[x] + rs[B + x], key.P,
                            key.Q, key.p) for x in range(B)]
'''
METRIC = '''
def read(t):
    calls = [e - s for name, s, e in t.spans if name == "scheme.add"]
    return sum(calls) / len(calls) / 1e6 if calls else None
'''


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_new_files_run_without_edits(tiny_root):
    before = _digests(tiny_root)
    pb = tiny_root / "portbench"
    (pb / "configs/tiny96.json").write_text(json.dumps(CONFIG))
    (pb / "traffic/add-b8.json").write_text(json.dumps(TRAFFIC))
    (pb / "requests/add_l1.py").write_text(KIND)
    (pb / "reference/add_l1.py").write_text(REFERENCE)
    (pb / "metrics/host.call_ms_per_request.py").write_text(METRIC)
    bench_path = tiny_root / "BENCHMARK.json"
    bench = json.loads(bench_path.read_text())
    bench["configs"].append({"name": "tiny96", "source": "CPU tests",
                             "file": "portbench/configs/tiny96.json",
                             "reduced": [], "why": "CPU tests"})
    bench["workloads"].append({"name": "tiny96.add", "config": "tiny96",
                               "traffic": "add-b8", "chips": 1,
                               "why": "CPU tests"})
    bench["per_layer"].append({
        "name": "host.call_ms_per_request", "unit": "ms/request",
        "better": "lower", "source": "program_span", "layer": "host",
        "moves": "results_per_s", "workloads": ["tiny96.add"]})
    bench_path.write_text(json.dumps(bench))

    after = _digests(tiny_root)
    changed = {p for p in before if after[p] != before[p]}
    assert changed == {bench_path.relative_to(tiny_root)}
    for rel, digest in before.items():     # the copy is the benchmark
        if rel.parts[0] == "portbench" and "tiny" not in rel.name:
            assert digest == hashlib.sha256(
                (HERE.parent / rel).read_bytes()).hexdigest(), rel

    cell = harness.Cell(tiny_root, "tiny96.add")
    assert cell.config["key_bits"] == 96 and cell.request.SPAN == "scheme.add"
    r = harness.run_cell(cell, 31, 1.5, False, time.perf_counter(),
                         device="cpu")
    assert r["correct"] and r["checks"]["lanes_wrong"]["value"] == 0
    assert set(r["metrics"]) == {"results_per_s", "request_p95_ms",
                                 "setup_s"}
    r = harness.run_cell(cell, 32, 1.5, True, time.perf_counter(),
                         device="cpu")
    assert r["correct"]
    assert r["metrics"]["host.call_ms_per_request"]["value"] > 0
    assert r["metrics"]["host.call_ms_per_request"]["unit"] == "ms/request"
