"""The port's span tracer (bgn_torch/utils/profiling.py) on the CPU, on
a 64-bit key: nothing is recorded without a profiler or recording(); a
Mult under the CPU profiler records one scheme.mult root whose pairing,
glue, kernel and wait spans share its op id and nest in their parents;
every torch op of the RNS Mult falls inside a glue.* or kernels.* span
(counted here by a dispatch mode, never in the program); profiling.trace
writes the spans into its Chrome trace; the four program_span readers of
portbench/metrics on synthetic spans and in a traced run of a tiny cell,
whose program spans nest inside the harness's scheme.mult spans.
"""
import _torch_threads  # noqa: F401  (first: one torch thread per process)
import collections
import glob
import json
import random
import time
import types
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from bgn_torch import scheme
from bgn_torch.ops import rns_pairing
from bgn_torch.utils import profiling
from portbench import harness
from portbench import trace as trace_mod
from portbench.conftest import make_root

METRICS = Path(__file__).resolve().parent.parent / "portbench" / "metrics"
READERS = ("scheme.host_waits_per_request", "scheme.idle_ms_per_request",
           "glue.idle_ms_per_request", "glue.host_ms_per_request")
MULT_LAYERS = {"pairing.miller", "pairing.final_exp", "glue.to_rns",
               "glue.fp2", "glue.from_rns", "glue.select",
               "kernels.miller_loop", "kernels.pow_loop",
               "kernels.fp2_pow_loop", "kernels.rns_exit"}


@pytest.fixture(scope="module")
def key():
    pk, sk = scheme.keygen(64, 1021, rng=random.Random(5), device="cpu")
    a = pk.encrypt_with_randomness([1, 2, 0, 5], [5, 6, 7, 8])
    b = pk.encrypt_with_randomness([2, 3, 4, 0], [9, 10, 11, 12])
    return pk, sk, a, b


@pytest.fixture(scope="module")
def profiled_mult(key):
    """The spans of one Mult under the CPU profiler, as the benchmark's
    traced CPU runs take them."""
    pk, _, a, b = key
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        out = pk.mult(a, b)
    recorded = profiling.spans()
    profiling.clear()
    return recorded, out


def _waits(recorded):
    return collections.Counter(s.name for s in recorded
                               if s.name.startswith("wait."))


def test_nothing_recorded_when_off(key):
    pk, _, a, b = key
    profiling.clear()
    pk.mult(a, b)
    assert profiling.spans() == []
    assert profiling.span("glue.fp2") is profiling.span("kernels.x")


def test_recording_block_and_bound():
    profiling.clear()
    with profiling.recording():
        with profiling.recording():
            with profiling.span("a"):
                pass
        with profiling.span("b"):
            pass
    with profiling.span("c"):
        pass
    assert [s.name for s in profiling.spans()] == ["a", "b"]
    with profiling.recording():
        for _ in range(profiling.MAX_SPANS + 3):
            with profiling.span("d"):
                pass
    kept = profiling.spans()
    profiling.clear()
    assert len(kept) == profiling.MAX_SPANS and kept[-1].name == "d"
    assert profiling.spans() == []


def test_mult_spans_nest_under_one_root(profiled_mult, key):
    recorded, out = profiled_mult
    pk, _, a, b = key
    assert torch.equal(out.data, pk.mult(a, b).data)
    roots = [s for s in recorded if s.parent is None]
    assert [r.name for r in roots] == ["scheme.mult"]
    by_sid = {s.sid: s for s in recorded}
    for s in recorded:
        assert s.op == roots[0].sid
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            up = by_sid[s.parent]
            assert up.start_ns <= s.start_ns and s.end_ns <= up.end_ns


def test_mult_records_each_layer(profiled_mult):
    recorded, _ = profiled_mult
    names = {s.name for s in recorded}
    assert MULT_LAYERS <= names
    for s in recorded:
        if s.name.startswith("kernels."):
            assert s.counts == {"launches": 0}     # the plain versions
        else:
            assert s.counts is None
    assert _waits(recorded) == {"wait.fp2_pow_sign": 1}


@pytest.mark.parametrize("mode, waits", [
    ("loop", {"wait.fp2_pow_sign": 1}),
    ("1", {"wait.fp2_pow_sign": 1, "wait.digits_to_host": 3}),
])
def test_mult_wait_sites(key, monkeypatch, mode, waits):
    """The host reads of a Mult in each kernel granularity: the sign check
    of l's digits, and in step mode the three digit strings read back for
    the host loops of step launches."""
    pk, _, a, b = key
    monkeypatch.setattr(rns_pairing, "_PALLAS_MODE", mode)
    profiling.clear()
    with profiling.recording():
        pk.mult(a, b)
    recorded = profiling.spans()
    profiling.clear()
    assert _waits(recorded) == waits


@pytest.mark.parametrize("level2", [False, True])
def test_decrypt_wait_sites(key, level2):
    """A decrypt's host reads: q1's digits copied to the key's device for
    the loop kernel, and the values and flags read back."""
    pk, sk, a, b = key
    ct = pk.mult(a, b) if level2 else a
    tables = pk.setup_decryption(sk, rng=random.Random(1))
    profiling.clear()
    with profiling.recording():
        got = sk.decrypt(ct, pk, tables)
    recorded = profiling.spans()
    profiling.clear()
    assert list(got) == ([2, 6, 0, 0] if level2 else [1, 2, 0, 5])
    assert _waits(recorded) == {"wait.digits_to_device": 1,
                                "wait.decrypt_status": 1}
    assert {s.name for s in recorded if s.parent is None} == {
        "scheme.decrypt"}


class _OpTimes(TorchDispatchMode):
    """The host clock at each torch op dispatched inside the mode."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append((time.time_ns(), str(func)))
        return func(*args, **(kwargs or {}))


def test_every_op_of_a_mult_in_glue_or_kernels(key):
    pk, _, a, b = key
    profiling.clear()
    with profiling.recording(), _OpTimes() as mode:
        pk.mult(a, b)
    layers = [(s.start_ns, s.end_ns) for s in profiling.spans()
              if s.name.startswith(("glue.", "kernels."))]
    profiling.clear()
    outside = [name for t, name in mode.ops
               if not any(s <= t <= e for s, e in layers)]
    assert len(mode.ops) > 1000 and outside == []


def test_trace_writes_the_spans(tmp_path):
    x = torch.arange(1 << 12, dtype=torch.float32)
    profiling.clear()
    with profiling.trace(str(tmp_path / "tr")):
        with profiling.span("glue.test"):
            torch.mul(x, 3)
    profiling.clear()
    (path,) = glob.glob(str(tmp_path / "tr" / "trace_*.json"))
    events = json.load(open(path))["traceEvents"]
    (sp,) = [e for e in events if e.get("cat") == "bgn_span"]
    (mul,) = [e for e in events if e.get("name") == "aten::mul"]
    assert sp["name"] == "glue.test" and sp["args"]["parent"] is None
    # one clock: the op lies inside the span on the trace's time line
    assert sp["ts"] <= mul["ts"]
    assert mul["ts"] + mul["dur"] <= sp["ts"] + sp["dur"]


# ---------------------------------------------------------------------------
# The readers of portbench/metrics on synthetic spans
# ---------------------------------------------------------------------------


def _span(name, s, e, sid, parent=None):
    return types.SimpleNamespace(name=name, start_ns=s, end_ns=e, sid=sid,
                                 parent=parent, op=1, counts=None)


def _trace(ops, t0=0, t1=1000, requests=2):
    return trace_mod.Trace(ops=ops, spans=[], t0=t0, t1=t1,
                           requests=requests, lanes=8, key=None, peaks=None)


def _read(name, t):
    return harness.load(METRICS / f"{name}.py").read(t)


def _with_spans(monkeypatch, spans):
    monkeypatch.setattr(profiling, "spans", lambda: list(spans))


def test_readers_split_a_gap_across_two_spans(monkeypatch):
    """The gap [100, 400] falls to scheme.mult (20 + 20), glue.a (130)
    and kernels.k (130)."""
    _with_spans(monkeypatch, [
        _span("scheme.mult", 50, 450, 1), _span("glue.a", 120, 250, 2, 1),
        _span("kernels.k", 250, 380, 3, 1)])
    t = _trace([("k", 0, 100), ("k", 400, 1000)])
    assert _read("glue.idle_ms_per_request", t) == pytest.approx(65e-6)
    assert _read("scheme.idle_ms_per_request", t) == pytest.approx(150e-6)
    assert _read("glue.host_ms_per_request", t) == pytest.approx(65e-6)
    assert _read("scheme.host_waits_per_request", t) == 0


def test_readers_leave_out_a_gap_outside_every_span(monkeypatch):
    _with_spans(monkeypatch, [
        _span("scheme.mult", 0, 400, 1), _span("glue.a", 100, 300, 2, 1),
        _span("wait.w", 150, 200, 3, 2)])
    # gaps [50, 120] (scheme.mult 50, glue.a 20), [500, 600] (no span),
    # the stretch clipped at 1000: [900, 1000] (no span)
    t = _trace([("k", 0, 50), ("k", 120, 500), ("k", 600, 900)])
    assert _read("scheme.idle_ms_per_request", t) == pytest.approx(35e-6)
    assert _read("glue.idle_ms_per_request", t) == pytest.approx(10e-6)
    assert _read("scheme.host_waits_per_request", t) == 0.5


def test_glue_self_time_leaves_out_nested_children(monkeypatch):
    _with_spans(monkeypatch, [
        _span("scheme.mult", 0, 900, 1),
        _span("glue.a", 100, 300, 2, 1), _span("wait.w", 150, 200, 3, 2),
        _span("glue.b", 400, 500, 4, 1), _span("kernels.k", 410, 440, 5, 4),
        _span("kernels.k", 430, 460, 6, 4),
        _span("glue.c", 950, 1200, 7)])      # clipped to the stretch
    t = _trace([("k", 0, 1000)])
    # glue.a 200 - 50, glue.b 100 - 50, glue.c 50: 250 ns over 2 requests
    assert _read("glue.host_ms_per_request", t) == pytest.approx(125e-6)
    assert _read("glue.idle_ms_per_request", t) == 0


def test_readers_give_none_without_spans(monkeypatch):
    t = _trace([("k", 0, 100)])
    _with_spans(monkeypatch, [])
    assert all(_read(name, t) is None for name in READERS)
    _with_spans(monkeypatch, [_span("scheme.mult", 2000, 3000, 1)])
    assert all(_read(name, t) is None for name in READERS)
    monkeypatch.delattr(profiling, "spans")    # a port without the tracer
    assert all(_read(name, t) is None for name in READERS)


NESTING = '''
from bgn_torch.utils import profiling


def read(t):
    calls = [(s, e) for name, s, e in t.spans if name == "scheme.mult"]
    mine = [s for s in profiling.spans() if t.t0 <= s.start_ns < t.t1]
    inside = [any(a <= s.start_ns and s.end_ns <= b for a, b in calls)
              for s in mine]
    return {SIDE}
'''


def test_traced_cell_reads_the_program_spans(tmp_path):
    """A traced CPU run of the 64-bit cell tiny.mult: the four readers
    read, and every program span of the stretch lies inside one of the
    harness's scheme.mult spans, on the one clock."""
    root = make_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for side, expr in (("in", "sum(inside)"),
                       ("out", "len(inside) - sum(inside)")):
        (root / f"portbench/metrics/test.spans_{side}.py").write_text(
            NESTING.replace("{SIDE}", expr))
        bench["per_layer"].append({
            "name": f"test.spans_{side}", "unit": "spans", "better": "lower",
            "source": "program_span", "layer": "scheme",
            "moves": "results_per_s", "workloads": ["tiny.mult"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    profiling.clear()
    r = harness.run_cell(harness.Cell(root, "tiny.mult"), 2**31 + 17, 3.0,
                         True, time.perf_counter(), device="cpu",
                         log=lambda *_: None)
    profiling.clear()
    assert r["correct"]
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert all(m.get(name) is not None for name in READERS), m
    assert m["scheme.host_waits_per_request"] == 1
    assert 0 < m["glue.host_ms_per_request"]
    assert 0 <= m["glue.idle_ms_per_request"] <= m["scheme.idle_ms_per_request"]
    assert m["test.spans_in"] >= len(MULT_LAYERS) and m["test.spans_out"] == 0
