"""One run of one cell: discovery by name, set-up, the measured window,
the traced stretch, and the comparison with the reference.

Everything that belongs to one configuration, traffic mix, request kind
or per-layer metric is a file of its own, found by its name:

    BENCHMARK.json                    the cells and metrics
    portbench/configs/<config>.json   one deployment (the `file` of its entry)
    portbench/traffic/<mix>.json      one traffic mix; its "kind" names
    portbench/requests/<kind>.py      what one request does on the port
    portbench/reference/<kind>.py     what the reference expects of it
    portbench/metrics/<metric>.py     one per-layer metric's reader

A request kind module gives SPAN (the name of the host span around its
call), setup(pk, key, traffic, rng) -> state (with state.lanes),
call(state, j) -> output, keep(state, j, output) -> what the judge needs
of that output (taken at once, so that the window holds no outputs), and
judge(state, window, ref, rng, traffic) -> {check: (value, limit)}, where
window lists (j, kept) for every window request (kept None where the
request raised).  A metric module gives read(trace) -> number or
None (nothing to read: the metric is left out of the line).

The key is drawn from the seed by the reference (reference/keys.py) and
handed to the port through scheme.public_key_from_parts; the reference
gets the same host parts.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import random
import re
import sys
import time
import traceback
from pathlib import Path

from . import e2e
from . import trace as trace_mod

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "bgn_tpu")
WARM_REQUESTS = 2     # set-up's requests, of the window's one shape
TRACE_REQUESTS = 8    # requests in the traced stretch (--trace 1)


class Cell:
    """A workload of BENCHMARK.json with its files, under `root` (the
    directory that holds BENCHMARK.json and portbench/)."""

    def __init__(self, root: Path, name: str):
        bench = json.loads((root / "BENCHMARK.json").read_text())
        found = [w for w in bench["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        w = found[0]
        self.root = root
        self.name = name
        self.chips = int(w["chips"])
        entry = next(c for c in bench["configs"] if c["name"] == w["config"])
        self.config = json.loads((root / entry["file"]).read_text())
        self.traffic = json.loads(
            (root / "portbench" / "traffic" / f"{w['traffic']}.json")
            .read_text())
        if (self.traffic.get("loop"), self.traffic.get("clients")) != \
                ("closed", 1):
            raise ValueError(f"{w['traffic']}: the harness runs one "
                             "closed-loop client (loop closed, clients 1)")
        kind = self.traffic["kind"]
        self.request = load(root / "portbench" / "requests" / f"{kind}.py")
        self.reference = load(root / "portbench" / "reference" / f"{kind}.py")

        def mine(m):
            return name in m.get("workloads", [name])

        self.end_to_end = [m for m in bench["end_to_end"] if mine(m)]
        self.per_layer = [m for m in bench["per_layer"] if mine(m)]

    def reader(self, metric: str):
        return load(self.root / "portbench" / "metrics" / f"{metric}.py")


def load(path: Path):
    """Import a file of the benchmark by its path."""
    name = "portbench_file_" + re.sub(r"\W", "_", str(path.resolve()))
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def deploy(config: dict, key, device):
    """The port's public key from the reference key's host parts."""
    from bgn_torch import scheme
    return scheme.public_key_from_parts(
        key.key_bits, key.n, key.l, key.p, config["msg_space"],
        bool(config["deterministic"]),
        scheme.PolyEncodingParams(config["poly_base"],
                                  config["fp_scale_base"],
                                  config["fp_precision"]),
        key.P, key.Q, n_digits="naf", validate=False, device=device)


def make_key(config: dict, seed: int):
    from .reference import keys
    return keys.keygen(config["key_bits"], config["msg_space"],
                       random.Random(f"{seed}:key"))


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool,
             t_start: float, device: str = "cuda", hooks=None,
             log=print) -> dict:
    """One run; returns the result line's object.  t_start: the
    perf_counter reading at process start.  hooks (for the control and
    the fault tests): "deploy" replaces deploy(), "call" wraps the
    request call as call(state, j, inner)."""
    import torch
    hooks = hooks or {}
    req, traffic = cell.request, cell.traffic
    on_card = device == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def held():
        return torch.cuda.memory_allocated() if on_card else 0

    marks = [time.perf_counter()]
    key = make_key(cell.config, seed)
    marks.append(time.perf_counter())
    pk = hooks.get("deploy", deploy)(cell.config, key, device)
    marks.append(time.perf_counter())
    sync()
    held_key = held()
    state = req.setup(pk, key, traffic, random.Random(f"{seed}:inputs"))
    sync()
    held_inputs = held() - held_key
    marks.append(time.perf_counter())
    inner = req.call
    call = inner if "call" not in hooks else \
        (lambda s, j: hooks["call"](s, j, inner))
    for _ in range(WARM_REQUESTS):     # the second also warms keep()
        out = call(state, 0)
        sync()
        req.keep(state, 0, out)
    del out
    held_kept = held() - held_key - held_inputs
    if traced:   # the profiler's first start (CUPTI) belongs to set-up
        with _profiler(torch, on_card):
            call(state, 0)
            sync()
    spans = []   # (name, start, end) on the profiler's clock, while it runs

    @contextlib.contextmanager
    def timed_span(name):
        t = time.time_ns()
        try:
            yield
        finally:
            if prof is not None:
                spans.append((name, t, time.time_ns()))

    def span(name):
        return timed_span(name) if traced else contextlib.nullcontext()

    sync()
    marks.append(time.perf_counter())
    log("setup: " + ", ".join(
        f"{what} {b - a:.3f} s" for what, a, b in zip(
            ("imports and start", "key", "port key", "inputs", "warm-up"),
            [t_start] + marks, marks)))
    log(f"memory held: port key {held_key} B, inputs {held_inputs} B, "
        f"kept after warm-up {held_kept} B; peak so far "
        f"{torch.cuda.max_memory_allocated() if on_card else 0} B")
    gc.collect()
    gc.freeze()
    window, lat, ends, ok = [], [], [], []
    prof, recorded, n_traced = None, None, 0
    errors = []
    t_w0 = time.perf_counter()
    setup_s = t_w0 - t_start
    trace_from = t_w0 + 0.25 * seconds
    deadline = t_w0 + seconds
    i = 0
    while True:
        t0 = time.perf_counter()
        if t0 >= deadline:
            break
        if traced and recorded is None and prof is None and t0 >= trace_from:
            prof = _profiler(torch, on_card)
            prof.__enter__()
        j = i % traffic["pool"]
        out, good = None, False
        with span(trace_mod.REQUEST):
            try:
                with span(req.SPAN):
                    out = call(state, j)
                with span("synchronize"):
                    sync()
                good = True
            except Exception:          # a failed request is counted
                errors.append(traceback.format_exc(limit=3))
        t1 = time.perf_counter()
        kept = None
        if good:
            with span(trace_mod.KEEP):     # ends with keep()'s work done
                kept = req.keep(state, j, out)
                sync()
        out = None
        window.append((j, kept))
        lat.append(t1 - t0)
        ends.append(t1)
        ok.append(good)
        i += 1
        if prof is not None:
            n_traced += 1
            if n_traced == TRACE_REQUESTS:
                prof.__exit__(None, None, None)
                recorded, prof = prof, None
    if prof is not None:
        prof.__exit__(None, None, None)
        recorded = prof
    gc.unfreeze()
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    for e in errors[:2]:
        log(e)

    metrics, dev_extra, breakdown = {}, {}, None
    if traced and recorded is not None:
        t = _trace_of(recorded, spans, state.lanes, key, device)
        for m in cell.per_layer:
            value = cell.reader(m["name"]).read(t)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev_extra = {"busy_s": t.busy_ns() / 1e9,
                     "window_s": t.window_ns / 1e9}
        breakdown = trace_mod.breakdown(t)
    elif not traced:
        values = {
            "results_per_s": e2e.results_per_s(t_w0, ends, state.lanes, ok),
            "request_p95_ms": e2e.request_p95_ms(lat),
            "setup_s": setup_s,
        }
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}

    checks = req.judge(state, window, cell.reference,
                       random.Random(f"{seed}:sample"), traffic)
    result = {
        "correct": all(v <= lim for v, lim in checks.values()),
        "attempted": len(window),
        "failed": ok.count(False),
        "metrics": metrics,
        "device": dict({
            "platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
            "count": cell.chips,
            "memory_peak_bytes": int(memory_peak),
        }, **dev_extra),
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, (v, lim) in checks.items()}
    return result


def _profiler(torch, on_card: bool):
    """The card's activity alone, so that the host's ~2,000 op calls a
    request are not recorded too; the harness times its own host
    spans."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CUDA if on_card
                               else ProfilerActivity.CPU])


def _trace_of(prof, spans, lanes: int, key, device) -> trace_mod.Trace:
    ops = trace_mod.outside(trace_mod.collect(prof), spans, trace_mod.KEEP)
    t0, t1, n = trace_mod.stretch(spans)
    return trace_mod.Trace(ops=ops, spans=spans, t0=t0, t1=t1, requests=n,
                           lanes=lanes, key=key, peaks=peaks_of(device))


def peaks_of(device: str):
    """The card's row of peaks.json, matched by a substring of its name."""
    if device != "cuda":
        return None
    import torch
    name = torch.cuda.get_device_name(0)
    table = json.loads((HERE / "peaks.json").read_text())
    for row in table["cards"]:
        if row["match"] in name:
            return row
    return None
