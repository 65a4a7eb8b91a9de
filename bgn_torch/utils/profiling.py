"""Profiling helpers: the program's span tracer, a torch.profiler trace of
the enclosed ops and a wall-clock op timer (the port's counterpart of
`bgn_tpu/utils/profiling.py`; the reference has only `go test -bench`).

The tracer records a span at each layer boundary of the port: its name,
start and end on `time.time_ns()` (the clock of torch.profiler's kineto
events, so a device idle gap can be set against what the program was
doing), the span that caused it (`parent`), the op id that every span of
one public scheme op shares (a span opened with none open is a root and
takes a fresh id), and counts (a kernel wrapper's launches).  Names:

    scheme.<op>       a public BGNPublicKey / BGNSecretKey op (root)
    pairing.miller    the Miller loop: conversions in and its kernel
    pairing.final_exp the final exponentiation
    glue.<part>       torch ops between two kernels: to_rns, from_rns,
                      fp2 (F_p^2 arithmetic), select (identity lanes)
    kernels.<name>    an ops/cuda_rns.py wrapper (its plain version on
                      the CPU); count "launches"
    wait.<site>       a host read of a device value: the host blocks
                      until the card has finished what was queued

Recording is on only while a torch profiler runs or inside `recording()`;
off, `span` is one check and allocates nothing.  Spans are kept in
memory, the last MAX_SPANS of them; `trace(log_dir)` writes those it
recorded into its Chrome trace."""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import itertools
import json
import os
import threading
import time
from typing import Callable

import torch

MAX_SPANS = 1 << 16
_SPAN_TID = 0x7FFFFFFF     # the spans' track in a Chrome trace

_profiler_enabled = torch._C._autograd._profiler_enabled


class _Tracer:
    """The process's recorder: the buffer of finished spans, the open
    spans of each thread, the depth of `recording()` blocks."""

    def __init__(self):
        self.done = collections.deque(maxlen=MAX_SPANS)
        self.local = threading.local()
        self.lock = threading.Lock()
        self.forced = 0
        self.ids = itertools.count(1)

    def open(self) -> list:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack


_TRACER = _Tracer()


class Span:
    """One span: name, start_ns, end_ns, sid (its id), parent (the sid of
    the span that was open when it began, None for a root), op (the op
    id it shares with its root) and counts (a dict, or None)."""

    __slots__ = ("name", "start_ns", "end_ns", "sid", "parent", "op",
                 "counts", "_counter", "_launches")

    def __init__(self, name: str, counter=None):
        self.name = name
        self._counter = counter
        self.counts = None

    def __enter__(self):
        stack = _TRACER.open()
        self.sid = next(_TRACER.ids)
        if stack:
            top = stack[-1]
            self.parent, self.op = top.sid, top.op
        else:
            self.parent, self.op = None, self.sid
        if self._counter is not None:
            self._launches = self._counter.launches
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.end_ns = time.time_ns()
        stack = _TRACER.open()
        stack.pop()
        if self._counter is not None:
            self.counts = {"launches": self._counter.launches
                           - self._launches}
            self._counter = None
        _TRACER.done.append(self)
        return False


class _Off:
    """The span given while nothing records: enters and exits, records
    nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_OFF = _Off()


def span(name: str, counter=None):
    """A context manager that records one span named `name` while a torch
    profiler runs or a `recording()` block is open.  counter: an object
    with an integer `launches` attribute (a kernel wrapper); the span
    counts how much it grew inside."""
    if _TRACER.forced or _profiler_enabled():
        return Span(name, counter)
    return _OFF


def traced(layer: str, launches: bool = False):
    """Decorator: every call of the function runs inside a span
    <layer>.<its name>.  launches: the function is a kernel wrapper, whose
    `launches` the span counts."""
    def wrap(fn):
        name = f"{layer}.{fn.__name__}"

        @functools.wraps(fn)
        def traced_fn(*args, **kwargs):
            with span(name, traced_fn if launches else None):
                return fn(*args, **kwargs)

        return traced_fn

    return wrap


@contextlib.contextmanager
def recording():
    """Record spans inside the block, with or without a profiler."""
    with _TRACER.lock:
        _TRACER.forced += 1
    try:
        yield
    finally:
        with _TRACER.lock:
            _TRACER.forced -= 1


def spans() -> list:
    """The recorded spans, oldest first by end (at most MAX_SPANS)."""
    return list(_TRACER.done)


def clear() -> None:
    """Drop every recorded span."""
    _TRACER.done.clear()


def _chrome_events(recorded, base_ns: int) -> list:
    """The spans as complete events ("ph": "X", microseconds from
    base_ns) of the process's Chrome trace, on a track of their own."""
    pid = os.getpid()
    return [{"ph": "M", "name": "thread_name", "pid": pid,
             "tid": _SPAN_TID, "args": {"name": "bgn_torch spans"}}] + [
        {"ph": "X", "cat": "bgn_span", "name": s.name, "pid": pid,
         "tid": _SPAN_TID, "ts": (s.start_ns - base_ns) / 1e3,
         "dur": (s.end_ns - s.start_ns) / 1e3,
         "args": {"sid": s.sid, "parent": s.parent, "op": s.op,
                  **(s.counts or {})}}
        for s in recorded]


@contextlib.contextmanager
def trace(log_dir: str):
    """Record the enclosed ops with torch.profiler (CPU activity, and CUDA
    activity when a card is present) and write one Chrome trace into
    log_dir (trace_<pid>_<ns>.json), with the program's spans recorded
    meanwhile as events of their own track; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    t0 = time.time_ns()
    with profile(activities=activities) as prof:
        yield prof
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    doc["traceEvents"].extend(_chrome_events(
        [s for s in _TRACER.done if s.start_ns >= t0],
        int(doc.get("baseTimeNanoseconds", 0))))
    with open(path, "w") as f:
        json.dump(doc, f)


def _on_cuda(out) -> bool:
    """Whether any tensor in out (tensors, sequences, dicts, dataclasses
    such as a Ciphertext, named tuples) lies on a card."""
    if isinstance(out, torch.Tensor):
        return out.is_cuda
    if isinstance(out, dict):
        return any(_on_cuda(v) for v in out.values())
    if isinstance(out, (list, tuple)):
        return any(_on_cuda(v) for v in out)
    if dataclasses.is_dataclass(out) and not isinstance(out, type):
        return any(_on_cuda(getattr(out, f.name))
                   for f in dataclasses.fields(out))
    return False


def time_op(fn: Callable, *args, iters: int = 10, warmup: int = 1) -> float:
    """Seconds per call of fn(*args) over `iters` calls after `warmup`
    calls; the card is synchronized after the warm-up and after the timed
    loop whenever an output tensor lies on it."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    if _on_cuda(out):
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    if _on_cuda(out):
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters
