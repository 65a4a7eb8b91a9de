"""Profiling helpers: a torch.profiler trace of the enclosed ops and a
wall-clock op timer (the port's counterpart of
`bgn_tpu/utils/profiling.py`; the reference has only `go test -bench`)."""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Callable

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Record the enclosed ops with torch.profiler (CPU activity, and CUDA
    activity when a card is present) and write one Chrome trace into
    log_dir (trace_<pid>_<ns>.json); yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


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
