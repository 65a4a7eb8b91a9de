"""A torch.profiler recording of a stretch of the window, reduced to what
the per-layer readers (metrics/*.py) take.

The arithmetic follows chip_smoke.py's phase 5 (`profile_op`): the raw
kineto events are read directly (key_averages() is slow over many
events), and only device-side events count as device time, so a torch op
and the kernel it launches are not both counted.  Busy time here is the
union of the device intervals inside the stretch, so overlapping
operations count once.  The stretch runs from the start of the first
traced request to the end of the last.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Any, List, Tuple

Interval = Tuple[str, int, int]      # (name, start_ns, end_ns)

REQUEST = "request"                  # the harness's span around a request
KEEP = "keep"     # ... around the kind's keep() and a synchronize


@dataclasses.dataclass
class Trace:
    """What a per-layer reader reads.  ops: device operations; spans:
    the harness's host spans of the stretch (request, the kind's call,
    synchronize, keep);
    requests: requests in the stretch; lanes: results per request; key:
    the reference's key; peaks: the card's row of peaks.json (None for a
    card that is not in it)."""

    ops: List[Interval]
    spans: List[Interval]
    t0: int
    t1: int
    requests: int
    lanes: int
    key: Any
    peaks: Any

    @property
    def window_ns(self) -> int:
        return self.t1 - self.t0

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of the device operations, clipped to the stretch."""
        clipped = sorted((max(s, self.t0), min(e, self.t1))
                         for _, s, e in self.ops if e > self.t0 and s < self.t1)
        merged: List[List[int]] = []
        for s, e in clipped:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_ns(self) -> int:
        return sum(e - s for s, e in self.busy_intervals())

    def idle_gaps(self) -> List[Tuple[int, int]]:
        """The stretches of the window in which no device operation ran."""
        gaps, at = [], self.t0
        for s, e in self.busy_intervals():
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if at < self.t1:
            gaps.append((at, self.t1))
        return gaps

    def op_ns(self, match) -> int:
        """Summed duration of the device operations whose name matches."""
        return sum(e - s for name, s, e in self.ops
                   if match(name) and e > self.t0 and s < self.t1)

    def host_doing(self, t: int) -> str:
        """The innermost harness span around time t."""
        inner = None
        for name, s, e in self.spans:
            if s <= t <= e and (inner is None or s >= inner[1]):
                inner = (name, s)
        return inner[0] if inner else "between requests"


def collect(prof) -> List[Interval]:
    """The device operations of a finished profiler (user annotations,
    which mirror host ranges on the device's timeline, left out).  Their
    clock is the host's wall clock in ns, time.time_ns(), on which the
    harness times its spans."""
    from torch.autograd import DeviceType
    ops = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or \
                getattr(e, "is_user_annotation", bool)():
            continue
        start = e.start_ns()
        ops.append((e.name(), start, start + e.duration_ns()))
    return ops


def outside(ops: List[Interval], spans: List[Interval],
            name: str) -> List[Interval]:
    """The operations that did not start inside a host span of this name:
    the harness's own device work (keep(), which synchronizes before its
    span ends) is not the program's."""
    inside = sorted((s, e) for n, s, e in spans if n == name)
    starts = [s for s, _ in inside]
    kept = []
    for op in ops:
        i = bisect.bisect_right(starts, op[1]) - 1
        if i < 0 or op[1] > inside[i][1]:
            kept.append(op)
    return kept


def stretch(spans: List[Interval]) -> Tuple[int, int, int]:
    """(t0, t1, requests) from the harness's request spans."""
    reqs = [(s, e) for name, s, e in spans if name == REQUEST]
    if not reqs:
        return 0, 0, 0
    return min(s for s, _ in reqs), max(e for _, e in reqs), len(reqs)


def breakdown(t: Trace, top: int = 10) -> dict:
    """The device operations that took most time (summed by name) and the
    longest idle gaps, each named by the harness span the host was in at
    its middle; seconds."""
    by_name: dict = {}
    for name, s, e in t.ops:
        if e > t.t0 and s < t.t1:
            by_name[name] = by_name.get(name, 0) + (min(e, t.t1) - max(s, t.t0))
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(t.idle_gaps(), key=lambda g: g[0] - g[1])[:top]
    return {
        "device_ops": [[name[:120], ns / 1e9] for name, ns in ops],
        "idle_gaps": [[t.host_doing((s + e) // 2), (e - s) / 1e9]
                      for s, e in gaps],
    }
