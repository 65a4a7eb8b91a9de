"""scheme.idle_ms_per_request (ms/request): the card's idle time while
the host is inside a public scheme op: the length of the traced
stretch's idle gaps (Trace.idle_gaps) that a root scheme.* span of the
program (bgn_torch's utils/profiling.py) overlaps, over the requests in
the stretch.  The rest of device.idle_share is the harness's (keep, the
synchronize after a request, between requests).  None where the program
records no span (a port without the tracer)."""


def _spans(t):
    """The program's spans that overlap the traced stretch."""
    try:
        from bgn_torch.utils import profiling
    except ImportError:
        return []
    recorded = getattr(profiling, "spans", None)
    if recorded is None:
        return []
    return [s for s in recorded() if s.end_ns > t.t0 and s.start_ns < t.t1]


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _overlap_ns(a, b) -> int:
    """The length of the intersection of two sorted lists of disjoint
    intervals."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        total += max(0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def read(t):
    spans = _spans(t)
    if not spans or t.requests == 0:
        return None
    roots = _union((max(s.start_ns, t.t0), min(s.end_ns, t.t1))
                   for s in spans
                   if s.parent is None and s.name.startswith("scheme."))
    return _overlap_ns(t.idle_gaps(), roots) / 1e6 / t.requests
