"""glue.idle_ms_per_request (ms/request): the card's idle time while the
host issues glue, the torch ops between two kernels: each idle gap of
the traced stretch (Trace.idle_gaps) is cut where the program's spans
(bgn_torch's utils/profiling.py) begin and end, and each piece goes to
the innermost span open over it; the pieces whose span is glue.* are
summed, over the requests in the stretch.  None where the program
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


def innermost(spans, t0: int, t1: int) -> list:
    """(start, end, name) pieces of [t0, t1] by the innermost open span,
    in time order; spans nest (one thread), a child inside its parent."""
    by_sid = {s.sid: s for s in spans}

    def depth(s):
        d = 0
        while s.parent in by_sid:
            s, d = by_sid[s.parent], d + 1
        return d

    events = []
    for s in spans:
        d = depth(s)
        events.append((max(s.start_ns, t0), 1, d, s))
        events.append((min(s.end_ns, t1), 0, -d, s))
    events.sort(key=lambda ev: ev[:3])   # ends first, then outer starts
    pieces, open_, at = [], [], t0
    for when, starts, _, s in events:
        if open_ and when > at:
            pieces.append((at, when, open_[-1].name))
        at = when
        if starts:
            open_.append(s)
        else:
            open_.remove(s)
    return pieces


def read(t):
    spans = _spans(t)
    if not spans or t.requests == 0:
        return None
    glue = [(s, e) for s, e, name in innermost(spans, t.t0, t.t1)
            if name.startswith("glue.")]
    return _overlap_ns(t.idle_gaps(), glue) / 1e6 / t.requests
