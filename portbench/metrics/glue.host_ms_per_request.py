"""glue.host_ms_per_request (ms/request): the host's time in glue, the
torch ops between two kernels: the self time of the program's glue.*
spans (bgn_torch's utils/profiling.py), each span's length less the time
its child spans cover, clipped to the traced stretch, over its requests:
what fusing the glue into kernels or capturing it in a graph could take
off the host.  None where the program records no span (a port without
the tracer)."""


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


def _covered_ns(intervals) -> int:
    """The length of the union of intervals."""
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total, end = total + e - s, e
        elif e > end:
            total, end = total + e - end, e
    return total


def read(t):
    spans = _spans(t)
    if not spans or t.requests == 0:
        return None

    def clip(s):
        return max(s.start_ns, t.t0), min(s.end_ns, t.t1)

    children = {}
    for s in spans:
        children.setdefault(s.parent, []).append(clip(s))
    self_ns = 0
    for s in spans:
        if s.name.startswith("glue."):
            a, b = clip(s)
            self_ns += b - a - _covered_ns(children.get(s.sid, ()))
    return self_ns / 1e6 / t.requests
