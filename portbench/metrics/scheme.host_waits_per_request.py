"""scheme.host_waits_per_request (waits/request): the host reads of a
device value inside the program, its wait.* spans (bgn_torch's
utils/profiling.py: a bool() or .item() of a tensor, .cpu(), .tolist(),
a pageable host-to-device copy), in the traced stretch, over its
requests: each one blocks the host until the card has run everything
queued before it, an exact count for a given key and batch.  None where
the program records no span (a port without the tracer)."""


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


def read(t):
    spans = _spans(t)
    if not spans or t.requests == 0:
        return None
    return sum(s.name.startswith("wait.") for s in spans) / t.requests
