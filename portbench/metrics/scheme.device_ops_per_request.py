"""scheme.device_ops_per_request (ops/request): the device operations
(kernels, copies, fills) that the profiler records in the traced stretch,
over the requests in it: what one scheme call puts on the card, an exact
count for a given key and batch."""


def read(t):
    n = sum(1 for _, s, e in t.ops if e > t.t0 and s < t.t1)
    if n == 0 or t.requests == 0:
        return None
    return n / t.requests
