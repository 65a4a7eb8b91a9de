"""glue.device_ms_per_request (ms/request): the device time of every
operation that is not one of the port's own kernels (whose names begin
bgn_): the torch ops of the RNS and limb field glue (fieldcore/rns.py,
fieldcore/limbs.py: conversions in and out of RNS, stacking) and copies,
over the requests in the traced stretch."""


def read(t):
    if not t.ops or t.requests == 0:
        return None
    return t.op_ns(lambda name: "bgn_" not in name) / 1e6 / t.requests
