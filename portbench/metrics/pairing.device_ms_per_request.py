"""pairing.device_ms_per_request (ms/request): the device time of the
pairing's loop kernels (bgn_miller_loop, bgn_pow_loop and
bgn_fp2_pow_loop: the Miller loop and the final exponentiation's two
powers, ops/rns_pairing.py), found by name, over the requests in the
traced stretch."""


def _pairing(name):
    return "miller_loop" in name or "pow_loop" in name


def read(t):
    ns = t.op_ns(_pairing)
    if ns == 0 or t.requests == 0:
        return None
    return ns / 1e6 / t.requests
