"""What the reference expects of a `mult` request: for each sampled lane
the two L1 ciphertexts C_a = P^m * Q^r and C_b = P^k * Q^r', worked out
from the drawn (m, r) and (k, r'), and their product e(C_a, C_b), the
Tate pairing of reference/pairing.py.  Plain Python ints; some hundreds
of lanes are spread over up to WORKERS spawned processes, a few stay in
this one.  Imports nothing of the program.
"""

from __future__ import annotations

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor

from portbench.reference import pairing

WORKERS = 8              # processes for the reference, after the window
LANES_PER_WORKER = 16    # fewer lanes than this a process stay in this one


def expect(key, lanes) -> dict:
    """lanes: (batch, lane, m, k, r, r') tuples -> {(batch, lane): (C_a,
    C_b, e(C_a, C_b))}."""
    args = [(key.p, key.n, key.l, key.P, key.Q, key.naf, m, k, ra, rb)
            for _, _, m, k, ra, rb in lanes]
    workers = min(WORKERS, os.cpu_count() or 1,
                  len(args) // LANES_PER_WORKER)
    if workers > 1:
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(workers, mp_context=ctx) as ex:
            out = list(ex.map(pairing.product_lane, args,
                              chunksize=max(1, len(args) // (4 * workers))))
    else:
        out = [pairing.product_lane(a) for a in args]
    return {(j, x): v for (j, x, *_), v in zip(lanes, out)}
