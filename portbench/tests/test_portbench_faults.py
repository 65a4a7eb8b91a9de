"""The comparison that decides `correct`, driven through a whole run on
the CPU at 64 bits (the harness's look for a card skipped): a sound run
is correct; the control and each fault that a `mult` cell can have make
it false.  The cell runs on one chip, so there is no exchange between
chips to leave out."""

import gc
import time
import weakref

import pytest
import torch

from bgn_torch.scheme import Ciphertext
from portbench import control, harness

torch.set_num_threads(1)


def _run(root, hooks=None, seconds=2.0, seed=2**33 + 7):
    cell = harness.Cell(root, "tiny.mult")
    return harness.run_cell(cell, seed, seconds, False, time.perf_counter(),
                            device="cpu", hooks=hooks)


def _stale():
    """Every request returns what the first one returned."""
    first = []

    def call(s, j, inner):
        if not first:
            first.append(inner(s, j))
        return first[0]
    return call


def _half(s, j, inner):
    """Half of the batch left out: the first half's products stand in
    for the rest."""
    b, h = s.pool[j], s.lanes // 2
    part = s.pk.mult(b.a[:h], b.b[:h])
    return Ciphertext(torch.cat([part.data, part.data], dim=2), True)


def _altered():
    """One answer altered where it is produced: lane 3 of the first
    request of the window."""
    calls = []

    def call(s, j, inner):
        out = inner(s, j)
        calls.append(j)
        if len(calls) == harness.WARM_REQUESTS + 1:
            out.data[0, 0, 3] += 1
        return out
    return call


def _repeated(s, j, inner):
    """The same answer altered in every request alike (lane 4), so that
    the outputs stay stable."""
    out = inner(s, j)
    out.data[0, 0, 4] += 1
    return out


def _raises():
    calls = []

    def call(s, j, inner):
        calls.append(j)
        if len(calls) == harness.WARM_REQUESTS + 1:
            raise RuntimeError("planted failure")
        return inner(s, j)
    return call


def test_sound_run_is_correct(tiny_root):
    r = _run(tiny_root)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 3 and r["failed"] == 0
    assert set(r["metrics"]) == {"results_per_s", "request_p95_ms",
                                 "setup_s"}


def test_control_is_not_correct(tiny_root):
    r = _run(tiny_root, {"deploy": control.control_deploy}, seconds=4.0)
    assert r["attempted"] > 2       # two requests of one input batch
    assert not r["correct"]
    assert r["checks"]["lanes_wrong"]["value"] > 0
    assert r["checks"]["requests_unstable"]["value"] > 0


@pytest.mark.parametrize("fault", ["stale", "half", "altered", "repeated",
                                   "raises"])
def test_fault_is_not_correct(tiny_root, fault):
    call = {"stale": _stale, "half": lambda: _half, "altered": _altered,
            "repeated": lambda: _repeated, "raises": _raises}[fault]()
    r = _run(tiny_root, {"call": call})
    assert not r["correct"], (fault, r["checks"])
    if fault == "raises":
        assert r["failed"] == 1


def test_window_keeps_no_outputs(tiny_root):
    """When a request starts, the only outputs alive are the first of
    each input batch."""
    alive, most = [], []

    def call(s, j, inner):
        gc.collect()
        most.append(sum(r() is not None for r in alive))
        out = inner(s, j)
        alive.append(weakref.ref(out.data))
        return out
    r = _run(tiny_root, {"call": call}, seconds=3.0)
    assert r["correct"] and r["attempted"] >= 4
    assert max(most) <= harness.Cell(tiny_root, "tiny.mult").traffic["pool"]
