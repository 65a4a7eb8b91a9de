"""results_per_s and request_p95_ms on synthetic request times."""

import pytest

from portbench import e2e


def _closed_loop(durations, t0=100.0):
    """(window start, request ends, latencies) of back-to-back requests."""
    ends, t = [], t0
    for d in durations:
        t += d
        ends.append(t)
    return t0, ends, list(durations)


def test_steady():
    t0, ends, lat = _closed_loop([0.125] * 200)
    ok = [True] * 200
    assert e2e.results_per_s(t0, ends, 8192, ok) == pytest.approx(8192 / 0.125)
    assert e2e.request_p95_ms(lat) == pytest.approx(125.0)


def test_stall_moves_both():
    base = [0.1 + 0.001 * (i % 7) for i in range(200)]
    stalled = list(base)
    for i in range(100, 115):       # a stall that holds 15 requests
        stalled[i] += 0.4
    r0 = e2e.results_per_s(*_closed_loop(base)[:2], 1056, [True] * 200)
    r1 = e2e.results_per_s(*_closed_loop(stalled)[:2], 1056, [True] * 200)
    p0 = e2e.request_p95_ms(base)
    p1 = e2e.request_p95_ms(stalled)
    assert r1 < r0 * 0.8
    assert p1 > p0 + 300
    # the rate is the whole window's: the work over the time
    assert r1 == pytest.approx(1056 * 200 / sum(stalled))


def test_failed_requests_and_tail():
    t0, ends, lat = _closed_loop([0.1] * 9 + [0.5])
    ok = [True] * 9 + [False]
    # a failed last request adds no lanes and does not end the window
    assert e2e.results_per_s(t0, ends, 10, ok) == pytest.approx(90 / 0.9)
    assert e2e.results_per_s(t0, ends, 10, [False] * 10) == 0.0
    # p95 interpolates between the closest ranks
    assert e2e.request_p95_ms(lat) == pytest.approx(1e3 * (0.1 + 0.55 * 0.4))
    assert e2e.request_p95_ms([0.2]) == pytest.approx(200.0)


def test_keep_work_left_out_of_the_trace():
    """Device operations that start inside a keep span are the harness's
    own and leave the trace; those outside, or starting after, stay."""
    from portbench import trace
    spans = [("request", 0, 100), ("keep", 100, 130), ("request", 130, 300),
             ("keep", 300, 320)]
    ops = [("bgn_miller_loop", 5, 90), ("eq", 104, 108), ("all", 109, 112),
           ("memcpy", 125, 131), ("bgn_pow_loop", 131, 290),
           ("late", 321, 330)]
    assert trace.outside(ops, spans, trace.KEEP) == [
        ("bgn_miller_loop", 5, 90), ("bgn_pow_loop", 131, 290),
        ("late", 321, 330)]
    assert trace.outside(ops, [], trace.KEEP) == ops
