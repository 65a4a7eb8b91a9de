"""device.idle_share (%): the share of the traced stretch in which no
operation ran on the card: 100 * (1 - busy / wall), busy the union of the
device operations' intervals, wall the stretch from the first traced
request's issue to the last one's end (chip_smoke.py phase 5's idle
share, with the union of intervals in place of their sum)."""


def read(t):
    if not t.ops or t.window_ns <= 0:
        return None
    return 100.0 * (1.0 - t.busy_ns() / t.window_ns)
