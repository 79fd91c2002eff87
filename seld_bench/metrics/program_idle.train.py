"""The share of a training cell's traced window in which the card is idle
(outside the union of its operations' intervals) while the host is inside
one of the program's spans (`seld.*`, utils/profiling.py): the idle that
the program's host work holds the card to. What remains of the idle share
(`idle_share.train`) lies outside the program, in the benchmark's own
loop or between the two. Intervals, not `idle_gaps`: long outer spans escape
that lookback."""
from seld_bench.yardstick.trace import union

UNIT, LAYER, MOVES, SOURCE = "%", "host", "train_windows_per_s", \
    "program_span"


def overlap_s(a, b) -> float:
    """Seconds two sorted lists of disjoint intervals share."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def program_idle(t):
    """The share in % of trace `t`'s window; None without a span or
    without a card under the run."""
    if not t.device_ops or t.window_s <= 0:
        return None
    spans = union([(max(o.start, t.start), min(o.end, t.end))
                   for o in t.host_ops if o.name.startswith("seld.")
                   and o.end > t.start and o.start < t.end])
    if not spans:
        return None
    idle, prev = [], t.start
    for s, e in t.busy_intervals():
        if s > prev:
            idle.append((prev, s))
        prev = max(prev, e)
    if t.end > prev:
        idle.append((prev, t.end))
    return 100.0 * overlap_s(idle, spans) / t.window_s


def read(ctx):
    return program_idle(ctx["trace"])
