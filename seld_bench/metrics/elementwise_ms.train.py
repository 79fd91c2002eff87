"""Device milliseconds a training step in PyTorch's elementwise and
reduction kernels (the optimizer, AGC, the casts, the norms), grouped by
the benchmark's frozen kernel classifier."""
from seld_bench.yardstick.trace import family

UNIT, LAYER, MOVES, SOURCE = "ms", "optimizer, casts and norms", \
    "train_windows_per_s", "device_trace"


def read(ctx):
    t = ctx["trace"]
    steps = ctx["items"] * ctx["facts"]["steps_per_item"]
    secs = t.seconds_by(lambda n: family(n) == "elementwise")
    if not secs or not steps:
        return None
    return 1e3 * secs / steps
