"""The FOA front-end kernel's share of its roofline: the bound of each
traced clip's extraction (yardstick/work.py: its bytes at 3.35 TB/s, its
operations at 989 TFLOP/s) over the summed device time of the
foa_frontend_* kernels."""
from seld_bench.yardstick.peaks import bound_s

UNIT, LAYER, MOVES, SOURCE = "%", "kernels", "score_clips_per_s", \
    "device_trace"


def read(ctx):
    t, f = ctx["trace"], ctx["facts"]
    secs = t.seconds_by(lambda n: "foa_frontend_" in n)
    if not secs:
        return None
    clip = sum(bound_s(*w) for w in f["frontend"])
    return 100.0 * clip * ctx["units"] / secs
