"""The GRU forward kernel's share of its roofline in a scoring cell: the
summed bounds of the recurrences the traced clips need (each biGRU layer
over every window of a clip; yardstick/work.py, 989 TFLOP/s and 3.35
TB/s) over the summed device time of every gru_fwd_* kernel."""
from seld_bench.yardstick.peaks import bound_s
from seld_bench.yardstick.work import gru_fwd_work

UNIT, LAYER, MOVES, SOURCE = "%", "kernels", "score_clips_per_s", \
    "device_trace"


def read(ctx):
    t, f = ctx["trace"], ctx["facts"]
    secs = t.seconds_by(lambda n: "gru_fwd_" in n)
    if not secs:
        return None
    clip = sum(bound_s(*gru_fwd_work(g)) for g in f["gru_fwd"])
    return 100.0 * clip * ctx["units"] / secs
