"""The GRU kernels' share of their roofline in a training cell: the summed
bounds of the forward and backward recurrences the traced steps need
(each biGRU layer at the step's batch; yardstick/work.py, 989 TFLOP/s and
3.35 TB/s) over the summed device time of every gru_fwd_* and gru_bwd_*
kernel in the trace."""
from seld_bench.yardstick.peaks import bound_s
from seld_bench.yardstick.work import gru_bwd_work, gru_fwd_work

UNIT, LAYER, MOVES, SOURCE = "%", "kernels", "train_windows_per_s", \
    "device_trace"


def read(ctx):
    t, f = ctx["trace"], ctx["facts"]
    secs = t.seconds_by(lambda n: "gru_fwd_" in n or "gru_bwd_" in n)
    if not secs:
        return None
    step = sum(bound_s(*gru_fwd_work(g)) for g in f["gru_fwd"]) + \
        sum(bound_s(*gru_bwd_work(g)) for g in f["gru_bwd"])
    return 100.0 * step * ctx["items"] * f["steps_per_item"] / secs
