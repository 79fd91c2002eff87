"""The training step's share of the card's top dense rate: the model's
forward and backward FLOPs a window (counted once over the benchmark's
plain reference at the cell's shapes) times the windows a second of the
run's measured window, over 989 TFLOP/s."""
from seld_bench.yardstick.peaks import DENSE_FLOPS_PER_S

UNIT, LAYER, MOVES, SOURCE = "%", "train step", "train_windows_per_s", \
    "host_clock"


def read(ctx):
    flops = ctx["facts"].get("flops_per_unit")
    if not flops or not ctx["trace"].device_ops:
        return None         # no count, or no card under the run
    return 100.0 * flops * ctx["unit_rate"] / DENSE_FLOPS_PER_S
