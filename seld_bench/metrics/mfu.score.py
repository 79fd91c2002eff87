"""The scoring path's share of the card's top dense rate: the forward
FLOPs a clip needs on the cell's path (every window on the exact path;
the trunk once and the head over every window on the fast path), counted
over the benchmark's plain reference, times the clips a second of the
run's measured window, over 989 TFLOP/s."""
from seld_bench.yardstick.peaks import DENSE_FLOPS_PER_S

UNIT, LAYER, MOVES, SOURCE = "%", "model forward", "score_clips_per_s", \
    "host_clock"


def read(ctx):
    flops = ctx["facts"].get("flops_per_unit")
    if not flops or not ctx["trace"].device_ops:
        return None         # no count, or no card under the run
    return 100.0 * flops * ctx["unit_rate"] / DENSE_FLOPS_PER_S
