"""The share of the rows the scorer's windowed model stage ran that its
outputs need: 100 x the program's count `score.windows` (the windows of
each clip) over `score.window_rows` (the rows of every chunk, padding
included: the whole model on the exact path, the head on the fast paths),
from `seld_tpu_torch.utils.profiling.counts`, which count while the
profiler records: the traced items alone."""
from seld_tpu_torch.utils import profiling

UNIT, LAYER, MOVES, SOURCE = "%", "model forward", "score_clips_per_s", \
    "program_counter"


def read(ctx):
    counts = getattr(profiling, "counts", None) or {}
    rows = counts.get("score.window_rows", 0)
    if not rows or not ctx["trace"].device_ops:
        return None         # no count, or no card under the run
    return 100.0 * counts.get("score.windows", 0) / rows
