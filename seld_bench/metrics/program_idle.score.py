"""As `program_idle.train`, over a scoring cell's traced window: the share
in which the card is idle while the host is inside one of the program's
spans (`seld.score.*`: the front-end, the normaliser, the scorer). The
rest of the idle share is the benchmark's own: the wav copies, the stack
and the outputs' copies to the host."""
from seld_bench import harness

UNIT, LAYER, MOVES, SOURCE = "%", "host", "score_clips_per_s", \
    "program_span"


def read(ctx):
    return harness.metric_reader("program_idle.train").program_idle(
        ctx["trace"])
