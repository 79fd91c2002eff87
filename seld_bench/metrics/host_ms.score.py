"""The host's milliseconds a clip inside the program: the union of the
program's `seld.score.frontend`, `seld.score.normalize` and
`seld.score.ensemble` spans in the traced window over the traced clips.
Set beside the device's time a clip, it says whether the host or the card
paces the path. Nothing without the spans or without a card under the
run."""
from seld_bench.yardstick.trace import union

UNIT, LAYER, MOVES, SOURCE = "ms", "host", "score_clips_per_s", \
    "program_span"
SPANS = ("seld.score.frontend", "seld.score.normalize",
         "seld.score.ensemble")


def read(ctx):
    t = ctx["trace"]
    spans = union([(max(o.start, t.start), min(o.end, t.end))
                   for o in t.host_ops if o.name in SPANS
                   and o.end > t.start and o.start < t.end])
    if not spans or not ctx["units"] or not t.device_ops:
        return None
    return 1e3 * sum(e - s for s, e in spans) / ctx["units"]
