"""The host's milliseconds a training step inside the replay call: the
summed durations of the program's `seld.train.replay` spans (one a
replay of a step's CUDA graph) over the traced steps. Near the step's
device time, the host blocks in each launch; far below it, the host runs
ahead and the card waits only where the host stops. Nothing without the
spans or without a card under the run."""
UNIT, LAYER, MOVES, SOURCE = "ms", "train step", "train_windows_per_s", \
    "program_span"


def read(ctx):
    t = ctx["trace"]
    spans = [o.end - o.start for o in t.host_ops
             if o.name == "seld.train.replay" and t.start <= o.start < t.end]
    steps = ctx["items"] * ctx["facts"]["steps_per_item"]
    if not spans or not steps or not t.device_ops:
        return None
    return 1e3 * sum(spans) / steps
