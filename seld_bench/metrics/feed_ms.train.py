"""The milliseconds an epoch waits on its feed: the summed durations of
the program's `seld.feed.epoch_index` spans (the host shuffle and the
index matrix's upload, `DeviceDataset.epoch_index_matrix`) over the traced
epochs. Nothing without the spans or without a card under the run."""
UNIT, LAYER, MOVES, SOURCE = "ms", "feed", "train_windows_per_s", \
    "program_span"


def read(ctx):
    t = ctx["trace"]
    spans = [o.end - o.start for o in t.host_ops
             if o.name == "seld.feed.epoch_index"
             and t.start <= o.start < t.end]
    if not spans or not ctx["items"] or not t.device_ops:
        return None
    return 1e3 * sum(spans) / ctx["items"]
