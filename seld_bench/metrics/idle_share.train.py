"""The device's idle share over the traced window of a training cell:
1 - (union of the device's operation intervals) / (the window's wall
time), from torch.profiler."""
UNIT, LAYER, MOVES, SOURCE = "%", "device", "train_windows_per_s", \
    "device_trace"


def read(ctx):
    t = ctx["trace"]
    if not t.device_ops or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
