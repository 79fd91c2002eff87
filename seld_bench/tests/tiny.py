"""Tiny versions of the benchmark's cells for the CPU tests: the same
drivers, references and limits, at widths and lengths a test run holds."""
from __future__ import annotations

import copy

from seld_bench import harness


def tiny_config(name: str) -> dict:
    cfg = copy.deepcopy(harness.workload(
        {"ss5": "ss5.train_b256",
         "seldnet": "seldnet.train_b256"}[name]).config)
    mc = cfg["model_config"]
    if name == "ss5":
        mc["filters"] = 8
        mc["BLOCK0_ARGS"]["filters1"] = 8
        mc["BLOCK1_ARGS"]["units"] = 16
        for k in ("BLOCK2_ARGS", "SED_ARGS"):
            mc[k].update(key_dim=4, n_head=2, kernel_size=4)
        mc["DOA_ARGS"]["units"] = 8
    else:
        mc["FIRST_ARGS"]["filters"] = [8, 8, 8]
        mc["SECOND_ARGS"]["units"] = [8, 8]
        mc["SED_ARGS"]["units"] = mc["DOA_ARGS"]["units"] = [8]
    cfg["input_shape"] = [100, 64, 7]
    return cfg


def tiny_workload(name: str) -> harness.Workload:
    """Workload `name` at a tiny size: 20 label frames a window, B=4."""
    wl = harness.workload(name)
    traffic = dict(wl.traffic)
    if traffic["driver"] == "train":
        traffic.update(clips=4, windows_per_clip=4, label_frames=20,
                       batch=4, trace_items=1)
    else:
        traffic.update(clips=3, clip_seconds=4, label_frames=40,
                       win_frames=100, batch_size=8, check_clips=2,
                       trace_items=1)
    return harness.Workload(wl.spec, tiny_config(wl.spec["config"]),
                            traffic, wl.limits)
