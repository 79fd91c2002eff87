"""A 60-second health check of the critical path on synthetic data
(scripts/smoke.py).

    python -m seld_tpu_torch.smoke

Covers: model build -> train steps (the loss decreases) -> the streaming
metric -> sliding-window inference -> DCASE CSV round trip -> the
official scorer, on a small seldnet (a conv block, a biGRU and dense
heads: the gru_scan and gru_scan_bwd kernels on the card). Exits non-zero
on any failure. Runs on the card (--device cuda, the default) unless
--device cpu; without a card it exits non-zero.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

CONFIG = {"FIRST": "simple_conv_block",
          "FIRST_ARGS": {"filters": [8], "pool_size": [[5, 4]]},
          "SECOND": "bidirectional_GRU_block", "SECOND_ARGS": {"units": [8]},
          "SED": "simple_dense_block", "SED_ARGS": {"units": [8]},
          "DOA": "simple_dense_block", "DOA_ARGS": {"units": [8]},
          "n_classes": 4}


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from seld_tpu_torch.make_answer import require_device
    require_device(args.device, "seld_tpu_torch.smoke")

    t0 = time.time()
    import tempfile

    import numpy as np
    import torch

    from seld_tpu_torch.inference import (ensemble_outputs,
                                          evaluate_clips_official)
    from seld_tpu_torch.models import build_model
    from seld_tpu_torch.train import losses as L
    from seld_tpu_torch.train import metrics as M
    from seld_tpu_torch.train.optimizers import adabelief
    from seld_tpu_torch.train.steps import make_train_step
    from seld_tpu_torch.train.train_state import TrainState
    from seld_tpu_torch.utils import io

    device = torch.device(args.device)
    n_classes = CONFIG["n_classes"]
    model = build_model("seldnet", (50, 16, 7), dict(CONFIG), seed=0,
                        device=device)
    print(f"[{time.time() - t0:5.1f}s] model built")

    state = TrainState(model, adabelief(list(model.parameters()), 3e-3,
                                        agc_clip=0.01), seed=1)
    step = make_train_step(
        sed_loss_fn=lambda y, p: L.sed_loss_with_weights(y, p),
        doa_loss_fn=L.MMSE, loss_weights=(1.0, 10.0),
        metric_block_size=5)

    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(8, 50, 16, 7).astype(np.float32)).to(
        device)
    sed = torch.from_numpy((rng.rand(8, 10, n_classes) < 0.2).astype(
        np.float32)).to(device)
    doa = sed.repeat_interleave(3, dim=-1) * 0.5
    ms = M.init_state(n_classes, device)
    losses = []
    for _ in range(10):
        state, ms, (sl, dl) = step(state, ms, x, (sed, doa))
        losses.append(float(sl) + 10 * float(dl))
    if not losses[-1] < losses[0]:
        raise SystemExit(f"smoke: the loss did not decrease "
                         f"({losses[0]:.4f} -> {losses[-1]:.4f})")
    er = float(M.result(ms)[0])
    if not np.isfinite(er):
        raise SystemExit(f"smoke: the metric's ER is {er}")
    print(f"[{time.time() - t0:5.1f}s] train steps ok "
          f"(loss {losses[0]:.3f} -> {losses[-1]:.3f}, ER {er:.3f})")

    clip = torch.from_numpy(rng.randn(250, 16, 7).astype(np.float32))
    outs = ensemble_outputs(model, [clip.to(device)], win_size=50,
                            step_size=5, batch_size=16)
    if tuple(outs[0][0].shape) != (50, n_classes):
        raise SystemExit(f"smoke: sliding-window SED output "
                         f"{tuple(outs[0][0].shape)}, want (50, "
                         f"{n_classes})")
    print(f"[{time.time() - t0:5.1f}s] sliding-window inference ok")

    with tempfile.TemporaryDirectory() as d:
        gt_sed = (rng.rand(50, n_classes) < 0.2).astype(np.float32)
        gt_doa = np.repeat(gt_sed, 3, -1) * 0.5
        io.write_answer(d, "clip.csv", gt_sed, gt_doa)
        seld, _ = evaluate_clips_official(
            [(gt_sed, gt_doa)], ["clip"], d, os.path.join(d, "out"),
            thresholds=0.5, n_classes=n_classes, gt_polar=False)
        if abs(seld) >= 1e-3:
            raise SystemExit(f"smoke: the scorer's round trip gave SELD "
                             f"{seld}, want 0")
    print(f"[{time.time() - t0:5.1f}s] official scorer round trip ok")
    print(f"SMOKE PASS in {time.time() - t0:.1f}s on "
          f"{torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
