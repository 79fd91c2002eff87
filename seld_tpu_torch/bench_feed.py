"""Training feed throughput on one NVIDIA card: host-fed, device-resident
and the epoch graph.

    python -m seld_tpu_torch.bench_feed

Epochs of the bench's SS5 step (seld_tpu_torch.bench: full width, B=256,
bf16 compute over f32 masters, dropout on, no augments) over one synthetic
windowed split made from numpy seed 0, through three feeds, as the JAX
package's scripts/bench_feed.py measures its own:

  device  DeviceDataset: the windows staged on the card once; each step
          gathers its batch there (one gather_rows launch) and runs the
          eager step
  scan    make_train_epoch over the same DeviceDataset: gather and update
          a step as a captured CUDA graph, replayed once a step
          (the trainer's --epoch_scan); FEED_FUSED=1 updates the metric
          inside it (--fuse_metrics)
  host    SeldDataset -> DeviceIterator: a host gather and a pinned copy to
          the card a step, one batch ahead on a side stream

Each mode prints one JSON line (windows/s of its best epoch and of every
timed epoch; an epoch's time takes in staging its index matrix and ends
in a scalar fetch of its last loss), then a summary line with the ratios
and the card's name and power limit. The state trains on across the
modes. Without a CUDA card it exits non-zero.

Environment: FEED_WINDOWS (1024), FEED_BATCH (256), FEED_LOOP (5, epoch
length multiplier: 20 steps an epoch by default), FEED_HOST_STEPS (cap on
the timed host-fed steps, 12), FEED_REPS (timed epochs a mode, 3),
FEED_SCAN (1; 0 skips the epoch graph), FEED_FUSED (0).
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from seld_tpu_torch.bench import (INPUT_SHAPE, N_CLASSES, build,
                                  card_name_and_power_limit)
from seld_tpu_torch.data.device_dataset import DeviceDataset
from seld_tpu_torch.data.loader import DeviceIterator, SeldDataset
from seld_tpu_torch.train import losses as L
from seld_tpu_torch.train import metrics as M
from seld_tpu_torch.train.steps import make_train_epoch


def synthetic_split(n_windows: int, seed: int = 0):
    """(x [N, 300, 64, 7] bf16, y [N, 60, 4C] f32 sed and doa side by
    side), drawn as the JAX package's bench_feed draws them."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(n_windows, *INPUT_SHAPE).astype(
        np.float32)).to(torch.bfloat16)
    sed = (rng.rand(n_windows, 60, N_CLASSES) < 0.1).astype(np.float32)
    doa = (np.clip(rng.randn(n_windows, 60, 3 * N_CLASSES), -1, 1)
           * np.repeat(sed, 3, axis=-1)).astype(np.float32)
    return x, np.concatenate([sed, doa], axis=-1)


def main(argv=None) -> None:
    argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter).parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_feed: no CUDA device (it measures the card "
                         "and never falls back to the CPU)")
    env = os.environ.get
    n_windows = int(env("FEED_WINDOWS", "1024"))
    batch = int(env("FEED_BATCH", "256"))
    loop = int(env("FEED_LOOP", "5"))
    host_cap = int(env("FEED_HOST_STEPS", "12"))
    reps = int(env("FEED_REPS", "3"))
    fused = env("FEED_FUSED", "0") == "1"
    c = N_CLASSES

    b = build(batch=batch, dtype="bf16", device="cuda")
    state = b.state
    x, y = synthetic_split(n_windows)

    def split(yb):
        return yb[..., :c], yb[..., c:]

    def run_epoch(feed, max_steps=None):
        """(steps, seconds) of the eager step over `feed`, ended by a
        scalar fetch of the last loss."""
        nonlocal state
        mstate = M.init_state(c, "cuda")
        t0 = time.perf_counter()
        n, losses = 0, None
        for xb, yb in feed:
            state, mstate, losses = b.step(state, mstate, xb, split(yb))
            n += 1
            if max_steps is not None and n >= max_steps:
                break
        losses[0].item()
        return n, time.perf_counter() - t0

    def best_rate(fn):
        rates = []
        for _ in range(reps):
            n, dt = fn()
            rates.append(n * batch / dt)
        return n, max(rates), rates

    results = {}
    t0 = time.perf_counter()
    dev_ds = DeviceDataset(x, y, batch, "cuda", loop_time=loop, seed=0)
    run_epoch(dev_ds, max_steps=2)                 # stage and warm up
    staged = time.perf_counter() - t0
    n, rate, rates = best_rate(lambda: run_epoch(dev_ds))
    results["device"] = {"mode": "device_resident", "steps": n,
                         "windows_per_sec": rate, "epoch_rates": rates,
                         "stage_and_warmup_secs": staged,
                         "hbm_gb": dev_ds.hbm_bytes() / 1e9}
    print(json.dumps(results["device"]), flush=True)

    if env("FEED_SCAN", "1") == "1":
        cw = L.class_weights_from_samples(L.DCASE2021_TRAIN_SAMPLES, "cuda")
        epoch_step = make_train_epoch(
            sed_loss_fn=lambda yy, p: L.sed_loss_with_weights(yy, p, cw),
            doa_loss_fn=lambda yy, p: L.MMSE_with_cls_weights(yy, p, cw),
            n_classes=c, loss_weights=(1.0, 1000.0), l2=1e-3,
            compute_dtype=torch.bfloat16, fuse_metrics=fused)
        x_all, y_all = dev_ds.device_arrays
        aug = torch.Generator(device="cuda").manual_seed(2)

        def run_scan_epoch():
            nonlocal state
            t0 = time.perf_counter()
            idx_all = dev_ds.epoch_index_matrix()
            state, _, (sl, _) = epoch_step(state, M.init_state(c, "cuda"),
                                           x_all, y_all, idx_all, aug)
            sl[-1].item()
            return idx_all.shape[0], time.perf_counter() - t0

        t0 = time.perf_counter()
        run_scan_epoch()                           # warm up and capture
        captured = time.perf_counter() - t0
        n, rate, rates = best_rate(run_scan_epoch)
        results["scan"] = {"mode": "epoch_graph", "fused_metrics": fused,
                           "steps": n, "windows_per_sec": rate,
                           "epoch_rates": rates,
                           "first_epoch_secs": captured}
        print(json.dumps(results["scan"]), flush=True)

    host_ds = SeldDataset(x, y, batch, train=True, loop_time=loop, seed=0)
    run_epoch(DeviceIterator(host_ds, "cuda"), max_steps=1)
    n, dt = run_epoch(DeviceIterator(host_ds, "cuda"), max_steps=host_cap)
    results["host"] = {"mode": "host_fed", "steps": n,
                       "windows_per_sec": n * batch / dt,
                       "mb_per_step": (x[:batch].numel() * 2
                                       + y[:batch].nbytes) / 1e6}
    print(json.dumps(results["host"]), flush=True)

    summary = {"metric": "device_resident_feed_speedup",
               "value": (results["device"]["windows_per_sec"]
                         / results["host"]["windows_per_sec"]),
               "unit": "x vs host-fed epoch", "batch": batch,
               "n_windows": n_windows}
    if "scan" in results:
        summary["epoch_graph_vs_device"] = (
            results["scan"]["windows_per_sec"]
            / results["device"]["windows_per_sec"])
    summary.update(device=torch.cuda.get_device_name(0),
                   card=card_name_and_power_limit())
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
