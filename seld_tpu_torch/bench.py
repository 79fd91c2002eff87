"""Benchmark: SS5 training throughput on one NVIDIA card.

    python -m seld_tpu_torch.bench

Trains conv_temporal + SS5 at full width on synthetic data made from a
numpy seed: bf16 compute over f32 master weights, class-weighted BCE +
1000 x class-weighted masked MSE + L2 1e-3, AGC 0.01 and AdaBelief, with
the streaming SELD metric — the JAX package's bench.py workload. Prints ONE
JSON line: windows/sec, the two timed windows, the FLOPs per window (6 x the
analytic forward MACs) and the MFU against the H100's dense bf16 peak, with
the card's name and power limit. Without a CUDA card it exits non-zero.

Environment: BENCH_BATCH (256), BENCH_STEPS (steps per timed window, 400,
as the JAX package's bench), BENCH_DTYPE (bf16 | fp32), BENCH_SPC (steps
per call, 1), BENCH_SPC_UNROLL (1) and BENCH_FUSE_METRICS (0; 1: the
single step with the metric inside, one captured CUDA graph a step, as
the JAX package's bench reads it). With BENCH_SPC=k > 1 each call is
`make_train_multistep(steps_per_call=k, unroll=BENCH_SPC_UNROLL)` on a
stacked [k, B, ...] batch: k updates replayed as a captured CUDA graph of
`unroll` steps, then one metric update, as the JAX package's bench runs
k steps a dispatch. BENCH_SPC=1 is the eager step of every earlier
measurement.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import time
from types import SimpleNamespace

import numpy as np
import torch

from seld_tpu_torch.config import get_model_config
from seld_tpu_torch.models import build_model
from seld_tpu_torch.nas.complexity import conv_temporal_complexity
from seld_tpu_torch.train import losses as L
from seld_tpu_torch.train import metrics as M
from seld_tpu_torch.train.optimizers import adabelief
from seld_tpu_torch.train.steps import make_train_multistep, make_train_step
from seld_tpu_torch.train.train_state import TrainState
from seld_tpu_torch.train.trainer import accdoa_objective

INPUT_SHAPE = (300, 64, 7)
N_CLASSES = 12
# dense bf16 tensor-core peak of one H100 SXM (NVIDIA data sheet, 700 W)
H100_BF16_PEAK_TFLOPS = 989.0
# 2 flops per multiply-accumulate x (1 forward + 2 backward)
FWD_BWD_HW_FLOPS_PER_MAC = 6.0
DTYPES = {"bf16": torch.bfloat16, "fp32": None}


def ss5_config(dropout: bool = True) -> dict:
    cfg = copy.deepcopy(get_model_config("SS5", search_paths=[]))
    cfg["n_classes"] = N_CLASSES
    if not dropout:
        # every dropout zeroed (the conformer stages default to 0.1)
        for key in ("BLOCK0", "BLOCK1", "BLOCK2", "SED", "DOA"):
            cfg.setdefault(f"{key}_ARGS", {})["dropout_rate"] = 0.0
    return cfg


# every zoo config and the model it builds, as tests/test_models.py pairs
# them (resnet_gru's BLOCK keys make it a conv_temporal body)
ZOO_MODELS = {"seldnet": "seldnet", "seldnet_v1": "seldnet_v1",
              "SS5": "conv_temporal", "dense_gru": "seldnet",
              "resnet_gru": "conv_temporal", "resnet50_gru": "seldnet",
              "xception_gru": "seldnet", "Condseldnet": "seldnet",
              "conv_temp": "conv_temporal"}


def zoo_model(name: str, dropout: bool = True):
    """(model name, config) of zoo config `name` at N_CLASSES classes: SS5
    as `ss5_config(dropout)`; resnet_gru with first_pool_size [5, 1], as
    tests/test_models.py builds it. The other configs' dropout rates are
    all 0."""
    if name == "SS5":
        return "conv_temporal", ss5_config(dropout)
    cfg = copy.deepcopy(get_model_config(name, search_paths=[]))
    if name == "resnet_gru":
        cfg.setdefault("first_pool_size", [5, 1])
    cfg["n_classes"] = N_CLASSES
    return ZOO_MODELS[name], cfg


# SS5 with BLOCK2 swapped for each 1-D block beyond SS5's own, at SS5's
# conformer widths (d_model 192, T 60): block name and arguments
BLOCK_ROWS = {
    "transformer": ("transformer_encoder_stage", {
        "depth": 2, "n_head": 4, "key_dim": 24, "ff_multiplier": 2,
        "kernel_size": 3}),
    "attention": ("attention_stage", {
        "depth": 2, "key_dim": 24, "n_head": 4, "kernel_size": 24,
        "ff_kernel_size": 1, "ff_multiplier": 2, "ff_factor0": 0.5,
        "ff_factor1": 0.5, "pos_encoding": "rff", "use_glu": True}),
    "conformer_relative_scan": ("conformer_encoder_stage", {
        "depth": 2, "key_dim": 24, "n_head": 4, "kernel_size": 24,
        "multiplier": 2, "pos_encoding": "basic", "pos_mode": "relative",
        "scan_depth": True}),
    "rnn_lstm": ("RNN_stage", {"depth": 2, "units": 128,
                               "rnn_type": "LSTM"}),
    "rnn_gru": ("RNN_stage", {"depth": 2, "units": 128, "rnn_type": "GRU"}),
    "rnn_gru_dropout": ("RNN_stage", {"depth": 2, "units": 128,
                                      "rnn_type": "GRU",
                                      "dropout_rate": 0.2}),
    "tcn": ("tcn_stage", {"filters": 192, "depth": 3}),
    "identity": ("identity_block", {}),
}


# the accdoa row's objective flags: --doa_loss MSE and the training CLI's
# default --loss_weight
ACCDOA_ARGS = SimpleNamespace(doa_loss="MSE", loss_weight="1,1000")


def block_row(name: str, dropout: bool = True):
    """(model name, config) of a row: "accdoa" is the accdoa model on
    `ss5_config(dropout)` (it reads SS5's stem and BLOCKs, not its heads);
    any other is `ss5_config(dropout)` with BLOCK2 = BLOCK_ROWS[name],
    every dropout rate 0 without `dropout`."""
    cfg = ss5_config(dropout)
    if name == "accdoa":
        return "accdoa", cfg
    block, args = BLOCK_ROWS[name]
    cfg["BLOCK2"], cfg["BLOCK2_ARGS"] = block, dict(args)
    if not dropout:
        cfg["BLOCK2_ARGS"]["dropout_rate"] = 0.0
    return "conv_temporal", cfg


def build(batch: int = 256, dtype: str = "bf16", device="cuda",
          seed: int = 0, dropout: bool = True, steps_per_call: int = 1,
          unroll: int = 1, model_name: str = "conv_temporal",
          cfg: dict = None, mesh=None,
          fuse_metrics: bool = False) -> SimpleNamespace:
    """The bench's model, optimizer, step and one synthetic batch.

    The model is `model_name` on `cfg` (N_CLASSES classes), SS5 by
    default (`ss5_config(dropout)`); accdoa trains on the trainer's
    objective under ACCDOA_ARGS, as `--model accdoa --doa_loss MSE` does.
    Weights come from `seed` (drawn on
    the CPU, so every device gets the same model) and the batch from numpy
    seed `seed`; x is pre-cast to the compute dtype, as the JAX package's
    feed does. With steps_per_call k > 1 the step is
    `make_train_multistep(k, unroll)` and the batch is k batches stacked
    [k, B, ...], drawn as the JAX package's bench draws them. `mesh`
    (parallel/mesh.py) makes the step data parallel: `batch` is then this
    rank's share. `fuse_metrics`: the single step's
    `make_train_step(fuse_metrics=True)`."""
    compute_dtype = DTYPES[dtype]
    cfg = ss5_config(dropout) if cfg is None else cfg
    model = build_model(model_name, INPUT_SHAPE, cfg, seed=seed,
                        device=device)
    opt = adabelief(list(model.parameters()), 1e-3, agc_clip=0.01)
    state = TrainState(model, opt, seed=seed + 1)
    cw = L.class_weights_from_samples(L.DCASE2021_TRAIN_SAMPLES, device)
    kwargs = dict(
        sed_loss_fn=lambda y, p: L.sed_loss_with_weights(y, p, cw),
        doa_loss_fn=lambda y, p: L.MMSE_with_cls_weights(y, p, cw),
        loss_weights=(1.0, 1000.0), l2=1e-3, compute_dtype=compute_dtype,
        mesh=mesh)
    if model_name == "accdoa":
        sed_loss_fn, doa_loss_fn, weights = accdoa_objective(ACCDOA_ARGS)
        kwargs.update(sed_loss_fn=sed_loss_fn, doa_loss_fn=doa_loss_fn,
                      loss_weights=weights)
    if steps_per_call > 1:
        step = make_train_multistep(steps_per_call=steps_per_call,
                                    unroll=unroll, **kwargs)
    else:
        step = make_train_step(fuse_metrics=fuse_metrics, **kwargs)

    rng = np.random.RandomState(seed)
    lead = (steps_per_call, batch) if steps_per_call > 1 else (batch,)
    x = torch.from_numpy(rng.randn(*lead, *INPUT_SHAPE).astype(np.float32))
    sed = (rng.rand(*lead, 60, N_CLASSES) < 0.1).astype(np.float32)
    doa = (np.clip(rng.randn(*lead, 60, 3 * N_CLASSES), -1, 1)
           * np.repeat(sed, 3, axis=-1)).astype(np.float32)
    x = x.to(device=device, dtype=compute_dtype or torch.float32)
    y = (torch.from_numpy(sed).to(device), torch.from_numpy(doa).to(device))
    return SimpleNamespace(cfg=cfg, state=state, step=step, x=x, y=y,
                           metric=M.init_state(N_CLASSES, device),
                           batch=batch, dtype=dtype,
                           steps_per_call=steps_per_call, step_kwargs=kwargs)


def steps_per_call_from_env():
    """(BENCH_SPC, BENCH_SPC_UNROLL) from the environment, checked."""
    spc = int(os.environ.get("BENCH_SPC", "1"))
    unroll = int(os.environ.get("BENCH_SPC_UNROLL", "1"))
    if spc < 1 or not 1 <= unroll <= spc:
        raise SystemExit(f"bench: BENCH_SPC={spc} must be >= 1 and "
                         f"BENCH_SPC_UNROLL={unroll} in [1, BENCH_SPC]")
    return spc, unroll


def gflops_per_window(cfg: dict) -> float:
    """Hardware fwd+bwd GFLOPs per window: 6 x the analytic forward MACs."""
    cx, _ = conv_temporal_complexity(cfg, INPUT_SHAPE)
    return cx["flops"] / 1e9 * FWD_BWD_HW_FLOPS_PER_MAC


def robust_window_time(run_window, n_windows=2, anomaly_ratio=1.25):
    """Time `n_windows` back-to-back windows; if window 0 exceeds
    `anomaly_ratio` x the best of the rest (a first-execution cost that the
    warmup did not flush), drop it and flag the run. run_window() runs the
    step loop, synchronises and returns its wall time. Returns
    (per_window_seconds, window_times, anomaly_flag)."""
    times = [run_window() for _ in range(n_windows)]
    if len(times) == 1:
        return times[0], times, False
    rest_min = min(times[1:])
    anomaly = times[0] > anomaly_ratio * rest_min
    counted = times[1:] if anomaly else times
    return sum(counted) / len(counted), times, anomaly


def card_name_and_power_limit() -> str:
    """nvidia-smi's `name, power.limit` line of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def main(argv=None) -> None:
    argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter).parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench: no CUDA device (the bench measures the card "
                         "and never falls back to the CPU)")
    batch = int(os.environ.get("BENCH_BATCH", "256"))
    n_steps = int(os.environ.get("BENCH_STEPS", "400"))
    dtype = os.environ.get("BENCH_DTYPE", "bf16")
    if dtype not in DTYPES:
        raise SystemExit(f"bench: BENCH_DTYPE={dtype!r}; one of "
                         f"{sorted(DTYPES)}")
    spc, unroll = steps_per_call_from_env()
    n_calls = max(1, n_steps // spc)
    fused = os.environ.get("BENCH_FUSE_METRICS", "0") == "1"
    b = build(batch, dtype, "cuda", steps_per_call=spc, unroll=unroll,
              fuse_metrics=fused)
    state, mstate = b.state, b.metric

    # warmup: builds the kernels (and captures the graph), and ends in a
    # scalar fetch of the step's loss, which cannot complete before the
    # step has run
    for _ in range(2):
        state, mstate, losses = b.step(state, mstate, b.x, b.y)
    warmup_loss = losses[0].reshape(-1)[0].item()
    if not np.isfinite(warmup_loss):
        raise SystemExit(f"non-finite warmup loss {warmup_loss}")

    def run_window():
        nonlocal state, mstate
        t0 = time.perf_counter()
        for _ in range(n_calls):
            state, mstate, _ = b.step(state, mstate, b.x, b.y)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    dt, window_times, anomaly = robust_window_time(run_window)
    n_steps = n_calls * spc
    windows_per_sec = n_steps * batch / dt
    gflops = gflops_per_window(b.cfg)
    achieved_tflops = windows_per_sec * gflops / 1e3
    print(json.dumps({
        "metric": "ss5_train_throughput",
        "value": windows_per_sec,
        "unit": "windows/sec",
        "batch": batch,
        "compute_dtype": dtype,
        "steps_per_call": spc,
        "unroll": unroll,
        "fuse_metrics": fused,
        "ms_per_step": dt / n_steps * 1e3,
        "warmup_anomaly": bool(anomaly),
        "window_times_sec": window_times,
        "steps_per_window": n_steps,
        "model_gflops_per_window": gflops,
        "achieved_tflops": achieved_tflops,
        "mfu_vs_bf16_peak": achieved_tflops / H100_BF16_PEAK_TFLOPS,
        "peak_tflops_bf16": H100_BF16_PEAK_TFLOPS,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        # a captured graph's private pool is reserved, not allocated
        "max_memory_reserved_bytes": torch.cuda.max_memory_reserved(),
        "device": torch.cuda.get_device_name(0),
        "card": card_name_and_power_limit(),
    }))


if __name__ == "__main__":
    main()
