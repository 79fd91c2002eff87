"""Profile the training step: per-step timing and an optional torch.profiler
trace (scripts/profile_train.py).

    python -m seld_tpu_torch.profile_train [--model conv_temporal
        --model_config SS5] [--batch 256] [--steps 20] [--trace DIR]

Prints a timing summary (p50/p90/mean seconds a step, steps/s and
windows/s) after one untimed step and `warmup` (2) timed ones dropped;
with --trace, the steps run under `utils.profiling.trace`, which writes
DIR/trace.json (Perfetto, chrome://tracing), and the card's kernel time
is printed by family (`utils.trace_analysis`). The step is the bench's
recipe: AdaBelief with AGC 0.01 at lr 1e-3, class-weighted BCE with label
smoothing 0.2 + 1000 x class-weighted masked MSE + L2 1e-3, bf16 compute
(--dtype bf16, the default) over f32 masters. The JAX script's --prng
(XLA's rbg generator) has no counterpart here.

Runs on the card (--device cuda, the default) unless --device cpu, where
the timings are the CPU's and the trace groups the host's operators;
without a card it exits non-zero.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", default="conv_temporal")
    ap.add_argument("--model_config", default="SS5")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--n_classes", type=int, default=12)
    ap.add_argument("--trace", default="",
                    help="directory for a torch.profiler trace")
    ap.add_argument("--dtype", default="bf16", choices=["bf16", "fp32"],
                    help="compute dtype (bench default is bf16)")
    ap.add_argument("--pad_ch", type=int, default=7,
                    help="input channels")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from seld_tpu_torch.make_answer import require_device
    require_device(args.device, "seld_tpu_torch.profile_train")

    import numpy as np
    import torch

    from seld_tpu_torch.config import get_model_config
    from seld_tpu_torch.models import build_model
    from seld_tpu_torch.train import losses as L
    from seld_tpu_torch.train import metrics as M
    from seld_tpu_torch.train.optimizers import adabelief
    from seld_tpu_torch.train.steps import make_train_step
    from seld_tpu_torch.train.train_state import TrainState
    from seld_tpu_torch.utils.profiling import StepTimer, trace
    from seld_tpu_torch.utils.trace_analysis import (DEVICE, HOST,
                                                     analyze_trace,
                                                     format_report)

    device = torch.device(args.device)
    input_shape = (300, 64, args.pad_ch)
    cfg = get_model_config(args.model_config,
                           search_paths=["./model_config"])
    cfg["n_classes"] = args.n_classes
    model = build_model(args.model, input_shape, cfg, seed=0, device=device)
    state = TrainState(model, adabelief(list(model.parameters()), 1e-3,
                                        agc_clip=0.01), seed=1)
    cw = L.class_weights_from_samples(
        L.DCASE2021_TRAIN_SAMPLES[:, :args.n_classes], device) \
        if args.n_classes == 12 else None
    step = make_train_step(
        sed_loss_fn=lambda y, p: L.sed_loss_with_weights(y, p, cw, 0.2),
        doa_loss_fn=lambda y, p: L.MMSE_with_cls_weights(y, p, cw),
        loss_weights=(1.0, 1000.0), l2=1e-3,
        compute_dtype=torch.bfloat16 if args.dtype == "bf16" else None)

    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(args.batch, *input_shape).astype(
        np.float32)).to(device)
    sed = torch.from_numpy((rng.rand(args.batch, 60, args.n_classes)
                            < 0.1).astype(np.float32)).to(device)
    doa = sed.repeat_interleave(3, dim=-1) * 0.5
    mstate = M.init_state(args.n_classes, device)

    sync = torch.cuda.synchronize if device.type == "cuda" else None
    print("building and warming up...", flush=True)
    state, mstate, losses = step(state, mstate, x, (sed, doa))
    float(losses[0])

    timer = StepTimer(warmup=2, sync=sync)

    def run(n):
        nonlocal state, mstate
        for _ in range(n):
            with timer:
                state, mstate, _ = step(state, mstate, x, (sed, doa))

    if args.trace:
        run(2)  # warmup outside the trace
        with trace(args.trace):
            run(args.steps)
        print(f"trace written to {args.trace}")
        print(format_report(analyze_trace(
            args.trace, DEVICE if device.type == "cuda" else HOST)))
    else:
        run(args.steps + 2)

    summary = timer.summary(items_per_step=args.batch)
    summary["windows_per_sec"] = summary.pop("items_per_sec")
    for k, v in summary.items():
        print(f"{k}: {v:.4f}" if isinstance(v, float) else f"{k}: {v}")
    if device.type == "cuda":
        print(f"device: {torch.cuda.get_device_name(device)}")
    return summary


if __name__ == "__main__":
    main()
