"""Where a training step's time goes on one NVIDIA card.

    python -m seld_tpu_torch.profile_step

Builds the bench's step with its defaults (`seld_tpu_torch.bench.build`:
SS5 full width, B=256, bf16 compute over f32 masters, dropout on), or
with BENCH_CONFIG=<zoo config> (`bench.zoo_model`: seldnet, dense_gru,
...) another model of the zoo at full width, warms it up, times STEPS (10) steps on the host clock (ended by
`torch.cuda.synchronize()`), then traces as many more under
`torch.profiler` and prints ONE JSON line. BENCH_SPC=k (and
BENCH_SPC_UNROLL), as the bench reads them, profiles the k-step call
(`make_train_multistep`, a CUDA graph replayed on the card) instead: each
run is ceil(STEPS / k) calls, and every number below is per step.

  ms_per_step           host clock per step, without the profiler
  traced_ms_per_step    host clock per step under the profiler
  device_ms_per_step    summed device time of every kernel, copy and set
                        (two streams' overlap counted twice)
  idle_share            1 - the union of the device's kernel, copy and set
                        intervals / the traced run's wall time: the share
                        of the traced run the card waits on the host, from
                        that one run (utils/trace_analysis.py::idle_share;
                        overlapping streams count once)
  port_kernels          ms per step and share of device time of each
                        hand-written kernel (gru_scan, gru_scan_bwd,
                        stem_dy, foa_frontend, gather_rows, batch_norm)
  groups                device ms per step of library GEMMs, convolutions,
                        elementwise and reduction passes, and everything
                        else (utils/trace_analysis.py's families)
  top                   the largest kernels by device time

Without a CUDA card it exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from seld_tpu_torch.bench import (build, card_name_and_power_limit,
                                  steps_per_call_from_env, zoo_model)
from seld_tpu_torch.utils.trace_analysis import (PORT_KERNELS, _classify,
                                                 idle_share, profile_events)

STEPS = 10            # steps per timed and per traced run


def _device_us(avg) -> float:
    t = getattr(avg, "self_device_time_total", None)
    return float(avg.self_cuda_time_total if t is None else t)


def main(argv=None) -> None:
    argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter).parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: no CUDA device")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    spc, unroll = steps_per_call_from_env()
    calls = -(-STEPS // spc)
    steps = calls * spc
    config = os.environ.get("BENCH_CONFIG", "SS5")
    model_name, cfg = zoo_model(config)
    b = build(device="cuda", steps_per_call=spc, unroll=unroll,
              model_name=model_name, cfg=cfg)
    state, mstate = b.state, b.metric

    def run():
        nonlocal state, mstate
        t0 = time.perf_counter()
        for _ in range(calls):
            state, mstate, losses = b.step(state, mstate, b.x, b.y)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / steps * 1e3, losses

    _, losses = run()                                  # warm up
    if not torch.isfinite(torch.stack(losses)).all():
        raise SystemExit("non-finite loss in the warmup")
    ms_step, _ = run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced_ms, _ = run()

    by_name = {}
    for avg in prof.key_averages():
        if avg.device_type == DeviceType.CUDA and _device_us(avg) > 0:
            by_name[avg.key] = by_name.get(avg.key, 0.0) + _device_us(avg)
    if not by_name:
        raise SystemExit("the profiler recorded no device time")
    per_step = {k: v / 1e3 / steps for k, v in by_name.items()}   # ms per step
    device_ms = sum(per_step.values())
    groups = {}
    for name, ms in per_step.items():
        g = _classify(name)
        groups[g] = groups.get(g, 0.0) + ms
    port = {k: {"ms_per_step": groups.get(k, 0.0),
                "share_of_device": groups.get(k, 0.0) / device_ms}
            for k in PORT_KERNELS}
    idle = idle_share(profile_events(prof), traced_ms * steps * 1e3)
    top = sorted(per_step.items(), key=lambda kv: -kv[1])[:12]
    print(json.dumps({
        "metric": "train_step_breakdown",
        "config": config, "model": model_name, "batch": b.batch, "compute_dtype": b.dtype, "steps": steps,
        "steps_per_call": spc, "unroll": unroll,
        "ms_per_step": ms_step,
        "traced_ms_per_step": traced_ms,
        "device_ms_per_step": device_ms,
        "idle_share": idle,
        "port_kernels": port,
        "groups": {k: groups.get(k, 0.0)
                   for k in ("gemm", "conv", "elementwise", "other")},
        "top": [{"kernel": k[:120], "ms_per_step": v,
                 "share_of_device": v / device_ms} for k, v in top],
        "device": torch.cuda.get_device_name(0),
        "card": card_name_and_power_limit(),
    }))


if __name__ == "__main__":
    main()
