"""Write a serving artifact for the port's server (scripts/export_model.py).

    # seeded Keras-style weights (no trained checkpoint needed):
    python -m seld_tpu_torch.inference.export_model --model_config SS5 \
        --seed 0 --out ss5_window.npz

    # weights from the JAX package, saved as a flat .npz whose keys are the
    # flax paths ("params/Conv2DBN_0/Conv_0/kernel", "batch_stats/...")
    python -m seld_tpu_torch.inference.export_model --model_config SS5 \
        --variables ss5_flax.npz --out ss5_window.npz

    # the whole-clip scorer (trunk-once fast path, fixed 60-s geometry), a
    # two-member ensemble, int8 weights:
    python -m seld_tpu_torch.inference.export_model --model_config SS5 \
        --unit clip --variables a.npz,b.npz --quantize int8 --out clip.npz

    # the real-time streaming engine, a bundle directory (1-s pushes, 4
    # lockstep streams a device step), checked against the live engine:
    python -m seld_tpu_torch.inference.export_model --model_config SS5 \
        --unit stream --n_streams 4 --out ss5_stream --verify

    # a data-parallel window artifact: a static batch of 64 split over two
    # cards (one replica a card), checked against the live model:
    python -m seld_tpu_torch.inference.export_model --model_config SS5 \
        --batch 64 --data_parallel 2 --out ss5_dp.npz --verify

Comma lists in --variables, --seed, --model_config and --model make an
ensemble: one artifact whose call returns the members' average (a list of
one value is broadcast over the members).

Serve it with `python -m seld_tpu_torch.serving.serve --artifact <out>`
(a stream bundle: `--bundle <out>`).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch


def _members(args):
    """(model name, model config, variables path, seed) per member."""
    lists = {k: [v.strip() for v in str(getattr(args, k)).split(",")
                 if v.strip()]
             for k in ("model", "model_config", "variables", "seed")}
    lists["variables"] = lists["variables"] or [""]
    n = max(len(v) for v in lists.values())
    for k, v in lists.items():
        if len(v) not in (1, n):
            raise SystemExit(f"--{k}: {len(v)} values for {n} members")
        lists[k] = v * n if len(v) == 1 else v
    return list(zip(lists["model"], lists["model_config"],
                    lists["variables"], [int(s) for s in lists["seed"]]))


def _fake_quantize(model, quantize) -> None:
    """Give a live model what an artifact of its weights computes:
    dequantize(quantize(w)), with the quantisation's report."""
    from seld_tpu_torch.inference.quantize import (dequantize_tree,
                                                   quantization_report,
                                                   quantize_tree)
    if not quantize:
        return
    state = model.state_dict()
    qstate = quantize_tree(state, quantize)
    rep = quantization_report(state, qstate)
    print(f"quantize {quantize}: weights "
          f"{rep['bytes_before'] / 1e6:.2f} -> "
          f"{rep['bytes_after'] / 1e6:.2f} MB, "
          f"{rep['n_quantized_leaves']} entries, "
          f"max |w - deq(q(w))| = {rep['max_abs_error']:.3e}")
    model.load_state_dict(dequantize_tree(qstate))


def _export_stream(args, model, time_down: int, quantize) -> None:
    """--unit stream: write the bundle; with --verify drive the bundle's
    engine and the live one (the model's fake-quantised weights) on the
    same random stream."""
    from seld_tpu_torch.inference.export import INPUT_DTYPES, \
        export_streaming
    from seld_tpu_torch.inference.streaming import StreamingSELD

    feat_shape = (args.n_freq, args.n_chan)
    geometry = dict(win_size=args.win_size, step_size=args.step_size,
                    time_down=time_down, chunk=args.chunk,
                    n_streams=args.n_streams)
    export_streaming(model, args.out, feat_shape, dtype=args.dtype,
                     quantize=quantize, **geometry)
    exp = StreamingSELD.from_exported(args.out, device=args.device)
    print(f"exported stream bundle: {args.out} (halo {exp.halo_t}, l_f "
          f"{exp.l_f}; serve with StreamingSELD.from_exported or "
          f"serving.serve --bundle)")
    if not args.verify:
        return
    _fake_quantize(model, quantize)
    live = StreamingSELD(model, feat_shape, halo=exp.halo_t,
                         dtype=INPUT_DTYPES[args.dtype], **geometry)
    # one window, then a bootstrap, steady-state pushes and a tail
    x = np.random.RandomState(0).randn(
        args.n_streams, args.win_size + 2 * live.l_f + live.chunk_f,
        *feat_shape).astype(np.float32)
    gl = list(live.push(x)) + list(live.finalize())
    ge = list(exp.push(x)) + list(exp.finalize())
    if len(gl) != len(ge) or not gl:
        raise SystemExit(f"verify: {len(ge)} frames from the bundle, "
                         f"{len(gl)} from the live engine")
    # the slack covers a GPU library picking another algorithm between
    # two engines; wrong or missing weights are O(1) on the heads
    for (sl, dl), (se, de) in zip(gl, ge):
        np.testing.assert_allclose(se, sl, rtol=0, atol=1e-5)
        np.testing.assert_allclose(de, dl, rtol=0, atol=1e-5)
    print("verify: exported stream engine matches the live engine")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="conv_temporal",
                    help="comma list broadcast across ensemble members")
    ap.add_argument("--model_config", required=True,
                    help="zoo name or a model-config JSON path; comma list "
                         "broadcast across ensemble members")
    ap.add_argument("--out", required=True,
                    help="artifact file to write (stream: a directory)")
    ap.add_argument("--variables", default="",
                    help="flax variables as a flat .npz keyed by path; "
                         "empty = seeded initial weights; comma-separate N "
                         "files for an N-member ensemble")
    ap.add_argument("--seed", default="0",
                    help="seed of the initial weights; comma list for an "
                         "ensemble of seeded members")
    ap.add_argument("--unit", default="window",
                    choices=["window", "clip", "stream"],
                    help="window: [b, win, F, C] forward, any batch; clip: "
                         "fixed-length trunk-once clip scorer "
                         "(conv_temporal); stream: the real-time "
                         "streaming engine's bundle (conv_temporal, one "
                         "member)")
    ap.add_argument("--n_classes", type=int, default=12)
    ap.add_argument("--win_size", type=int, default=300)
    ap.add_argument("--n_freq", type=int, default=64)
    ap.add_argument("--n_chan", type=int, default=7,
                    help="7 foa / 10 mic / 17 joint")
    ap.add_argument("--step_size", type=int, default=5,
                    help="clip unit: window stride in feature frames")
    ap.add_argument("--clip_frames", type=int, default=3000,
                    help="clip unit: fixed clip length (3000 = 60 s DCASE)")
    ap.add_argument("--chunk", type=int, default=10,
                    help="stream unit: label frames per device step "
                         "(10 = 1 s)")
    ap.add_argument("--n_streams", type=int, default=1,
                    help="stream unit: lockstep streams per device step")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--quantize", default="none",
                    choices=["none", "int8", "bfloat16"],
                    help="weight-only quantisation of the stored weights: "
                         "int8 = per-output-channel symmetric (~4x smaller), "
                         "bfloat16 = cast weights (~2x); dequantised on the "
                         "device at load (inference/quantize.py)")
    ap.add_argument("--batch", type=int, default=0,
                    help="window unit: 0 = every batch size; N = static "
                         "batch (the server pads and chunks each dispatch "
                         "to N rows)")
    ap.add_argument("--data_parallel", type=int, default=0,
                    help="window unit, one member: split the static --batch "
                         "over this many devices (a replica a device, one "
                         "dispatch spanning them)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--verify", action="store_true",
                    help="reload the artifact and check it matches the live "
                         "model(s) on random input")
    args = ap.parse_args(argv)
    members = _members(args)
    if args.unit in ("clip", "stream") and \
            {m for m, *_ in members} != {"conv_temporal"}:
        raise SystemExit(f"--unit {args.unit} needs the trunk/head stage "
                         "split (conv_temporal only)")
    if args.unit == "stream" and len(members) > 1:
        raise SystemExit("--unit stream serves one engine per model; "
                         "export each member separately")
    if args.data_parallel and args.unit != "window":
        raise SystemExit(f"--data_parallel is a window-unit option; "
                         f"--unit {args.unit} artifacts are single-device")
    if args.data_parallel:
        if len(members) > 1:
            raise SystemExit("--data_parallel supports single-model "
                             "window exports")
        if torch.device(args.device).type == "cuda" and \
                torch.cuda.device_count() < args.data_parallel:
            raise SystemExit(f"--data_parallel {args.data_parallel}: only "
                             f"{torch.cuda.device_count()} devices visible")

    from seld_tpu_torch.bridge import from_flax, load_npz
    from seld_tpu_torch.config import resolve_model_config
    from seld_tpu_torch.inference import export as E
    from seld_tpu_torch.inference.ensemble import _predict_clip_fast
    from seld_tpu_torch.models import build_model

    input_shape = (args.win_size, args.n_freq, args.n_chan)
    quantize = None if args.quantize == "none" else args.quantize
    models, time_downs = [], []
    for name, cfg_name, variables, seed in members:
        cfg = resolve_model_config(cfg_name)
        cfg["n_classes"] = args.n_classes
        model = build_model(name, input_shape, cfg, seed=seed,
                            device=args.device)
        if variables:
            model.load_state_dict(from_flax(load_npz(variables), model))
        models.append(model)
        time_downs.append(cfg.get("first_pool_size", [5, 1])[0])

    extra = {"model_config_name": args.model_config,
             "variables": args.variables or None,
             "seed": None if args.variables else args.seed}
    if args.unit == "stream":
        _export_stream(args, models[0], time_downs[0], quantize)
        return
    if args.unit == "window" and args.data_parallel:
        E.export_window(models[0], args.out, dtype=args.dtype,
                        batch=args.batch or None, quantize=quantize,
                        nr_devices=args.data_parallel, extra_meta=extra)
    elif args.unit == "window":
        E.export_window_ensemble(models, args.out, dtype=args.dtype,
                                 batch=args.batch or None, quantize=quantize,
                                 extra_meta=extra)
    else:
        E.export_clip_fast_ensemble(
            models, args.out, args.clip_frames, win_size=args.win_size,
            step_size=args.step_size, time_downs=time_downs,
            dtype=args.dtype, quantize=quantize, extra_meta=extra)
    print(f"exported {args.unit} artifact: {args.out} "
          f"({len(models)} member(s))")

    if not args.verify:
        return
    for model in models:
        _fake_quantize(model, quantize)
    art = E.load_exported(args.out, device=args.device)
    rng = np.random.RandomState(0)
    if args.unit == "window":
        x = torch.from_numpy(rng.randn(args.batch or 3, *input_shape)
                             .astype(np.float32))
    else:
        x = torch.from_numpy(rng.randn(args.clip_frames, *input_shape[1:])
                             .astype(np.float32))
    xin = x.to(args.device, art.dtype)
    with torch.inference_mode():
        if args.unit == "window":
            # a data-parallel artifact runs row blocks: the live model runs
            # the same blocks, so both pick the same library algorithms
            blocks = xin.chunk(max(args.data_parallel, 1))
            outs = [tuple(torch.cat(o) for o in zip(*(m(b) for b in blocks)))
                    for m in models]
        else:
            outs = [_predict_clip_fast(
                        m, xin, win_size=args.win_size,
                        step_size=args.step_size, batch_size=1 << 30,
                        time_down=td)
                    for m, td in zip(models, time_downs)]
        want = [(sum(o[i].float() for o in outs) / len(outs)).cpu().numpy()
                for i in range(2)]
    # the failure this guards (wrong or missing weights) is O(1) on the
    # sigmoid/tanh heads; the slack covers a GPU library picking another
    # algorithm between two calls
    for got, ref in zip(art.call(x), want):
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    print("verify: artifact matches the live model")


if __name__ == "__main__":
    main()
