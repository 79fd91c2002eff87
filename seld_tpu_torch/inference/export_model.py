"""Write a window serving artifact for the port's server.

    # seeded Keras-style weights (no trained checkpoint needed):
    python -m seld_tpu_torch.inference.export_model --model_config SS5 \
        --seed 0 --out ss5_window.npz

    # weights from the JAX package, saved as a flat .npz whose keys are the
    # flax paths ("params/Conv2DBN_0/Conv_0/kernel", "batch_stats/...")
    python -m seld_tpu_torch.inference.export_model --model_config SS5 \
        --variables ss5_flax.npz --out ss5_window.npz

Serve it with `python -m seld_tpu_torch.serving.serve --artifact <out>`.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="conv_temporal")
    ap.add_argument("--model_config", required=True,
                    help="zoo name or a model-config JSON path")
    ap.add_argument("--out", required=True, help="artifact file to write")
    ap.add_argument("--variables", default="",
                    help="flax variables as a flat .npz keyed by path; "
                         "empty = seeded initial weights")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n_classes", type=int, default=12)
    ap.add_argument("--win_size", type=int, default=300)
    ap.add_argument("--n_freq", type=int, default=64)
    ap.add_argument("--n_chan", type=int, default=7,
                    help="7 foa / 10 mic / 17 joint")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--batch", type=int, default=0,
                    help="0 = every batch size; N = static batch (the "
                         "server pads and chunks each dispatch to N rows)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--verify", action="store_true",
                    help="reload the artifact and check it matches the live "
                         "model on random input")
    args = ap.parse_args(argv)

    from seld_tpu_torch.bridge import from_flax, load_npz
    from seld_tpu_torch.config import resolve_model_config
    from seld_tpu_torch.inference.export import export_window, load_exported
    from seld_tpu_torch.models import build_model

    cfg = resolve_model_config(args.model_config)
    cfg["n_classes"] = args.n_classes
    input_shape = (args.win_size, args.n_freq, args.n_chan)
    model = build_model(args.model, input_shape, cfg, seed=args.seed,
                        device=args.device)
    if args.variables:
        model.load_state_dict(from_flax(load_npz(args.variables), model))
    export_window(model, args.out, dtype=args.dtype,
                  batch=args.batch or None,
                  extra_meta={"model_config_name": args.model_config,
                              "variables": args.variables or None,
                              "seed": None if args.variables else args.seed})
    print(f"exported window artifact: {args.out}")

    if args.verify:
        art = load_exported(args.out, device=args.device)
        x = torch.from_numpy(np.random.RandomState(0).randn(
            args.batch or 3, *input_shape).astype(np.float32))
        with torch.inference_mode():
            want = [o.float().cpu().numpy() for o in
                    model(x.to(args.device, art.dtype))]
        # the failure this guards (wrong or missing weights) is O(1) on the
        # sigmoid/tanh heads; the slack covers a GPU library picking another
        # algorithm between two calls
        for got, ref in zip(art.call(x), want):
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
        print("verify: artifact matches the live model")


if __name__ == "__main__":
    main()
