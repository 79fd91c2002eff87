"""Import a trained reference Keras checkpoint for serving on the card
(scripts/import_tf_weights.py).

The reference publishes its trained models as legacy HDF5 files saved by
`tf.keras.models.save_model(model, f'SWA_best_{score}.hdf5',
include_optimizer=False)` (reference trainv2.py:366-369). This tool maps
such a file onto the port's model (`compat.keras_h5`) and writes a
checkpoint of its variables that the inference tools load
(`make_answer --models`, `predict_wav --ckpt`, `stream_demo`):

    python -m seld_tpu_torch.import_tf_weights \\
        --weights saved_model/..._v_0/SWA_best_0.34466397762298584.hdf5 \\
        --model_config SS5 --out ./imported/ss5_swa

    python -m seld_tpu_torch.make_answer --data <feat dir> \\
        --models SS5:./imported/ss5_swa ...

Requires h5py only (no TensorFlow). The model runs one forward on the card
(--device cuda, the default) to record its application order, unless
--device cpu; without a card it exits non-zero.
"""
from __future__ import annotations

import argparse
import os


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--weights", required=True,
                    help="legacy Keras .hdf5 file (full-model or "
                         "weights-only)")
    ap.add_argument("--model", default="conv_temporal")
    ap.add_argument("--model_config", required=True,
                    help="model config name (zoo / ./model_config) or a "
                         ".json path; must match the checkpoint's "
                         "architecture")
    ap.add_argument("--input_shape", default="300,64,7",
                    help="feature input shape T,F,C (reference "
                         "evaluator.py:74)")
    ap.add_argument("--n_classes", type=int, default=12)
    ap.add_argument("--out", required=True, help="checkpoint directory")
    ap.add_argument("--drop", nargs="*", default=(),
                    help="h5 layer names to force-ignore (normally "
                         "unnecessary: the pre-LN attention_block's "
                         "discarded LayerNorms are found automatically)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from seld_tpu_torch.make_answer import require_device
    require_device(args.device, "seld_tpu_torch.import_tf_weights")

    import torch

    from seld_tpu_torch.compat import import_keras_weights
    from seld_tpu_torch.config import resolve_model_config
    from seld_tpu_torch.models import build_model
    from seld_tpu_torch.train.checkpoint import save_variables

    out = os.path.abspath(args.out)
    if os.path.exists(out):  # fail fast, before the import
        raise SystemExit(f"{out} already exists")

    input_shape = tuple(int(v) for v in args.input_shape.split(","))
    model_config = resolve_model_config(args.model_config)
    model_config["n_classes"] = args.n_classes
    model = build_model(args.model, input_shape, model_config,
                        device=args.device)
    x = torch.zeros((1, *input_shape), device=args.device)
    model.load_state_dict(import_keras_weights(model, args.weights, x,
                                               drop=args.drop))
    n_params = sum(p.numel() for p in model.parameters())
    save_variables(out, model, {
        "imported_from": os.path.abspath(args.weights),
        "model": args.model, "model_config": args.model_config,
        "input_shape": list(input_shape), "n_classes": args.n_classes})
    print(f"imported {args.weights} -> {out} ({n_params:,} params)")


if __name__ == "__main__":
    main()
