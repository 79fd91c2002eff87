"""Ensemble inference and the DCASE answer writer (scripts/make_answer.py;
the reference's make_answer.py and evaluator.py).

    python -m seld_tpu_torch.make_answer --data <feat_label dir> \\
        --mode test --models SS5:<ckpt1> SS5:<ckpt2> \\
        --ans_path <metadata_dev dir> --output_path ./answer [--fast]

Each --models entry is `<model_config>:<checkpoint dir>`, a checkpoint the
port's trainer saved (`bestscore_*`, `SWA_best_*`). The members' sliding-
window outputs are averaged, thresholded per class and written as DCASE
CSVs; without --submit they are scored against <ans_path>/dev-<mode> with
the official metric. Runs on the card (--device cuda, the default) unless
--device cpu; without a card it exits non-zero.
"""
from __future__ import annotations

import argparse
import os
import sys
from glob import glob

import numpy as np
import torch


def require_device(device: str, prog: str) -> None:
    """Exit non-zero, printing nothing on stdout, where `device` is the card
    and there is none: the entry points never fall back to the CPU."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        sys.exit(f"{prog}: no CUDA device (pass --device cpu to run on the "
                 "CPU)")


def load_member(spec: str, model_name: str, n_classes: int, device):
    """(model, model config) of a `<model_config>:<checkpoint dir>` entry."""
    from seld_tpu_torch.config import resolve_model_config
    from seld_tpu_torch.models import build_model
    from seld_tpu_torch.train.checkpoint import load_variables

    config_path, ckpt_path = spec.split(":", 1)
    model_config = resolve_model_config(config_path)
    model_config["n_classes"] = n_classes
    model = build_model(model_name, (300, 64, 7), model_config,
                        device=device)
    load_variables(os.path.abspath(ckpt_path.rstrip("/")), model)
    return model, model_config


def members_outputs(specs, xs, *, model_name: str, n_classes: int,
                    batch: int, fast: bool = False, quantize: str = "none",
                    bf16: bool = False, clip_batch: int = 1,
                    device="cuda"):
    """The members' averaged sliding-window outputs on the clips `xs`.

    quantize: score dequantize(quantize(w)), what a --quantize artifact
    computes. bf16: every float entry of the members, and the clips, in
    bfloat16 (the default f32 is the reference's numerics).
    """
    from seld_tpu_torch.inference import (average_ensemble,
                                          dequantize_tree, ensemble_outputs,
                                          quantize_tree)

    if fast and model_name != "conv_temporal":
        raise SystemExit("--fast supports conv_temporal only (it needs the "
                         "model's trunk/head split)")
    xs = [torch.from_numpy(np.asarray(x, np.float32)) for x in xs]
    if bf16:
        xs = [x.to(torch.bfloat16) for x in xs]
    outs = []
    for spec in specs:
        model, model_config = load_member(spec, model_name, n_classes,
                                          device)
        if quantize != "none":
            model.load_state_dict(dequantize_tree(
                quantize_tree(model.state_dict(), quantize)))
        if bf16:
            model.to(torch.bfloat16)
        # the trunk's time downsampling comes from THIS model's config;
        # the fast path checks it against the trunk's output length
        time_down = model_config.get("first_pool_size", [5, 1])[0]
        outs.append(ensemble_outputs(model, xs, batch_size=batch, fast=fast,
                                     time_down=time_down,
                                     clip_batch=clip_batch))
    return average_ensemble(outs)


def parse_thresholds(value: str, n_classes: int):
    """'class' (the shipped per-class table), a float, or a comma list."""
    from seld_tpu_torch.inference import DEFAULT_CLASS_THRESHOLDS

    if value == "class":
        if n_classes > len(DEFAULT_CLASS_THRESHOLDS):
            raise SystemExit(
                f"--thresholds class provides {len(DEFAULT_CLASS_THRESHOLDS)}"
                f" per-class values; pass a scalar for "
                f"--n_classes {n_classes}")
        return DEFAULT_CLASS_THRESHOLDS[:n_classes]
    if "," in value:
        # per-class table, e.g. from search_best
        thresholds = np.asarray([float(v) for v in value.split(",")],
                                np.float32)
        if thresholds.shape[0] != n_classes:
            raise SystemExit(f"--thresholds lists {thresholds.shape[0]} "
                             f"values for --n_classes {n_classes}")
        return thresholds
    return float(value)


def main(argv=None):
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda")
    require_device(pre.parse_known_args(argv)[0].device,
                   "seld_tpu_torch.make_answer")

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--data", required=True, help="feat_label dir")
    ap.add_argument("--mode", default="test", choices=["train", "val", "test"])
    ap.add_argument("--models", nargs="+", required=True,
                    help="<model_config>:<checkpoint dir> entries")
    ap.add_argument("--model", default="conv_temporal")
    ap.add_argument("--output_path", default="./make_answer_out")
    ap.add_argument("--ans_path", default=None)
    ap.add_argument("--submit", action="store_true",
                    help="write eval-split submission CSVs (no scoring)")
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--n_classes", type=int, default=12)
    ap.add_argument("--thresholds", default="class",
                    help="'class' (per-class table), a float, or a "
                         "comma-separated per-class list")
    ap.add_argument("--class_wise", action="store_true",
                    help="also print per-class recall/precision "
                         "(evaluator.py CLASS_WISE_EVAL)")
    ap.add_argument("--fast", action="store_true",
                    help="trunk-once sliding window (near-exact: conv edge "
                         "effects at window boundaries)")
    ap.add_argument("--clip_batch", type=int, default=1,
                    help="--fast: equal-length clips stacked per head chunk")
    ap.add_argument("--quantize", default="none",
                    choices=["none", "int8", "bfloat16"],
                    help="score with weight-only-quantised members "
                         "(dequantize(quantize(w)), what a --quantize "
                         "artifact computes)")
    ap.add_argument("--bf16", action="store_true",
                    help="bfloat16 weights + activations for inference "
                         "(default fp32 = reference numerics)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from seld_tpu_torch.data.loader import SPLITS, load_seldnet_data
    from seld_tpu_torch.inference import evaluate_clips_official
    from seld_tpu_torch.utils import io

    if args.submit:
        # eval split: no fold digits in filenames, load everything
        feat_dir = os.path.join(args.data, "foa_eval_norm")
        files = sorted(glob(os.path.join(feat_dir, "*.npy")))
        xs = [np.load(f).astype("float32") for f in files]
        if xs and xs[0].ndim == 2:
            xs = [np.transpose(x.reshape(x.shape[0], -1, 64), (0, 2, 1))
                  for x in xs]
        name_list = [os.path.splitext(os.path.basename(f))[0] for f in files]
    else:
        if args.ans_path is None:
            raise SystemExit("--ans_path (metadata_dev dir) is required for "
                             "scoring mode; use --submit to skip scoring")
        feat_dir = os.path.join(args.data, "foa_dev_norm")
        label_dir = os.path.join(args.data, "foa_dev_label")
        xs, ys = load_seldnet_data(feat_dir, label_dir, mode=args.mode)
        name_list = sorted(glob(os.path.join(feat_dir, "*.npy")))
        name_list = [os.path.splitext(os.path.basename(f))[0]
                     for f in name_list
                     if int(os.path.basename(f)[4]) in SPLITS[args.mode]]

    outputs = members_outputs(
        args.models, xs, model_name=args.model, n_classes=args.n_classes,
        batch=args.batch, fast=args.fast, quantize=args.quantize,
        bf16=args.bf16, clip_batch=args.clip_batch, device=args.device)
    thresholds = parse_thresholds(args.thresholds, args.n_classes)

    if args.submit:
        os.makedirs(args.output_path, exist_ok=True)
        for name, (sed, doa) in zip(name_list, outputs):
            io.write_answer(args.output_path, name + ".csv",
                            sed.cpu().numpy() > thresholds,
                            doa.cpu().numpy())
        print(f"wrote {len(outputs)} submission CSVs to {args.output_path}")
        return None

    gt_dir = os.path.join(args.ans_path, f"dev-{args.mode}")
    seld, (er, f, le, lr) = evaluate_clips_official(
        outputs, name_list, gt_dir, args.output_path,
        thresholds=thresholds, n_classes=args.n_classes)
    print(f"ensemble outputs\nER: {er:4f}, F: {f:4f}, DER: {le:4f}, "
          f"DERF: {lr:4f}, SELD: {seld:4f}")

    if args.class_wise:
        # per-class recall/precision from the streaming metric
        # (evaluator.py:106-122)
        from seld_tpu_torch.data.transforms import \
            split_total_labels_to_sed_doa
        from seld_tpu_torch.train import metrics as SM
        m = SM.SELDMetrics(n_classes=args.n_classes, device=args.device)
        th = torch.as_tensor(thresholds, device=args.device)
        for (sed, doa), y in zip(outputs, ys):
            y = torch.from_numpy(y[:sed.shape[0]]).to(args.device)
            y_sed, y_doa = split_total_labels_to_sed_doa(None, y)[1]
            m.update_states((y_sed[None], y_doa[None]),
                            ((sed > th)[None].float(), doa[None]))
        recall, precision = m.class_result()
        for c in range(args.n_classes):
            print(f"class {c}: recall {float(recall[c]):.4f} "
                  f"precision {float(precision[c]):.4f}")
    return seld, (er, f, le, lr)


if __name__ == "__main__":
    main()
