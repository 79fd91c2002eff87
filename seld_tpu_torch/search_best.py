"""Per-class SED threshold search over a (possibly ensembled) model set on
the validation split (scripts/search_best.py; the reference's
search_best.py).

    python -m seld_tpu_torch.search_best --data <feat_label dir> \\
        --models SS5:<ckpt1> SS5:<ckpt2> --ans_path <metadata_dev dir> \\
        [--fast] [--bf16]

Averages the members' sliding-window outputs on dev-val, runs the greedy
per-class threshold search (`seld_tpu_torch.inference.search_thresholds`),
and prints the searched table both human-readable and as a comma-separated
string ready for `python -m seld_tpu_torch.make_answer --thresholds`, then
a `THRESHOLDS_JSON:` line. Runs on the card unless --device cpu.
"""
from __future__ import annotations

import argparse
import json
import os
from glob import glob

from seld_tpu_torch.make_answer import members_outputs, require_device


def main(argv=None):
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda")
    require_device(pre.parse_known_args(argv)[0].device,
                   "seld_tpu_torch.search_best")

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--data", required=True, help="feat_label dir")
    ap.add_argument("--models", nargs="+", required=True,
                    help="<model_config>:<checkpoint dir> entries")
    ap.add_argument("--model", default="conv_temporal")
    ap.add_argument("--ans_path", required=True,
                    help="metadata_dev dir (ground-truth CSVs)")
    ap.add_argument("--output_path", default="./search_best_out")
    ap.add_argument("--mode", default="val", choices=["val", "test"])
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--n_classes", type=int, default=12)
    ap.add_argument("--fast", action="store_true",
                    help="trunk-once sliding window (conv_temporal)")
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--quantize", default="none",
                    choices=["none", "int8", "bfloat16"],
                    help="search thresholds on the weight-only-quantised "
                         "deployment numerics (dequantize(quantize(w)))")
    ap.add_argument("--verbose", action="store_true",
                    help="print per-class progress")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from seld_tpu_torch.data.loader import SPLITS, load_seldnet_data
    from seld_tpu_torch.inference import search_thresholds

    feat_dir = os.path.join(args.data, "foa_dev_norm")
    label_dir = os.path.join(args.data, "foa_dev_label")
    xs, _ = load_seldnet_data(feat_dir, label_dir, mode=args.mode)
    names = sorted(os.path.splitext(os.path.basename(f))[0]
                   for f in glob(os.path.join(feat_dir, "*.npy"))
                   if int(os.path.basename(f)[4]) in SPLITS[args.mode])

    outputs = members_outputs(
        args.models, xs, model_name=args.model, n_classes=args.n_classes,
        batch=args.batch, fast=args.fast, quantize=args.quantize,
        bf16=args.bf16, device=args.device)
    gt_dir = os.path.join(args.ans_path, f"dev-{args.mode}")
    thresholds, best = search_thresholds(
        outputs, names, gt_dir, args.output_path,
        n_classes=args.n_classes, verbose=args.verbose)
    table = ",".join(f"{t:.2f}" for t in thresholds)
    print(f"best {args.mode} SELD with searched thresholds: {best:.5f}")
    print(f"--thresholds {table}")
    print("THRESHOLDS_JSON:" + json.dumps(
        {"thresholds": [float(t) for t in thresholds], "best": float(best)}))
    return thresholds, best


if __name__ == "__main__":
    main()
