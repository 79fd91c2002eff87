"""CLI flag parsing for the training entry point: a copy of
seld_tpu/config/params.py (the reference's flag surface, the model-config
JSON resolution and the composed run name
`{model}_{model_config}_{doa_loss}_{name}`, persisted through the
versioned config store), pinned equal to it by tests/test_torch_imports.py.
The help texts are the JAX package's; the port's training CLI
(seld_tpu_torch/train/__main__.py) adds its own `--device` and refuses the
flags whose code is not ported.
"""
from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence, Tuple

from seld_tpu_torch.config.manager import get_config
from seld_tpu_torch.config.zoo import get_model_config

# (name, kwargs) — one row per reference flag, grouped as in params.py
_FLAG_SPEC = [
    # identity / paths
    ("--name", dict(type=str, required=True)),
    ("--gpus", dict(type=str, default="-1")),          # accepted, unused on TPU
    ("--resume", dict(action="store_true")),
    ("--abspath", dict(type=str, default="./")),
    ("--config_mode", dict(type=str, default="")),
    ("--doa_loss", dict(type=str, default="MSE",
                        choices=["MAE", "MSE", "MSLE", "MMSE"])),
    ("--model", dict(type=str, default="seldnet")),
    ("--model_config", dict(type=str, default="")),
    ("--output_path", dict(type=str, default="./output")),
    ("--ans_path", dict(type=str, default="./metadata_dev/")),
    # training
    ("--lr", dict(type=float, default=0.001)),
    ("--decay", dict(type=float, default=0.5)),
    ("--batch", dict(type=int, default=256)),
    # NOT argparse type=bool (the reference's bug: bool('false') is True,
    # so '--agc false' silently ENABLED AGC there); accepts true/false or a
    # numeric clip factor (trainer treats a float as the AGC clip)
    ("--agc", dict(type=lambda v: {"true": True, "1": True, "false": False,
                                   "0": False}.get(v.lower(), None)
                   if v.lower() in ("true", "false", "0", "1")
                   else float(v),
                   default=False)),
    ("--epoch", dict(type=int, default=1000)),
    ("--loss_weight", dict(type=str, default="1,1000")),
    ("--lr_patience", dict(type=int, default=80,
                           help="learning rate decay patience for plateau")),
    ("--patience", dict(type=int, default=100, help="early stop patience")),
    ("--freq_mask_size", dict(type=int, default=16)),
    ("--time_mask_size", dict(type=int, default=24)),
    ("--tfm_period", dict(type=int, default=100)),
    ("--use_acs", dict(action="store_true")),
    ("--use_tdm", dict(action="store_true")),
    ("--use_tfm", dict(action="store_true")),
    ("--loop_time", dict(type=int, default=5,
                         help="times of train dataset iter for an epoch")),
    ("--tdm_epoch", dict(type=int, default=2,
                         help="epochs of applying tdm augmentation; 0 = off")),
    # metric / SED loss
    ("--lad_doa_thresh", dict(type=int, default=20)),
    ("--sed_loss", dict(type=str, default="BCE", choices=["BCE", "FOCAL"])),
    ("--focal_g", dict(type=float, default=2)),
    ("--focal_a", dict(type=float, default=0.25)),
    # TPU-native additions
    ("--mesh", dict(type=str, default="data:-1",
                    help='mesh spec "axis:size[,axis:size]"; -1 = all devices')),
    ("--bf16", dict(action="store_true",
                    help="bfloat16 compute (params stay fp32)")),
    ("--label_smoothing", dict(type=float, default=0.0)),
    # --swa off = reference train.py (v1) semantics: no weight averaging, no
    # lr halving at swa_start, and plateau decay runs for the WHOLE schedule
    # (train.py:372-390). Default on = trainv2.py challenge semantics.
    # argparse only turns ValueError/TypeError from `type` into a clean
    # usage error — a dict KeyError would escape as a raw traceback
    ("--swa", dict(type=lambda v: {"on": True, "true": True, "1": True,
                                   "off": False, "false": False,
                                   "0": False}.get(v.lower(), v.lower()),
                   choices=[True, False], default=True,
                   metavar="{on,off}")),
    ("--swa_start", dict(type=int, default=80)),
    ("--swa_freq", dict(type=int, default=2)),
    ("--eval_every", dict(type=int, default=10,
                          help="full-clip official-ensemble eval cadence "
                               "(trainv2.py:328 hardcodes 10)")),
    ("--from_wav", dict(action="store_true",
                        help="train from raw wavs via the on-device "
                             "front-end; features never touch disk")),
    ("--wav_mode", dict(type=str, default="foa", choices=["foa", "mic"],
                        help="--from_wav modality: foa (7ch log-mel+IV) or "
                             "mic (10ch log-mel+GCC-PHAT); with --use_both "
                             "both are extracted (17ch)")),
    ("--use_both", dict(action="store_true",
                        help="joint FOA+MIC dataset (17ch) with acs_aug "
                             "channel swaps (reference train.py:178-208)")),
    ("--device_data", dict(action="store_true",
                           help="stage the windowed train split in HBM once "
                                "and gather batches on device (feed is a "
                                "~1 KB index vector/step instead of ~72 MB "
                                "of features); single-process only")),
    ("--epoch_scan", dict(action="store_true",
                          help="with --device_data: run each train epoch as "
                               "ONE compiled lax.scan dispatch (gather + "
                               "augment + update fused on device)")),
    ("--fuse_metrics", dict(action="store_true",
                            help="with --epoch_scan: accumulate metrics "
                                 "inside the scan (no per-step label/pred "
                                 "stacking; slower compile, reused across "
                                 "epochs)")),
    ("--init_from", dict(type=str, default="",
                         help="warm-start params (+BN stats) from an orbax "
                              "checkpoint — e.g. scripts/import_tf_weights.py "
                              "output — with a FRESH optimizer/schedule "
                              "(fine-tune); unlike --resume, which restores "
                              "the full training state of this run")),
]


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    for flag, kwargs in _FLAG_SPEC:
        parser.add_argument(flag, **kwargs)
    return parser


def get_param(argv: Optional[Sequence[str]] = None,
              config_path: str = "./config") -> Tuple[argparse.Namespace, dict]:
    """Parse flags -> (run config namespace, model config dict)."""
    config = build_parser().parse_args(argv)

    if len(config.model_config) == 0:
        config.model_config = config.model
    config.model_config = os.path.splitext(config.model_config)[0]
    model_config = get_model_config(
        config.model_config,
        search_paths=[os.path.join(config.abspath, "model_config"),
                      "./model_config"])

    config.name = "_".join([config.model, config.model_config,
                            config.doa_loss, config.name])
    config = get_config(config.name, config, path=config_path,
                        mode=config.config_mode)
    return config, model_config
