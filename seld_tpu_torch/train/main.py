"""SELD training entry point, the twin of the JAX package's scripts/train.py.

    python -m seld_tpu_torch.train --name exp0 --model conv_temporal \\
        --model_config SS5 --doa_loss MMSE --abspath <root> \\
        --from_wav --device_data --bf16 --use_tfm --use_acs --agc true

The flags are the JAX package's (config/params.py), plus `--device`
(default cuda; without a card the run refuses to start rather than fall
back to the CPU). Data sources under --abspath:
  default     DCASE2021/feat_label/foa_dev_norm/*.npy + foa_dev_label/*.npy
  --from_wav  foa_dev/*.wav + metadata_dev/*.csv, through the front-end
              kernel on the card; the train-split normalizer is written to
              ./saved_model/<run>/normalizer.npz
Checkpoints go to ./saved_model/<run>/bestscore_<score>, scalars to
./tensorboard_log/<run>/scalars.jsonl, run configs to ./config/.

When <ans_path>/dev-test holds ground-truth CSVs, the test split's full
clips are scored every --eval_every epochs by sliding-window overlap-add
against the official scorer (ENS_T/* scalars, CSVs under --output_path),
and after training the SWA average is scored and saved as
./saved_model/<run>/SWA_best_<score>.

With --device_data, --epoch_scan runs each train epoch as one epoch step
(gather, augment and update a step, captured once as a CUDA graph and
replayed a step at a time on the card; a plain loop with --device cpu),
and --fuse_metrics accumulates the metric inside it.

Flags whose code is not ported raise: --use_tdm, --use_both and
--wav_mode mic.
"""
from __future__ import annotations

import argparse
import os
import time
from glob import glob

import numpy as np
import torch

from seld_tpu_torch.config.params import get_param
from seld_tpu_torch.data import transforms as T
from seld_tpu_torch.data.device_dataset import DeviceDataset
from seld_tpu_torch.data.loader import SeldDataset, load_seldnet_data
from seld_tpu_torch.train.checkpoint import save_checkpoint
from seld_tpu_torch.train.trainer import SELDTrainer

# flag -> (value that runs unported code, ROADMAP item that ports it)
_UNPORTED = {
    "use_tdm": (True, "TDM mixing (queue 1, item 6)"),
    "use_both": (True, "the joint FOA+MIC input (queue 1, item 8)"),
    "wav_mode": ("mic", "the microphone-array features (queue 1, item 8)"),
}


def tfm_profile(config):
    """(time_size, freq_size, time_n_mask, freq_n_mask) for the active loop:
    v2 (--swa on) hardcodes 6/8 x 10/6 and ignores the size flags; v1
    (--swa off) takes the flag sizes, one mask each."""
    if getattr(config, "swa", True):
        return 6, 8, 10, 6
    return config.time_mask_size, config.freq_mask_size, 1, 1


def build_augment(config):
    """--use_tfm masking as the selected loop does it (v2 adds the random
    gain); --use_acs is the FOA intensity-vector aug."""
    fns = []
    if getattr(config, "use_tfm", False):
        t_size, f_size, t_n, f_n = tfm_profile(config)
        if getattr(config, "swa", True):
            fns.append(T.random_ups_and_downs)
        fns.append(lambda g, x, y: (T.batch_mask(
            g, x, axis=-3, max_mask_size=t_size, n_mask=t_n,
            period=config.tfm_period), y))
        fns.append(lambda g, x, y: (T.batch_mask(
            g, x, axis=-2, max_mask_size=f_size, n_mask=f_n,
            period=config.tfm_period), y))
    if getattr(config, "use_acs", False):
        fns.append(T.foa_intensity_vec_aug)
    return T.compose(*fns) if fns else None


def build_datasets(config, device):
    """({split: SeldDataset} for train, val and test, the test split's full
    clips for the ensemble evaluation)."""
    feat_dtype = torch.bfloat16 if getattr(config, "bf16", False) else None
    if getattr(config, "from_wav", False):
        from seld_tpu_torch.data.wav_pipeline import make_wav_datasets
        datasets, splits, stats = make_wav_datasets(
            os.path.join(config.abspath, "foa_dev"),
            os.path.join(config.abspath, "metadata_dev"),
            batch=config.batch, loop_time=config.loop_time, n_classes=12,
            feature_dtype=feat_dtype, device=device)
        # a wav-native checkpoint is unservable without its normalizer
        norm_dir = os.path.join("./saved_model", config.name)
        os.makedirs(norm_dir, exist_ok=True)
        np.savez(os.path.join(norm_dir, "normalizer.npz"),
                 mean=np.asarray(stats[0]), std=np.asarray(stats[1]))
        return datasets, list(splits["test"][0])

    path = os.path.join(config.abspath, "DCASE2021/feat_label/")
    datasets = {}
    test_xs = None
    for mode in ("train", "val", "test"):
        x, y = load_seldnet_data(os.path.join(path, "foa_dev_norm"),
                                 os.path.join(path, "foa_dev_label"),
                                 mode=mode, n_freq_bins=64)
        if mode == "test":
            test_xs = x
        datasets[mode] = SeldDataset.from_clips(
            x, y, batch_size=config.batch, train=mode == "train",
            loop_time=config.loop_time, feature_dtype=feat_dtype)
    return datasets, test_xs


def _check_flags(config, device):
    for flag, (value, what) in _UNPORTED.items():
        if getattr(config, flag, None) == value:
            raise NotImplementedError(
                f"--{flag} runs {what}, which is not ported yet (ROADMAP)")
    if getattr(config, "epoch_scan", False) and not getattr(
            config, "device_data", False):
        raise ValueError("--epoch_scan requires --device_data (the epoch "
                         "scan gathers from the HBM-resident dataset)")
    if getattr(config, "fuse_metrics", False) and not getattr(
            config, "epoch_scan", False):
        raise ValueError("--fuse_metrics only applies to the --epoch_scan "
                         "path (metrics accumulate inside the epoch scan)")
    if config.resume and getattr(config, "init_from", ""):
        raise ValueError("--resume restores this run's full training state; "
                         "--init_from starts a fresh fine-tune from external "
                         "weights — pick one")
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("seld_tpu_torch.train: no CUDA device (pass "
                         "--device cpu to train on the CPU)")


def main(argv=None):
    """Parse the flags, build the datasets and train; returns the fit
    result with the trainer ("trainer") and the seconds the datasets took
    to build ("setup_secs")."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda")
    known, rest = pre.parse_known_args(argv)
    device = known.device
    config, model_config = get_param(rest)
    _check_flags(config, device)

    t0 = time.perf_counter()
    datasets, test_xs = build_datasets(config, device)
    trainer = SELDTrainer(config, model_config, n_classes=12,
                          input_shape=(300, 64, 7), device=device)
    trainer.set_augment(build_augment(config))
    if config.resume:
        if not trainer.resume():
            raise ValueError("the model does not exist, cannot be resumed")
        print(f"resumed from epoch {trainer.start_epoch}")
    elif getattr(config, "init_from", ""):
        trainer.init_from(config.init_from)
        print(f"initialized params from {config.init_from}")

    # periodic full-clip ensemble eval against the official scorer
    gt_dir = os.path.join(config.ans_path, "dev-test")
    eval_fn = None
    if os.path.exists(gt_dir):
        names = sorted(os.path.splitext(os.path.basename(f))[0]
                       for f in glob(os.path.join(gt_dir, "*.csv")))

        def eval_fn(tr, epoch):
            seld, mv = tr.evaluate_ensemble(
                test_xs, names, gt_dir, config.output_path, epoch)
            print(f"ensemble @ {epoch}: ER {mv[0]:.4f} F {mv[1]:.4f} "
                  f"LE {mv[2]:.4f} LR {mv[3]:.4f} SELD {seld:.4f}")

    trainset = datasets["train"]
    if getattr(config, "device_data", False):
        # stage every split on the card once; each step then gathers its
        # batch there from a row of the epoch's index matrix
        def to_device(ds, train):
            dev = DeviceDataset(ds.x, ds.y, ds.batch_size, device,
                                train=train, loop_time=ds.loop_time)
            print(f"device_data: staged {dev.n_windows} windows "
                  f"({dev.hbm_bytes() / 1e9:.2f} GB) on {device}")
            return dev
        trainset = to_device(trainset, True)
        for split in ("val", "test"):
            datasets[split] = to_device(datasets[split], False)
    setup_secs = time.perf_counter() - t0

    result = trainer.fit(trainset, datasets["val"], datasets["test"],
                         eval_fn=eval_fn, eval_every=config.eval_every)
    print(f"best val seld score: {result['best_score']:.5f}")

    # final SWA evaluation + save (trainv2.py:362-369)
    if trainer.swa.count > 0 and eval_fn is not None:
        seld, _ = trainer.evaluate_ensemble(
            test_xs, names, gt_dir, config.output_path,
            result["last_epoch"], params=trainer.swa_params(),
            batch_stats=trainer.swa_batch_stats())
        save_checkpoint(trainer.workdir, f"SWA_best_{seld:.5f}",
                        trainer.state, trainer.swa,
                        params=trainer.swa_params())
        print(f"SWA seld score: {seld:.5f}")
    return {**result, "trainer": trainer, "setup_secs": setup_secs}
