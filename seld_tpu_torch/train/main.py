"""SELD training entry point, the twin of the JAX package's scripts/train.py.

    python -m seld_tpu_torch.train --name exp0 --model conv_temporal \\
        --model_config SS5 --doa_loss MMSE --abspath <root> \\
        --from_wav --device_data --bf16 --use_tfm --use_acs --agc true

The flags are the JAX package's (config/params.py), plus `--device`
(default cuda; without a card the run refuses to start rather than fall
back to the CPU). Data sources under --abspath:
  default     DCASE2021/feat_label/foa_dev_norm/*.npy + foa_dev_label/*.npy
  --use_both  the same plus mic_dev_norm/*.npy: 17 channels, FOA + MIC
  --from_wav  foa_dev/*.wav + metadata_dev/*.csv, through the front-end
              kernel on the card (7 channels); --wav_mode mic reads
              mic_dev/*.wav instead (log-mel + GCC-PHAT, 10 channels), and
              --use_both both directories (17 channels); the train-split
              normalizer is written to ./saved_model/<run>/normalizer.npz
Under --use_both, --use_acs is the audio channel swap of the whole joint
input (`acs_aug`), else the FOA intensity-vector augment; the mic input
alone takes neither, and --use_acs with it is refused.
Checkpoints go to ./saved_model/<run>/bestscore_<score>, scalars to
./tensorboard_log/<run>/scalars.jsonl, run configs to ./config/.

--use_tdm rebuilds the train split every --tdm_epoch epochs from
foa_dev's wavs with pasted single-class events (data/tdm_pipeline.py:
the paste on the host, the features on the card, normalization and
windows on the host), on the reference's growing-overlap curriculum; each
rebuild logs its seconds by part. The TDM set is FOA (7 channels), so
--use_tdm with a 10- or 17-channel input is refused. Without foa_dev or
metadata_dev under --abspath, TDM falls back to the static train set, as
the JAX CLI does.

When <ans_path>/dev-test holds ground-truth CSVs, the test split's full
clips are scored every --eval_every epochs by sliding-window overlap-add
against the official scorer (ENS_T/* scalars, CSVs under --output_path),
and after training the SWA average is scored and saved as
./saved_model/<run>/SWA_best_<score>.

Several cards (--mesh, the JAX CLI's flag; default data:-1, every visible
card): one process a card, each a rank of a torch.distributed group.
Under torchrun / python -m torch.distributed.run (RANK and WORLD_SIZE
set) each process joins that group; started plainly with a mesh of more
than one rank, the CLI spawns one worker a rank itself (tcp://localhost).
A spec that asks for more cards than are visible raises. The backend is
NCCL on the card (one rank a card) and gloo on the CPU. Every rank
builds the whole split (the wav front-end on its own card) and keeps its
shard: the staged shard under --device_data, else its strided slice of
the train split (eval splits are sharded a batch at a time). Rank 0 alone
writes the config's checkpoints, normalizer, scalars and the ensemble
evaluation. On one card data:-1 is one rank and no group: the path above.

With --device_data, --epoch_scan runs each train epoch as one epoch step
(gather, augment and update a step, captured once as a CUDA graph and
replayed a step at a time on the card; a plain loop with --device cpu),
and --fuse_metrics accumulates the metric inside it. A TDM rebuild under
--device_data frees the staged split and the epoch step captured over it
before it stages the new one, so one train split is staged at a time.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time
from glob import glob

import numpy as np
import torch

from seld_tpu_torch.config.params import get_param
from seld_tpu_torch.data import transforms as T
from seld_tpu_torch.data.device_dataset import DeviceDataset
from seld_tpu_torch.data.loader import (SeldDataset, load_joint_seldnet_data,
                                        load_seldnet_data, load_wav_clips)
from seld_tpu_torch.parallel.mesh import make_mesh, parse_mesh_spec
from seld_tpu_torch.train.checkpoint import save_checkpoint
from seld_tpu_torch.train.trainer import SELDTrainer


def input_channels(config) -> int:
    """17 for the joint FOA+MIC input, 10 for mic wavs, else 7 (FOA)."""
    if getattr(config, "use_both", False):
        return 17
    if (getattr(config, "from_wav", False)
            and getattr(config, "wav_mode", "foa") == "mic"):
        return 10
    return 7


def tfm_profile(config):
    """(time_size, freq_size, time_n_mask, freq_n_mask) for the active loop:
    v2 (--swa on) hardcodes 6/8 x 10/6 and ignores the size flags; v1
    (--swa off) takes the flag sizes, one mask each."""
    if getattr(config, "swa", True):
        return 6, 8, 10, 6
    return config.time_mask_size, config.freq_mask_size, 1, 1


def build_augment(config):
    """--use_tfm masking as the selected loop does it (v2 adds the random
    gain); --use_acs is the FOA intensity-vector aug, or under --use_both
    the channel swap of the joint FOA+MIC input."""
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
        fns.append(T.acs_aug if getattr(config, "use_both", False)
                   else T.foa_intensity_vec_aug)
    return T.compose(*fns) if fns else None


def build_datasets(config, device, chief=True):
    """({split: SeldDataset} for train, val and test, the test split's full
    clips for the ensemble evaluation); only the `chief` writes the
    normalizer."""
    feat_dtype = torch.bfloat16 if getattr(config, "bf16", False) else None
    use_both = getattr(config, "use_both", False)
    if getattr(config, "from_wav", False):
        from seld_tpu_torch.data.wav_pipeline import make_wav_datasets
        wav_mode = getattr(config, "wav_mode", "foa")
        wav_dir = os.path.join(config.abspath, "foa_dev" if use_both
                               or wav_mode == "foa" else "mic_dev")
        mic_dir = os.path.join(config.abspath, "mic_dev") if use_both \
            else None
        datasets, splits, stats = make_wav_datasets(
            wav_dir, os.path.join(config.abspath, "metadata_dev"),
            batch=config.batch, mode=wav_mode, mic_dir=mic_dir,
            loop_time=config.loop_time, n_classes=12,
            feature_dtype=feat_dtype, device=device)
        # a wav-native checkpoint is unservable without its normalizer
        if chief:
            norm_dir = os.path.join("./saved_model", config.name)
            os.makedirs(norm_dir, exist_ok=True)
            np.savez(os.path.join(norm_dir, "normalizer.npz"),
                     mean=np.asarray(stats[0]), std=np.asarray(stats[1]))
        return datasets, list(splits["test"][0])

    path = os.path.join(config.abspath, "DCASE2021/feat_label/")
    datasets = {}
    test_xs = None
    for mode in ("train", "val", "test"):
        if use_both:
            x, y = load_joint_seldnet_data(path, mode=mode, n_freq_bins=64)
        else:
            x, y = load_seldnet_data(os.path.join(path, "foa_dev_norm"),
                                     os.path.join(path, "foa_dev_label"),
                                     mode=mode, n_freq_bins=64)
        if mode == "test":
            test_xs = x
        datasets[mode] = SeldDataset.from_clips(
            x, y, batch_size=config.batch, train=mode == "train",
            loop_time=config.loop_time, feature_dtype=feat_dtype)
    return datasets, test_xs


def _uses_tdm(config) -> bool:
    return bool(getattr(config, "use_tdm", False)) and config.tdm_epoch != 0


def _check_flags(config, device):
    if _uses_tdm(config) and input_channels(config) != 7:
        raise ValueError(
            f"--use_tdm rebuilds an FOA (7-channel) train set, and this "
            f"run's input has {input_channels(config)} channels (--use_both "
            f"or --from_wav --wav_mode mic): the JAX CLI fails at its first "
            f"step on this pair")
    if getattr(config, "use_acs", False) and input_channels(config) == 10:
        raise ValueError(
            "--use_acs augments the FOA intensity vectors (7 channels) or, "
            "with --use_both, swaps the joint FOA+MIC channels (17); the "
            "10-channel mic input has neither (the JAX CLI fails at its "
            "first step on this pair)")
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


def tdm_provider(config, static_trainset, device):
    """--use_tdm: a function epoch -> train set that rebuilds the split
    with pasted events when epoch % tdm_epoch == 0 or nothing is built yet
    (RandomState(7), the growing-overlap curriculum), and the list it
    appends each rebuild's seconds by part to; or the static train set and
    None when foa_dev or metadata_dev is missing."""
    wav_dir = os.path.join(config.abspath, "foa_dev")
    meta_dir = os.path.join(config.abspath, "metadata_dev")
    if not (os.path.isdir(wav_dir) and os.path.isdir(meta_dir)):
        print(f"use_tdm: raw wav dirs not found under {config.abspath}; "
              "falling back to the static train set")
        return static_trainset, None
    from seld_tpu_torch.data.tdm import build_event_banks
    from seld_tpu_torch.data.tdm_pipeline import (TDMCurriculum,
                                                  make_tdm_trainset)
    wavs, wav_labels = load_wav_clips(wav_dir, meta_dir, "train",
                                      n_classes=12)
    banks = build_event_banks(list(zip(wavs, wav_labels)), n_classes=12)
    curriculum = TDMCurriculum()
    tdm_rng = np.random.RandomState(7)
    cache, rebuilds = {}, []

    def trainset(epoch):
        if epoch % config.tdm_epoch == 0 or "ds" not in cache:
            curriculum.advance(epoch)
            timing = {"epoch": epoch}
            cache.pop("ds", None)
            cache["ds"] = make_tdm_trainset(
                wavs, wav_labels, banks, tdm_rng, config.batch, curriculum,
                loop_time=config.loop_time, device=device, timing=timing)
            rebuilds.append(timing)
            print(f"use_tdm: rebuilt the train split for epoch {epoch} "
                  f"(overlap {curriculum.overlap_num} x "
                  f"{curriculum.overlap_sec} s): paste "
                  f"{timing['paste_s']:.3f} s, extract "
                  f"{timing['extract_s']:.3f} s, normalize + window "
                  f"{timing['normalize_window_s']:.3f} s")
        return cache["ds"]
    return trainset, rebuilds


def _world_of(spec: str, device) -> int:
    """The ranks a run asks for: the mesh spec over the visible cards, or,
    on the CPU, over the spec's own sizes (data:-1 is then one rank)."""
    if torch.device(device).type == "cuda":
        n = torch.cuda.device_count()
    else:
        sizes = [part.partition(":")[2] for part in spec.split(",")]
        n = int(np.prod([int(v) for v in sizes if v not in ("", "-1")]))
    return int(np.prod(list(parse_mesh_spec(spec, n).values())))


def _rank_device(device, local_rank: int) -> torch.device:
    """A rank's device: the card local_rank, or the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.device("cuda", local_rank)
    return device


def _join_group(device, init_method, rank, world) -> None:
    """Join the group: NCCL on the card, gloo on the CPU."""
    import torch.distributed as dist
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        init_method=init_method, rank=rank, world_size=world)


def _train_rank(rank, config, model_config, device):
    """`train` on this rank of the joined group: ranks other than 0 print
    nothing, and the scalar log is closed before the process ends."""
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(
            null if rank else sys.stdout):
        out = train(config, model_config, device)
    out["trainer"].logger.close()
    return out


def _spawned(rank, world, port, config, model_config, device):
    """One worker of a run the CLI spawned: joins the group, trains."""
    import torch.distributed as dist
    device = _rank_device(device, rank)
    _join_group(device, f"tcp://localhost:{port}", rank, world)
    try:
        _train_rank(rank, config, model_config, device)
    finally:
        dist.destroy_process_group()


def main(argv=None):
    """Parse the flags and train on the ranks --mesh asks for (one process
    a rank): see `train` for what a run returns. A run the CLI spawns over
    several ranks returns {"ranks": N} once every worker has ended."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda")
    known, rest = pre.parse_known_args(argv)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        # a torchrun worker: join its group; rank 0 writes the run config
        # first, the others then find it
        import torch.distributed as dist
        rank = int(os.environ["RANK"])
        device = _rank_device(known.device,
                              int(os.environ.get("LOCAL_RANK", rank)))
        _join_group(device, "env://", rank, int(os.environ["WORLD_SIZE"]))
        try:
            if rank == 0:
                config, model_config = get_param(rest)
            dist.all_reduce(torch.zeros(1, device=device))    # a barrier
            if rank != 0:
                config, model_config = get_param(rest)
            return _train_rank(rank, config, model_config, device)
        finally:
            dist.destroy_process_group()
    config, model_config = get_param(rest)
    _check_flags(config, known.device)
    world = _world_of(config.mesh, known.device)
    if world == 1:
        return train(config, model_config, known.device)
    import socket

    import torch.multiprocessing as mp
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    mp.spawn(_spawned, args=(world, port, config, model_config,
                             known.device), nprocs=world)
    return {"ranks": world}


def train(config, model_config, device):
    """Build the datasets and train on this process's rank of the current
    group (one rank without one); returns the fit result with the trainer
    ("trainer"), the seconds the datasets took to build ("setup_secs"),
    the last train split trained on ("trainset") and, under --use_tdm,
    each rebuild's seconds by part ("tdm_rebuilds": paste_s, extract_s,
    normalize_window_s and, with --device_data, restage_s)."""
    _check_flags(config, device)
    mesh = make_mesh(config.mesh, device)
    chief = mesh.rank == 0
    if mesh.distributed and chief:
        import torch.distributed as dist
        print(f"data parallel: {mesh.world} rank(s) over "
              f"{dist.get_backend()}, mesh {mesh.axes}")

    t0 = time.perf_counter()
    datasets, test_xs = build_datasets(config, device, chief)
    trainer = SELDTrainer(config, model_config, n_classes=12,
                          input_shape=(300, 64, input_channels(config)),
                          device=device, mesh=mesh)
    trainer.set_augment(build_augment(config))
    if config.resume:
        if not trainer.resume():
            raise ValueError("the model does not exist, cannot be resumed")
        print(f"resumed from epoch {trainer.start_epoch}")
    elif getattr(config, "init_from", ""):
        trainer.init_from(config.init_from)
        print(f"initialized params from {config.init_from}")

    # periodic full-clip ensemble eval against the official scorer: every
    # rank scores its share of the windows (the same clips, the same
    # epochs), rank 0 alone writes the CSVs and logs
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

    trainset, rebuilds = datasets["train"], None
    if _uses_tdm(config):
        trainset, rebuilds = tdm_provider(config, trainset, device)
    staged = {}
    if getattr(config, "device_data", False):
        # stage every split on the card once; each step then gathers its
        # batch there from a row of the epoch's index matrix
        def to_device(ds, train, batch=None):
            dev = DeviceDataset(ds.x, ds.y, batch or ds.batch_size, device,
                                train=train, loop_time=ds.loop_time,
                                mesh=mesh)
            print(f"device_data: staged {dev.n_windows} windows "
                  f"({dev.hbm_bytes() / 1e9:.2f} GB) on {device}")
            return dev
        for split in ("val", "test"):
            # whole clips a batch, as many as make it divide over the
            # shards (the JAX CLI's grouping); else the split stays
            # host-fed and each batch is padded (scripts/train.py:247-265)
            ds = datasets[split]
            clip, n = ds.batch_size, ds.x.shape[0]
            eval_b = clip
            while eval_b % mesh.data_size and eval_b < n:
                eval_b += clip
            if eval_b % mesh.data_size == 0 and n % eval_b == 0:
                datasets[split] = to_device(ds, False, eval_b)
            else:
                print(f"device_data: {split} eval stays host-fed ({n} "
                      f"windows not batchable as a multiple of {clip} "
                      f"windows a clip over {mesh.data_size} shards)")
        if callable(trainset):
            provider = trainset

            def trainset(epoch):
                ds = provider(epoch)
                if staged.get("src") is not ds:
                    # free the old split, and the epoch step captured over
                    # it, before the new one is staged
                    staged.pop("dev", None)
                    trainer.release_epoch_program()
                    t_stage = time.perf_counter()
                    staged["src"], staged["dev"] = ds, to_device(ds, True)
                    rebuilds[-1]["restage_s"] = (time.perf_counter()
                                                 - t_stage)
                return staged["dev"]
        else:
            trainset = to_device(trainset, True)
    elif mesh.distributed:
        # the host feed: this rank's strided slice of each train split
        def strided(ds):
            return SeldDataset(ds.x, ds.y, ds.batch_size // mesh.data_size,
                               loop_time=ds.loop_time,
                               process_index=mesh.data_index,
                               process_count=mesh.data_size)
        if callable(trainset):
            provider = trainset

            def trainset(epoch):
                ds = provider(epoch)
                if staged.get("src") is not ds:
                    staged["src"], staged["dev"] = ds, strided(ds)
                return staged["dev"]
        else:
            trainset = strided(trainset)
    setup_secs = time.perf_counter() - t0

    last = {}

    def tracked(epoch):
        last.pop("trainset", None)      # no reference outlives its epoch
        last["trainset"] = trainset(epoch) if callable(trainset) \
            else trainset
        return last["trainset"]

    try:
        result = trainer.fit(tracked, datasets["val"], datasets["test"],
                             eval_fn=eval_fn, eval_every=config.eval_every)
        print(f"best val seld score: {result['best_score']:.5f}")

        # final SWA evaluation (every rank) + save (trainv2.py:362-369),
        # on rank 0
        if trainer.swa.count > 0 and eval_fn is not None:
            seld, _ = trainer.evaluate_ensemble(
                test_xs, names, gt_dir, config.output_path,
                result["last_epoch"], params=trainer.swa_params(),
                batch_stats=trainer.swa_batch_stats())
            if chief:
                save_checkpoint(trainer.workdir, f"SWA_best_{seld:.5f}",
                                trainer.state, trainer.swa,
                                params=trainer.swa_params())
                print(f"SWA seld score: {seld:.5f}")
    finally:
        if mesh.distributed:
            # drop the epoch step's captured program, on success and on
            # failure alike, before the caller destroys the group: NCCL
            # cannot destroy a communicator whose collectives a live CUDA
            # graph holds (destroy_process_group waits for ever)
            trainer.release_epoch_program()
    return {**result, "trainer": trainer, "setup_secs": setup_secs,
            "trainset": last.get("trainset"), "tdm_rebuilds": rebuilds}
