"""SELD training loop (seld_tpu/train/trainer.py).

`SELDTrainer` runs the reference's two recipes, picked by `--swa`:
  - `--swa off` (train.py, v1): plateau lr decay over the whole schedule,
    early stop, best-checkpoint save, no weight averaging
  - `--swa on` (default, trainv2.py, the challenge loop): AdaBelief with
    AGC, class weights, label smoothing, MMSE_with_cls_weights, L2 1e-3,
    SWA (start 80, freq 2, lr halved at the start; plateau decay stops once
    SWA engages)

Each epoch streams batches from the dataset (gathered on the card when it
is device-resident, else copied ahead by `DeviceIterator`), applies the
augment from the trainer's own generator, and runs the train step; val and
test epochs run the eval step. With `--epoch_scan` a train epoch over a
device-resident split runs as one epoch step instead
(`steps.make_train_epoch`: gather, augment and update a step, replayed as
a CUDA graph on the card), with the metric inside it under
`--fuse_metrics`. Checkpoints carry the whole training state
(train/checkpoint.py), so a resumed run continues exactly.

Data parallel (`mesh=`, parallel/mesh.py; the default is the mesh of the
current process group in `config.mesh`'s axes, world 1 without one): the
parameters and statistics are broadcast from rank 0, every step runs under
the mesh (train/steps.py), a device-resident split is this rank's shard,
and a host split is this rank's strided slice (train) or the whole split
(eval: each batch is padded to the shard count, this rank takes its rows,
and the pad is cut off before the losses and the metric, as
seld_tpu/train/trainer.py:236-262). Every rank holds the same state and
scalars; rank 0 alone writes checkpoints, logs and scalars, after a
barrier (an all-reduce of a scalar), so a checkpoint saved on N ranks
resumes on any rank count.
`evaluate_ensemble` scores full clips by sliding-window overlap-add against
the official DCASE scorer (the recipe's periodic evaluation, `eval_fn`).
"""
from __future__ import annotations

import logging
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from seld_tpu_torch.bridge import from_flax, load_npz
from seld_tpu_torch.data.loader import DeviceIterator
from seld_tpu_torch.models import build_model
from seld_tpu_torch.parallel import collectives
from seld_tpu_torch.parallel.mesh import (batch_shard_count, make_mesh,
                                          replicate, shard_batch)
from seld_tpu_torch.train import losses as L
from seld_tpu_torch.train import metrics as M
from seld_tpu_torch.train.checkpoint import (latest_best, restore_checkpoint,
                                             save_checkpoint)
from seld_tpu_torch.train.optimizers import adabelief, adam
from seld_tpu_torch.train.steps import (make_eval_step, make_train_epoch,
                                        make_train_step)
from seld_tpu_torch.train.train_state import SWAState, TrainState
from seld_tpu_torch.utils.logging import ScalarLogger


def accdoa_objective(config):
    """ACCDOA's (sed_loss, doa_loss, loss_weights)
    (seld_tpu/train/trainer.py:96-107). ACCDOA (arXiv 2006.12014) has one
    activity-coupled vector head; the model emits (clipped vector norms,
    vectors), so the metric works unchanged, and the objective is
    `config.doa_loss` (MSE by default) on the vectors alone: the derived
    "sed" gets no loss. The weights are (0, 1), or (0, w1) of
    `config.loss_weight` "w0,w1" where the config has one, as the CLI's
    always does."""
    doa_loss = L.get_doa_loss(getattr(config, "doa_loss", "MSE") or "MSE")
    w_doa = (float(str(config.loss_weight).split(",")[1])
             if hasattr(config, "loss_weight") else 1.0)
    return (lambda y, p: p.new_zeros(())), doa_loss, (0.0, w_doa)


class _NoLogger:
    """The scalar sink of a rank other than 0: it writes nothing."""

    def add_scalar(self, tag, value, step) -> None:
        pass

    def close(self) -> None:
        pass


class SELDTrainer:
    def __init__(self, config, model_config: dict, *,
                 n_classes: Optional[int] = None,
                 input_shape=(300, 64, 7),
                 device="cuda",
                 mesh=None,
                 optimizer: str = "adabelief",
                 use_class_weights: bool = True,
                 train_samples: Optional[np.ndarray] = None,
                 workdir: str = "./saved_model",
                 logdir: str = "./tensorboard_log",
                 metric_block_size: int = 10):
        self.config = config
        self.model_config = dict(model_config)
        self.n_classes = n_classes or self.model_config.get("n_classes", 14)
        self.model_config["n_classes"] = self.n_classes
        self.input_shape = tuple(input_shape)
        self.device = torch.device(device)
        self.mesh = mesh if mesh is not None else make_mesh(
            getattr(config, "mesh", "data:-1"), self.device)
        self.is_chief = self.mesh.rank == 0
        self.workdir = os.path.join(workdir, config.name)
        self.logger = (ScalarLogger(os.path.join(logdir, config.name))
                       if self.is_chief else _NoLogger())
        self.metric_block_size = metric_block_size

        # losses (trainv2.py:291-297)
        if use_class_weights:
            samples = (train_samples if train_samples is not None
                       else L.DCASE2021_TRAIN_SAMPLES)
            if np.shape(samples)[-1] != self.n_classes:
                raise ValueError("train_samples does not match n_classes")
            self.cls_weights = L.class_weights_from_samples(samples,
                                                            self.device)
        else:
            self.cls_weights = None

        smoothing = getattr(config, "label_smoothing", 0.0)
        sed_kind = getattr(config, "sed_loss", "BCE")
        focal_a = getattr(config, "focal_a", 0.25)
        focal_g = getattr(config, "focal_g", 2.0)

        def sed_loss(y, p):
            return L.sed_loss_with_weights(
                y, p, self.cls_weights, label_smoothing=smoothing,
                kind=sed_kind, focal_alpha=focal_a, focal_gamma=focal_g)

        doa_kind = getattr(config, "doa_loss", "MMSE")
        if doa_kind == "MMSE" and self.cls_weights is not None:
            def doa_loss(y, p):
                return L.MMSE_with_cls_weights(y, p, self.cls_weights)
        else:
            doa_loss = L.get_doa_loss(doa_kind)
        self.sed_loss, self.doa_loss = sed_loss, doa_loss
        self.loss_weights = tuple(
            float(w) for w in str(getattr(config, "loss_weight", "1,1000")
                                  ).split(","))
        if getattr(config, "model", "") == "accdoa":
            self.sed_loss, self.doa_loss, self.loss_weights = \
                accdoa_objective(config)
        agc = getattr(config, "agc", True)
        self.agc_clip = (0.01 if agc is True else float(agc)) if agc else None
        self.l2 = float(getattr(config, "l2", 1e-3))

        # model + state: weights from `seed`, dropout masks from seed + 1,
        # augment draws from seed + 17
        seed = getattr(config, "seed", 0)
        self.model = build_model(config.model, self.input_shape,
                                 self.model_config, seed=seed,
                                 device=self.device)
        lr = float(getattr(config, "lr", 1e-3))
        opt_factory = adabelief if optimizer == "adabelief" else adam
        self.state = TrainState(
            self.model, opt_factory(list(self.model.parameters()), lr,
                                    agc_clip=self.agc_clip), seed=seed + 1)
        replicate(self.model, self.mesh)
        self.swa = SWAState(self.state.params, self.state.batch_stats)

        compute_dtype = (torch.bfloat16 if getattr(config, "bf16", False)
                         else None)
        self.compute_dtype = compute_dtype
        self.train_step = make_train_step(
            sed_loss_fn=self.sed_loss, doa_loss_fn=self.doa_loss,
            loss_weights=self.loss_weights, l2=self.l2,
            doa_threshold=getattr(config, "lad_doa_thresh", 20),
            metric_block_size=metric_block_size, compute_dtype=compute_dtype,
            mesh=self.mesh)
        self.eval_step = make_eval_step(
            sed_loss_fn=self.sed_loss, doa_loss_fn=self.doa_loss,
            doa_threshold=getattr(config, "lad_doa_thresh", 20),
            metric_block_size=metric_block_size, compute_dtype=compute_dtype,
            mesh=self.mesh)

        self.best_score = np.inf
        self.start_epoch = 0
        self._augment: Optional[Callable] = None
        self.aug_generator = torch.Generator(device=self.device).manual_seed(
            seed + 17)
        # --epoch_scan: a train epoch over a device-resident split is one
        # epoch step (a CUDA graph replayed once a step on the card)
        self._use_epoch_scan = bool(getattr(config, "epoch_scan", False))
        self._epoch_step = None

    # ------------------------------------------------------------------
    def set_augment(self, augment_fn: Optional[Callable]) -> None:
        """augment_fn(generator, x, y_total) -> (x, y_total)."""
        self._augment = augment_fn
        self._epoch_step = None  # rebuild with the new augment inside

    def _get_epoch_step(self):
        if self._epoch_step is None:
            self._epoch_step = make_train_epoch(
                sed_loss_fn=self.sed_loss, doa_loss_fn=self.doa_loss,
                n_classes=self.n_classes, loss_weights=self.loss_weights,
                l2=self.l2,
                doa_threshold=getattr(self.config, "lad_doa_thresh", 20),
                metric_block_size=self.metric_block_size,
                compute_dtype=self.compute_dtype, augment_fn=self._augment,
                fuse_metrics=getattr(self.config, "fuse_metrics", False),
                mesh=self.mesh)
        return self._epoch_step

    def release_epoch_program(self) -> None:
        """Drop the epoch step's captured program and the split it holds
        (a restaged split is captured anew at its first epoch)."""
        if self._epoch_step is not None:
            self._epoch_step.release()

    def resume(self) -> bool:
        """Restore the best checkpoint of this run (not the last one, as the
        JAX package does); False when there is none."""
        path = latest_best(self.workdir)
        if path is None:
            return False
        _, _, extra = restore_checkpoint(path, self.state, self.swa,
                                         self.aug_generator)
        if extra:
            self.best_score = extra.get("best_score", np.inf)
            self.start_epoch = extra.get("epoch", -1) + 1
        return True

    def init_from(self, path: str) -> None:
        """Warm-start params and batch stats from a flax-variables `.npz`
        (keys "params/...", "batch_stats/..."), with the optimizer, the SWA
        average, the lr schedule and the epoch counter fresh — unlike
        resume(), which restores this run's whole training state."""
        self.model.load_state_dict(from_flax(load_npz(path), self.model))
        self.swa = SWAState(self.state.params, self.state.batch_stats)

    # ------------------------------------------------------------------
    def _split_labels(self, y):
        c = self.n_classes
        return y[..., :c], y[..., c:]

    def _eval_shards(self, dataset):
        """A host eval split's (whole-clip) batches as this rank's rows,
        each zero-padded to a multiple of the shard count."""
        n = batch_shard_count(self.mesh)
        for batch in dataset:
            x, y = (torch.as_tensor(a) for a in batch)
            pad = -x.shape[0] % n
            if pad:
                x, y = (torch.cat([a, a.new_zeros((pad, *a.shape[1:]))])
                        for a in (x, y))
            yield shard_batch((x, y), self.mesh)

    def _run_epoch(self, dataset, epoch: int, mode: str) -> Dict[str, float]:
        train = mode == "train"
        if (train and self._use_epoch_scan
                and getattr(dataset, "device_resident", False)):
            return self._run_epoch_scan(dataset, epoch, mode)
        mstate = M.init_state(self.n_classes, self.device)
        slosses, dlosses = [], []
        resident = getattr(dataset, "device_resident", False)
        source, n_valid = dataset, None
        if self.mesh.distributed and not train and not resident:
            source = self._eval_shards(dataset)
            if dataset.batch_size % batch_shard_count(self.mesh):
                n_valid = dataset.batch_size      # the rows before the pad
        feed = source if resident else DeviceIterator(source, self.device)
        for x, y in feed:
            if train and self._augment is not None:
                with collectives.data_parallel(self.mesh):
                    x, y = self._augment(self.aug_generator, x, y)
            y = self._split_labels(y)
            if train:
                self.state, mstate, (sl, dl) = self.train_step(
                    self.state, mstate, x, y)
            else:
                mstate, (sl, dl) = self.eval_step(self.state, mstate, x, y,
                                                  n_valid)
            slosses.append(sl)
            dlosses.append(dl)
        n = len(slosses)
        sloss_sum = float(torch.stack(slosses).sum()) if n else 0.0
        dloss_sum = float(torch.stack(dlosses).sum()) if n else 0.0
        return self._epoch_scalars(mstate, sloss_sum, dloss_sum, n, epoch,
                                   mode)

    def _run_epoch_scan(self, dataset, epoch: int, mode: str
                        ) -> Dict[str, float]:
        """A train epoch as one epoch step over the device-resident split
        (steps.make_train_epoch): the host stages the epoch's index matrix
        and fetches the scalars at the end."""
        mstate = M.init_state(self.n_classes, self.device)
        x_all, y_all = dataset.device_arrays
        idx_all = dataset.epoch_index_matrix()
        self.state, mstate, (sl, dl) = self._get_epoch_step()(
            self.state, mstate, x_all, y_all, idx_all, self.aug_generator)
        return self._epoch_scalars(mstate, float(sl.sum()), float(dl.sum()),
                                   int(sl.shape[0]), epoch, mode)

    def _epoch_scalars(self, mstate, sloss_sum: float, dloss_sum: float,
                       n: int, epoch: int, mode: str) -> Dict[str, float]:
        er, f, de, de_f = [float(v) for v in M.result(mstate)]
        seld = float(M.calculate_seld_score((er, f, de, de_f)))
        scalars = {
            "ErrorRate": er, "F": f, "DoaErrorRate": de, "DoaErrorRateF": de_f,
            "sedLoss": sloss_sum / max(n, 1), "doaLoss": dloss_sum / max(n, 1),
            "seldScore": seld,
        }
        for tag, val in scalars.items():
            self.logger.add_scalar(f"{mode}/{mode}_{tag}", val, epoch)
        return scalars

    # ------------------------------------------------------------------
    def evaluate_ensemble(self, test_xs, label_names, gt_dir, output_dir,
                          epoch: int, batch_size: Optional[int] = None,
                          thresholds=0.5, params=None, batch_stats=None):
        """Full-clip sliding-window eval + official scoring
        (trainv2.py:195-237), logged as ENS_T/*. `params`/`batch_stats`
        score other weights than the model's own (the SWA average).

        Under a process group every rank must call this with the same clips:
        the windows are split over the trainer's mesh, the chief alone
        scores them (the CSVs under `output_dir`, the ENS_T scalars), and
        its (seld, metric values) reach every rank by a broadcast."""
        from seld_tpu_torch.inference.ensemble import (
            ensemble_outputs, evaluate_clips_official)
        variables = None
        if params is not None or batch_stats is not None:
            variables = {**(params if params is not None
                            else self.state.params),
                         **(batch_stats if batch_stats is not None
                            else self.state.batch_stats)}
        outs = ensemble_outputs(
            self.model, test_xs,
            batch_size=batch_size or getattr(self.config, "batch", 256),
            mesh=self.mesh, variables=variables)
        scores = torch.zeros(5, dtype=torch.float64)
        if self.is_chief:
            seld, metric_values = evaluate_clips_official(
                outs, label_names, gt_dir, output_dir,
                thresholds=thresholds, n_classes=self.n_classes)
            for tag, val in zip(("ER", "F", "DER", "DERF"), metric_values):
                self.logger.add_scalar(f"ENS_T/{tag}", float(val), epoch)
            self.logger.add_scalar("ENS_T/seldScore", seld, epoch)
            if not self.mesh.distributed:
                return seld, metric_values
            scores = torch.tensor([seld, *metric_values],
                                  dtype=torch.float64)
        # the chief's score, so that every rank takes the same branches
        scores = collectives.broadcast_(scores.to(self.device)).cpu()
        return float(scores[0]), tuple(float(v) for v in scores[1:])

    def barrier(self) -> None:
        """Every rank reaches this point before any goes on (an all-reduce
        of a scalar; nothing at one rank)."""
        if self.mesh.distributed:
            collectives.all_reduce_(torch.zeros(1, device=self.device))

    def save(self, name: str, **kw) -> None:
        """`save_checkpoint` of the trainer's state and SWA average under
        its workdir, by rank 0 alone after a barrier (every rank holds the
        same state)."""
        self.barrier()
        if self.is_chief:
            save_checkpoint(self.workdir, name, self.state, self.swa, **kw)

    def swa_params(self):
        return self.swa.avg_params

    def swa_batch_stats(self):
        return self.swa.avg_batch_stats

    # ------------------------------------------------------------------
    def fit(self, trainset, valset=None, testset=None, *,
            epochs: Optional[int] = None,
            eval_fn: Optional[Callable] = None,
            eval_every: int = 10,
            verbose: bool = True) -> Dict:
        cfg = self.config
        epochs = epochs or getattr(cfg, "epoch", 1000)
        use_swa = bool(getattr(cfg, "swa", True))
        swa_start = getattr(cfg, "swa_start", 80)
        swa_freq = getattr(cfg, "swa_freq", 2)
        patience = getattr(cfg, "patience", 100)
        lr_patience = getattr(cfg, "lr_patience", 80)
        decay = getattr(cfg, "decay", 0.5)
        base_lr = float(getattr(cfg, "lr", 1e-3))

        early_stop, lr_decay_wait = 0, 0
        if valset is None:
            logging.getLogger("seld_tpu_torch").warning(
                "SELDTrainer.fit: no valset given — best-checkpoint "
                "selection and early stopping will use the TRAIN-split SELD "
                "score, which rewards overfitting.")
        history: List[Dict] = []
        for epoch in range(self.start_epoch, epochs):
            t0 = time.time()
            if use_swa and epoch == swa_start:
                self.state.set_lr(base_lr * 0.5)        # trainv2:325-326

            if eval_fn is not None and eval_every > 0 \
                    and epoch % eval_every == 0:
                eval_fn(self, epoch)

            epoch_trainset = (trainset(epoch) if callable(trainset)
                              else trainset)
            t_train = time.time()       # a rebuild of the split is not in it
            train_scalars = self._run_epoch(epoch_trainset, epoch, "train")
            train_secs = time.time() - t_train
            # no reference to the split outlives its epoch: a provider
            # that rebuilds it frees the old one first
            del epoch_trainset
            score = train_scalars["seldScore"]
            val_scalars = None
            if valset is not None:
                val_scalars = self._run_epoch(valset, epoch, "val")
                score = val_scalars["seldScore"]
            if testset is not None:
                self._run_epoch(testset, epoch, "test")

            if use_swa and self.swa.should_update(epoch, swa_start, swa_freq):
                self.swa.update(self.state.params, self.state.batch_stats)
            self.logger.add_scalar("train/lr", float(self.state.get_lr()),
                                   epoch)
            self.logger.add_scalar("train/swa_count", float(self.swa.count),
                                   epoch)

            history.append({"epoch": epoch, "train": train_scalars,
                            "val": val_scalars, "secs": time.time() - t0,
                            "train_secs": train_secs})
            if verbose:
                msg = (f"epoch {epoch}: train seld "
                       f"{train_scalars['seldScore']:.4f}")
                if val_scalars:
                    msg += f", val seld {val_scalars['seldScore']:.4f}"
                print(msg + f" ({time.time() - t0:.1f}s)")

            if score < self.best_score:
                self.best_score = score
                early_stop, lr_decay_wait = 0, 0
                self.save(f"bestscore_{self.best_score:.5f}",
                          extra={"best_score": float(self.best_score),
                                 "epoch": epoch},
                          keep_best_only=True,
                          aug_generator=self.aug_generator)
            else:
                if (lr_decay_wait >= lr_patience and decay != 1
                        and (not use_swa or epoch < swa_start)):
                    lr = self.state.get_lr() * decay
                    self.state.set_lr(lr)               # train.py:381-385
                    lr_decay_wait = 0
                    if verbose:
                        print(f"epoch {epoch}: plateau lr decay -> {lr:.2e}")
                if early_stop >= patience:
                    break
                early_stop += 1
                lr_decay_wait += 1

        return {"history": history, "best_score": self.best_score,
                # resuming an already-completed run never enters the loop
                "last_epoch": epoch if history else self.start_epoch - 1}
