"""Resumable random-search NAS driver (seld_tpu/nas/search.py).

Parity targets: nas_seldnet.py (SELD, conv_temporal over mother/GRU/dense
stages at 400-480 MFLOPs) and nas_vad.py (VAD at 0.5-0.6 MFLOPs). Each
sample: rejection-sample a config against the analytic-FLOPs constraint,
build the model, train for one epoch, score with the streaming metric,
append {config, perf} to a JSON results file. The search is
crash-resumable by re-reading its own results file (nas_seldnet.py:261-270),
guarded by a train-config match.

On the card a candidate compiles nothing: its model runs eagerly through
the port's kernels (the stem's backward through stem_dy, every biGRU whose
width the kernels take through gru_scan and gru_scan_bwd, a card-resident
split's batches through gather_rows). A candidate's losses and metric
states stay on its device and are read once per loop.
"""
from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from seld_tpu_torch.data.loader import DeviceIterator
from seld_tpu_torch.models import build_model
from seld_tpu_torch.nas.complexity import (conv_temporal_complexity,
                                           vad_architecture_complexity)
from seld_tpu_torch.nas.sampler import (conv_temporal_sampler,
                                        mother_stage_postprocess,
                                        sample_constraint)
from seld_tpu_torch.train import losses as L
from seld_tpu_torch.train import metrics as M
from seld_tpu_torch.train.optimizers import adabelief, adam
from seld_tpu_torch.train.steps import make_eval_step, make_train_step
from seld_tpu_torch.train.train_state import TrainState

# default search spaces (nas_seldnet.py:37-77)
SELD_SEARCH_SPACE_2D = {
    "mother_stage": {
        "depth": [1, 2, 3],
        "filters0": [0] * 11 + [3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128,
                                192, 256],
        "filters1": [0] * 11 + [3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128,
                                192, 256],
        "filters2": [0] * 11 + [3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128,
                                192, 256],
        "kernel_size0": [1, 3, 5],
        "kernel_size1": [1, 3, 5],
        "kernel_size2": [1, 3, 5],
        "connect0": [[0], [1]],
        "connect1": [[0, 0], [0, 1], [1, 0], [1, 1]],
        "connect2": [[0, 0, 0], [0, 0, 1], [0, 1, 0], [0, 1, 1],
                     [1, 0, 0], [1, 0, 1], [1, 1, 0], [1, 1, 1]],
        "strides": [(1, 1), (1, 2), (1, 3)],
    },
}
SELD_SEARCH_SPACE_1D = {
    "bidirectional_GRU_stage": {
        "depth": [1, 2, 3],
        "units": [4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256],
    },
    "simple_dense_stage": {
        "depth": [1, 2, 3],
        "units": [4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256],
        "dense_activation": ["relu"],
        "dropout_rate": [0.0, 0.2, 0.5],
    },
}


def sweep_thresholds() -> np.ndarray:
    """The 12 SED thresholds of the swept score, float32 values bit-equal
    to the JAX package's `jnp.linspace(0.05, 0.6, 12)`: XLA evaluates
    start * (1 - s) + stop * s with s = i * f32(1 / 11)."""
    f32 = np.float32
    start, stop = f32(0.05), f32(0.6)
    s = np.arange(11, dtype=f32) * (f32(1) / f32(11))
    inner = start * (f32(1) - s) + stop * s
    return np.concatenate([inner, [stop]]).astype(f32)


def train_and_eval_candidate(model_config: dict, input_shape, trainset,
                             testset, *, model_name: str = "conv_temporal",
                             n_classes: int = 12, lr: float = 1e-3,
                             metric_block_size: int = 10,
                             seed: int = 0,
                             proxy: str = "reference",
                             device=None,
                             weights: Optional[Dict[str, torch.Tensor]] = None
                             ) -> Dict:
    """One-epoch fit + streaming-metric score (nas_seldnet.py:169-205).

    proxy="reference" trains the reference's NAS recipe (adam, plain BCE +
    MSE at 1:1000 — nas_seldnet.py:183-186). proxy="trainer" trains the
    challenge recipe instead (AdaBelief + AGC 0.01, class-weighted BCE +
    MMSE_with_cls_weights, L2 1e-3), which separates candidates on
    synthetic data where the reference recipe leaves every SED head at no
    detection.

    `device` (a name or a torch.device) holds the whole candidate: model,
    batches, losses and metric states; None is the card. `weights` is an
    optional state_dict to start from (the JAX package initialises from
    PRNGKey(seed) inside its fit; a test carries those parameters across);
    else the port's initialisation from `seed`.
    """
    device = torch.device(device if device is not None else "cuda")
    model_config = dict(model_config)
    model_config["n_classes"] = n_classes
    model = build_model(model_name, input_shape, model_config, seed=seed,
                        device=device)
    if weights is not None:
        model.load_state_dict(weights)
    return _fit_and_score(model, model_config, input_shape, trainset,
                          testset, model_name=model_name,
                          n_classes=n_classes, lr=lr,
                          metric_block_size=metric_block_size, seed=seed,
                          proxy=proxy, device=device)


def _fit_and_score(model, model_config, input_shape, trainset, testset, *,
                   model_name, n_classes, lr, metric_block_size, seed,
                   device, proxy: str = "reference") -> Dict:
    params = list(model.parameters())
    opt = (adabelief(params, lr, agc_clip=0.01) if proxy == "trainer"
           else adam(params, lr))
    state = TrainState(model, opt, seed=seed + 1)

    if proxy == "trainer":
        # class weights only exist for the DCASE2021 12-class table; other
        # class counts fall back to unweighted BCE rather than broadcasting
        # a 12-vector against n_classes logits
        cw = (L.class_weights_from_samples(L.DCASE2021_TRAIN_SAMPLES,
                                           device=device)
              if n_classes == L.DCASE2021_TRAIN_SAMPLES.shape[-1] else None)
        tstep = make_train_step(
            sed_loss_fn=lambda y, p: L.sed_loss_with_weights(y, p, cw),
            doa_loss_fn=lambda y, p: L.MMSE_with_cls_weights(y, p, cw),
            loss_weights=(1.0, 1000.0), l2=1e-3,
            metric_block_size=metric_block_size)
    else:
        # plain BCE + MSE with 1:1000 weights (nas_seldnet.py:183-186)
        tstep = make_train_step(
            sed_loss_fn=lambda y, p: L.sed_loss_with_weights(y, p),
            doa_loss_fn=L.MSE, loss_weights=(1.0, 1000.0),
            metric_block_size=metric_block_size)
    estep = make_eval_step(
        sed_loss_fn=lambda y, p: L.sed_loss_with_weights(y, p),
        doa_loss_fn=L.MSE, metric_block_size=metric_block_size,
        return_preds=True)

    def split(y):
        if isinstance(y, tuple):
            return y
        return y[..., :n_classes], y[..., n_classes:]

    def feed(dataset):
        # card-resident datasets already yield batches on the card; host
        # datasets stream through the staging iterator
        if getattr(dataset, "device_resident", False):
            return dataset
        return DeviceIterator(dataset, device=device)

    # losses accumulate as device scalars and are read once after each
    # loop: a read a step would wait for the device every batch
    losses = []
    mstate = M.init_state(n_classes, device)
    for x, y in feed(trainset):
        state, mstate, (sl, dl) = tstep(state, mstate, x, split(y))
        losses.append((sl, dl))
    n = len(losses)
    tr_loss = float(sum(sl + 1000.0 * dl for sl, dl in losses)) if n else 0.0

    mstate = M.init_state(n_classes, device)
    losses = []
    eval_preds = []  # kept on the device; reused by the threshold sweep
    for x, y in feed(testset):
        mstate, (sl, dl), preds = estep(state, mstate, x, split(y))
        losses.append((sl, dl))
        eval_preds.append((preds, split(y)))
    m = len(losses)
    te_loss = float(sum(sl + 1000.0 * dl for sl, dl in losses)) if m else 0.0

    scores = [float(v) for v in M.result(mstate)]

    # Threshold-swept candidate scoring: on data where the fixed 0.5 SED
    # threshold leaves a proxy-trained candidate with no detections, the
    # score at 0.5 reads 1.0 for almost every candidate; each candidate is
    # also scored at its best SED threshold over a fixed grid, from the
    # predictions of the one eval pass (one metric state a threshold)
    thresholds = sweep_thresholds()
    mstates = [M.init_state(n_classes, device) for _ in thresholds]
    for preds, y in eval_preds:
        for i, th in enumerate(thresholds.tolist()):
            mstates[i] = M.update(mstates[i], y, preds,
                                  block_size=metric_block_size,
                                  sed_threshold=th)
    er_v, f_v, de_v, df_v = (torch.stack(v) for v in zip(
        *[M.result(ms) for ms in mstates]))
    seld_v = M.calculate_seld_score((er_v, f_v, de_v, df_v)).cpu().numpy()
    best = int(np.argmin(seld_v))

    cx = (conv_temporal_complexity(model_config, input_shape)[0]
          if model_name == "conv_temporal"
          else vad_architecture_complexity(model_config, input_shape)[0])
    return {
        "loss": tr_loss / max(n, 1),
        "val_loss": te_loss / max(m, 1),
        "test_error_rate": scores[0],
        "test_f1score": scores[1],
        "test_der": scores[2],
        "test_derf": scores[3],
        "test_seld_score": float(M.calculate_seld_score(scores)),
        "test_seld_score_searched": float(seld_v[best]),
        "searched_threshold": float(thresholds[best]),
        "test_f1_searched": float(f_v[best]),
        **cx,
    }


class RandomSearch:
    """Resumable {sample -> train -> score -> append JSON} loop."""

    def __init__(self, name: str, train_config: dict, *,
                 results_dir: str = ".",
                 sampler: Callable = conv_temporal_sampler,
                 search_space_2d: Optional[dict] = None,
                 search_space_1d: Optional[dict] = None,
                 n_blocks: int = 4,
                 input_shape=(300, 64, 7),
                 min_flops: Optional[int] = 400_000_000,
                 max_flops: Optional[int] = 480_000_000,
                 n_classes: int = 12):
        self.name = name
        # a missing results_dir must fail at construction, not after the
        # first candidate evaluation completes and its flush crashes
        results_dir = results_dir or "."
        os.makedirs(results_dir, exist_ok=True)
        self.path = os.path.join(results_dir, f"{name}.json")
        self.train_config = dict(train_config)
        self.sampler = sampler
        self.space_2d = search_space_2d or SELD_SEARCH_SPACE_2D
        self.space_1d = search_space_1d or SELD_SEARCH_SPACE_1D
        self.n_blocks = n_blocks
        self.input_shape = tuple(input_shape)
        self.n_classes = n_classes
        self.constraint = sample_constraint(min_flops, max_flops,
                                            n_classes=n_classes)
        self.results = {"train_config": self.train_config}
        self._resume()

    def _resume(self) -> None:
        if not os.path.exists(self.path):
            return
        with open(self.path, "r") as f:
            stored = json.load(f)
        if stored.get("train_config") != self.train_config:
            raise ValueError(
                "stored train_config does not match; use a new name")
        self.results = stored

    @property
    def n_done(self) -> int:
        return sum(k.isdigit() for k in self.results)

    def sample_config(self) -> dict:
        default = {"n_classes": self.n_classes,
                   **{k: v for k, v in self.train_config.items()
                      if k in ("first_pool_size", "filters",
                               "first_kernel_size")}}
        # bounded rejection sampling: an unsatisfiable FLOPs window (or a
        # search-space/complexity error swallowed as rejection) must raise,
        # not hang the search silently
        return self.sampler(
            self.space_2d, self.space_1d, self.n_blocks, self.input_shape,
            default_config=default,
            config_postprocess_fn=mother_stage_postprocess,
            constraint=self.constraint, max_iters=500_000)

    def _flush(self) -> None:
        with open(self.path, "w") as f:
            json.dump(self.results, f, indent=4)

    def run(self, n_samples: int, evaluate: Callable[[dict], Dict],
            verbose: bool = True) -> dict:
        """evaluate(model_config) -> perf dict."""
        for i in range(self.n_done, n_samples):
            t0 = time.time()
            model_config = self.sample_config()
            perf = evaluate(model_config)
            self.results[f"{i:03}"] = {"config": model_config, "perf": perf}
            self._flush()
            if verbose:
                score = perf.get("test_seld_score", perf.get("val_auc"))
                print(f"[{i + 1}/{n_samples}] score={score} "
                      f"({time.time() - t0:.1f}s)")
        return self.results

    def run_parallel(self, n_samples: int,
                     evaluate: Callable[[dict, object], Dict],
                     *, workers: Optional[int] = None,
                     devices=None, verbose: bool = True) -> dict:
        """Concurrent candidate evaluation: worker threads, candidate i on
        devices[i % len(devices)] (a list of torch.devices; default every
        visible card). Several workers may share one card: each candidate
        has its own model, optimizer and generator, and the kernels' lazy
        build and launch counts are guarded by locks.

        evaluate(model_config, device) -> perf dict.

        Configs are sampled lazily under a lock in index order (the
        sampler draws from the stdlib `random` module), so a seeded run
        samples the serial run's configs. Results are written to disk in
        index order as soon as their prefix is complete, so a crash never
        leaves holes and re-running with the same name continues from the
        last contiguous sample.
        """
        import threading
        from concurrent.futures import ThreadPoolExecutor

        if devices is None:
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        devices = list(devices)
        if not devices:
            raise ValueError("run_parallel needs at least one device")
        workers = workers or len(devices)
        start = self.n_done
        if start >= n_samples:
            return self.results

        pending: Dict[int, Dict] = {}
        configs: Dict[int, dict] = {}
        next_write = start
        lock = threading.Lock()

        def config_for(i: int) -> dict:
            with lock:
                for j in range(start, i + 1):   # in index order
                    if j not in configs:
                        configs[j] = self.sample_config()
                return configs[i]

        def flush_locked():
            nonlocal next_write
            wrote = False
            while next_write in pending:
                self.results[f"{next_write:03}"] = pending.pop(next_write)
                next_write += 1
                wrote = True
            if wrote:
                self._flush()

        def worker(i: int):
            t0 = time.time()
            dev = devices[(i - start) % len(devices)]
            perf = evaluate(config_for(i), dev)
            with lock:
                pending[i] = {"config": configs[i], "perf": perf}
                flush_locked()
            if verbose:
                score = perf.get("test_seld_score", perf.get("val_auc"))
                print(f"[{i + 1}/{n_samples}] score={score} "
                      f"({time.time() - t0:.1f}s, {dev})")

        with ThreadPoolExecutor(max_workers=workers) as pool:
            futures = [pool.submit(worker, i)
                       for i in range(start, n_samples)]
            for fut in futures:
                fut.result()
        return self.results


def merge_results(paths, out_path: str) -> dict:
    """Merge sharded NAS result JSONs (result_merge.py:10-28)."""
    merged: dict = {}
    for idx, path in enumerate(sorted(paths)):
        with open(path, "r") as f:
            tmp = json.load(f)
        if idx == 0:
            merged = tmp
        else:
            length = sum(k.isdigit() for k in merged)
            for key, val in tmp.items():
                if key != "train_config":
                    merged[f"{int(key) + length:03}"] = val
    with open(out_path, "w") as f:
        json.dump(merged, f, indent=4)
    return merged
