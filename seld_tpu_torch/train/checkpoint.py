"""Checkpoint save/restore (seld_tpu/train/checkpoint.py).

A checkpoint is the complete training state, so a resumed run continues
bit for bit: the f32 parameters and the BatchNorm running statistics under
their flax path names, the optimizer's moments, step count and learning
rate, the step counter, the dropout generator's state, the SWA average and
count, and, when given, the augment generator's state. Names encode the
metric (`bestscore_<score>`) and `keep_best_only` deletes the previous
best, as the reference does; `<name>.meta.json` beside it carries the
extra state (best score, epoch).

The format is the port's own: a directory `<name>` holding `state.pt`, a
`torch.save` of CPU tensors (not the JAX package's orbax layout). The
optimizer's count and learning rate are stored as a Python int and float.

Restore writes into the state's existing tensors: the parameters, the
statistics, the moments, the optimizer's count and learning rate tensors,
and the generators (`set_state` writes a generator's seed and offset in
place). A CUDA graph captured over that state (train/graphs.py) holds
their addresses and registered generator states, so it replays the
restored run without a new capture.
"""
from __future__ import annotations

import glob
import json
import os
import re
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch

from seld_tpu_torch.train.train_state import SWAState, TrainState

_STATE_FILE = "state.pt"


def _cpu(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu().clone() for k, v in tensors.items()}


def _to_saveable(state: TrainState, swa: Optional[SWAState],
                 aug_generator: Optional[torch.Generator],
                 params: Optional[Dict[str, torch.Tensor]]) -> Dict[str, Any]:
    opt = state.optimizer
    slots = {"m": [t.cpu().clone() for t in opt.m],
             "v": [t.cpu().clone() for t in opt.v]}
    if getattr(opt, "vhat", None) is not None:
        slots["vhat"] = [t.cpu().clone() for t in opt.vhat]
    tree = {
        "step": state.step,
        "params": _cpu(params if params is not None else state.params),
        "batch_stats": _cpu(state.batch_stats),
        "opt_state": {"slots": slots, "count": opt.count, "lr": opt.lr},
        "rng": state.generator.get_state(),
    }
    if swa is not None:
        tree["swa"] = {"avg_params": _cpu(swa.avg_params), "count": swa.count,
                       "avg_batch_stats": (_cpu(swa.avg_batch_stats)
                                           if swa.avg_batch_stats is not None
                                           else None)}
    if aug_generator is not None:
        tree["aug_rng"] = aug_generator.get_state()
    return tree


def save_checkpoint(directory: str, name: str, state: TrainState,
                    swa: Optional[SWAState] = None,
                    extra: Optional[Dict[str, Any]] = None,
                    keep_best_only: bool = False,
                    aug_generator: Optional[torch.Generator] = None,
                    params: Optional[Dict[str, torch.Tensor]] = None) -> str:
    """Save the state under `<directory>/<name>`; returns the path.
    `params` are stored in place of the state's own (the final SWA save
    stores the SWA average, as the JAX package's `state.replace(params=...)`
    does)."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.abspath(os.path.join(directory, name))
    if keep_best_only:
        for old in glob.glob(os.path.join(directory, "bestscore_*")):
            # exact-path match, not startswith: 'bestscore_0.41' must still
            # delete an older 'bestscore_0.4123'
            if os.path.abspath(old) in (path, path + ".meta.json"):
                continue
            if os.path.isdir(old):
                shutil.rmtree(old, ignore_errors=True)
            else:  # orphaned .meta.json sidecars
                os.remove(old)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.makedirs(path)
    torch.save(_to_saveable(state, swa, aug_generator, params),
               os.path.join(path, _STATE_FILE))
    if extra:
        with open(path + ".meta.json", "w") as f:
            json.dump(extra, f)
    return path


def _copy_into(dst: Dict[str, torch.Tensor], src: Dict[str, torch.Tensor],
               what: str) -> None:
    if set(dst) != set(src):
        raise KeyError(f"{what}: checkpoint keys differ from the model's: "
                       f"{sorted(set(dst) ^ set(src))}")
    with torch.no_grad():
        for k, t in dst.items():
            t.copy_(src[k])


def restore_checkpoint(path: str, state: TrainState,
                       swa: Optional[SWAState] = None,
                       aug_generator: Optional[torch.Generator] = None):
    """Restore into `state` (and `swa`, `aug_generator`) in place; returns
    (state, swa, extra)."""
    tree = torch.load(os.path.join(path, _STATE_FILE), weights_only=True)
    state.step = tree["step"]
    _copy_into(state.params, tree["params"], "params")
    _copy_into(state.batch_stats, tree["batch_stats"], "batch_stats")
    opt, saved = state.optimizer, tree["opt_state"]
    for name, tensors in saved["slots"].items():
        with torch.no_grad():
            for t, s in zip(getattr(opt, name), tensors):
                t.copy_(s)
    opt.count, opt.lr = saved["count"], saved["lr"]
    state.generator.set_state(tree["rng"])
    if swa is not None and "swa" in tree:
        saved = tree["swa"]
        swa.count = saved["count"]
        _copy_into(swa.avg_params, saved["avg_params"], "swa params")
        if swa.avg_batch_stats is not None and \
                saved["avg_batch_stats"] is not None:
            _copy_into(swa.avg_batch_stats, saved["avg_batch_stats"],
                       "swa batch_stats")
    if aug_generator is not None and "aug_rng" in tree:
        aug_generator.set_state(tree["aug_rng"])
    extra = None
    if os.path.exists(path + ".meta.json"):
        with open(path + ".meta.json") as f:
            extra = json.load(f)
    return state, swa, extra


def save_variables(path: str, model: torch.nn.Module,
                   extra: Optional[Dict[str, Any]] = None) -> str:
    """A checkpoint of the model's variables alone (parameters and
    BatchNorm statistics, no optimizer state), as `load_variables` reads
    it: the directory `path` holding `state.pt`, and `extra` in
    `path.meta.json`; returns the absolute path."""
    path = os.path.abspath(path)
    os.makedirs(path)
    torch.save({"params": _cpu(dict(model.named_parameters())),
                "batch_stats": _cpu(dict(model.named_buffers()))},
               os.path.join(path, _STATE_FILE))
    if extra:
        with open(path + ".meta.json", "w") as f:
            json.dump(extra, f)
    return path


def load_variables(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load only a checkpoint's model variables (parameters and BatchNorm
    statistics) into `model`, for inference tooling that has no optimizer
    (the JAX package's `load_variables`); returns the model."""
    tree = torch.load(os.path.join(path, _STATE_FILE), weights_only=True)
    model.load_state_dict({**tree["params"], **tree["batch_stats"]},
                          strict=True)
    return model


def latest_best(directory: str) -> Optional[str]:
    """The best-score checkpoint directory (lowest score in the name)."""
    candidates = [p for p in glob.glob(os.path.join(directory, "bestscore_*"))
                  if os.path.isdir(p)]
    if not candidates:
        return None

    def score(p):
        m = re.search(r"bestscore_([0-9]+(?:\.[0-9]+)?)", os.path.basename(p))
        return float(m.group(1)) if m else np.inf

    return os.path.abspath(min(candidates, key=score))
