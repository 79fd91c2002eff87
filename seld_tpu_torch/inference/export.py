"""Window serving artifacts (seld_tpu/inference/export.py, window unit).

The JAX package exports the jitted forward as StableHLO with the weights
baked in. A torch artifact cannot hold StableHLO, so the port's counterpart
keeps the same contract — export once, then serve with no checkpoint
directory and no training code — as two files:

  <path>            the weights, an .npz keyed by state_dict name (f32)
  <path>.meta.json  unit "window", model name and config, per-window input
                    shape, input dtype, optional static batch

`load_exported(path, device=...)` rebuilds the model from the port's zoo
and loads the weights. The window unit maps `[b, win, F, C]` to
`(sed [b, t, C], doa [b, t, 3C])` for any b (or for b == batch when the
artifact was exported with a static batch).

Not yet ported: the clip unit, the stream unit, ensembles, quantisation and
data-parallel artifacts.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

_META_SUFFIX = ".meta.json"
FORMAT = "seld_tpu_torch.window/v1"
INPUT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def export_window(model: nn.Module, path: str, *, dtype: str = "float32",
                  batch: Optional[int] = None,
                  extra_meta: Optional[Dict[str, Any]] = None) -> str:
    """Write `model` (from `models.build_model`) as a window artifact.

    dtype: the input dtype the artifact accepts ("float32" or "bfloat16";
      requests in another dtype are value-cast to it). Weights stay f32.
    batch: None serves every batch size; an int N makes the server
      pad-and-chunk every dispatch to exactly N rows.
    """
    if dtype not in INPUT_DTYPES:
        raise ValueError(f"dtype {dtype!r}; one of {sorted(INPUT_DTYPES)}")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    arrays = {k: v.detach().float().cpu().numpy()
              for k, v in model.state_dict().items()}
    with open(path, "wb") as f:
        np.savez(f, **arrays)
    meta = {
        "format": FORMAT,
        "unit": "window",
        "model": model.model_name,
        "model_config": model.model_config,
        "input_shape": list(model.input_shape),
        "input_dtype": dtype,
        "batch": batch,
        "n_classes": model.model_config.get("n_classes", 14),
        "torch_version": torch.__version__,
        "bytes": os.path.getsize(path),
    }
    meta.update(extra_meta or {})
    with open(path + _META_SUFFIX, "w") as f:
        json.dump(meta, f, indent=2)
    return path


class LoadedArtifact:
    """A loaded window artifact: `call(x)` on its device, plus meta."""

    def __init__(self, model: nn.Module, meta: Dict[str, Any], device):
        self.model = model
        self.meta = meta
        self.device = torch.device(device)
        self.input_shape: Tuple[int, ...] = tuple(meta["input_shape"])
        self.dtype = INPUT_DTYPES[meta["input_dtype"]]
        self.batch: Optional[int] = meta.get("batch")

    @torch.inference_mode()
    def call(self, x: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
        """[b, *input_shape] (any host or device tensor) -> (sed, doa) as
        float32 numpy arrays (the copy back waits for the device)."""
        x = x.to(device=self.device, dtype=self.dtype)
        sed, doa = self.model(x)
        return sed.float().cpu().numpy(), doa.float().cpu().numpy()


def load_exported(path: str, device="cuda") -> LoadedArtifact:
    from seld_tpu_torch.models import build_model

    with open(path + _META_SUFFIX) as f:
        meta = json.load(f)
    if meta.get("format") != FORMAT or meta.get("unit") != "window":
        raise ValueError(f"{path}: not a {FORMAT} window artifact "
                         f"(format {meta.get('format')!r}, unit "
                         f"{meta.get('unit')!r})")
    model = build_model(meta["model"], meta["input_shape"],
                        meta["model_config"], device=device)
    with np.load(path) as weights:
        state = {k: torch.from_numpy(weights[k]) for k in weights.files}
    model.load_state_dict(state, strict=True)
    return LoadedArtifact(model, meta, device)
