"""Parameter bridge between the JAX package's flax variables and the port.

The port keeps flax's parameter names, shapes and layouts, and registers
children under flax's auto-names, so the bridge is a name map and a copy:
the flax path `params/A_0/B_1/kernel` (or `batch_stats/.../mean`) is the
state_dict key `A_0.B_1.kernel`. Variables travel as nested dicts of numpy
arrays (e.g. `jax.tree_util.tree_map(np.asarray, variables)`), or on disk as
a flat `.npz` keyed by those paths (`load_npz`).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

COLLECTIONS = ("params", "batch_stats")


def _flatten(tree: Mapping, prefix: str, out: Dict[str, np.ndarray]):
    for key, value in tree.items():
        path = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            _flatten(value, path, out)
        else:
            if path in out:
                raise KeyError(f"flax leaf {path!r} appears in two "
                               "collections")
            out[path] = np.asarray(value)


def load_npz(path: str) -> Dict[str, dict]:
    """A flat `.npz` of flax variables keyed by path
    ("params/Conv2DBN_0/Conv_0/kernel", "batch_stats/...") -> the nested
    dict `from_flax` takes."""
    tree: Dict[str, dict] = {}
    with np.load(path) as flat:
        for key in flat.files:
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = flat[key]
    return tree


def from_flax(variables: Mapping, model: Optional[nn.Module] = None
              ) -> Dict[str, torch.Tensor]:
    """{"params": ..., "batch_stats": ...} -> state_dict.

    Raises on a collection other than params/batch_stats. With `model`, also
    raises on any leaf the model does not consume, any model entry the
    variables do not provide, and any shape mismatch; the returned tensors
    then take the model's dtypes and devices, ready for `load_state_dict`.
    """
    unknown = set(variables) - set(COLLECTIONS)
    if unknown:
        raise KeyError(f"unknown flax collections {sorted(unknown)}")
    flat: Dict[str, np.ndarray] = {}
    for col in COLLECTIONS:
        _flatten(variables.get(col, {}), "", flat)
    if model is None:
        return {k: torch.from_numpy(np.array(v)) for k, v in flat.items()}

    want = model.state_dict()
    extra = sorted(set(flat) - set(want))
    missing = sorted(set(want) - set(flat))
    if extra or missing:
        raise KeyError(f"flax leaves not consumed: {extra}; model entries "
                       f"not found: {missing}")
    out = {}
    for key, ref in want.items():
        arr = flat[key]
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{key}: flax shape {tuple(arr.shape)} != port "
                             f"shape {tuple(ref.shape)}")
        out[key] = torch.from_numpy(np.array(arr, np.float32)).to(
            dtype=ref.dtype, device=ref.device)
    return out


def to_flax(model: nn.Module) -> Dict[str, dict]:
    """The inverse: the model's parameters -> "params", its buffers (the
    BatchNorm running statistics) -> "batch_stats", as nested numpy dicts."""
    out: Dict[str, dict] = {"params": {}, "batch_stats": {}}
    for col, items in (("params", model.named_parameters()),
                       ("batch_stats", model.named_buffers())):
        for key, value in items:
            node = out[col]
            *parents, leaf = key.split(".")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = value.detach().cpu().numpy()
    return out
