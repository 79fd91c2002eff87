"""Tensor-parallel parameter sharding over a mesh's `model` axis
(seld_tpu/parallel/partitioning.py).

The port keeps flax's parameter names and layouts (bridge.py), so the JAX
package's rules carry over name for name, on state_dict keys:
  - a `kernel` [..., I, O] with 2 or more dims: its output dim is sharded
    over the model axis where the axis divides it and it is at least
    `min_dim` (column parallelism);
  - the per-head attention kernels [H, I, O] (`query_kernel` and the
    rest): the head dim;
  - everything under a GRU_*/LSTM_* module, biases, norms, running
    statistics and positional tables: replicated.

A spec is a tuple, as JAX's PartitionSpec: () replicated, (None, ...,
"model") or ("model",) sharded along the dim that holds the axis name.

`shard_tree` puts this rank's slice of every sharded leaf in place. A
model so sharded runs its train step over a mesh with that model axis
(train/steps.py): each sharded layer computes its shard of the output
from the whole input and gathers the rest over the model sub-group
(parallel/collectives.py), so every activation after a layer is whole on
every rank and the step equals the one-rank step; the GRU's weights stay
whole, as the JAX package's recurrence declares them replicated.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn

_HEAD_KERNELS = ("query_kernel", "key_kernel", "value_kernel",
                 "projection_kernel", "pos_kernel")

Spec = Tuple[Optional[str], ...]


def _spec(key: str, shape, size: int, axis: str, min_dim: int) -> Spec:
    names = key.split(".")
    leaf, ndim = names[-1], len(shape)
    if any(n.startswith(("GRU_", "LSTM_")) for n in names):
        return ()
    if leaf in _HEAD_KERNELS and ndim == 3:
        if shape[0] % size == 0 and shape[0] >= min_dim:
            return (axis,)
        return ()
    if leaf == "kernel" and ndim >= 2:
        if shape[-1] % size == 0 and shape[-1] >= min_dim:
            return (None,) * (ndim - 1) + (axis,)
    return ()


def _tree(tree: Union[nn.Module, Dict[str, torch.Tensor]]
          ) -> Dict[str, torch.Tensor]:
    return tree.state_dict() if isinstance(tree, nn.Module) else dict(tree)


def tp_param_specs(tree: Union[nn.Module, Dict[str, torch.Tensor]], mesh,
                   axis: str = "model", min_dim: int = 2
                   ) -> Dict[str, Spec]:
    """The spec of every state_dict key of a model (or of a state_dict)
    for a mesh of parallel/mesh.py."""
    size = mesh.axes[axis]
    return {k: _spec(k, tuple(t.shape), size, axis, min_dim)
            for k, t in _tree(tree).items()}


def shard_dim(spec: Spec, axis: str = "model") -> Optional[int]:
    """The dim a spec shards over `axis`, or None."""
    return spec.index(axis) if axis in spec else None


def shard_tree(tree: Union[nn.Module, Dict[str, torch.Tensor]], mesh,
               specs: Optional[Dict[str, Spec]] = None, axis: str = "model"):
    """This rank's shards (default specs: `tp_param_specs`). A model's
    sharded parameters are replaced in place by parameters that hold this
    rank's slice, and `model.tensor_parallel` records {key: dim} for the
    train step; returns the model. A state_dict gives a new dict of
    slices. Under a process group every rank calls it: it makes the mesh's
    sub-groups (`Mesh.make_groups`). Parameters shard over the model axis
    alone (the JAX package's `axis` argument is kept for its signature)."""
    if axis != "model":
        raise ValueError(f"parameters shard over the model axis, not "
                         f"{axis!r}")
    mesh.make_groups()
    if specs is None:
        specs = tp_param_specs(tree, mesh, axis)
    size, index = mesh.model_size, mesh.model_index
    dims = {k: d for k, s in specs.items()
            if (d := shard_dim(s, axis)) is not None}

    def piece(t: torch.Tensor, d: int) -> torch.Tensor:
        n = t.shape[d] // size
        return t.detach().narrow(d, index * n, n).clone()

    if not isinstance(tree, nn.Module):
        return {k: piece(t, dims[k]) if k in dims else t
                for k, t in tree.items()}
    for key, d in dims.items():
        *path, leaf = key.split(".")
        owner = tree.get_submodule(".".join(path))
        if leaf not in owner._parameters:
            raise KeyError(f"{key}: only parameters are sharded")
        setattr(owner, leaf, nn.Parameter(piece(getattr(owner, leaf), d)))
    tree.tensor_parallel = dims
    return tree
