"""Model constructors (seld_tpu/models/models.py).

Each model is an nn.Module built from a JSON-style model_config dict whose
block names dispatch through the port's registry. SELD models output
(sed [B, T', C], doa [B, T', 3C]).

Ported: conv_temporal (the SS5 challenge model), with its trunk/head split
for the fast sliding-window inference (`stage=`).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
from torch import nn

from seld_tpu_torch.config.registry import get_block, get_model, register_model
from seld_tpu_torch.models import modules  # noqa: F401  (registers blocks)
from seld_tpu_torch.models.layers import Conv2DBN, Dense, add_child
from seld_tpu_torch.utils import sorted_block_keys


def _build_block(name: str, args: dict, in_shape, generator) -> nn.Module:
    return get_block(name)(args)(in_shape, generator=generator)


class SELDHeads(nn.Module):
    """Shared SED/DOA head structure: block -> Dense(sigmoid) / Dense(tanh)."""

    def __init__(self, model_config: Dict[str, Any], n_classes: int,
                 in_shape: Sequence[int], gate_doa_with_sed: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = model_config
        self.gate_doa_with_sed = gate_doa_with_sed
        sed = add_child(self, _build_block(cfg["SED"], cfg["SED_ARGS"],
                                           in_shape, generator))
        add_child(self, Dense(sed.out_shape[-1], n_classes,
                              generator=generator), name="sed_out")
        doa = add_child(self, _build_block(cfg["DOA"], cfg["DOA_ARGS"],
                                           in_shape, generator))
        add_child(self, Dense(doa.out_shape[-1], 3 * n_classes,
                              generator=generator), name="doa_out")
        self._blocks = (sed, doa)

    def forward(self, x: torch.Tensor):
        sed_block, doa_block = self._blocks
        sed = torch.sigmoid(self.sed_out(sed_block(x)))
        doa = torch.tanh(self.doa_out(doa_block(x)))
        if self.gate_doa_with_sed:
            doa = torch.tanh(doa * torch.cat([sed] * 3, dim=-1))
        return sed, doa


def _time_local_block(name: str, args: dict) -> bool:
    """Blocks that are translation-equivariant along time with stride 1 —
    computable once on a full clip and windowed afterwards (the fast
    inference split, seld_tpu_torch.inference.ensemble)."""
    if name in ("simple_dense_stage", "simple_dense_block", "identity_block"):
        return True
    if name == "mother_stage":
        strides = args.get("strides", (1, 1))
        if (strides[0] if hasattr(strides, "__len__") else strides) != 1:
            return False
        # squeeze-and-excitation global-average-pools over TIME, so
        # clip-global statistics differ from per-window ones on every
        # frame: SE blocks are not window-local even at stride 1
        return not args.get("squeeze_ratio", 0)
    return False


def conv_temporal_trunk_blocks(cfg: Dict[str, Any]) -> int:
    """Number of leading BLOCKs (after the stem) in the time-local trunk."""
    n = 0
    for block in sorted_block_keys(cfg):
        if not _time_local_block(cfg[block], cfg.get(f"{block}_ARGS", {})):
            break
        n += 1
    return n


class ConvTemporal(nn.Module):
    """Stem conv+pool then sorted BLOCK0..N + heads (models.py:54-78).

    forward(x, stage): "full" (default) runs everything; "trunk" runs the
    stem and the leading time-local blocks (`conv_temporal_trunk_blocks`)
    and returns their features; "head" takes trunk features and runs the
    remaining blocks and the heads. Every child exists whatever the stage,
    so the state_dict is the same. Nothing is sized by the input's length:
    the trunk takes a whole clip (e.g. 3000 frames) as it takes a window.
    """

    def __init__(self, model_config: Dict[str, Any],
                 input_shape: Sequence[int],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = model_config
        self.model_config = cfg
        self.input_shape = tuple(input_shape)
        stem = add_child(self, Conv2DBN(
            self.input_shape, cfg.get("filters", 32),
            cfg.get("first_kernel_size", 7), padding="SAME",
            activation="relu", pool=tuple(cfg.get("first_pool_size", [5, 1])),
            generator=generator))
        shape = stem.out_shape
        self.blocks = []
        for b in sorted_block_keys(cfg):
            block = add_child(self, _build_block(cfg[b], cfg[f"{b}_ARGS"],
                                                 shape, generator))
            self.blocks.append(block)
            shape = block.out_shape
        add_child(self, SELDHeads(cfg, cfg.get("n_classes", 14), shape,
                                  generator=generator))
        self.n_trunk = conv_temporal_trunk_blocks(cfg)

    def forward(self, x: torch.Tensor, stage: str = "full"):
        if stage not in ("full", "trunk", "head"):
            raise ValueError(f"stage {stage!r}: one of full, trunk, head")
        blocks = self.blocks
        if stage != "head":
            x = self.Conv2DBN_0(x)
        if stage == "trunk":
            blocks = blocks[:self.n_trunk]
        elif stage == "head":
            blocks = blocks[self.n_trunk:]
        for block in blocks:
            x = block(x)
        if stage == "trunk":
            return x
        return self.SELDHeads_0(x)


@register_model("conv_temporal")
def conv_temporal(input_shape, model_config: dict,
                  generator: Optional[torch.Generator] = None):
    return ConvTemporal(dict(model_config), input_shape, generator)


def build_model(name: str, input_shape: Sequence[int], model_config: dict, *,
                seed: int = 0, device="cuda") -> nn.Module:
    """Build model `name` for per-window `input_shape` with Keras-style
    initial weights drawn from `seed`, on `device`.

    Weights are drawn on the CPU from a `torch.Generator`, so a seed gives
    the same model on every device. The model is returned in eval mode —
    the serving path; call `.train()` for training mode.
    """
    generator = torch.Generator().manual_seed(seed)
    model = get_model(name)(tuple(input_shape), model_config,
                            generator=generator)
    model.model_name = name
    return model.to(device).eval()
