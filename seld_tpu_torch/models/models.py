"""Model constructors (seld_tpu/models/models.py).

Each model is an nn.Module built from a JSON-style model_config dict whose
block names dispatch through the port's registry. SELD models output
(sed [B, T', C], doa [B, T', 3C]).

  - seldnet        FIRST -> SECOND body + SED/DOA heads
  - seldnet_v1     the same, doa gated by the tiled sed, then tanh
  - conv_temporal  stem conv+pool, sorted BLOCK0..N + heads, with its
                   trunk/head split for the fast sliding-window inference
                   (`stage=`)
  - vad_architecture                      the config-driven VAD MLP/conv
  - spectro_temporal_attention_based_VAD
  - accdoa         stem conv+pool, sorted BLOCK0..N, one activity-coupled
                   vector head (sed = its clipped norms, doa = the vectors)
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import torch
from torch import nn

from seld_tpu_torch.config.registry import get_block, get_model, register_model
from seld_tpu_torch.models import modules  # noqa: F401  (registers blocks)
from seld_tpu_torch.models.layers import (BatchNorm, Conv2DBN, Dense,
                                          add_child, force_1d,
                                          force_1d_shape)
from seld_tpu_torch.ops.dropout import dropout
from seld_tpu_torch.ops.pooling import max_pool
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


class SELDNet(nn.Module):
    """FIRST -> SECOND body + SED/DOA heads (models.py:61-73); n_classes
    defaults to 14. forward(x) -> (sed, doa)."""

    def __init__(self, model_config: Dict[str, Any],
                 input_shape: Sequence[int], gate_doa_with_sed: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = model_config
        self.model_config = cfg
        self.input_shape = tuple(input_shape)
        first = add_child(self, _build_block(
            cfg["FIRST"], cfg["FIRST_ARGS"], self.input_shape, generator))
        second = add_child(self, _build_block(
            cfg["SECOND"], cfg["SECOND_ARGS"], first.out_shape, generator))
        add_child(self, SELDHeads(cfg, cfg.get("n_classes", 14),
                                  second.out_shape, gate_doa_with_sed,
                                  generator))
        self._body = (first, second)

    def forward(self, x: torch.Tensor):
        first, second = self._body
        return self.SELDHeads_0(second(first(x)))


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


class VADArchitecture(nn.Module):
    """Config-driven VAD MLP/conv (models.py:81-102): the input flattened
    per window (`flatten`, default) or kept [T, F, C], sorted BLOCK0..N,
    then Dense(`last_unit`) + sigmoid, squeezed when `last_unit` is 1."""

    def __init__(self, model_config: Dict[str, Any],
                 input_shape: Sequence[int],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = model_config
        self.model_config = cfg
        self.flatten = cfg.get("flatten", True)
        shape = tuple(input_shape)
        if self.flatten:
            shape = (math.prod(shape),)
        self.blocks = []
        for b in sorted_block_keys(cfg):
            block = add_child(self, _build_block(cfg[b], cfg[f"{b}_ARGS"],
                                                 shape, generator))
            self.blocks.append(block)
            shape = block.out_shape
        if len(shape) == 3:
            shape = force_1d_shape(shape)
        add_child(self, Dense(shape[-1], cfg.get("last_unit", 1),
                              generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.flatten:
            x = x.reshape(x.shape[0], -1)
        for block in self.blocks:
            x = block(x)
        x = torch.sigmoid(self.Dense_0(force_1d(x)))
        return x[..., 0] if x.shape[-1] == 1 else x


class SpectroTemporalAttentionVAD(nn.Module):
    """Spectro-temporal attention VAD (models.py:105-163): `T` gated conv
    stages with frequency pooling, a pipe net (its own sigmoid output),
    temporal attention over the window's frames and a post net.

    forward(x [B, T, F(, 1)]) -> (frame_probs [B, T, 1], pipe_probs
    [B, T, 1], attention_score [B, T]). Dropout draws from
    `dropout_generator` (set_dropout_generator)."""

    def __init__(self, model_config: Dict[str, Any],
                 input_shape: Sequence[int],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = model_config
        self.model_config = cfg
        stages, nc, fc = cfg.get("T", 4), cfg.get("Nc", 16), cfg.get("fc", 3)
        np_, nt = cfg.get("Np", 256), cfg.get("Nt", 128)
        self.heads = cfg.get("H", 4)
        self.nt = nt
        self.dropout_rate = cfg.get("dropout_rate", 0.5)
        self.dropout_generator = None   # set_dropout_generator
        g = generator
        shape = tuple(input_shape)
        if len(shape) == 2:
            shape = (*shape, 1)
        # children in the flax module's creation order (its auto-names)
        self.gated = []
        for i in range(stages):
            lin = add_child(self, Conv2DBN(shape, nc * 2 ** i, fc,
                                           activation=None, generator=g))
            gate = add_child(self, Conv2DBN(shape, nc * 2 ** i, fc,
                                            activation="sigmoid",
                                            generator=g))
            self.gated.append((lin, gate))
            t, f, c = lin.out_shape
            shape = (t, f // 2, c)

        def dense_bn(width, units, use_bias=True):
            return (add_child(self, Dense(width, units, use_bias=use_bias,
                                          generator=g)),
                    add_child(self, BatchNorm(units)))

        width = shape[1] * shape[2]
        self.pipe = []
        for _ in range(2):
            self.pipe.append(dense_bn(width, np_))
            width = np_
        pipe_out = add_child(self, Dense(np_, 1, generator=g))
        self.query = dense_bn(np_, nt, use_bias=False)
        self.key = dense_bn(np_, nt, use_bias=False)
        self.value = dense_bn(np_, nt, use_bias=False)
        self.post = dense_bn(nt, np_)
        self.outs = (pipe_out, add_child(self, Dense(np_, 1, generator=g)))

    def _drop(self, x: torch.Tensor) -> torch.Tensor:
        return dropout(x, self.dropout_rate, self.training,
                       self.dropout_generator)

    def forward(self, x: torch.Tensor):
        if x.dim() == 3:
            x = x[..., None]
        for lin, gate in self.gated:
            x = max_pool(lin(x) * gate(x), (1, 2), strides=(1, 2))
        x = x.reshape(x.shape[0], x.shape[1], -1)

        for dense, bn in self.pipe:
            x = self._drop(torch.relu(bn(dense(x))))
        pipe_out, post_out = self.outs
        pipe = torch.sigmoid(pipe_out(x))

        # temporal attention, H heads of Nt // H features
        def attend(layers, z):
            dense, bn = layers
            return torch.sigmoid(bn(dense(z)))

        query = attend(self.query, x.mean(dim=-2))            # [B, Nt]
        key = attend(self.key, x)                             # [B, T, Nt]
        value = attend(self.value, x)
        h = self.heads
        query = query.reshape(*query.shape[:-1], self.nt // h, h)
        key = key.reshape(*key.shape[:-1], self.nt // h, h)
        value = value.reshape(*value.shape[:-1], self.nt // h, h)
        scale = 1.0 / torch.sqrt(torch.tensor(float(self.nt),
                                              dtype=x.dtype))
        score = (query[:, None] * key).sum(dim=-2) * scale.to(x.device)
        x = value * torch.softmax(score[..., None, :], dim=-3)
        x = x.reshape(*x.shape[:-2], self.nt)
        score = torch.softmax(score.sum(dim=-1), dim=-1)      # [B, T]

        dense, bn = self.post
        x = self._drop(torch.relu(bn(dense(x))))
        x = torch.sigmoid(post_out(x))
        return x, pipe, score


class ACCDOA(nn.Module):
    """Activity-coupled cartesian DOA model (arXiv 2006.12014;
    models.py:245-293): the stem Conv2DBN with its pool (the fused stem in
    training, whose backward is stem_dy on the card), the BLOCKs in numeric
    order, then `accdoa_out` Dense(3C) + tanh. forward(x) -> (sed, doa):
    doa the vectors [B, T', 3C] (x|y|z blocks of C, the DCASE label
    layout), sed = min(||v_c||, 1) over each class's 3-vector. Its
    objective is MSE on doa alone (the trainer's ACCDOA branch)."""

    def __init__(self, model_config: Dict[str, Any],
                 input_shape: Sequence[int],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = model_config
        self.model_config = cfg
        self.input_shape = tuple(input_shape)
        self.n_classes = cfg.get("n_classes", 14)
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
        add_child(self, Dense(force_1d_shape(shape)[-1], 3 * self.n_classes,
                              generator=generator), name="accdoa_out")

    def forward(self, x: torch.Tensor):
        x = self.Conv2DBN_0(x)
        for block in self.blocks:
            x = block(x)
        vec = torch.tanh(self.accdoa_out(force_1d(x)))
        v3 = vec.reshape(*vec.shape[:-1], 3, self.n_classes)
        sed = torch.clamp_max(torch.linalg.vector_norm(v3, dim=-2), 1.0)
        return sed, vec


@register_model("accdoa")
def accdoa(input_shape, model_config: dict,
           generator: Optional[torch.Generator] = None):
    return ACCDOA(dict(model_config), input_shape, generator)


@register_model("seldnet")
def seldnet(input_shape, model_config: dict,
            generator: Optional[torch.Generator] = None):
    return SELDNet(dict(model_config), input_shape, False, generator)


@register_model("seldnet_v1")
def seldnet_v1(input_shape, model_config: dict,
               generator: Optional[torch.Generator] = None):
    return SELDNet(dict(model_config), input_shape, True, generator)


@register_model("conv_temporal")
def conv_temporal(input_shape, model_config: dict,
                  generator: Optional[torch.Generator] = None):
    return ConvTemporal(dict(model_config), input_shape, generator)


@register_model("vad_architecture")
def vad_architecture(input_shape, model_config: dict,
                     generator: Optional[torch.Generator] = None):
    return VADArchitecture(dict(model_config), input_shape, generator)


@register_model("spectro_temporal_attention_based_VAD")
def spectro_temporal_attention_based_VAD(
        input_shape, model_config: dict,
        generator: Optional[torch.Generator] = None):
    return SpectroTemporalAttentionVAD(dict(model_config), input_shape,
                                       generator)


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
