"""Config-dict-driven block factories (seld_tpu/models/modules.py).

Each factory takes a plain config dict (the JSON architecture DSL),
validates it eagerly with the reference's ValueErrors (NAS rejection
sampling relies on them) and returns a function
`build(in_shape, generator=None) -> nn.Module`; the module's
`forward(x)` applies the block and its `out_shape` is the per-sample
output shape. Children register under flax's auto-names in flax's creation
order, so parameter paths equal the JAX package's.

Blocks (all 24 of the JAX package's registry):
  mother_stage/mother_block            2D -> 2D (NAS super-block, with
                                       bn_pair_batch's one wide BatchNorm)
  simple_conv_block, cond_conv_block, another_conv_block,
  res_basic_stage, res_bottleneck_stage, dense_net_block,
  resnet50_block, xception_block       2D -> 2D (the legacy conv families)
  bidirectional_GRU_stage/block, RNN_stage/block (GRU or LSTM)
  simple_dense_stage/simple_dense_block
  transformer_encoder_stage/block      post-LN, Conv1D FFN
  conformer_encoder_stage/block        absolute or relative positional
                                       encoding (basic or RFF), unrolled or
                                       `scan_depth` (stacked parameters)
  attention_stage/block
  tcn_stage, identity_block

Reference quirks kept (seld_tpu/models/modules.py:24-30): attention_block
applies its FF convs to `x`, not the pre-LayerNormed branch, and adds a
zeros encoding where pos_encoding is None.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from seld_tpu_torch.config.registry import register_block
from seld_tpu_torch.models.layers import (
    GRU,
    LSTM,
    BatchNorm,
    Conv,
    Conv2DBN,
    Dense,
    LayerNorm,
    MultiHeadAttention,
    RelPositionMultiHeadAttention,
    RFFPosEncoding,
    add_child,
    basic_pos_encoding_on,
    force_1d,
    force_1d_shape,
    get_activation,
)
from seld_tpu_torch.ops.dropout import dropout
from seld_tpu_torch.ops.pooling import avg_pool, max_pool


def _layer_norm(features: int) -> LayerNorm:
    """LayerNorm with the Keras default epsilon (1e-3, vs flax's 1e-6)."""
    return LayerNorm(features, epsilon=1e-3)


def _tuple2(v) -> Tuple[int, int]:
    if isinstance(v, (int, float)):
        return (int(v), int(v))
    v = tuple(int(i) for i in v)
    return v * 2 if len(v) == 1 else v


def _conv(in_ch, filters, kernel, strides=(1, 1), groups=1, use_bias=True,
          generator=None) -> Conv:
    return Conv(in_ch, filters, _tuple2(kernel), strides=_tuple2(strides),
                padding="SAME", feature_group_count=groups,
                use_bias=use_bias, generator=generator)


def _conv1d(in_ch, filters, kernel, groups=1, use_bias=True,
            generator=None) -> Conv:
    return Conv(in_ch, filters, (int(kernel),), padding="SAME",
                feature_group_count=groups, use_bias=use_bias,
                generator=generator)


def _dense(in_features, units, use_bias=True, generator=None) -> Dense:
    return Dense(in_features, units, use_bias=use_bias, generator=generator)


# --------------------------------------------------------------------------
#                               MOTHER BLOCK
# --------------------------------------------------------------------------
def _validate_mother_config(c: dict) -> None:
    """Reference-identical validation (modules.py:202-222)."""
    f0, f1, f2 = c["filters0"], c["filters1"], c["filters2"]
    k0, k1, k2 = c["kernel_size0"], c["kernel_size1"], c["kernel_size2"]
    connect0, connect1, connect2 = c["connect0"], c["connect1"], c["connect2"]
    strides = _tuple2(c.get("strides", (1, 1)))

    if (f0 == 0) != (k0 == 0):
        raise ValueError("0) skipped layer must have 0 filters, 0 kernel size")
    if (f1 == 0) != (k1 == 0):
        raise ValueError("1) skipped layer must have 0 filters, 0 kernel size")
    if (f2 == 0) != (k2 == 0):
        raise ValueError("2) skipped layer must have 0 filters, 0 kernel size")

    if f0 == 0 and max(connect1[1], connect2[1]):
        raise ValueError("cannot link skipped layer (first layer)")
    if f1 == 0 and connect2[2] > 0:
        raise ValueError("cannot link skipped layer (second layer)")

    if (f0 != 0) + sum(connect0) == 0:
        raise ValueError("cannot pass zero inputs to the second layer")
    if (f1 != 0) + sum(connect1) == 0:
        raise ValueError("cannot pass zero inputs to the third layer")
    if (f2 != 0) + sum(connect2) == 0:
        raise ValueError("cannot pass zero inputs to the final output")

    if f1 == 0 and strides != (1, 1):
        raise ValueError("if strides are set, the second layer must be active")


class MotherBlock(nn.Module):
    """NAS super-block: <=3 convs with arbitrary skip/concat wiring + SE.

    The wiring is resolved at construction from the input shape into
    `self.layers`, one entry per conv layer:
      ("conv", conv, bn, [(i, skip_conv, skip_bn)])  bn(conv(prev)) + skips
      ("pair", conv, wide_bn, [(i, skip_conv)])      bn_pair_batch's layer 2
      ("concat", [(i, skip_conv)])                   concat of outputs[i]
      ("pass",)                                      the previous output
    where a skip_conv of None means the identity. With `bn_pair_batch`,
    layer 2 normalises its conv and every projected skip with ONE
    BatchNorm over their concatenated channels (per-channel statistics are
    those of separate BatchNorms; only the parameter layout differs):
    the main conv, the projections, then the wide BatchNorm, in flax's
    order.
    """

    def __init__(self, config: Dict[str, Any], strides: Tuple[int, int],
                 in_shape: Sequence[int],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        c = config
        f0, f1, f2 = c["filters0"], c["filters1"], c["filters2"]
        k0, k1, k2 = c["kernel_size0"], c["kernel_size1"], c["kernel_size2"]
        connect0, connect1, connect2 = (c["connect0"], c["connect1"],
                                        c["connect2"])
        self.act = get_activation(c.get("activation", "relu"))
        self.se_act = get_activation(c.get("se_activation", "relu"))
        squeeze_ratio = c.get("squeeze_ratio", 0)
        g = generator

        def conv(shape, f, k, s=(1, 1)):
            m = add_child(self, _conv(shape[-1], f, k, strides=s,
                                      generator=g))
            return m, m.out_shape_of(shape)

        def bn(f):
            return add_child(self, BatchNorm(f))

        def conv_layer(prev, f, k, s, connect, shapes, skip_strides):
            main, out = conv(prev, f, k, s)
            main_bn = bn(f)
            skips = []
            for i in range(len(connect)):
                if connect[i] == 1:
                    if tuple(shapes[i]) != tuple(out):
                        sc, _ = conv(shapes[i], f, 1, skip_strides(i))
                        skips.append((i, sc, bn(f)))
                    else:
                        skips.append((i, None, None))
            return ("conv", main, main_bn, skips), out

        def pair_layer(prev, f, k, s, connect, shapes):
            main, out = conv(prev, f, k, s)
            skips = []
            for i in range(len(connect)):
                if connect[i] == 1:
                    sc = None
                    if tuple(shapes[i]) != tuple(out):
                        sc, _ = conv(shapes[i], f, 1, s)
                    skips.append((i, sc))
            wide = 1 + sum(sc is not None for _, sc in skips)
            return ("pair", main, bn(f * wide), skips), out

        shapes = [tuple(in_shape)]
        self.layers = []
        # first layer (never strided)
        if f0 > 0:
            layer, out = conv_layer(shapes[-1], f0, k0, (1, 1), connect0[:1],
                                    shapes[-1:], lambda i: (1, 1))
        else:
            layer, out = ("pass",), shapes[-1]
        self.layers.append(layer)
        shapes.append(out)

        # second layer (applies strides)
        if f1 > 0 and c.get("bn_pair_batch", False):
            layer, out = pair_layer(shapes[-1], f1, k1, strides, connect1,
                                    shapes)
        elif f1 > 0:
            layer, out = conv_layer(shapes[-1], f1, k1, strides, connect1,
                                    shapes, lambda i: strides)
        else:
            sel = [i for i in range(len(connect1)) if connect1[i] == 1]
            layer = ("concat", [(i, None) for i in sel])
            out = (*shapes[sel[0]][:2], sum(shapes[i][2] for i in sel))
        self.layers.append(layer)
        shapes.append(out)

        # third layer (never strided)
        if f2 > 0:
            layer, out = conv_layer(
                shapes[-1], f2, k2, (1, 1), connect2, shapes,
                lambda i: (1, 1) if i == 2 else strides)
        else:
            parts, chans, spatial = [], 0, None
            for i in range(len(connect2)):
                if connect2[i] == 1:
                    shape, sc = shapes[i], None
                    if connect2[-1] == 1 and strides != (1, 1) and i < 2:
                        # align pre-stride tensors with the strided branch
                        sc, shape = conv(shape, shape[-1], 1, strides)
                    parts.append((i, sc))
                    chans += shape[-1]
                    spatial = shape[:2]
            layer, out = ("concat", parts), (*spatial, chans)
        self.layers.append(layer)

        # squeeze and excitation
        self.se = None
        if squeeze_ratio > 0:
            se_filters = int(squeeze_ratio * out[-1])
            se1, _ = conv((1, 1, out[-1]), se_filters, 1)
            se2, _ = conv((1, 1, se_filters), out[-1], 1)
            self.se = (se1, se2)
        self.out_shape = tuple(out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outputs = [x]
        for layer in self.layers:
            if layer[0] == "pass":
                out = outputs[-1]
            elif layer[0] == "conv":
                _, main, main_bn, skips = layer
                out = main_bn(main(outputs[-1]))
                for i, sc, sbn in skips:
                    skip = outputs[i]
                    if sc is not None:
                        skip = sbn(sc(skip))
                    out = out + skip
                out = self.act(out)
            elif layer[0] == "pair":
                _, main, wide_bn, skips = layer
                raws = [main(outputs[-1])] + [sc(outputs[i])
                                              for i, sc in skips
                                              if sc is not None]
                parts = iter(wide_bn(torch.cat(raws, dim=-1)).chunk(
                    len(raws), dim=-1))
                # added in the unrolled layer's index order
                out = next(parts)
                for i, sc in skips:
                    out = out + (outputs[i] if sc is None else next(parts))
                out = self.act(out)
            else:
                out = torch.cat([outputs[i] if sc is None else sc(outputs[i])
                                 for i, sc in layer[1]], dim=-1)
            outputs.append(out)
        if self.se is not None:
            se = out.mean(dim=(-3, -2), keepdim=True)
            se = self.se_act(self.se[0](se))
            se = torch.sigmoid(self.se[1](se))
            out = se * out
        return out


class MotherStage(nn.Module):
    def __init__(self, config: Dict[str, Any], in_shape: Sequence[int],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        strides = _tuple2(config.get("strides", (1, 1)))
        shape = tuple(in_shape)
        for i in range(config["depth"]):
            block = add_child(self, MotherBlock(
                config, strides if i == 0 else (1, 1), shape, generator))
            shape = block.out_shape
        self.out_shape = shape

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.children():
            x = block(x)
        return x


@register_block("mother_block")
def mother_block(model_config: dict):
    _validate_mother_config(model_config)
    return functools.partial(MotherBlock, dict(model_config),
                             _tuple2(model_config.get("strides", (1, 1))))


@register_block("mother_stage")
def mother_stage(model_config: dict):
    _validate_mother_config(model_config)
    return functools.partial(MotherStage, dict(model_config))


# --------------------------------------------------------------------------
#                        RNN / DENSE 1D BLOCKS
# --------------------------------------------------------------------------
class BidirectionalGRUBlock(nn.Module):
    """force_1d then stacked biGRUs merged multiplicatively."""

    def __init__(self, units: Tuple[int, ...], in_shape: Sequence[int],
                 dropout_rate: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        t, i = force_1d_shape(in_shape)
        for u in units:
            # reference GRU blocks pass recurrent_dropout=dropout_rate
            add_child(self, GRU(i, u, bidirectional=True, merge_mode="mul",
                                dropout=dropout_rate,
                                recurrent_dropout=dropout_rate,
                                generator=generator))
            i = u
        self.out_shape = (t, i)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = force_1d(x)
        for gru in self.children():
            x = gru(x)
        return x


def _bigru(units, dropout_rate, in_shape, generator=None):
    return BidirectionalGRUBlock(units, in_shape, dropout_rate, generator)


@register_block("bidirectional_GRU_block")
def bidirectional_GRU_block(model_config: dict):
    return functools.partial(_bigru, tuple(model_config["units"]),
                             model_config.get("dropout_rate", 0.0))


@register_block("bidirectional_GRU_stage")
def bidirectional_GRU_stage(model_config: dict):
    return functools.partial(
        _bigru, (model_config["units"],) * model_config["depth"],
        model_config.get("dropout_rate", 0.0))


class RNNBlock(nn.Module):
    """force_1d then `depth` (bi)directional GRU or LSTM layers
    (modules.py:299-343), each with recurrent_dropout = dropout_rate, as
    the reference passes it."""

    def __init__(self, units: int, in_shape: Sequence[int],
                 bidirectional: bool = True, merge_mode: str = "mul",
                 rnn_type: str = "GRU", dropout_rate: float = 0.0,
                 depth: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        t, i = force_1d_shape(in_shape)
        cls = GRU if rnn_type == "GRU" else LSTM
        for _ in range(depth):
            add_child(self, cls(i, units, bidirectional=bidirectional,
                                merge_mode=merge_mode, dropout=dropout_rate,
                                recurrent_dropout=dropout_rate,
                                generator=generator))
            i = 2 * units if bidirectional and merge_mode == "concat" \
                else units
        self.out_shape = (t, i)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = force_1d(x)
        for rnn in self.children():
            x = rnn(x)
        return x


def _rnn_kwargs(model_config: dict) -> dict:
    return dict(units=model_config["units"],
                bidirectional=model_config.get("bidirectional", True),
                merge_mode=model_config.get("merge_mode", "mul"),
                rnn_type=model_config.get("rnn_type", "GRU"),
                dropout_rate=model_config.get("dropout_rate", 0.0))


def _rnn(kwargs, in_shape, generator=None):
    return RNNBlock(in_shape=in_shape, generator=generator, **kwargs)


@register_block("RNN_block")
def RNN_block(model_config: dict):
    return functools.partial(_rnn, _rnn_kwargs(model_config))


@register_block("RNN_stage")
def RNN_stage(model_config: dict):
    return functools.partial(_rnn, dict(_rnn_kwargs(model_config),
                                        depth=model_config["depth"]))


class SimpleDenseBlock(nn.Module):
    """Dense for 2D inputs, Conv1D for 3D (modules.py:350-376)."""

    def __init__(self, units: Tuple[int, ...], in_shape: Sequence[int],
                 kernel_size: int = 1, activation: Optional[str] = None,
                 dropout_rate: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        shape = force_1d_shape(in_shape)
        for u in units:
            if len(shape) == 1:
                add_child(self, _dense(shape[-1], u, generator=generator))
            else:
                add_child(self, _conv1d(shape[-1], u, kernel_size,
                                        generator=generator))
            shape = (*shape[:-1], u)
        self.act = get_activation(activation)
        self.dropout_rate = dropout_rate
        self.dropout_generator = None   # set_dropout_generator
        self.out_shape = shape

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = force_1d(x)
        for layer in self.children():
            x = layer(x)
            if self.act:
                x = self.act(x)
            x = dropout(x, self.dropout_rate, self.training,
                        self.dropout_generator)
        return x


@register_block("simple_dense_block")
def simple_dense_block(model_config: dict):
    return functools.partial(
        _simple_dense, tuple(model_config["units"]),
        model_config.get("kernel_size", 1),
        model_config.get("dense_activation", None),
        model_config.get("dropout_rate", 0.0))


@register_block("simple_dense_stage")
def simple_dense_stage(model_config: dict):
    # Reference quirk (modules.py:86-103): the stage OVERWRITES
    # 'dense_activation' with the 'activation' key (default None), so a
    # config carrying only 'dense_activation' — like SS5.json's BLOCK1 —
    # runs a LINEAR dense stage. Replicated exactly.
    return functools.partial(
        _simple_dense, (model_config["units"],) * model_config["depth"],
        model_config.get("kernel_size", 1),
        model_config.get("activation", None),
        model_config.get("dropout_rate", 0.0))


def _simple_dense(units, kernel_size, activation, dropout_rate, in_shape,
                  generator=None):
    return SimpleDenseBlock(units, in_shape, kernel_size, activation,
                            dropout_rate, generator)


# --------------------------------------------------------------------------
#                       ATTENTION-FAMILY 1D BLOCKS
# --------------------------------------------------------------------------
class _Drop:
    """Dropout at the block's rate from its generator (set_dropout_generator)
    in training; the identity in eval."""

    def _drop(self, x):
        return dropout(x, self.dropout_rate, self.training,
                       self.dropout_generator)


class TransformerEncoderBlock(_Drop, nn.Module):
    """Post-LN transformer encoder with a Conv1D FFN (modules.py:398-454):
    per layer x = LN(x + drop(MHA(x))), x = LN(x + drop(conv2(drop(act(
    conv1(x)))))); children MultiHeadAttention_i, LayerNorm, Conv, Conv,
    LayerNorm in flax's order."""

    def __init__(self, in_shape: Sequence[int], n_head: int, key_dim: int,
                 ff_multiplier: float, kernel_size: int,
                 activation: str = "relu", dropout_rate: float = 0.1,
                 depth: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        t, d = force_1d_shape(in_shape)
        hidden = int(ff_multiplier * d)
        g = generator
        self.act = get_activation(activation)
        self.dropout_rate = dropout_rate
        self.dropout_generator = None   # set_dropout_generator
        self.layers = []
        for _ in range(depth):
            self.layers.append(tuple(add_child(self, m) for m in (
                MultiHeadAttention(d, d, d, n_head, key_dim, output_size=d,
                                   dropout=dropout_rate, use_bias=True,
                                   generator=g),
                _layer_norm(d),
                _conv1d(d, hidden, kernel_size, generator=g),
                _conv1d(hidden, d, kernel_size, generator=g),
                _layer_norm(d))))
        self.out_shape = (t, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = force_1d(x)
        for mha, ln1, conv1, conv2, ln2 in self.layers:
            x = ln1(x + self._drop(mha(x, x, x)))
            ffn = self._drop(conv2(self._drop(self.act(conv1(x)))))
            x = ln2(x + ffn)
        return x


def _transformer(kwargs, in_shape, generator=None):
    return TransformerEncoderBlock(in_shape, generator=generator, **kwargs)


def _transformer_kwargs(model_config: dict) -> dict:
    return dict(n_head=model_config["n_head"],
                key_dim=model_config["key_dim"],
                ff_multiplier=model_config["ff_multiplier"],
                kernel_size=model_config["kernel_size"],
                activation=model_config.get("activation", "relu"),
                dropout_rate=model_config.get("dropout_rate", 0.1))


@register_block("transformer_encoder_block")
def transformer_encoder_block(model_config: dict):
    return functools.partial(_transformer, _transformer_kwargs(model_config))


@register_block("transformer_encoder_stage")
def transformer_encoder_stage(model_config: dict):
    return functools.partial(_transformer, dict(
        _transformer_kwargs(model_config), depth=model_config["depth"]))


class ScanBody(nn.Module):
    """flax `nn.scan`'s parameter layout (variable_axes params and
    batch_stats on axis 0): the children of one layer, every parameter and
    buffer stacked over `copies` on a leading depth axis.

    forward(x, step) runs `step(x)` once a layer, in order, with the
    children holding layer i's slices (`torch.func.functional_call`): the
    gradient of a slice lands in its stacked parameter, and a BatchNorm's
    running statistics update in their slice, in place. `step` reads the
    children through the first copy's references, which are this module's
    children."""

    def __init__(self, copies: Sequence[nn.Module]):
        super().__init__()
        first = copies[0]
        for name, child in first.named_children():
            self.add_module(name, child)
        params = {n: torch.stack([c.get_parameter(n).detach()
                                  for c in copies])
                  for n, _ in first.named_parameters()}
        buffers = {n: torch.stack([c.get_buffer(n) for c in copies])
                   for n, _ in first.named_buffers()}
        for n, t in params.items():
            owner, leaf = self._owner(n)
            setattr(owner, leaf, nn.Parameter(t))
        for n, t in buffers.items():
            owner, leaf = self._owner(n)
            owner.register_buffer(leaf, t)
        self.depth = len(copies)
        self._names = [*params, *buffers]

    def _owner(self, name: str):
        *path, leaf = name.split(".")
        return self.get_submodule(".".join(path)), leaf

    def forward(self, x: torch.Tensor, step, layer: Optional[int] = None):
        if layer is not None:
            return step(x)
        for i in range(self.depth):
            # the tensors in place now (a caller's functional_call may have
            # swapped in cast copies), sliced at layer i
            sliced = {n: getattr(*self._owner(n))[i] for n in self._names}
            x = torch.func.functional_call(self, sliced, (x, step),
                                           {"layer": i})
        return x


class ConformerEncoderBlock(_Drop, nn.Module):
    """Conformer block: FFN/2 -> MHSA -> GLU+depthwise conv -> FFN/2
    (modules.py:457-616), `depth` iterations. Positional encoding
    `pos_encoding` None, "basic" (sinusoidal) or "rff" (RFFPosEncoding, a
    child of each iteration), added to x in `pos_mode` "absolute" or fed
    to a RelPositionMultiHeadAttention in "relative" mode (ValueError
    without an encoding). Unrolled, each iteration's children register on
    the block in flax's order; with `scan_depth` (also at depth 1) one
    iteration's children register under `scan` with every parameter and
    batch statistic stacked over the depth (ScanBody), flax nn.scan's
    tree."""

    def __init__(self, in_shape: Sequence[int], key_dim: int = 36,
                 n_head: int = 4, kernel_size: int = 32,
                 activation: str = "swish", dropout_rate: float = 0.1,
                 multiplier: float = 4, ffn_factor: float = 0.5,
                 pos_encoding: Optional[str] = "basic",
                 pos_mode: str = "absolute", use_bias: bool = True,
                 depth: int = 1, scan_depth: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if pos_mode == "relative" and pos_encoding not in ("basic", "rff"):
            raise ValueError(
                "relative pos mode requires a positional encoding")
        self.act = get_activation(activation)
        self.dropout_rate, self.ffn_factor = dropout_rate, ffn_factor
        self.pos_encoding, self.pos_mode = pos_encoding, pos_mode
        self.dropout_generator = None   # set_dropout_generator
        time, emb = force_1d_shape(in_shape)
        hidden = int(multiplier * emb)
        g = generator

        def iteration(parent):
            """One iteration's children on `parent`, in flax's order."""
            def child(m):
                return add_child(parent, m)

            def ffn():
                return (child(_layer_norm(emb)),
                        child(_dense(emb, hidden, generator=g)),
                        child(_dense(hidden, emb, generator=g)))

            it = {"ffn1": ffn()}
            if pos_encoding == "rff":
                it["rff"] = child(RFFPosEncoding(emb, generator=g))
            it["attn_ln"] = child(_layer_norm(emb))
            if pos_mode == "relative":
                it["mha"] = child(RelPositionMultiHeadAttention(
                    emb, emb, emb, emb, n_head, key_dim,
                    dropout=dropout_rate, use_bias=use_bias, generator=g))
            else:
                it["mha"] = child(MultiHeadAttention(
                    emb, emb, emb, n_head, key_dim, dropout=dropout_rate,
                    use_bias=use_bias, generator=g))
            it["conv_ln"] = child(_layer_norm(emb))
            it["glu"] = child(_conv1d(emb, 2 * emb, 1, generator=g))
            it["depthwise"] = child(_conv1d(emb, emb, kernel_size,
                                            groups=emb, generator=g))
            it["bn"] = child(BatchNorm(emb))
            it["pointwise"] = child(_conv1d(emb, emb, 1, generator=g))
            it["ffn2"] = ffn()
            it["out_ln"] = child(_layer_norm(emb))
            return it

        if scan_depth:
            copies, its = [], []
            for _ in range(depth):
                copies.append(nn.Module())
                its.append(iteration(copies[-1]))
            add_child(self, ScanBody(copies), name="scan")
            self.iters = its[:1]      # the scan body's children
        else:
            self.iters = [iteration(self) for _ in range(depth)]
        self.scan_depth = scan_depth
        self.out_shape = (time, emb)

    def _ffn(self, x, layers):
        ln, d1, d2 = layers
        return self._drop(d2(self._drop(self.act(d1(ln(x))))))

    def _iteration(self, x: torch.Tensor, it: dict) -> torch.Tensor:
        x = x + self.ffn_factor * self._ffn(x, it["ffn1"])
        encoding = None
        if self.pos_encoding == "basic":
            encoding = basic_pos_encoding_on(x.shape[-2], x.shape[-1],
                                             x.device, x.dtype)
        elif self.pos_encoding == "rff":
            encoding = it["rff"](x.shape[-2], x.dtype)
        if self.pos_mode == "absolute" and encoding is not None:
            x = x + encoding

        attn_in = it["attn_ln"](x)
        if self.pos_mode == "relative":
            attn = it["mha"](attn_in, attn_in, attn_in, encoding)
        else:
            attn = it["mha"](attn_in, attn_in, attn_in)
        x = self._drop(attn) + x

        # conv module: pointwise-GLU -> depthwise -> BN -> swish -> pointwise
        conv = it["glu"](it["conv_ln"](x))
        conv_1, conv_2 = conv.chunk(2, dim=-1)
        conv = conv_1 * torch.sigmoid(conv_2)
        conv = torch.nn.functional.silu(it["bn"](it["depthwise"](conv)))
        conv = self._drop(it["pointwise"](conv))
        conv = conv + x

        # final half-step FFN off the conv output, residual to pre-conv x
        ffn = self._ffn(conv, it["ffn2"])
        return it["out_ln"](x + self.ffn_factor * ffn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = force_1d(x)
        if self.scan_depth:
            return self.scan(x, functools.partial(self._iteration,
                                                  it=self.iters[0]))
        for it in self.iters:
            x = self._iteration(x, it)
        return x


def _conformer_kwargs(model_config: dict) -> dict:
    return dict(
        key_dim=model_config.get("key_dim", 36),
        n_head=model_config.get("n_head", 4),
        kernel_size=model_config.get("kernel_size", 32),
        activation=model_config.get("activation", "swish"),
        dropout_rate=model_config.get("dropout_rate", 0.1),
        multiplier=model_config.get("multiplier", 4),
        ffn_factor=model_config.get("ffn_factor", 0.5),
        pos_encoding=model_config.get("pos_encoding", "basic"),
        pos_mode=model_config.get("pos_mode", "absolute"),
        use_bias=model_config.get("use_bias", True),
    )


def _conformer(kwargs, in_shape, generator=None):
    return ConformerEncoderBlock(in_shape, generator=generator, **kwargs)


@register_block("conformer_encoder_block")
def conformer_encoder_block(model_config: dict):
    return functools.partial(_conformer, _conformer_kwargs(model_config))


@register_block("conformer_encoder_stage")
def conformer_encoder_stage(model_config: dict):
    kwargs = dict(_conformer_kwargs(model_config),
                  depth=model_config["depth"],
                  scan_depth=model_config.get("scan_depth", False))
    return functools.partial(_conformer, kwargs)


class AttentionBlock(_Drop, nn.Module):
    """Generalised attention block (modules.py:619-715): per layer an
    optional first FF (two Conv1Ds), MHSA (absolute: the encoding added to
    the residual after the attention's input is taken; relative: the
    encoding fed to a RelPositionMultiHeadAttention), an optional GLU, an
    optional depthwise conv module and an optional second FF; LayerNorm
    after each part (post-LN) or before the attention, GLU and depthwise
    parts (`layer_norm_in_front`). The FF convs read `x`, not a pre-LN
    branch, and pos_encoding None gives a zeros encoding (the reference's
    quirks); a kernel_size of 0 replaces x with the GLU branch."""

    def __init__(self, in_shape: Sequence[int], key_dim: int, n_head: int,
                 kernel_size: int, ff_kernel_size: int,
                 ff_multiplier: float, ff_factor0: float, ff_factor1: float,
                 activation: str = "swish",
                 pos_encoding: Optional[str] = "basic",
                 abs_pos_encoding: bool = False,
                 layer_norm_in_front: bool = False, use_glu: bool = False,
                 use_bias: bool = False, dropout_rate: float = 0.1,
                 depth: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        t, d = force_1d_shape(in_shape)
        g, pre = generator, layer_norm_in_front
        hidden = int(ff_multiplier * d)
        self.act = get_activation(activation)
        self.ff_factors = (ff_factor0, ff_factor1)
        self.pos_encoding, self.abs_pos_encoding = pos_encoding, \
            abs_pos_encoding
        self.pre, self.use_glu, self.kernel_size = pre, use_glu, kernel_size
        self.dropout_rate = dropout_rate
        self.dropout_generator = None   # set_dropout_generator

        def child(m):
            return add_child(self, m)

        def ff():
            return (child(_conv1d(d, hidden, ff_kernel_size, generator=g)),
                    child(_conv1d(hidden, d, ff_kernel_size, generator=g)))

        # one dict of children per layer, created in flax's order
        self.iters = []
        for _ in range(depth):
            it = {}
            if ff_factor0 > 0:
                it["ff0"] = ff()
                if not pre:
                    it["ff0_ln"] = child(_layer_norm(d))
            if pos_encoding == "rff":
                it["rff"] = child(RFFPosEncoding(d, generator=g))
            if pre:
                it["attn_ln"] = child(_layer_norm(d))
            if abs_pos_encoding:
                it["mha"] = child(MultiHeadAttention(
                    d, d, d, n_head, key_dim, dropout=dropout_rate,
                    use_bias=use_bias, generator=g))
            else:
                it["mha"] = child(RelPositionMultiHeadAttention(
                    d, d, d, d, n_head, key_dim, dropout=dropout_rate,
                    use_bias=use_bias, generator=g))
            if not pre:
                it["attn_post_ln"] = child(_layer_norm(d))
            if use_glu:
                if pre:
                    it["glu_ln"] = child(_layer_norm(d))
                it["glu"] = child(_conv1d(d, 2 * d, 1, generator=g))
            if kernel_size > 0:
                if pre and not use_glu:
                    it["dw_ln"] = child(_layer_norm(d))
                it["depthwise"] = child(_conv1d(d, d, kernel_size, groups=d,
                                                generator=g))
                it["bn"] = child(BatchNorm(d))
                it["pointwise"] = child(_conv1d(d, d, 1, generator=g))
                if not pre:
                    it["dw_post_ln"] = child(_layer_norm(d))
            if ff_factor1 > 0:
                it["ff1"] = ff()
                if not pre:
                    it["ff1_ln"] = child(_layer_norm(d))
            self.iters.append(it)
        self.out_shape = (t, d)

    def _ff(self, x, convs):
        conv1, conv2 = convs
        return self._drop(conv2(self._drop(self.act(conv1(x)))))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = force_1d(x)
        time, d = x.shape[-2:]
        for it in self.iters:
            if "ff0" in it:
                x = x + self.ff_factors[0] * self._ff(x, it["ff0"])
                if not self.pre:
                    x = it["ff0_ln"](x)

            if self.pos_encoding == "basic":
                encoding = basic_pos_encoding_on(time, d, x.device, x.dtype)
            elif self.pos_encoding == "rff":
                encoding = it["rff"](time, x.dtype)
            else:
                encoding = x.new_zeros((1, time, d))

            attn_in = it["attn_ln"](x) if self.pre else x
            if self.abs_pos_encoding:
                x = x + encoding
                attn = it["mha"](attn_in, attn_in, attn_in)
            else:
                attn = it["mha"](attn_in, attn_in, attn_in, encoding)
            x = self._drop(attn) + x
            if not self.pre:
                x = it["attn_post_ln"](x)

            conv = x
            if self.use_glu:
                if self.pre:
                    conv = it["glu_ln"](conv)
                conv_1, conv_2 = it["glu"](conv).chunk(2, dim=-1)
                conv = conv_1 * torch.sigmoid(conv_2)

            if self.kernel_size > 0:
                if self.pre and not self.use_glu:
                    conv = it["dw_ln"](conv)
                conv = torch.nn.functional.silu(
                    it["bn"](it["depthwise"](conv)))
                x = x + self._drop(it["pointwise"](conv))
                if not self.pre:
                    x = it["dw_post_ln"](x)
            else:
                x = conv

            if "ff1" in it:
                x = x + self.ff_factors[1] * self._ff(x, it["ff1"])
                if not self.pre:
                    x = it["ff1_ln"](x)
        return x


def _attention_kwargs(model_config: dict) -> dict:
    """The attention block's arguments, with the reference's ValueErrors
    (NAS rejection sampling relies on them)."""
    ff_factor0 = model_config["ff_factor0"]
    ff_factor1 = model_config["ff_factor1"]
    ff_kernel_size = model_config["ff_kernel_size"]
    ff_multiplier = model_config["ff_multiplier"]
    pos_encoding = model_config.get("pos_encoding", "basic")
    abs_pos_encoding = model_config.get("abs_pos_encoding", False)

    if ff_factor0 < 0 or ff_factor1 < 0:
        raise ValueError("ff_factor0, ff_factor1 >= 0 must hold")
    if ff_factor0 == 0 and ff_factor1 == 0:
        if ff_kernel_size > 0:
            raise ValueError("if FF modules are not used, "
                             "ff_kernel must be set to 0")
        if ff_multiplier > 0:
            raise ValueError("if FF modules are not used, "
                             "ff_multiplier must be set to 0")
    if not abs_pos_encoding and pos_encoding is None:
        raise ValueError("relative pos encoding demands any types of encoding "
                         "except the null one")

    return dict(
        key_dim=model_config["key_dim"],
        n_head=model_config["n_head"],
        kernel_size=model_config["kernel_size"],
        ff_kernel_size=ff_kernel_size,
        ff_multiplier=ff_multiplier,
        ff_factor0=ff_factor0,
        ff_factor1=ff_factor1,
        activation=model_config.get("activation", "swish"),
        pos_encoding=pos_encoding,
        abs_pos_encoding=abs_pos_encoding,
        layer_norm_in_front=model_config.get("layer_norm_in_front", False),
        use_glu=model_config.get("use_glu", False),
        use_bias=model_config.get("use_bias", False),
        dropout_rate=model_config.get("dropout_rate", 0.1),
    )


def _attention(kwargs, in_shape, generator=None):
    return AttentionBlock(in_shape, generator=generator, **kwargs)


@register_block("attention_block")
def attention_block(model_config: dict):
    return functools.partial(_attention, _attention_kwargs(model_config))


@register_block("attention_stage")
def attention_stage(model_config: dict):
    return functools.partial(_attention, dict(
        _attention_kwargs(model_config), depth=model_config["depth"]))


# --------------------------------------------------------------------------
#                      LEGACY CONV FAMILIES (2D -> 2D)
# --------------------------------------------------------------------------
def _pooled(shape, window, strides=None, padding="VALID"):
    """Per-sample shape after `max_pool` / `avg_pool`."""
    strides = strides or window
    t, f, c = shape
    if padding == "SAME":
        return (-(-t // strides[0]), -(-f // strides[1]), c)
    return ((t - window[0]) // strides[0] + 1,
            (f - window[1]) // strides[1] + 1, c)


class SimpleConvBlock(nn.Module):
    """Classic SELDnet conv stack: [conv3x3-BN-relu-maxpool-dropout] x N
    (modules.py:771-793). Its Conv2DBNs take no pool, so no fused stem:
    each layer runs its Conv, then its BatchNorm with the pool
    (`BatchNorm(x, relu_pool=...)`: BatchNorm, ReLU and the pool)."""

    def __init__(self, filters: Tuple[int, ...],
                 pool_size: Tuple[Tuple[int, int], ...],
                 dropout_rate: float, in_shape: Sequence[int],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        shape = tuple(in_shape)
        self.layers = []
        for f, pool in zip(filters, pool_size):
            conv = add_child(self, Conv2DBN(shape, f, 3, activation="relu",
                                            generator=generator))
            self.layers.append((conv, pool))
            shape = _pooled(conv.out_shape, pool)
        self.dropout_rate = dropout_rate
        self.dropout_generator = None   # set_dropout_generator
        self.out_shape = shape

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv, pool in self.layers:
            x = conv.BatchNorm_0(conv.Conv_0(x), relu_pool=pool)
            x = dropout(x, self.dropout_rate, self.training,
                        self.dropout_generator)
        return x


@register_block("simple_conv_block")
def simple_conv_block(model_config: dict):
    return functools.partial(
        SimpleConvBlock, tuple(model_config["filters"]),
        tuple(_tuple2(p) for p in model_config["pool_size"]),
        model_config.get("dropout_rate", 0.0))


class CondConvBlock(nn.Module):
    """Conditionally-parameterised conv stack (CondConv, arXiv 1904.04971;
    modules.py:796-830): per layer, a per-sample sigmoid routing
    Dense(mean over T, F) mixes the outputs of `num_experts` 3x3 convs
    (conv is linear, so this is the mix of their kernels), then BN, ReLU,
    max pool and dropout. Children in flax's order: Dense_l, then the
    layer's experts Conv_{K l}..Conv_{K l + K - 1}, then BatchNorm_l."""

    def __init__(self, filters: Tuple[int, ...],
                 pool_size: Tuple[Tuple[int, int], ...],
                 dropout_rate: float, num_experts: int,
                 in_shape: Sequence[int],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        shape = tuple(in_shape)
        self.layers = []
        for f, pool in zip(filters, pool_size):
            route = add_child(self, _dense(shape[-1], num_experts,
                                           generator=generator))
            experts = [add_child(self, _conv(shape[-1], f, 3,
                                             generator=generator))
                       for _ in range(num_experts)]
            bn = add_child(self, BatchNorm(f))
            self.layers.append((route, experts, bn, pool))
            shape = _pooled(experts[0].out_shape_of(shape), pool)
        self.dropout_rate = dropout_rate
        self.dropout_generator = None   # set_dropout_generator
        self.out_shape = shape

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for route, experts, bn, pool in self.layers:
            weights = torch.sigmoid(route(x.mean(dim=(1, 2))))   # [B, K]
            mixed = torch.stack([conv(x) for conv in experts], dim=-1)
            x = torch.einsum("bhwck,bk->bhwc", mixed, weights)
            x = bn(x, relu_pool=pool)
            x = dropout(x, self.dropout_rate, self.training,
                        self.dropout_generator)
        return x


@register_block("cond_conv_block")
def cond_conv_block(model_config: dict):
    return functools.partial(
        CondConvBlock, tuple(model_config["filters"]),
        tuple(_tuple2(p) for p in model_config["pool_size"]),
        model_config.get("dropout_rate", 0.0),
        model_config.get("num_experts", 4))


class AnotherConvBlock(nn.Module):
    """depth x [conv3x3-BN-relu] then a max pool (modules.py:833-850)."""

    def __init__(self, filters: int, depth: int, pool_size: Tuple[int, int],
                 in_shape: Sequence[int],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        shape = tuple(in_shape)
        for _ in range(depth):
            shape = add_child(self, Conv2DBN(
                shape, filters, 3, activation="relu",
                generator=generator)).out_shape
        self.pool = pool_size
        self.out_shape = _pooled(shape, pool_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv in self.children():
            x = conv(x)
        return max_pool(x, self.pool, strides=self.pool)


@register_block("another_conv_block")
def another_conv_block(model_config: dict):
    return functools.partial(AnotherConvBlock, model_config["filters"],
                             model_config["depth"],
                             _tuple2(model_config["pool_size"]))


class _ResidualStage(nn.Module):
    """`depth` residual blocks, the first strided: x -> relu(bn(conv(
    Conv2DBNs(x))) + shortcut(x)), where the shortcut is a strided 1x1 conv
    + BN only where that shape differs from x's. flax numbers each block's
    Conv_i and BatchNorm_i in creation order, so a later block's indices
    depend on whether an earlier one had a projection; `self.blocks`
    holds (Conv2DBNs, conv, bn, projection or None) in that order."""

    def _add_block(self, shape, convbns, kernel, out_ch, strides,
                   generator):
        """Adds the block's last conv + BN after its Conv2DBNs, then the
        projection where shapes differ; returns the block's out shape."""
        mid = convbns[-1].out_shape
        conv = add_child(self, _conv(mid[-1], out_ch, kernel,
                                     generator=generator))
        bn = add_child(self, BatchNorm(out_ch))
        out = conv.out_shape_of(mid)
        projection = None
        if tuple(shape) != tuple(out):
            projection = (add_child(self, _conv(shape[-1], out_ch, 1,
                                                strides=strides,
                                                generator=generator)),
                          add_child(self, BatchNorm(out_ch)))
        self.blocks.append((convbns, conv, bn, projection))
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for convbns, conv, bn, projection in self.blocks:
            out = x
            for layer in convbns:
                out = layer(out)
            shortcut = x if projection is None else \
                projection[1](projection[0](x))
            x = torch.relu(bn(conv(out)) + shortcut)
        return x


class ResBasicStage(_ResidualStage):
    """ResNet-v1 basic stage (modules.py:853-878): conv3x3(strided)-BN-relu
    -> conv3x3-BN, plus the shortcut."""

    def __init__(self, filters: int, depth: int, strides: Tuple[int, int],
                 in_shape: Sequence[int],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g, shape = generator, tuple(in_shape)
        self.blocks = []
        for i in range(depth):
            s = strides if i == 0 else (1, 1)
            first = add_child(self, Conv2DBN(shape, filters, 3, strides=s,
                                             activation="relu", generator=g))
            shape = self._add_block(shape, [first], 3, filters, s, g)
        self.out_shape = shape


@register_block("res_basic_stage")
def res_basic_stage(model_config: dict):
    return functools.partial(ResBasicStage, model_config["filters"],
                             model_config["depth"],
                             _tuple2(model_config["strides"]))


class ResBottleneckStage(_ResidualStage):
    """ResNet bottleneck stage (modules.py:881-910): 1x1-BN-relu ->
    3x3(strided)-BN-relu -> 1x1 (filters x bottleneck_ratio)-BN, plus the
    shortcut."""

    def __init__(self, filters: int, depth: int, strides: Tuple[int, int],
                 bottleneck_ratio: int, in_shape: Sequence[int],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g, shape = generator, tuple(in_shape)
        self.blocks = []
        for i in range(depth):
            s = strides if i == 0 else (1, 1)
            reduce = add_child(self, Conv2DBN(shape, filters, 1,
                                              activation="relu", generator=g))
            mid = add_child(self, Conv2DBN(reduce.out_shape, filters, 3,
                                           strides=s, activation="relu",
                                           generator=g))
            shape = self._add_block(shape, [reduce, mid], 1,
                                    filters * bottleneck_ratio, s, g)
        self.out_shape = shape


@register_block("res_bottleneck_stage")
def res_bottleneck_stage(model_config: dict):
    return functools.partial(ResBottleneckStage, model_config["filters"],
                             model_config["depth"],
                             _tuple2(model_config["strides"]),
                             model_config.get("bottleneck_ratio", 4))


class DenseNetStage(nn.Module):
    """One DenseNet stage (modules.py:913-943): depth x [BN-relu-1x1
    (int(bottleneck_ratio x growth)) -> BN-relu-3x3 (growth), concat], then,
    unless reduction_ratio is None, a transition BN-relu-1x1
    (int(channels x reduction_ratio)) and a VALID average pool of window
    `strides` where that is not (1, 1)."""

    def __init__(self, growth_rate: int, depth: int,
                 strides: Tuple[int, int], bottleneck_ratio: float,
                 reduction_ratio: Optional[float], in_shape: Sequence[int],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        t, f, c = in_shape
        mid = int(bottleneck_ratio * growth_rate)
        self.layers = []
        for _ in range(depth):
            self.layers.append((
                add_child(self, BatchNorm(c)),
                add_child(self, _conv(c, mid, 1, use_bias=False,
                                      generator=g)),
                add_child(self, BatchNorm(mid)),
                add_child(self, _conv(mid, growth_rate, 3, use_bias=False,
                                      generator=g))))
            c += growth_rate
        self.transition = None
        self.strides = _tuple2(strides)
        if reduction_ratio is not None:
            out = int(c * reduction_ratio)
            self.transition = (add_child(self, BatchNorm(c)),
                               add_child(self, _conv(c, out, 1,
                                                     use_bias=False,
                                                     generator=g)))
            c = out
            if self.strides != (1, 1):
                t, f, _ = _pooled((t, f, c), self.strides)
        self.out_shape = (t, f, c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for bn1, conv1, bn2, conv2 in self.layers:
            out = conv1(torch.relu(bn1(x)))
            out = conv2(torch.relu(bn2(out)))
            x = torch.cat([x, out], dim=-1)
        if self.transition is not None:
            bn, conv = self.transition
            x = conv(torch.relu(bn(x)))
            if self.strides != (1, 1):
                x = avg_pool(x, self.strides)
        return x


class DenseNetBody(nn.Module):
    """DenseNet-121-style body (modules.py:946-960): stem conv7x7-BN-relu,
    max pool (5, 2), len(block_num) DenseNetStages of growth
    max(filters // 2, 8) with strides (1, 2), the last without its
    transition, then BN-relu."""

    def __init__(self, filters: int, block_num: Tuple[int, ...],
                 in_shape: Sequence[int],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        stem = add_child(self, Conv2DBN(tuple(in_shape), filters, 7,
                                        activation="relu",
                                        generator=generator))
        shape = _pooled(stem.out_shape, (5, 2))
        growth = max(filters // 2, 8)
        self.stages = []
        for i, depth in enumerate(block_num):
            last = i == len(block_num) - 1
            stage = add_child(self, DenseNetStage(
                growth, depth, (1, 2), 4.0, None if last else 0.5, shape,
                generator))
            self.stages.append(stage)
            shape = stage.out_shape
        add_child(self, BatchNorm(shape[-1]))
        self.out_shape = shape

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = max_pool(self.Conv2DBN_0(x), (5, 2), strides=(5, 2))
        for stage in self.stages:
            x = stage(x)
        return torch.relu(self.BatchNorm_0(x))


@register_block("dense_net_block")
def dense_net_block(model_config: dict):
    if "block_num" in model_config:
        return functools.partial(DenseNetBody, model_config["filters"],
                                 tuple(model_config["block_num"]))
    return functools.partial(
        DenseNetStage, model_config["growth_rate"], model_config["depth"],
        _tuple2(model_config.get("strides", (1, 1))),
        model_config.get("bottleneck_ratio", 4.0),
        model_config.get("reduction_ratio", 0.5))


class ResNet50Body(nn.Module):
    """ResNet50-style body (modules.py:976-995): stem conv7x7-BN-relu, max
    pool (5, 2), then ResBottleneckStages of filters x 2^i, the first
    unstrided and the others strided (1, 2)."""

    def __init__(self, filters: int, block_num: Tuple[int, ...],
                 in_shape: Sequence[int],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        stem = add_child(self, Conv2DBN(tuple(in_shape), filters, 7,
                                        activation="relu",
                                        generator=generator))
        shape = _pooled(stem.out_shape, (5, 2))
        self.stages = []
        for i, depth in enumerate(block_num):
            stage = add_child(self, ResBottleneckStage(
                filters * (2 ** i), depth, (1, 1) if i == 0 else (1, 2), 4,
                shape, generator))
            self.stages.append(stage)
            shape = stage.out_shape
        self.out_shape = shape

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = max_pool(self.Conv2DBN_0(x), (5, 2), strides=(5, 2))
        for stage in self.stages:
            x = stage(x)
        return x


@register_block("resnet50_block")
def resnet50_block(model_config: dict):
    return functools.partial(ResNet50Body, model_config["filters"],
                             tuple(model_config["block_num"]))


class SeparableConvBN(nn.Module):
    """Depthwise conv (kernel [k, k, 1, C], C groups) -> pointwise 1x1 ->
    BN, both convs without bias (modules.py:998-1007)."""

    def __init__(self, filters: int, in_shape: Sequence[int],
                 kernel_size: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        c = in_shape[-1]
        add_child(self, _conv(c, c, kernel_size, groups=c, use_bias=False,
                              generator=generator))
        add_child(self, _conv(c, filters, 1, use_bias=False,
                              generator=generator))
        add_child(self, BatchNorm(filters))
        self.out_shape = (*tuple(in_shape)[:2], filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.BatchNorm_0(self.Conv_1(self.Conv_0(x)))


class XceptionBody(nn.Module):
    """Xception-style body (modules.py:1010-1036): stem conv3x3-BN-relu,
    max pool (5, 2); an entry flow of two reductions, each a strided 1x1
    conv + BN shortcut added to sepconv-relu-sepconv under the overlapping
    SAME max pool (1, 3) / (1, 2); `block_num` middle-flow residual blocks
    of three relu-sepconv; a final ReLU."""

    def __init__(self, filters: int, block_num: int,
                 in_shape: Sequence[int],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        stem = add_child(self, Conv2DBN(tuple(in_shape), filters, 3,
                                        activation="relu", generator=g))
        shape = _pooled(stem.out_shape, (5, 2))
        width = filters * 4
        self.entry = []
        for f in (filters * 2, width):
            conv = add_child(self, _conv(shape[-1], f, 1, strides=(1, 2),
                                         generator=g))
            bn = add_child(self, BatchNorm(f))
            sep1 = add_child(self, SeparableConvBN(f, shape, generator=g))
            sep2 = add_child(self, SeparableConvBN(f, sep1.out_shape,
                                                   generator=g))
            self.entry.append((conv, bn, sep1, sep2))
            shape = _pooled(sep2.out_shape, (1, 3), (1, 2), "SAME")
        self.middle = []
        for _ in range(block_num):
            seps = []
            for _ in range(3):
                seps.append(add_child(self, SeparableConvBN(
                    width, shape, generator=g)))
                shape = seps[-1].out_shape
            self.middle.append(seps)
        self.out_shape = shape

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = max_pool(self.Conv2DBN_0(x), (5, 2), strides=(5, 2))
        for conv, bn, sep1, sep2 in self.entry:
            shortcut = bn(conv(x))
            out = sep2(torch.relu(sep1(x)))
            out = max_pool(out, (1, 3), strides=(1, 2), padding="SAME")
            x = out + shortcut
        for seps in self.middle:
            out = x
            for sep in seps:
                out = sep(torch.relu(out))
            x = x + out
        return torch.relu(x)


@register_block("xception_block")
def xception_block(model_config: dict):
    return functools.partial(XceptionBody, model_config["filters"],
                             model_config["block_num"])


# --------------------------------------------------------------------------
#                      TEMPORAL CONV (SELD-TCN) AND IDENTITY
# --------------------------------------------------------------------------
class TCNStage(_Drop, nn.Module):
    """Dilated temporal-conv stage (SELD-TCN, arXiv 2003.01609;
    modules.py:1047-1093): a 1x1 projection where the width is not
    `filters`, then `depth` x [SAME Conv1D of 2 x filters, dilation 2^i ->
    BN -> tanh x sigmoid gate -> dropout -> a 1x1 residual conv added to x
    and a 1x1 skip conv summed], output relu(sum of skips). The last
    residual conv reaches no output (`unused_parameters`): the train step
    gives it zeros, as jax.grad does."""

    def __init__(self, filters: int, in_shape: Sequence[int],
                 depth: int = 3, kernel_size: int = 3,
                 dropout_rate: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        t, c = force_1d_shape(in_shape)
        g = generator
        # in a list: a module attribute would register it a second time
        self.proj = ([add_child(self, _conv1d(c, filters, 1, generator=g))]
                     if c != filters else [])
        self.layers = []
        for i in range(depth):
            self.layers.append(tuple(add_child(self, m) for m in (
                Conv(filters, 2 * filters, (kernel_size,), padding="SAME",
                     kernel_dilation=(2 ** i,), generator=g),
                BatchNorm(2 * filters),
                _conv1d(filters, filters, 1, generator=g),
                _conv1d(filters, filters, 1, generator=g))))
        self.dropout_rate = dropout_rate
        self.dropout_generator = None   # set_dropout_generator
        self.out_shape = (t, filters)
        # the last residual conv reaches no output
        last_res = self.layers[-1][2] if self.layers else None
        self.unused_parameters = tuple(
            f"{n}.{p}" for n, m in self.named_children() if m is last_res
            for p, _ in m.named_parameters())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = force_1d(x)
        for proj in self.proj:
            x = proj(x)
        skips = 0.0
        for conv, bn, res, skip in self.layers:
            gate_in, gate = bn(conv(x)).chunk(2, dim=-1)
            h = self._drop(torch.tanh(gate_in) * torch.sigmoid(gate))
            skips = skips + skip(h)
            x = x + res(h)
        return torch.relu(skips)


@register_block("tcn_stage")
def tcn_stage(model_config: dict):
    return functools.partial(
        TCNStage, model_config["filters"],
        depth=model_config.get("depth", 3),
        kernel_size=model_config.get("kernel_size", 3),
        dropout_rate=model_config.get("dropout_rate", 0.0))


class Identity(nn.Module):
    """The identity block (modules.py:1096-1104)."""

    def __init__(self, in_shape: Sequence[int],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.out_shape = tuple(in_shape)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


@register_block("identity_block")
def identity_block(model_config: dict):
    return Identity
