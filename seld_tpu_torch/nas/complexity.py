"""Analytic FLOPs/params calculators.

Formula parity with the reference complexity stack (complexity.py:329-550
primitives, :14-325 block calculators; stage_complexity.py; model_complexity
.py). Complexities are `{'flops': int, 'params': int}` dicts accumulated via
dict_add; `input_shape` excludes the batch dim with channels last. FLOPs
follow the reference's multiply-count convention (pycls-style MACs).

The reference splits these across three modules dispatched by
`globals()[f'{name}_complexity']`; here one module with an explicit
registry (`STAGE_COMPLEXITY`) serves blocks, stages, and models.
"""
from __future__ import annotations

import copy
from typing import Dict, Optional

import numpy as np

from seld_tpu_torch.utils import dict_add, safe_tuple, force_1d_shape
from seld_tpu_torch.utils import sorted_block_keys

Cx = Dict[str, int]


def _acc(cx: Optional[Cx], flops: int = 0, params: int = 0) -> Cx:
    return dict_add({"flops": flops, "params": params}, cx if cx else {})


# ---------------------------------------------------------------------------
# primitives (complexity.py:329-550)
# ---------------------------------------------------------------------------
def conv1d_complexity(input_shape, filters, kernel_size, strides=1,
                      padding="same", groups=1, use_bias=True, prev_cx=None):
    t, c = input_shape
    not_same = padding != "same"
    t = (t - 1 - not_same * (kernel_size - 1)) // strides + 1
    if t < 1:
        raise ValueError("invalid strides, kernel_size")
    flops = kernel_size * c * filters * t // groups
    params = kernel_size * c * filters // groups + use_bias * filters
    return _acc(prev_cx, flops, params), [t, filters]


def conv2d_complexity(input_shape, filters, kernel_size, strides=(1, 1),
                      padding="same", groups=1, use_bias=True, prev_cx=None):
    if input_shape[-1] < groups or input_shape[-1] % groups:
        raise ValueError("wrong groups")
    if filters < groups or filters % groups:
        raise ValueError("wrong groups")
    kernel_size = safe_tuple(kernel_size, 2)
    strides = safe_tuple(strides, 2)
    not_same = padding != "same"

    h, w, c = input_shape
    h = (h - 1 - not_same * (kernel_size[0] - 1)) // strides[0] + 1
    w = (w - 1 - not_same * (kernel_size[1] - 1)) // strides[1] + 1
    if h < 1 or w < 1:
        raise ValueError("invalid strides, kernel_size")
    kernel = kernel_size[0] * kernel_size[1]
    flops = kernel * c * filters * h * w // groups
    params = kernel * c * filters // groups + use_bias * filters
    return _acc(prev_cx, flops, params), [h, w, filters]


def separable_conv2d_complexity(input_shape, filters, kernel_size,
                                strides=(1, 1), padding="same",
                                depth_multiplier=1, use_bias=True,
                                prev_cx=None):
    chan = input_shape[-1]
    cx, shape = conv2d_complexity(
        input_shape, int(chan * depth_multiplier), kernel_size, strides,
        padding=padding, groups=chan, use_bias=False, prev_cx=prev_cx)
    return conv2d_complexity(shape, filters, 1, use_bias=use_bias, prev_cx=cx)


def norm_complexity(input_shape, center=True, scale=True, prev_cx=None):
    return _acc(prev_cx, 0, input_shape[-1] * (center + scale)), input_shape


def pool2d_complexity(input_shape, pool_size, strides=None, padding="valid",
                      prev_cx=None):
    if strides is None:
        strides = pool_size
    strides = safe_tuple(strides, 2)
    not_same = padding != "same"
    h, w, c = input_shape
    h = (h - 1 - not_same * (strides[0] - 1)) // strides[0] + 1
    w = (w - 1 - not_same * (strides[1] - 1)) // strides[1] + 1
    if h < 1 or w < 1:
        raise ValueError("invalid strides, kernel_size")
    return (prev_cx if prev_cx else {}), input_shape[:-3] + [h, w, c]


def linear_complexity(input_shape, units, use_bias=True, prev_cx=None):
    c = input_shape[-1]
    size = int(np.prod(input_shape[:-1])) if len(input_shape) > 1 else 1
    flops = size * (c + use_bias) * units
    params = (c + use_bias) * units
    return _acc(prev_cx, flops, params), input_shape[:-1] + [units]


def gru_complexity(input_shape, units, use_bias=True, bi=True,
                   merge_mode="mul", prev_cx=None):
    num_steps, input_chan = input_shape[-2:]
    params = 3 * units * (input_chan + units + 2 * use_bias)
    flops = num_steps * (units + input_chan + 2 * use_bias + 1) * units * 3
    if bi:
        params *= 2
        flops *= 2
    output_shape = input_shape[:-1] + [units * (2 if merge_mode == "concat"
                                                else 1)]
    return _acc(prev_cx, flops, params), output_shape


def lstm_complexity(input_shape, units, use_bias=True, bi=True,
                    merge_mode="mul", prev_cx=None):
    num_steps, input_chan = input_shape[-2:]
    params = 4 * units * (input_chan + units + use_bias)
    flops = num_steps * (units + input_chan + 2 * use_bias + 1) * units * 4
    if bi:
        params *= 2
        flops *= 2
    output_shape = input_shape[:-1] + [units * (2 if merge_mode == "concat"
                                                else 1)]
    return _acc(prev_cx, flops, params), output_shape


def multi_head_attention_complexity(input_shape, num_heads, key_dim,
                                    value_dim=None, use_relative=False,
                                    use_bias=True, prev_cx=None):
    c = input_shape[-1]
    size = int(np.prod(input_shape[:-1])) if len(input_shape) > 1 else 1
    if value_dim is None:
        value_dim = key_dim

    params = num_heads * (c + use_bias) * (key_dim * 2 + value_dim)
    if use_relative:
        params += num_heads * key_dim * 2 + num_heads * key_dim * c
    params += num_heads * c * value_dim + c * use_bias

    flops = size * num_heads * (2 * key_dim * (c + use_bias)
                                + value_dim * (c + use_bias))
    if use_relative:
        flops += size * c * num_heads * key_dim
    flops += (size * size * key_dim + size * size * value_dim) * num_heads
    if use_relative:
        flops += size * size * key_dim * num_heads
    flops += size * (value_dim * num_heads + use_bias) * c
    return _acc(prev_cx, flops, params), input_shape


# ---------------------------------------------------------------------------
# block complexities (complexity.py:14-325)
# ---------------------------------------------------------------------------
def mother_block_complexity(model_config, input_shape):
    from seld_tpu_torch.models.modules import _validate_mother_config
    _validate_mother_config(model_config)

    filters0 = model_config["filters0"]
    filters1 = model_config["filters1"]
    filters2 = model_config["filters2"]
    kernel_size0 = model_config["kernel_size0"]
    kernel_size1 = model_config["kernel_size1"]
    kernel_size2 = model_config["kernel_size2"]
    connect0 = model_config["connect0"]
    connect1 = model_config["connect1"]
    connect2 = model_config["connect2"]
    strides = safe_tuple(model_config.get("strides", (1, 1)))
    squeeze_ratio = model_config.get("squeeze_ratio", 0)

    shapes = [list(input_shape)]
    cx: Cx = {}

    # first layer
    if filters0 > 0:
        cx, shape = conv2d_complexity(shapes[-1], filters0, kernel_size0,
                                      padding="same", prev_cx=cx)
        cx, shape = norm_complexity(shape, prev_cx=cx)
        if connect0[0] == 1:
            skip = shapes[-1]
            if skip[-3:] != shape[-3:]:
                cx, skip = conv2d_complexity(skip, filters0, 1, prev_cx=cx)
                cx, skip = norm_complexity(skip, prev_cx=cx)
    else:
        shape = shapes[-1][:]
    shapes.append(shape)

    # second layer
    if filters1 > 0:
        cx, shape = conv2d_complexity(shapes[-1], filters1, kernel_size1,
                                      padding="same", strides=strides,
                                      prev_cx=cx)
        cx, shape = norm_complexity(shape, prev_cx=cx)
        for i in range(2):
            if connect1[i] == 1:
                skip = shapes[i]
                if skip[-3:] != shape[-3:]:
                    cx, skip = conv2d_complexity(skip, filters1, 1,
                                                 strides=strides, prev_cx=cx)
                    cx, skip = norm_complexity(skip, prev_cx=cx)
    else:
        shape = shapes[-1][:-1] + [sum(connect1[i] * shapes[i][-1]
                                       for i in range(2))]
    shapes.append(shape)

    # third layer
    if filters2 > 0:
        cx, shape = conv2d_complexity(shapes[-1], filters2, kernel_size2,
                                      padding="same", prev_cx=cx)
        cx, shape = norm_complexity(shape, prev_cx=cx)
        for i in range(3):
            if connect2[i] == 1:
                skip = shapes[i]
                if skip[-3:] != shape[-3:]:
                    cx, skip = conv2d_complexity(
                        skip, filters2, 1,
                        strides=(1, 1) if i == 2 else strides, prev_cx=cx)
                    cx, skip = norm_complexity(skip, prev_cx=cx)
    else:
        for i in range(len(connect2)):
            if connect2[i] == 1:
                skip = shapes[i]
                if connect2[-1] == 1 and tuple(strides) != (1, 1) and i < 2:
                    cx, skip = conv2d_complexity(
                        skip, skip[-1], 1, strides=strides, prev_cx=cx)
        shape = shapes[-1][:-1] + [sum(connect2[i] * shapes[i][-1]
                                       for i in range(3))]

    if squeeze_ratio > 0:
        se_filters = int(squeeze_ratio * shape[-1])
        se_shape = [*shape[:-3], 1, 1, shape[-1]]
        cx, se_shape = conv2d_complexity(se_shape, se_filters, 1, prev_cx=cx)
        cx, se_shape = conv2d_complexity(se_shape, shape[-1], 1, prev_cx=cx)

    return cx, shape


def bidirectional_GRU_block_complexity(model_config, input_shape):
    shape = force_1d_shape(input_shape)
    cx: Cx = {}
    for units in model_config["units"]:
        cx, shape = gru_complexity(shape, units, bi=True, prev_cx=cx)
    return cx, shape


def RNN_block_complexity(model_config, input_shape):
    units = model_config["units"]
    bidirectional = model_config.get("bidirectional", True)
    merge_mode = model_config.get("merge_mode", "mul")
    rnn_type = model_config.get("rnn_type", "GRU")
    shape = force_1d_shape(input_shape)
    fn = gru_complexity if rnn_type == "GRU" else lstm_complexity
    return fn(shape, units, bi=bidirectional, merge_mode=merge_mode)


def transformer_encoder_block_complexity(model_config, input_shape):
    n_head = model_config["n_head"]
    key_dim = model_config["key_dim"]
    ff_multiplier = model_config["ff_multiplier"]
    kernel_size = model_config["kernel_size"]

    shape = force_1d_shape(input_shape)
    d_model = shape[-1]
    if d_model < n_head or d_model % n_head:
        raise ValueError("invalid n_head")
    ff_dim = int(ff_multiplier * d_model)
    if ff_dim < 1:
        raise ValueError("invalid ff_multiplier")

    cx, shape = multi_head_attention_complexity(shape, n_head, key_dim,
                                                prev_cx={})
    cx, shape = norm_complexity(shape, prev_cx=cx)
    cx, shape = conv1d_complexity(shape, ff_dim, kernel_size, prev_cx=cx)
    cx, shape = conv1d_complexity(shape, d_model, kernel_size, prev_cx=cx)
    cx, shape = norm_complexity(shape, prev_cx=cx)
    return cx, shape


def simple_dense_block_complexity(model_config, input_shape):
    kernel_size = model_config.get("kernel_size", 1)
    shape = force_1d_shape(input_shape)
    cx: Cx = {}
    for units in model_config["units"]:
        if len(shape) == 1:
            cx, shape = linear_complexity(shape, units, prev_cx=cx)
        else:
            cx, shape = conv1d_complexity(shape, units, kernel_size,
                                          prev_cx=cx)
    return cx, shape


def identity_block_complexity(model_config, input_shape):
    return {"flops": 0, "params": 0}, input_shape


def conformer_encoder_block_complexity(model_config, input_shape):
    time, emb = input_shape
    multiplier = model_config.get("multiplier", 4)
    key_dim = model_config.get("key_dim", 36)
    n_head = model_config.get("n_head", 4)
    kernel_size = model_config.get("kernel_size", 32)
    pos_mode = model_config.get("pos_mode", "absolute")
    use_bias = model_config.get("use_bias", True)

    if emb < n_head or emb % n_head:
        raise ValueError("invalid n_head")
    if emb % 2:
        raise ValueError("Input Shape should be even")

    cx, shape = norm_complexity(input_shape, prev_cx=None)
    cx, shape = linear_complexity(shape, emb * multiplier, True, cx)
    cx, shape = linear_complexity(shape, emb, True, cx)

    cx, shape = norm_complexity(shape, prev_cx=cx)
    cx, shape = multi_head_attention_complexity(
        shape, n_head, key_dim, key_dim, use_bias=use_bias,
        use_relative=pos_mode == "relative", prev_cx=cx)

    cx, shape = norm_complexity(shape, prev_cx=cx)
    cx, shape = conv1d_complexity(shape, 2 * emb, 1, prev_cx=cx)
    shape[-1] = shape[-1] // 2
    cx, shape = conv1d_complexity(shape, emb, kernel_size, groups=emb,
                                  prev_cx=cx)
    cx, shape = norm_complexity(shape, prev_cx=cx)
    cx, shape = conv1d_complexity(shape, emb, 1, prev_cx=cx)

    cx, shape = norm_complexity(shape, prev_cx=cx)
    cx, shape = linear_complexity(shape, emb * multiplier, True, cx)
    cx, shape = linear_complexity(shape, emb, True, cx)
    cx, shape = norm_complexity(shape, prev_cx=cx)
    return cx, shape


def attention_block_complexity(model_config, input_shape):
    key_dim = model_config["key_dim"]
    n_head = model_config["n_head"]
    kernel_size = model_config["kernel_size"]
    ff_kernel_size = model_config["ff_kernel_size"]
    ff_multiplier = model_config["ff_multiplier"]
    ff_factor0 = model_config["ff_factor0"]
    ff_factor1 = model_config["ff_factor1"]

    pos_encoding = model_config.get("pos_encoding", "basic")
    abs_pos_encoding = model_config.get("abs_pos_encoding", False)
    layer_norm_in_front = model_config.get("layer_norm_in_front", False)
    use_glu = model_config.get("use_glu", False)
    use_bias = model_config.get("use_bias", False)

    cx: Cx = {}
    time, d_model = shape = force_1d_shape(input_shape)
    ff_dim = int(ff_multiplier * d_model)

    if d_model < n_head or d_model % n_head:
        raise ValueError("invalid n_head")
    if ff_multiplier > 0 and ff_dim < 1:
        raise ValueError("invalid ff_multiplier")
    if d_model % 2:
        raise ValueError("Input Shape should be even")
    if ff_factor0 < 0 or ff_factor1 < 0:
        raise ValueError("ff_factor0, ff_factor1 >= 0 must hold")
    if ff_factor0 == 0 and ff_factor1 == 0:
        if ff_kernel_size != 0:
            raise ValueError("if FF modules are not used, "
                             "ff_kernel must be set to 0")
        if ff_multiplier != 0:
            raise ValueError("if FF modules are not used, "
                             "ff_multiplier must be set to 0")
    if not abs_pos_encoding and pos_encoding is None:
        raise ValueError("relative pos encoding demands any types of encoding "
                         "except the null one")

    if ff_factor0 > 0:
        cx, shape = norm_complexity(shape, prev_cx=cx)
        cx, shape = conv1d_complexity(shape, ff_dim, ff_kernel_size,
                                      prev_cx=cx)
        cx, shape = conv1d_complexity(shape, d_model, ff_kernel_size,
                                      prev_cx=cx)

    cx, shape = norm_complexity(shape, prev_cx=cx)
    cx, shape = multi_head_attention_complexity(
        shape, n_head, key_dim, use_relative=not abs_pos_encoding,
        use_bias=use_bias, prev_cx=cx)

    if use_glu:
        if layer_norm_in_front:
            cx, shape = norm_complexity(shape, prev_cx=cx)
        cx, shape = conv1d_complexity(shape, 2 * d_model, 1, prev_cx=cx)
        shape[-1] = shape[-1] // 2

    if kernel_size > 0:
        if not use_glu or not layer_norm_in_front:
            cx, shape = norm_complexity(shape, prev_cx=cx)
        cx, shape = conv1d_complexity(shape, d_model, kernel_size,
                                      groups=d_model, prev_cx=cx)
        cx, shape = norm_complexity(shape, prev_cx=cx)
        cx, shape = conv1d_complexity(shape, d_model, 1, prev_cx=cx)

    if ff_factor1 > 0:
        cx, shape = norm_complexity(shape, prev_cx=cx)
        cx, shape = conv1d_complexity(shape, ff_dim, ff_kernel_size,
                                      prev_cx=cx)
        cx, shape = conv1d_complexity(shape, d_model, ff_kernel_size,
                                      prev_cx=cx)

    return cx, shape


# ---------------------------------------------------------------------------
# stage complexities (stage_complexity.py)
# ---------------------------------------------------------------------------
def mother_stage_complexity(model_config, input_shape):
    depth = model_config["depth"]
    model_config = copy.deepcopy(model_config)
    shape = input_shape
    total_cx: Cx = {}
    for _ in range(depth):
        cx, shape = mother_block_complexity(model_config, shape)
        total_cx = dict_add(total_cx, cx)
        model_config["strides"] = 1
    return total_cx, shape


def bidirectional_GRU_stage_complexity(model_config, input_shape):
    cfg = copy.deepcopy(model_config)
    cfg["units"] = [model_config["units"]] * model_config["depth"]
    return bidirectional_GRU_block_complexity(cfg, input_shape)


def RNN_stage_complexity(model_config, input_shape):
    shape = input_shape
    total_cx: Cx = {}
    for _ in range(model_config["depth"]):
        cx, shape = RNN_block_complexity(model_config, shape)
        total_cx = dict_add(total_cx, cx)
    return total_cx, shape


def simple_dense_stage_complexity(model_config, input_shape):
    cfg = copy.deepcopy(model_config)
    cfg["units"] = [model_config["units"]] * model_config["depth"]
    return simple_dense_block_complexity(cfg, input_shape)


def _repeated_1d_stage(block_fn, model_config, input_shape):
    shape = force_1d_shape(input_shape)
    total_cx: Cx = {}
    for _ in range(model_config["depth"]):
        cx, shape = block_fn(model_config, shape)
        total_cx = dict_add(total_cx, cx)
    return total_cx, shape


def transformer_encoder_stage_complexity(model_config, input_shape):
    return _repeated_1d_stage(transformer_encoder_block_complexity,
                              model_config, input_shape)


def conformer_encoder_stage_complexity(model_config, input_shape):
    return _repeated_1d_stage(conformer_encoder_block_complexity,
                              model_config, input_shape)


def attention_stage_complexity(model_config, input_shape):
    return _repeated_1d_stage(attention_block_complexity,
                              model_config, input_shape)


def tcn_stage_complexity(model_config, input_shape):
    """Dilated TCN stage (beyond-parity block, see models/modules.py)."""
    filters = model_config["filters"]
    depth = model_config.get("depth", 3)
    kernel_size = model_config.get("kernel_size", 3)

    shape = force_1d_shape(input_shape)
    cx: Cx = {}
    if shape[-1] != filters:
        cx, shape = conv1d_complexity(shape, filters, 1, prev_cx=cx)
    for _ in range(depth):
        cx, gshape = conv1d_complexity(shape, 2 * filters, kernel_size,
                                       prev_cx=cx)
        cx, gshape = norm_complexity(gshape, prev_cx=cx)
        gshape = gshape[:-1] + [filters]  # gated: 2F -> F
        cx, _ = conv1d_complexity(gshape, filters, 1, prev_cx=cx)  # residual
        cx, _ = conv1d_complexity(gshape, filters, 1, prev_cx=cx)  # skip
    return cx, shape


STAGE_COMPLEXITY = {
    "tcn_stage": tcn_stage_complexity,
    "mother_block": mother_block_complexity,
    "mother_stage": mother_stage_complexity,
    "bidirectional_GRU_block": bidirectional_GRU_block_complexity,
    "bidirectional_GRU_stage": bidirectional_GRU_stage_complexity,
    "RNN_block": RNN_block_complexity,
    "RNN_stage": RNN_stage_complexity,
    "simple_dense_block": simple_dense_block_complexity,
    "simple_dense_stage": simple_dense_stage_complexity,
    "transformer_encoder_block": transformer_encoder_block_complexity,
    "transformer_encoder_stage": transformer_encoder_stage_complexity,
    "conformer_encoder_block": conformer_encoder_block_complexity,
    "conformer_encoder_stage": conformer_encoder_stage_complexity,
    "attention_block": attention_block_complexity,
    "attention_stage": attention_stage_complexity,
    "identity_block": identity_block_complexity,
}


def get_stage_complexity(name: str):
    if name not in STAGE_COMPLEXITY:
        raise KeyError(f"no complexity model for block {name!r}")
    return STAGE_COMPLEXITY[name]


# ---------------------------------------------------------------------------
# model complexities (model_complexity.py)
# ---------------------------------------------------------------------------
def conv_temporal_complexity(model_config, input_shape):
    filters = model_config.get("filters", 32)
    first_kernel_size = model_config.get("first_kernel_size", 7)
    first_pool_size = model_config.get("first_pool_size", [5, 1])
    n_classes = model_config.get("n_classes", 14)

    shape = list(input_shape[-3:])
    total_cx, shape = conv2d_complexity(shape, filters, first_kernel_size,
                                        padding="same", prev_cx={})
    total_cx, shape = norm_complexity(shape, prev_cx=total_cx)
    total_cx, shape = pool2d_complexity(shape, first_pool_size, padding="same",
                                        prev_cx=total_cx)

    blocks = sorted_block_keys(model_config)
    for block in blocks:
        cx, shape = get_stage_complexity(model_config[block])(
            model_config[f"{block}_ARGS"], shape)
        total_cx = dict_add(total_cx, cx)

    cx, sed_shape = get_stage_complexity(model_config["SED"])(
        model_config["SED_ARGS"], shape)
    cx, sed_shape = linear_complexity(sed_shape, n_classes, prev_cx=cx)
    total_cx = dict_add(total_cx, cx)

    cx, doa_shape = get_stage_complexity(model_config["DOA"])(
        model_config["DOA_ARGS"], shape)
    cx, doa_shape = linear_complexity(doa_shape, 3 * n_classes, prev_cx=cx)
    total_cx = dict_add(total_cx, cx)

    return total_cx, (sed_shape, doa_shape)


def accdoa_complexity(model_config, input_shape):
    """Whole-model complexity for the ACCDOA builder (models.py ACCDOA)."""
    filters = model_config.get("filters", 32)
    first_kernel_size = model_config.get("first_kernel_size", 7)
    first_pool_size = model_config.get("first_pool_size", [5, 1])
    n_classes = model_config.get("n_classes", 14)

    shape = list(input_shape[-3:])
    total_cx, shape = conv2d_complexity(shape, filters, first_kernel_size,
                                        padding="same", prev_cx={})
    total_cx, shape = norm_complexity(shape, prev_cx=total_cx)
    total_cx, shape = pool2d_complexity(shape, first_pool_size, padding="same",
                                        prev_cx=total_cx)
    blocks = sorted_block_keys(model_config)
    for block in blocks:
        cx, shape = get_stage_complexity(model_config[block])(
            model_config[f"{block}_ARGS"], shape)
        total_cx = dict_add(total_cx, cx)
    shape = force_1d_shape(shape)
    total_cx, shape = linear_complexity(shape, 3 * n_classes, prev_cx=total_cx)
    return total_cx, shape


def vad_architecture_complexity(model_config, input_shape):
    flatten = model_config.get("flatten", True)
    last_unit = model_config.get("last_unit", 1)

    shape = [int(np.prod(input_shape))] if flatten else list(input_shape)
    total_cx: Cx = {}

    blocks = sorted_block_keys(model_config)
    for block in blocks:
        cx, shape = get_stage_complexity(model_config[block])(
            model_config[f"{block}_ARGS"], shape)
        total_cx = dict_add(total_cx, cx)

    shape = force_1d_shape(shape)
    total_cx, shape = linear_complexity(shape, last_unit, prev_cx=total_cx)
    return total_cx, shape
