"""Built-in model-architecture configs.

The reference ships these as `model_config/*.json` (consumed via
params.py:56-66). We keep the identical schema — plain dicts whose keys name
registered block factories plus their `*_ARGS` — so any of the reference's
JSON files loads unchanged. `get_model_config` prefers an on-disk JSON (same
lookup rule as the reference) and falls back to this programmatic zoo.

Configs covered (reference model_config/ directory):
  seldnet, seldnet_v1       : CRNN (3x conv64 + pools + 2x biGRU128 + dense heads)
  SS5                       : the NAS-winning challenge model (conv_temporal body)
  conv_temp, Condseldnet,
  dense_gru, resnet_gru,
  resnet50_gru, xception_gru: legacy families (res/dense/xception block stages)
"""
from __future__ import annotations

import copy
import json
import os
from typing import Optional, Sequence


def _crnn_heads(n_classes: int = 14) -> dict:
    return {
        "SED": "simple_dense_block",
        "SED_ARGS": {
            "units": [128],
            "n_classes": n_classes,
            "activation": "sigmoid",
            "name": "sed_out",
        },
        "DOA": "simple_dense_block",
        "DOA_ARGS": {
            "units": [128],
            "n_classes": 3 * n_classes,
            "activation": "tanh",
            "name": "doa_out",
        },
    }


def _bigru_block(units: Sequence[int] = (128, 128)) -> dict:
    return {"units": list(units), "dropout_rate": 0.0}


_SELDNET = {
    "FIRST": "simple_conv_block",
    "FIRST_ARGS": {
        "filters": [64, 64, 64],
        "pool_size": [[5, 4], [1, 4], [1, 2]],
        "dropout_rate": 0.0,
    },
    "SECOND": "bidirectional_GRU_block",
    "SECOND_ARGS": _bigru_block(),
    **_crnn_heads(),
}

_SS5 = {
    "n_classes": 12,
    "first_pool_size": [5, 2],
    "BLOCK0": "mother_stage",
    "BLOCK0_ARGS": {
        "depth": 2,
        "filters0": 0,
        "filters1": 96,
        "filters2": 0,
        "kernel_size0": 0,
        "kernel_size1": 3,
        "kernel_size2": 0,
        "connect0": [1],
        "connect1": [1, 0],
        "connect2": [1, 0, 1],
        "strides": [1, 3],
    },
    "BLOCK1": "simple_dense_stage",
    "BLOCK1_ARGS": {
        "depth": 1,
        "units": 192,
        "dense_activation": "relu",
        "dropout_rate": 0.0,
    },
    "BLOCK2": "conformer_encoder_stage",
    "BLOCK2_ARGS": {
        "depth": 2,
        "key_dim": 24,
        "n_head": 4,
        "kernel_size": 24,
        "multiplier": 2,
        "pos_encoding": None,
    },
    "SED": "conformer_encoder_stage",
    "SED_ARGS": {
        "depth": 1,
        "key_dim": 48,
        "n_head": 4,
        "kernel_size": 8,
        "multiplier": 2,
        "pos_encoding": None,
    },
    "DOA": "bidirectional_GRU_stage",
    "DOA_ARGS": {"depth": 2, "units": 128},
}

_RESNET_GRU = {
    "filters": 32,
    **{
        f"BLOCK{i}": "res_bottleneck_stage" for i in range(4)
    },
    "BLOCK0_ARGS": {"filters": 32, "depth": 3, "strides": [1, 2]},
    "BLOCK1_ARGS": {"filters": 64, "depth": 4, "strides": [1, 2]},
    "BLOCK2_ARGS": {"filters": 128, "depth": 6, "strides": [1, 2]},
    "BLOCK3_ARGS": {"filters": 256, "depth": 3, "strides": [1, 2]},
    "BLOCK4": "bidirectional_GRU_block",
    "BLOCK4_ARGS": _bigru_block(),
    **_crnn_heads(),
}

_DENSE_GRU = {
    "FIRST": "dense_net_block",
    "FIRST_ARGS": {
        "filters": 64,
        "block_num": [6, 12, 24, 16],
        "kernel_regularizer": {"l1": 0, "l2": 1e-3},
    },
    "SECOND": "bidirectional_GRU_block",
    "SECOND_ARGS": _bigru_block(),
    **_crnn_heads(),
}

_RESNET50_GRU = {
    "FIRST": "resnet50_block",
    "FIRST_ARGS": {
        "filters": 32,
        "block_num": [3, 4, 6, 3],
        "kernel_regularizer": {"l1": 0, "l2": 1e-3},
    },
    "SECOND": "bidirectional_GRU_block",
    "SECOND_ARGS": _bigru_block(),
    **_crnn_heads(),
}

_XCEPTION_GRU = {
    "FIRST": "xception_block",
    "FIRST_ARGS": {
        "filters": 32,
        "block_num": 8,
        "kernel_regularizer": {"l1": 0, "l2": 1e-3},
    },
    "SECOND": "bidirectional_GRU_block",
    "SECOND_ARGS": _bigru_block(),
    **_crnn_heads(),
}

_CONDSELDNET = {
    "FIRST": "cond_conv_block",
    "FIRST_ARGS": {
        "filters": [64, 64, 64],
        "pool_size": [[5, 4], [1, 4], [1, 2]],
        "dropout_rate": 0.0,
        "kernel_regularizer": {"l1": 0.0, "l2": 2e-4},
    },
    "SECOND": "bidirectional_GRU_block",
    "SECOND_ARGS": _bigru_block(),
    **_crnn_heads(),
}

_CONV_TEMP = {
    "BLOCK0": "res_bottleneck_stage",
    "BLOCK0_ARGS": {"filters": 32, "depth": 3, "strides": [1, 2]},
    "BLOCK1": "another_conv_block",
    "BLOCK1_ARGS": {"filters": 256, "depth": 2, "pool_size": [1, 4]},
    "BLOCK2": "dense_net_block",
    "BLOCK2_ARGS": {
        "growth_rate": 16,
        "depth": 6,
        "strides": [1, 2],
        "bottleneck_ratio": 2,
        "reduction_ratio": 0.5,
    },
    "BLOCK3": "res_basic_stage",
    "BLOCK3_ARGS": {"filters": 256, "depth": 3, "strides": [1, 2]},
    "BLOCK4": "bidirectional_GRU_block",
    "BLOCK4_ARGS": _bigru_block(),
    **_crnn_heads(),
}

MODEL_CONFIGS = {
    "seldnet": _SELDNET,
    "seldnet_v1": _SELDNET,
    "SS5": _SS5,
    "resnet_gru": _RESNET_GRU,
    "dense_gru": _DENSE_GRU,
    "resnet50_gru": _RESNET50_GRU,
    "xception_gru": _XCEPTION_GRU,
    "Condseldnet": _CONDSELDNET,
    "conv_temp": _CONV_TEMP,
}


def get_model_config(name: str, search_paths: Optional[Sequence[str]] = None) -> dict:
    """Resolve a model config by name.

    Lookup order: `<path>/<name>.json` for each search path (defaulting to
    `./model_config`, matching params.py:60-63), then the built-in zoo.
    Returns a deep copy — callers may mutate freely.
    """
    name = os.path.splitext(name)[0]
    if search_paths is None:
        search_paths = ["./model_config"]
    for path in search_paths:
        candidate = os.path.join(path, name + ".json")
        if os.path.exists(candidate):
            with open(candidate, "r") as f:
                return json.load(f)
    if name in MODEL_CONFIGS:
        return copy.deepcopy(MODEL_CONFIGS[name])
    raise ValueError(f"Model config does not exist: {name!r}")


def resolve_model_config(name_or_path: str) -> dict:
    """Resolve a CLI `--model_config` value: an explicit .json FILE path
    wins, anything else goes through `get_model_config` (./model_config
    then the built-in zoo). `os.path.isfile` — not exists — so a zoo name
    that collides with a local directory still resolves."""
    if os.path.isfile(name_or_path):
        with open(name_or_path, "r") as f:
            return json.load(f)
    return get_model_config(name_or_path)


def dump_model_configs(out_dir: str) -> None:
    """Materialize the built-in zoo as a model_config/ directory of JSONs."""
    os.makedirs(out_dir, exist_ok=True)
    for name, cfg in MODEL_CONFIGS.items():
        with open(os.path.join(out_dir, name + ".json"), "w") as f:
            json.dump(cfg, f, indent=4, sort_keys=False)
