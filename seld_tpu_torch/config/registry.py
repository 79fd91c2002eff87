"""Name -> factory registries for blocks and models.

A copy of seld_tpu/config/registry.py that registers the port's factories.
Block factories take a config dict, validate it eagerly (so NAS rejection
sampling sees the reference's ValueErrors) and return a function
`build(in_shape, generator=None) -> nn.Module`; model factories take
`(input_shape, model_config)` and return an nn.Module.

Registration happens at import time of seld_tpu_torch.models.modules / .models.
"""
from __future__ import annotations

from typing import Callable, Dict

BLOCKS: Dict[str, Callable] = {}
MODELS: Dict[str, Callable] = {}


def register_block(name: str):
    def wrap(fn: Callable) -> Callable:
        if name in BLOCKS:
            raise ValueError(f"duplicate block registration: {name}")
        BLOCKS[name] = fn
        return fn
    return wrap


def register_model(name: str):
    def wrap(fn: Callable) -> Callable:
        if name in MODELS:
            raise ValueError(f"duplicate model registration: {name}")
        MODELS[name] = fn
        return fn
    return wrap


def get_block(name: str) -> Callable:
    # ensure block factories are registered
    import seld_tpu_torch.models.modules  # noqa: F401
    if name not in BLOCKS:
        raise KeyError(f"unknown block type: {name!r}; known: {sorted(BLOCKS)}")
    return BLOCKS[name]


def get_model(name: str) -> Callable:
    import seld_tpu_torch.models.models  # noqa: F401
    if name not in MODELS:
        raise KeyError(f"unknown model: {name!r}; known: {sorted(MODELS)}")
    return MODELS[name]
