"""Helpers shared by the port's modules (copies from seld_tpu/utils/common.py)."""
from __future__ import annotations

import copy
import math
from typing import Sequence, Tuple, Union

import numpy as np


def dict_add(first: dict, second: dict) -> dict:
    """Key-wise sum of two dicts (missing keys treated as absent, not zero)."""
    output = copy.deepcopy(first)
    for key, val in second.items():
        if key in output:
            output[key] += val
        else:
            output[key] = val
    return output


def safe_tuple(tuple_or_scalar: Union[int, float, Sequence], length: int = 2) -> Tuple:
    """Broadcast a scalar or length-1 sequence to a tuple of `length`."""
    if isinstance(tuple_or_scalar, (int, float)):
        tuple_or_scalar = (tuple_or_scalar,) * length

    tuple_or_scalar = tuple(tuple_or_scalar)
    count = len(tuple_or_scalar)
    if count == 1:
        tuple_or_scalar = tuple_or_scalar * length
    elif count != length:
        raise ValueError("length of input must be one or required length")
    return tuple_or_scalar


def force_1d_shape(shape: Sequence[int]) -> list:
    """[T, F, C] -> [T, F*C]; passthrough for already-1D feature shapes."""
    shape = list(shape)
    if len(shape) == 3:
        shape = [shape[0], shape[1] * shape[2]]
    elif len(shape) > 3:
        raise ValueError(f"invalid shape: {shape}")
    return shape


def sorted_block_keys(cfg) -> list:
    """BLOCK0..BLOCKn keys in NUMERIC order — lexicographic sorted() puts
    BLOCK10 before BLOCK2, which fed 1D stages into 2D complexity folds
    and misordered model bodies for n_blocks >= 11."""
    keys = [k for k in cfg
            if k.startswith("BLOCK") and not k.endswith("ARGS")]
    return sorted(keys, key=lambda k: (len(k), k))


def degree_to_radian(degree):
    if isinstance(degree, (np.ndarray, np.generic, int, float)):
        return degree * np.pi / 180
    return degree * math.pi / 180


def radian_to_degree(radian):
    if isinstance(radian, (np.ndarray, np.generic, int, float)):
        return radian * 180 / np.pi
    return radian * 180 / math.pi
