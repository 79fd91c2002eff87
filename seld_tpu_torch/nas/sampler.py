"""Random config sampling for NAS (config_sampler.py parity).

Uniform sampling from value-list search spaces with rejection against a
complexity constraint. Search spaces are dicts:
  {block_name: {arg: [candidate values]}}
Body blocks choose 2D modules first, then 1D (once 1D, stays 1D);
SED/DOA heads are 1D-only (config_sampler.py:23-89).
"""
from __future__ import annotations

import copy
import random
from collections import OrderedDict
from typing import Callable, Optional

from seld_tpu_torch.utils import dict_add
from seld_tpu_torch.utils import sorted_block_keys
from seld_tpu_torch.nas.complexity import (
    STAGE_COMPLEXITY, get_stage_complexity, linear_complexity)


def search_space_sanity_check(search_space: dict) -> None:
    for name in search_space:
        for v in search_space[name].values():
            if not isinstance(v, (list, tuple)):
                raise ValueError(f"values of {name} must be tuple or list")
            if len(v) == 0:
                raise ValueError(f"len of value in {name} must be > 0")


def config_sampling(search_space: OrderedDict) -> OrderedDict:
    """Recursive sampler for {BLOCK: [types], BLOCK_ARGS: {type: space}}
    style spaces (config_sampler.py:8-20)."""
    sample = copy.deepcopy(search_space)
    for key in sample.keys():
        if not key.endswith("_ARGS"):
            sample[key] = random.sample(list(sample[key]), 1)[0]
        else:
            block_type = key.replace("_ARGS", "")
            sample[key] = config_sampling(sample[key][sample[block_type]])
    return sample


def _body_and_heads_sampler(with_heads: bool):
    def sampler(search_space_2d: dict, search_space_1d: dict, n_blocks: int,
                input_shape, default_config: Optional[dict] = None,
                config_postprocess_fn: Optional[Callable] = None,
                constraint: Optional[Callable] = None,
                max_iters: Optional[int] = None) -> dict:
        search_space_sanity_check(search_space_2d)
        search_space_sanity_check(search_space_1d)

        total = copy.deepcopy(search_space_2d)
        total.update(search_space_1d)
        modules_2d = list(search_space_2d.keys())
        modules_1d = list(search_space_1d.keys())
        default_config = default_config or {}

        count = 0
        n_2d = n_blocks
        while True:
            if count % 10000 == 0:
                n_2d = (n_blocks if len(modules_1d) == 0
                        else random.randint(0, n_blocks))
            count += 1
            if max_iters is not None and count > max_iters:
                raise RuntimeError(
                    f"no config satisfying constraint in {max_iters} draws")

            model_config = copy.deepcopy(default_config)
            for i in range(n_blocks):
                pool = modules_2d if i < n_2d else modules_1d
                module = random.sample(pool, 1)[0]
                model_config[f"BLOCK{i}"] = module
                model_config[f"BLOCK{i}_ARGS"] = {
                    k: random.sample(list(v), 1)[0]
                    for k, v in total[module].items()}

            if with_heads:
                for head in ("SED", "DOA"):
                    module = random.sample(modules_1d, 1)[0]
                    model_config[head] = module
                    model_config[f"{head}_ARGS"] = {
                        k: random.sample(list(v), 1)[0]
                        for k, v in total[module].items()}

            if config_postprocess_fn is not None:
                model_config = config_postprocess_fn(model_config)
            if constraint is None or constraint(model_config, input_shape):
                return model_config

    return sampler


conv_temporal_sampler = _body_and_heads_sampler(with_heads=True)
vad_architecture_sampler = _body_and_heads_sampler(with_heads=False)


def complexity(model_config: OrderedDict, input_shape,
               mapping_dict: Optional[dict] = None) -> dict:
    """Fold complexity over a {BLOCK: type, BLOCK_ARGS: args, ...} config
    (config_sampler.py:150-166)."""
    mapping_dict = mapping_dict or STAGE_COMPLEXITY
    block = None
    total = {}
    for key in model_config.keys():
        if block is None:
            block = model_config[key]
        else:
            cx, input_shape = mapping_dict[block](model_config[key],
                                                  input_shape)
            total = dict_add(total, cx)
            block = None
    return total


def sample_constraint(min_flops=None, max_flops=None,
                      min_params=None, max_params=None,
                      n_classes: int = 12):
    """FLOPs/params window + degenerate-mother-stage rejection
    (nas_seldnet.py:80-137)."""
    def _constraint(model_config, input_shape) -> bool:
        shape = list(input_shape)
        total_cx = {}
        blocks = sorted_block_keys(model_config)
        try:
            for block in blocks:
                cx, shape = get_stage_complexity(model_config[block])(
                    model_config[f"{block}_ARGS"], shape)
                total_cx = dict_add(total_cx, cx)

                if model_config[block] == "mother_stage":
                    args = model_config[f"{block}_ARGS"]
                    n_convs = ((args["filters0"] > 0)
                               + (args["filters1"] > 0)
                               + (args["filters2"] > 0))
                    if n_convs == 1 and args["filters1"] == 0:
                        return False
                    if (n_convs == 2 and args["filters1"] > 0
                            and list(args["strides"]) == [1, 1]):
                        return False

            nc = model_config.get("n_classes", n_classes)
            if "SED" in model_config:
                cx, sed_shape = get_stage_complexity(model_config["SED"])(
                    model_config["SED_ARGS"], shape)
                cx, sed_shape = linear_complexity(sed_shape, nc, prev_cx=cx)
                total_cx = dict_add(total_cx, cx)
                cx, doa_shape = get_stage_complexity(model_config["DOA"])(
                    model_config["DOA_ARGS"], shape)
                cx, doa_shape = linear_complexity(doa_shape, 3 * nc,
                                                  prev_cx=cx)
                total_cx = dict_add(total_cx, cx)
        except (ValueError, KeyError):
            return False

        if min_flops and total_cx["flops"] < min_flops:
            return False
        if max_flops and total_cx["flops"] > max_flops:
            return False
        if min_params and total_cx["params"] < min_params:
            return False
        if max_params and total_cx["params"] > max_params:
            return False
        return True

    return _constraint


def mother_stage_postprocess(model_config: dict) -> dict:
    """Canonicalize sampled mother-stage configs (nas_seldnet.py:140-166):
    zero out arguments of skipped convs and force connections consistent."""
    model_config = copy.deepcopy(model_config)
    blocks = sorted_block_keys(model_config)
    for block in blocks:
        if model_config[block] != "mother_stage":
            continue
        args = model_config[f"{block}_ARGS"]
        if args["filters2"] == 0:
            if args["filters1"] != 0:
                args["connect2"] = list(args["connect2"])
                args["connect2"][2] = 1
            elif args["filters0"] != 0:
                args["connect2"] = list(args["connect2"])
                args["connect2"][1] = 1
        if args["filters0"] == 0:
            args["kernel_size0"] = 0
            args["connect1"] = list(args["connect1"])
            args["connect1"][1] = 0
            args["connect2"] = list(args["connect2"])
            args["connect2"][1] = 0
        if args["filters1"] == 0:
            args["kernel_size1"] = 0
            args["connect2"] = list(args["connect2"])
            args["connect2"][2] = 0
            args["strides"] = [1, 1]
        if args["filters2"] == 0:
            args["kernel_size2"] = 0
    return model_config
