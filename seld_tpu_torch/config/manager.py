"""Versioned run-config store: a copy of seld_tpu/config/manager.py,
pinned equal to it by tests/test_torch_imports.py.

  - each run's full flag set is persisted as `config/<name>_v_N.json`
  - identical configs (all keys except the ephemeral ones) dedupe to the
    existing version
  - `mode` contains 'l' (load existing, CLI flags overwrite) and/or 'o'
    (use only the loaded config)
  - the 'gpus' key is stripped before persisting; nothing touches CUDA
    environment variables
"""
from __future__ import annotations

import argparse
import json
import os
from glob import glob
from typing import Union


def save_config(path: str, name: str, config: dict) -> None:
    os.makedirs(path, exist_ok=True)
    if not name.endswith(".json"):
        name += ".json"
    with open(os.path.join(path, name), "w") as f:
        json.dump(config, f, sort_keys=True, indent=4)


def load_config(path: str, name: str) -> dict:
    if not name.endswith(".json"):
        name += ".json"
    jsonpath = os.path.join(path, name)
    if not os.path.exists(jsonpath):
        raise ValueError(f"config does not exist: {jsonpath}")
    with open(jsonpath, "r") as f:
        return json.load(f)


def _base_name(name: str) -> str:
    """Strip extension and trailing `_v_N` version suffix."""
    stem = os.path.splitext(os.path.basename(name))[0]
    return stem.split("_v_")[0]


def _next_version_name(path: str, name: str) -> str:
    base = _base_name(name)
    existing = glob(os.path.join(path, base + "_v_*.json"))
    versions = []
    for f in existing:
        # numeric max, NOT lexicographic sort: sorted() puts _v_9 after
        # _v_10, which would stick the store at version 10 and silently
        # overwrite it for every later distinct config
        tail = os.path.splitext(os.path.basename(f))[0].split("_v_")[-1]
        if tail.isdigit():
            versions.append(int(tail))
    if not versions:
        return base + "_v_0"
    return f"{base}_v_{max(versions) + 1}"


# keys that do not define a run's identity: 'name' embeds the version, and
# 'resume' is ephemeral — the reference compares it too, which silently bumps
# the version on `--resume` and then cannot find the checkpoint to resume
# (train.py:322-331 globs the NEW version's empty dir). Quality fix.
_EPHEMERAL_KEYS = ("name", "resume", "epoch")  # epoch = stop criterion


def _find_duplicate(path: str, name: str, new_config: dict) -> Union[str, bool]:
    base = _base_name(name)
    for candidate in sorted(glob(os.path.join(path, base + "_v_*.json"))):
        existing = load_config(os.path.dirname(candidate), os.path.basename(candidate))
        existing.pop("gpus", None)
        if set(existing) != set(new_config):
            continue
        if all(existing[k] == new_config[k] for k in new_config
               if k not in _EPHEMERAL_KEYS):
            return os.path.splitext(os.path.basename(candidate))[0]
    return False


def get_config(name: str,
               config: Union[argparse.Namespace, dict],
               path: str = "./config",
               mode: str = "") -> argparse.Namespace:
    """Persist / load / dedupe a run config.

    mode '' : save flags as a new (or deduped) `<name>_v_N.json`
    mode 'l': load `<name>.json`, overwrite with current flags, dedupe/save
    mode 'lo' (or 'ol'): load `<name>.json` and ignore current flags
    """
    assert len(name) > 0, "name must be typed"
    for m in mode:
        assert m in ("l", "o"), "mode must be l, o, lo, or ol"
    if mode == "o":
        raise ValueError("cannot use only saved config ('o') without loading ('l')")

    os.makedirs(path, exist_ok=True)

    config = dict(vars(config)) if isinstance(config, argparse.Namespace) else dict(config)
    config.pop("config_mode", None)
    config.pop("gpus", None)

    name = os.path.splitext(name)[0]

    if "l" in mode:
        loaded = load_config(path, name)
        loaded.pop("gpus", None)
        if "o" in mode:
            final = loaded
            final["name"] = name
            return argparse.Namespace(**final)
        final = {**loaded, **config}
    else:
        final = config
        versioned = name + "_v_0"
        final["name"] = versioned
        if not os.path.exists(os.path.join(path, versioned + ".json")):
            save_config(path, versioned, final)
            return argparse.Namespace(**final)

    dup = _find_duplicate(path, name, final)
    if dup:
        final["name"] = dup
        return argparse.Namespace(**final)

    versioned = _next_version_name(path, name)
    final["name"] = versioned
    save_config(path, versioned, final)
    return argparse.Namespace(**final)
