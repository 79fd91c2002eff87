"""What every driver shares: finding a workload's files by name, the
seeded weights, the readings that decide `correct`.

A workload of BENCHMARK.json names a configuration (`configs/<config>.json`:
the model, its zoo config as run, the reference module), a traffic mix
(`traffic/<traffic>.json`: parameters and the driver that reads them,
`drivers/<driver>.py`) and has its limits in `limits/<workload>.json`.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
from typing import Dict, List, NamedTuple, Optional

import torch

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)


def _load(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> Dict:
    return _load(os.path.join(root, "BENCHMARK.json"))


class Workload(NamedTuple):
    spec: Dict       # the BENCHMARK.json entry
    config: Dict     # configs/<config>.json
    traffic: Dict    # traffic/<traffic>.json
    limits: Dict     # limits/<name>.json: {reading: limit}


def workload(name: str, root: str = ROOT) -> Workload:
    for spec in benchmark(root)["workloads"]:
        if spec["name"] == name:
            break
    else:
        raise SystemExit(f"seld_bench: no workload {name!r} in BENCHMARK.json")
    limits_path = os.path.join(PKG, "limits", f"{name}.json")
    return Workload(spec, _load(os.path.join(PKG, "configs",
                                             f"{spec['config']}.json")),
                    _load(os.path.join(PKG, "traffic",
                                       f"{spec['traffic']}.json")),
                    _load(limits_path) if os.path.exists(limits_path) else {})


def driver(kind: str):
    return importlib.import_module(f"seld_bench.drivers.{kind}")


def reference(config: Dict):
    """The configuration's plain reference, `reference/<name>.py`."""
    return importlib.import_module(f"seld_bench.reference.{config['name']}")


def metric_reader(name: str):
    """`metrics/<name>.py` (a metric's name may hold dots)."""
    path = os.path.join(PKG, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "seld_bench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sub_seed(seed: int, stream: int) -> int:
    """A seed for one of a run's random streams, drawn from --seed."""
    return (int(seed) * 1_000_003 + 7919 * stream) % (2 ** 62)


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def _leaf_range(name: str, shape) -> tuple:
    """(low, high) of a leaf's uniform draw: glorot-like kernels, recurrent
    kernels at the scale of an orthogonal matrix, norm scales near 1,
    small biases, running variances near 1."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "recurrent_kernel":
        a = math.sqrt(3.0 / shape[1])
        return -a, a
    if leaf.endswith("kernel"):
        if leaf == "kernel" and ".GRU_" in name:
            fan_in, fan_out = shape[-2], shape[-1]
        else:
            rf = math.prod(shape[:-2])
            fan_in, fan_out = shape[-2] * rf, shape[-1] * rf
        a = math.sqrt(6.0 / (fan_in + fan_out))
        return -a, a
    if leaf == "scale":
        return 0.9, 1.1
    if leaf == "var":
        return 0.8, 1.2
    return -0.1, 0.1


def make_weights(shapes: Dict[str, tuple], seed: int, device
                 ) -> Dict[str, torch.Tensor]:
    """Every leaf of `shapes` (name -> shape, in order) as f32 on `device`,
    drawn from `seed` in one uniform draw on the device and scaled leaf by
    leaf (`_leaf_range`)."""
    names = list(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    lo, hi = zip(*(_leaf_range(n, shapes[n]) for n in names))
    counts = torch.tensor(sizes, device=device)
    lo = torch.repeat_interleave(torch.tensor(lo, device=device), counts)
    hi = torch.repeat_interleave(torch.tensor(hi, device=device), counts)
    u = torch.rand(sum(sizes), generator=generator(seed, device),
                   device=device)
    flat = lo + (hi - lo) * u
    return {n: p.view(shapes[n]) for n, p in zip(names, flat.split(sizes))}


class Phases:
    """Seconds of a set-up's phases, each ended on the device."""

    def __init__(self, device):
        import time
        self._time, self.device = time.perf_counter, torch.device(device)
        self._last = self._time()
        self.phases: Dict[str, float] = {}

    def __call__(self, name: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = self._time()
        self.phases[name] = now - self._last
        self._last = now


class Reading(NamedTuple):
    """One number compared, beside its limit (correct where value <=
    limit)."""
    name: str
    value: float
    limit: Optional[float]

    @property
    def ok(self) -> bool:
        return self.limit is not None and math.isfinite(self.value) \
            and self.value <= self.limit


def readings_with_limits(values: Dict[str, float], limits: Dict
                         ) -> List[Reading]:
    """The readings the cell's limits name, each beside its limit (a
    reading the check did not give is NaN, and fails)."""
    return [Reading(k, float(values.get(k, math.nan)), limit)
            for k, limit in limits.items()]
