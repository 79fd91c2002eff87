"""Serving artifacts (seld_tpu/inference/export.py): window and clip units,
model ensembles, weight-only quantisation.

The JAX package exports the jitted forward as StableHLO with the weights
baked in. A torch artifact cannot hold StableHLO, so the port's counterpart
keeps the same contract — export once, then serve with no checkpoint
directory and no training code — as two files:

  <path>            the weights, an .npz keyed "<member>/<state_dict name>":
                    f32 values, or with `quantize` the int8 words and f32
                    scales ("#q", "#scale") or the bf16 bits ("#bf16")
  <path>.meta.json  the unit, the members (model name, config, per-window
                    input shape), the input shape and dtype the artifact
                    takes, the quantisation, and the unit's geometry

`load_exported(path, device=...)` rebuilds each member from the port's zoo
and loads its weights, dequantised on the device. Two units:

- ``window``: ``[b, win, F, C] -> (sed [b, t, C], doa [b, t, 3C])`` for any
  b (or b == batch when exported with a static batch). A data-parallel
  window artifact (`nr_devices` N > 1, a static batch N divides) loads one
  replica of its members on each of N devices; a call splits the batch
  into N row blocks in order, runs each on its device from a worker
  thread of its own (on the device's own stream) and returns the rows in
  order.
- ``clip`` (conv_temporal only): ``[T, F, C] -> (sed [L, C], doa
  [L, 3C])``, the trunk-once fast sliding-window predictor
  (inference/ensemble.py) for a fixed clip length `clip_frames` (DCASE 60-s
  clips: T=3000), with `win_size`, `step_size` and `time_down` in the meta.

An artifact of several members returns their average, computed in f32.

The stream unit is a BUNDLE, a directory (`export_streaming`):

  <dir>/meta.json    the geometry keys of the JAX package's bundle
                     (feat_shape, win_size, step_size, time_down, chunk,
                     the halo measured at export, dtype, n_streams, l_f),
                     the member and the quantisation
  <dir>/weights.npz  the weights, stored as an artifact's

served by `StreamingSELD.from_exported(dir, device=...)`.
"""
from __future__ import annotations

import contextlib
import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

_META_SUFFIX = ".meta.json"
FORMAT = "seld_tpu_torch.artifact/v2"
UNITS = ("window", "clip")
INPUT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
STREAM_FORMAT = "seld_tpu_torch.streaming_bundle/v1"
_BUNDLE_META = "meta.json"
_BUNDLE_WEIGHTS = "weights.npz"


def _pack(state: Dict[str, torch.Tensor], quantize: Optional[str],
          prefix: str) -> Dict[str, np.ndarray]:
    """A member's state_dict as npz entries, quantised as asked."""
    from seld_tpu_torch.inference.quantize import QTensor, quantize_tree

    state = {k: v.detach().float().cpu() for k, v in state.items()}
    entries = quantize_tree(state, quantize) if quantize else state
    out = {}
    for key, v in entries.items():
        name = f"{prefix}/{key}"
        if isinstance(v, QTensor):
            out[name + "#q"] = v.q.numpy()
            out[name + "#scale"] = v.scale.numpy()
        elif v.dtype == torch.bfloat16:
            out[name + "#bf16"] = v.view(torch.int16).numpy()
        else:
            out[name] = v.numpy()
    return out


def _unpack(weights, prefix: str, device) -> Dict[str, torch.Tensor]:
    """A member's state_dict from npz entries, dequantised on `device`."""
    from seld_tpu_torch.inference.quantize import QTensor, dequantize_tree

    entries: Dict[str, Any] = {}
    for name in weights.files:
        member, key = name.split("/", 1)
        if member != prefix or key.endswith("#scale"):
            continue
        arr = torch.from_numpy(weights[name]).to(device)
        if key.endswith("#q"):
            scale = torch.from_numpy(weights[name[:-2] + "#scale"])
            entries[key[:-2]] = QTensor(arr, scale.to(device))
        elif key.endswith("#bf16"):
            entries[key[:-5]] = arr.view(torch.bfloat16)
        else:
            entries[key] = arr
    return dequantize_tree(entries)


def _members_meta(models: Sequence[nn.Module]) -> Dict[str, Any]:
    return {"members": [{"model": m.model_name,
                         "model_config": m.model_config,
                         "input_shape": list(m.input_shape)}
                        for m in models],
            "n_members": len(models),
            "n_classes": models[0].model_config.get("n_classes", 14),
            "torch_version": torch.__version__}


def _build_members(meta: Dict[str, Any], weights, device) -> List[nn.Module]:
    """Each member rebuilt from the zoo with its stored weights."""
    from seld_tpu_torch.models import build_model

    models = []
    for i, member in enumerate(meta["members"]):
        model = build_model(member["model"], member["input_shape"],
                            member["model_config"], device=device)
        model.load_state_dict(_unpack(weights, str(i), device), strict=True)
        models.append(model)
    return models


def _export(models: Sequence[nn.Module], path: str, unit: str,
            input_shape: Sequence[int], *, dtype: str,
            quantize: Optional[str], geometry: Dict[str, Any],
            extra_meta: Optional[Dict[str, Any]]) -> str:
    if dtype not in INPUT_DTYPES:
        raise ValueError(f"dtype {dtype!r}; one of {sorted(INPUT_DTYPES)}")
    if not models:
        raise ValueError("need at least one model")
    shapes = {tuple(m.input_shape) for m in models}
    if len(shapes) != 1:
        raise ValueError(f"ensemble members take different window shapes "
                         f"{sorted(shapes)}")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    arrays = {}
    for i, m in enumerate(models):
        arrays.update(_pack(m.state_dict(), quantize, str(i)))
    with open(path, "wb") as f:
        np.savez(f, **arrays)
    meta = {
        "format": FORMAT,
        "unit": unit,
        **_members_meta(models),
        "input_shape": list(input_shape),
        "input_dtype": dtype,
        "quantize": quantize or "none",
        "bytes": os.path.getsize(path),
        **geometry,
    }
    meta.update(extra_meta or {})
    with open(path + _META_SUFFIX, "w") as f:
        json.dump(meta, f, indent=2)
    return path


def export_window(model: nn.Module, path: str, *, dtype: str = "float32",
                  batch: Optional[int] = None,
                  quantize: Optional[str] = None, nr_devices: int = 1,
                  extra_meta: Optional[Dict[str, Any]] = None) -> str:
    """Write `model` (from `models.build_model`) as a window artifact.

    dtype: the input dtype the artifact accepts ("float32" or "bfloat16";
      requests in another dtype are value-cast to it).
    batch: None serves every batch size; an int N makes the server
      pad-and-chunk every dispatch to exactly N rows.
    quantize: None (f32 weights), "int8" or "bfloat16" (quantize.py).
    nr_devices: > 1 writes a data-parallel artifact: it needs a static
      `batch` that nr_devices divides, and a load places one replica on
      each of nr_devices devices (one dispatch spans them all).
    """
    if nr_devices > 1:
        if not batch:
            raise ValueError("a data-parallel export needs a static batch "
                             "(a batch of any size cannot split over the "
                             "devices)")
        if batch % nr_devices:
            raise ValueError(f"batch {batch} must divide over the "
                             f"{nr_devices}-device mesh")
    return _export([model], path, "window", model.input_shape, dtype=dtype,
                   quantize=quantize,
                   geometry={"batch": batch, "nr_devices": int(nr_devices)},
                   extra_meta=extra_meta)


def export_window_ensemble(models: Sequence[nn.Module], path: str, *,
                           dtype: str = "float32",
                           batch: Optional[int] = None,
                           quantize: Optional[str] = None,
                           extra_meta: Optional[Dict[str, Any]] = None
                           ) -> str:
    """An N-model ensemble's per-window forward as ONE artifact: one call
    returns the members' average (sed, doa), computed in f32
    (make_answer.py:133-140). Members may differ in architecture but take
    the same window shape."""
    return _export(models, path, "window", models[0].input_shape,
                   dtype=dtype, quantize=quantize,
                   geometry={"batch": batch, "nr_devices": 1},
                   extra_meta=extra_meta)


def export_clip_fast(model: nn.Module, path: str, clip_frames: int, *,
                     win_size: int = 300, step_size: int = 5,
                     time_down: Optional[int] = None,
                     dtype: str = "float32", quantize: Optional[str] = None,
                     extra_meta: Optional[Dict[str, Any]] = None) -> str:
    """The trunk-once fast sliding-window clip predictor as an artifact.

    One call scores a whole clip of `clip_frames` frames: the time-local
    trunk runs once, all windows go through the sequence head in one
    chunk, and the overlap-add normalisation happens inside the call.
    conv_temporal only (it needs the trunk/head stage split).
    """
    if time_down is None:
        raise ValueError("pass time_down (conv_temporal: "
                         "first_pool_size[0], e.g. 5)")
    return export_clip_fast_ensemble(
        [model], path, clip_frames, win_size=win_size, step_size=step_size,
        time_downs=[time_down], dtype=dtype, quantize=quantize,
        extra_meta=extra_meta)


def export_clip_fast_ensemble(models: Sequence[nn.Module], path: str,
                              clip_frames: int, *, win_size: int = 300,
                              step_size: int = 5,
                              time_downs: Sequence[int],
                              dtype: str = "float32",
                              quantize: Optional[str] = None,
                              extra_meta: Optional[Dict[str, Any]] = None
                              ) -> str:
    """An N-model ensemble trunk-once clip scorer as ONE artifact: each
    member runs its own fast sliding-window pass and the overlap-added
    sequences are averaged inside the call. `time_downs[i]` is member i's
    total trunk time stride (conv_temporal: first_pool_size[0])."""
    if len(time_downs) != len(models):
        raise ValueError("need one time_down per member")
    if any(m.model_name != "conv_temporal" for m in models):
        raise ValueError("the clip unit needs the trunk/head stage split "
                         "(conv_temporal only)")
    feat = models[0].input_shape[1:]
    return _export(models, path, "clip", (clip_frames, *feat), dtype=dtype,
                   quantize=quantize,
                   geometry={"clip_frames": clip_frames,
                             "win_size": win_size, "step_size": step_size,
                             "time_downs": [int(t) for t in time_downs],
                             "time_down": int(time_downs[0]),
                             "nr_devices": 1},
                   extra_meta=extra_meta)


def export_streaming(model: nn.Module, out_dir: str, feat_shape, *,
                     win_size: int = 300, step_size: int = 5,
                     time_down: int = 5, chunk: int = 10,
                     halo: Optional[int] = None, dtype: str = "float32",
                     n_streams: int = 1,
                     quantize: Optional[str] = None) -> str:
    """Write the real-time streaming engine as a BUNDLE directory.

    The geometry is validated and the trunk halo MEASURED here, on the
    weights the bundle holds (after `quantize`), by building the live
    engine; `StreamingSELD.from_exported(out_dir)` then serves live feeds
    from the bundle alone, with no checkpoint and nothing measured again.
    conv_temporal only (the engine needs the trunk/head stage split).
    dtype: the features' dtype on the device, "float32" or "bfloat16".
    """
    import copy

    from seld_tpu_torch.inference.quantize import (dequantize_tree,
                                                   quantize_tree)
    from seld_tpu_torch.inference.streaming import StreamingSELD

    if dtype not in INPUT_DTYPES:
        raise ValueError(f"dtype {dtype!r}; one of {sorted(INPUT_DTYPES)}")
    if model.model_name != "conv_temporal":
        raise ValueError("the stream unit needs the trunk/head stage split "
                         "(conv_temporal only)")
    live = model
    if quantize:
        live = copy.deepcopy(model)
        live.load_state_dict(dequantize_tree(quantize_tree(
            model.state_dict(), quantize)))
    engine = StreamingSELD(live, feat_shape, win_size=win_size,
                           step_size=step_size, time_down=time_down,
                           chunk=chunk, halo=halo,
                           dtype=INPUT_DTYPES[dtype], n_streams=n_streams)
    os.makedirs(out_dir, exist_ok=True)
    weights = os.path.join(out_dir, _BUNDLE_WEIGHTS)
    with open(weights, "wb") as f:
        np.savez(f, **_pack(model.state_dict(), quantize, "0"))
    meta = {
        "format": STREAM_FORMAT,
        "unit": "stream",
        "feat_shape": list(engine.feat_shape),
        "win_size": win_size, "step_size": step_size,
        "time_down": time_down, "chunk": chunk, "halo": engine.halo_t,
        "dtype": dtype, "n_streams": n_streams, "l_f": engine.l_f,
        **_members_meta([model]),
        "quantize": quantize or "none",
        "bytes": os.path.getsize(weights),
    }
    with open(os.path.join(out_dir, _BUNDLE_META), "w") as f:
        json.dump(meta, f, indent=2)
    return out_dir


def load_stream_bundle(path: str, device="cuda"
                       ) -> Tuple[nn.Module, Dict[str, Any]]:
    """(model on `device`, meta) of a stream bundle directory."""
    with open(os.path.join(path, _BUNDLE_META)) as f:
        meta = json.load(f)
    if meta.get("format") != STREAM_FORMAT:
        raise ValueError(f"{path}: not a {STREAM_FORMAT} bundle (format "
                         f"{meta.get('format')!r})")
    with np.load(os.path.join(path, _BUNDLE_WEIGHTS)) as weights:
        (model,) = _build_members(meta, weights, device)
    return model, meta


def _devices(device, n: int) -> List[torch.device]:
    """The n devices an artifact of `nr_devices` n runs on: the first n
    cards for a CUDA device (raises when fewer are visible), n replicas on
    the CPU for the CPU."""
    device = torch.device(device)
    if n == 1:
        return [device]
    if device.type == "cpu":
        return [device] * n
    visible = torch.cuda.device_count()
    if visible < n:
        raise ValueError(f"artifact wants {n} devices; {visible} visible")
    return [torch.device(device.type, i) for i in range(n)]


class LoadedArtifact:
    """A loaded window or clip artifact: `call(x)` on its device(s), plus
    meta. A data-parallel artifact holds one replica of its members a
    device (`replicas[i]` on `devices[i]`; `models` is the first)."""

    def __init__(self, replicas: List[List[nn.Module]], meta: Dict[str, Any],
                 devices: Sequence):
        self.replicas = replicas
        self.models = replicas[0]
        self.meta = meta
        self.unit: str = meta["unit"]
        self.devices = [torch.device(d) for d in devices]
        self.device = self.devices[0]
        self.nr_devices = len(self.devices)
        self.input_shape: Tuple[int, ...] = tuple(meta["input_shape"])
        self.dtype = INPUT_DTYPES[meta["input_dtype"]]
        self.batch: Optional[int] = meta.get("batch")
        self._pool = self._streams = None
        if self.nr_devices > 1:
            self._pool = ThreadPoolExecutor(
                self.nr_devices, thread_name_prefix="seld-replica")
            self._streams = [torch.cuda.Stream(d) if d.type == "cuda"
                             else None for d in self.devices]

    def _member_outputs(self, models, x: torch.Tensor):
        if self.unit == "window":
            return [m(x) for m in models]
        from seld_tpu_torch.inference.ensemble import _predict_clip_fast
        return [_predict_clip_fast(
                    m, x, win_size=self.meta["win_size"],
                    step_size=self.meta["step_size"], batch_size=1 << 30,
                    time_down=td)
                for m, td in zip(models, self.meta["time_downs"])]

    def _launch(self, i: int, x: torch.Tensor):
        """Replica i's members' average (f32) of rows x, queued on its
        device and not waited for."""
        device = self.devices[i]
        with (torch.cuda.device(device) if device.type == "cuda"
              else contextlib.nullcontext()):
            x = x.to(device=device, dtype=self.dtype)
            outs = self._member_outputs(self.replicas[i], x)
            n = float(len(outs))
            return (sum(s.float() for s, _ in outs) / n,
                    sum(d.float() for _, d in outs) / n)

    def _block(self, i: int, x: torch.Tensor):
        """Replica i's rows x on a worker thread, copied back: inference
        mode and the current stream are per thread, so each is set
        here (the card's own stream)."""
        stream = self._streams[i]
        with torch.inference_mode(), (
                torch.cuda.stream(stream) if stream is not None
                else contextlib.nullcontext()):
            sed, doa = self._launch(i, x)
            return sed.cpu(), doa.cpu()

    @torch.inference_mode()
    def call(self, x: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
        """window: [b, *input_shape]; clip: [*input_shape] (any host or
        device tensor) -> (sed, doa) as float32 numpy arrays, the members'
        average (the copy back waits for the device). A data-parallel
        artifact splits b into nr_devices row blocks in order and runs
        them at once, a worker thread a card (faster than queueing the
        cards in turn from one thread at 256 rows a card on two cards,
        slower at 32, where one card beats two either way; PERF.md)."""
        if self.nr_devices == 1:
            sed, doa = self._launch(0, x)
            return sed.cpu().numpy(), doa.cpu().numpy()
        if x.shape[0] % self.nr_devices:
            raise ValueError(f"a batch of {x.shape[0]} rows does not split "
                             f"over the artifact's {self.nr_devices} "
                             "devices")
        outs = list(self._pool.map(self._block, range(self.nr_devices),
                                   x.chunk(self.nr_devices)))
        return (torch.cat([s for s, _ in outs]).numpy(),
                torch.cat([d for _, d in outs]).numpy())


def load_exported(path: str, device="cuda") -> LoadedArtifact:
    """A window or clip artifact on `device`: a data-parallel artifact
    (`nr_devices` N > 1) on the first N cards of a CUDA device (raises when
    fewer are visible) or as N replicas on the CPU. A stream bundle (a
    directory, or a meta whose unit is "stream") is refused: it loads
    through `StreamingSELD.from_exported`."""
    meta_path = (os.path.join(path, _BUNDLE_META) if os.path.isdir(path)
                 else path + _META_SUFFIX)
    with open(meta_path) as f:
        meta = json.load(f)
    unit = meta.get("unit")
    if unit == "stream":
        raise ValueError(f"{path}: a streaming engine bundle; load it with "
                         "StreamingSELD.from_exported")
    if meta.get("format") != FORMAT or unit not in UNITS:
        raise ValueError(f"{path}: not a {FORMAT} window or clip artifact "
                         f"(format {meta.get('format')!r}, unit {unit!r})")
    n = int(meta.get("nr_devices", 1))
    if n > 1 and (unit != "window" or not meta.get("batch")
                  or meta["batch"] % n):
        raise ValueError(f"{path}: nr_devices {n} needs a window artifact "
                         f"whose static batch {n} divides (unit {unit!r}, "
                         f"batch {meta.get('batch')})")
    devices = _devices(device, n)
    with np.load(path) as weights:
        replicas = [_build_members(meta, weights, d) for d in devices]
    return LoadedArtifact(replicas, meta, devices)
