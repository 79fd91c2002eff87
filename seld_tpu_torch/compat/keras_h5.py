"""Import trained reference Keras checkpoints (legacy HDF5 files) into the
port's models (seld_tpu/compat/keras_h5.py).

The reference trains in TF/Keras and saves its best models as legacy HDF5
(``tf.keras.models.save_model(model, f'SWA_best_{score}.hdf5',
include_optimizer=False)``, reference trainv2.py:366-369). This module
maps those weights onto the port's modules, so a reference user's trained
checkpoints serve on the card without retraining:

    state_dict = import_keras_weights(model, "SWA_best_x.hdf5", x)
    model.load_state_dict(state_dict)

(CLI: ``python -m seld_tpu_torch.import_tf_weights`` writes a checkpoint
that `train.checkpoint.load_variables` loads.)

The mechanics are the JAX package's. One group per layer in the file,
keyed by Keras' auto-name (``conv2d_3``); sorting one base's groups by
suffix recovers that base's creation order, which equals the model's
application order of that kind. `call_order` records that order with
forward pre-hooks on the port's weight-bearing modules (flax's method
interceptor on the JAX side), and bases that share a kind are told apart
by structure (kernel rank, direction and gate counts, `pos_kernel`), never
by their interleaving in the file. Shapes are checked on every mapped
tensor.

The parsing of the file (`H5Layer`, `read_legacy_h5`, `_BASE_KIND`,
`_NAME_RE`) is a copy of the JAX package's, pinned equal to it by
tests/test_torch_imports.py.
"""
from __future__ import annotations

import re
from collections import deque
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

__all__ = ["read_legacy_h5", "call_order", "set_mapped_weights",
           "align_entries", "import_keras_weights", "H5Layer"]


# ---------------------------------------------------------------------------
# the port's side: application-order capture of weight-bearing modules
# ---------------------------------------------------------------------------
# module class -> mapping kind
FLAX_KIND = {
    "Conv": "conv",
    "Dense": "dense",
    "BatchNorm": "bn",
    "LayerNorm": "ln",
    "GRU": "rnn",
    "LSTM": "rnn",
    "MultiHeadAttention": "mha",
    "RelPositionMultiHeadAttention": "mha",
}


def call_order(model: nn.Module, x: torch.Tensor, train: bool = False
               ) -> List[Tuple[str, str]]:
    """[(kind, module path)] of the weight-bearing modules that own
    parameters, in the order a forward of x first applies them. A module
    applied again (a scanned block's layer) keeps its first place. The
    fused training stem (ops/stem.py) reads its Conv and BatchNorm's
    parameters without calling them, so a Conv2DBN records its two children
    as it starts."""
    names = {id(m): n for n, m in model.named_modules()}
    record, seen, handles = [], set(), []

    def note(module, args=None):
        path = names[id(module)]
        if path not in seen and any(True for _ in
                                    module.parameters(recurse=False)):
            seen.add(path)
            record.append((FLAX_KIND[type(module).__name__], path))

    def note_stem(module, args):
        note(module.Conv_0)
        note(module.BatchNorm_0)

    for module in model.modules():
        kind = type(module).__name__
        if kind in FLAX_KIND:
            handles.append(module.register_forward_pre_hook(note))
        elif kind == "Conv2DBN":
            handles.append(module.register_forward_pre_hook(note_stem))
    mode = model.training
    try:
        model.train(train)
        with torch.no_grad():
            model(x)
    finally:
        model.train(mode)
        for h in handles:
            h.remove()
    return record


def _own(model: nn.Module, path: str) -> Dict[str, torch.Tensor]:
    """A module's own parameters by leaf name."""
    return dict(model.get_submodule(path).named_parameters(recurse=False))


def set_mapped_weights(state_dict: Dict[str, torch.Tensor],
                       order: Sequence[Tuple[str, str]], tf_entries
                       ) -> Dict[str, torch.Tensor]:
    """A copy of `state_dict` with the TF layers' weights written onto the
    modules of `order` ([(kind, path)], `call_order`'s); `tf_entries` is the
    parallel [(kind, payload)] list. Payload formats per kind match Keras
    `get_weights()`:

    * conv/dense: [kernel(, bias)]
    * bn: [gamma, beta, moving_mean, moving_variance]
    * ln: [gamma, beta]
    * rnn: [kernel, recurrent_kernel, bias] * directions
    * mha: {param_name: array} (the reference's custom layers use the port's
      parameter names, reference layers.py:146-201, :334-351) or the
      standard-Keras 8-tuple (q/k/v/out kernel+bias)
    """
    out = dict(state_dict)
    if len(order) != len(tf_entries):
        raise ValueError(
            f"layer count mismatch: port {len(order)} vs tf "
            f"{len(tf_entries)}\nport: {list(order)}\ntf: "
            f"{[k for k, _ in tf_entries]}")

    def put(path, name, value):
        key = f"{path}.{name}"
        if key not in out:
            raise ValueError(f"{path}: no parameter {name}")
        _check_shape(path, name, out[key], value)
        out[key] = torch.as_tensor(np.asarray(value, np.float32)).to(
            dtype=out[key].dtype, device=out[key].device)

    for (kind, path), (tkind, payload) in zip(order, tf_entries):
        if kind != tkind:
            raise ValueError(f"kind mismatch at {path}: port {kind} vs "
                             f"tf {tkind}")
        if kind in ("conv", "dense"):
            put(path, "kernel", payload[0])
            if len(payload) > 1:
                put(path, "bias", payload[1])
        elif kind == "bn":
            for name, w in zip(("scale", "bias", "mean", "var"), payload):
                put(path, name, w)
        elif kind == "ln":
            put(path, "scale", payload[0])
            put(path, "bias", payload[1])
        elif kind == "rnn":
            n = len(payload)
            if n not in (3, 6):
                raise ValueError(f"{path}: unexpected rnn weight count {n}")
            dirs = n // 3
            for i, name in enumerate(("kernel", "recurrent_kernel",
                                      "bias")):
                put(path, name, np.stack([payload[3 * d + i]
                                          for d in range(dirs)]))
        elif kind == "mha":
            if isinstance(payload, dict):
                for name, w in payload.items():
                    put(path, name, w)
            else:  # standard keras MHA -> per-head kernels
                (qk, qb, kk, kb, vk, vb, ok, ob) = payload
                for name, w in [("query_kernel", qk.transpose(1, 0, 2)),
                                ("q_bias", qb),
                                ("key_kernel", kk.transpose(1, 0, 2)),
                                ("k_bias", kb),
                                ("value_kernel", vk.transpose(1, 0, 2)),
                                ("v_bias", vb),
                                ("projection_kernel", ok),
                                ("projection_bias", ob)]:
                    put(path, name, w)
    return out


def _check_shape(path, name, have, got):
    if tuple(have.shape) != tuple(np.shape(got)):
        raise ValueError(f"{path}/{name}: port {tuple(have.shape)} vs "
                         f"tf {tuple(np.shape(got))}")


# ---------------------------------------------------------------------------
# legacy HDF5 reading (a copy of the JAX package's)
# ---------------------------------------------------------------------------
# Keras auto-name base -> mapping kind
_BASE_KIND = {
    "conv2d": "conv",
    "conv1d": "conv",
    "dense": "dense",
    "batch_normalization": "bn",
    "layer_normalization": "ln",
    "gru": "rnn",
    "lstm": "rnn",
    "bidirectional": "rnn",
    "multi_head_attention": "mha",
    "multi_head_attention_": "mha",   # reference custom MHA (layers.py:102)
    "rel_position_multi_head_attention": "mha",  # layers.py:332
}

_NAME_RE = re.compile(r"^(.*?)(?:_(\d+))?$")


class H5Layer:
    """One weight-bearing layer group from a legacy Keras HDF5 file."""

    def __init__(self, name: str, weights: List[Tuple[str, np.ndarray]]):
        self.name = name
        m = _NAME_RE.fullmatch(name)
        self.base, idx = m.group(1), m.group(2)
        self.index = int(idx) if idx is not None else 0
        if self.base not in _BASE_KIND:
            raise ValueError(
                f"unsupported Keras layer '{name}' in checkpoint (base "
                f"'{self.base}'); supported: {sorted(_BASE_KIND)}")
        self.kind = _BASE_KIND[self.base]
        self.weights = weights
        self.payload = self._payload()

    # -- payload normalization to set_mapped_weights' per-kind formats -----
    def _by_basename(self) -> Dict[str, np.ndarray]:
        out = {}
        for path, arr in self.weights:
            out[path.rsplit("/", 1)[-1]] = arr
        return out

    def _payload(self):
        names = self._by_basename()
        if self.kind in ("conv", "dense"):
            p = [names["kernel"]]
            if "bias" in names:
                p.append(names["bias"])
            return p
        if self.kind == "bn":
            return [names["gamma"], names["beta"], names["moving_mean"],
                    names["moving_variance"]]
        if self.kind == "ln":
            return [names["gamma"], names["beta"]]
        if self.kind == "rnn":
            return self._rnn_payload()
        if self.kind == "mha":
            return self._mha_payload()
        raise AssertionError(self.kind)

    def _rnn_payload(self):
        if self.base != "bidirectional":
            names = self._by_basename()
            return [names["kernel"], names["recurrent_kernel"], names["bias"]]
        fwd = [(p, a) for p, a in self.weights if "backward" not in p]
        bwd = [(p, a) for p, a in self.weights if "backward" in p]
        if not bwd:  # no directional path markers: keras saves fwd then bwd
            half = len(self.weights) // 2
            fwd, bwd = self.weights[:half], self.weights[half:]
        out = []
        for half in (fwd, bwd):
            names = {p.rsplit("/", 1)[-1]: a for p, a in half}
            out += [names["kernel"], names["recurrent_kernel"], names["bias"]]
        return out

    def _mha_payload(self):
        if self.base in ("multi_head_attention_",
                         "rel_position_multi_head_attention"):
            return self._by_basename()
        # standard keras MHA: q/k/v/attention_output kernel+bias 8-tuple,
        # identified by the parent component in the weight path
        comp = {}
        for path, arr in self.weights:
            parts = path.split("/")
            leaf = parts[-1]
            parent = next((p for p in parts
                           if p.startswith(("query", "key", "value",
                                            "attention_output"))), None)
            if parent is None:
                # a custom layer that escaped base-name detection (e.g. a
                # user-renamed reference MHA): fall back to param names
                return self._by_basename()
            comp[(parent.split("_")[0] if not parent.startswith(
                "attention_output") else "out", leaf)] = arr
        try:
            return tuple(comp[k] for k in
                         [("query", "kernel"), ("query", "bias"),
                          ("key", "kernel"), ("key", "bias"),
                          ("value", "kernel"), ("value", "bias"),
                          ("out", "kernel"), ("out", "bias")])
        except KeyError as e:
            raise ValueError(f"{self.name}: standard-Keras MHA weight "
                             f"{e} missing") from None

    # -- structural subkind for cross-base disambiguation -------------------
    def subkind(self) -> tuple:
        if self.kind == "conv":
            return ("conv", self.payload[0].ndim)
        if self.kind == "rnn":
            dirs = len(self.payload) // 3
            rec = self.payload[1]
            return ("rnn", dirs, rec.shape[1] // rec.shape[0])
        if self.kind == "mha":
            if isinstance(self.payload, dict):
                return ("mha", "rel" if "pos_kernel" in self.payload
                        else "plain")
            return ("mha", "plain")
        return (self.kind,)


def _decode(v) -> str:
    return v.decode() if isinstance(v, bytes) else str(v)


def read_legacy_h5(path: str) -> List[H5Layer]:
    """Weight-bearing layers from a legacy Keras HDF5 file.

    Accepts both full-model files (reference `tf.keras.models.save_model`,
    weights under the `model_weights` group) and bare `save_weights` files
    (weights at the root). Weight names are normalized (`:0` stripped).
    """
    import h5py

    layers = []
    with h5py.File(path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f
        if "layer_names" not in root.attrs:
            raise ValueError(
                f"{path}: no 'layer_names' attribute — not a legacy Keras "
                "HDF5 weights file (Keras 3 '.weights.h5' files are not the "
                "reference's format)")
        for name in root.attrs["layer_names"]:
            name = _decode(name)
            g = root[name]
            wnames = [_decode(w) for w in g.attrs.get("weight_names", [])]
            if not wnames:
                continue  # weightless layer (activation, pooling, dropout)
            weights = [(w[:-2] if w.endswith(":0") else w,
                        np.asarray(g[w])) for w in wnames]
            layers.append(H5Layer(name, weights))
    return layers


# ---------------------------------------------------------------------------
# alignment + top-level import
# ---------------------------------------------------------------------------
def _port_subkind(kind: str, sub: Dict[str, Any]) -> tuple:
    if kind == "conv":
        return ("conv", sub["kernel"].ndim)
    if kind == "rnn":
        rec = sub["recurrent_kernel"]
        return ("rnn", sub["kernel"].shape[0], rec.shape[2] // rec.shape[1])
    if kind == "mha":
        return ("mha", "rel" if "pos_kernel" in sub else "plain")
    return (kind,)


def _is_init_ln(layer: H5Layer) -> bool:
    gamma, beta = layer.payload
    return bool(np.all(gamma == 1.0) and np.all(beta == 0.0))


def align_entries(model: nn.Module, order: Sequence[Tuple[str, str]],
                  h5_layers: Sequence[H5Layer]):
    """Match h5 layers to the model's modules per structural subkind, in
    per-base creation order; returns tf_entries parallel to `order`."""
    # within one subkind, multiple bases would make creation order ambiguous
    # (per-base counters are independent) -- possible only for mha custom vs
    # standard, which the reference never mixes
    queues: Dict[tuple, deque] = {}
    for layer in sorted(h5_layers, key=lambda l: (l.base, l.index)):
        queues.setdefault(layer.subkind(), deque()).append(layer)
    for sk, q in queues.items():
        bases = {l.base for l in q}
        if len(bases) > 1 and sk[0] == "mha":
            raise ValueError(
                f"checkpoint mixes MHA flavors {sorted(bases)}: per-base "
                "creation order is ambiguous across them")

    # the pre-LN attention_block quirk: the reference creates LayerNorms
    # whose outputs it discards (modules.py:560-568), which the port does
    # not create. They get no gradient, so in any trained checkpoint they
    # hold their exact init (gamma=1, beta=0): drop precisely the excess
    # that is bit-exact init, and refuse any ambiguity.
    subkinds = [_port_subkind(kind, _own(model, path))
                for kind, path in order]
    needed = sum(1 for sk in subkinds if sk == ("ln",))
    lnq = queues.get(("ln",))
    if lnq is not None and len(lnq) > needed:
        excess = len(lnq) - needed
        init_lns = [l for l in lnq if _is_init_ln(l)]
        if len(init_lns) != excess:
            raise ValueError(
                f"checkpoint has {len(lnq)} LayerNorms but the model uses "
                f"{needed}; {len(init_lns)} are at exact init "
                f"({[l.name for l in init_lns]}) which does not match the "
                f"excess of {excess} -- cannot identify the reference's "
                "discarded pre-LN LayerNorms automatically; pass drop={...} "
                "with the unused layer names")
        dropped = {l.name for l in init_lns}
        queues[("ln",)] = deque(l for l in lnq if l.name not in dropped)

    entries = []
    for (kind, path), sk in zip(order, subkinds):
        q = queues.get(sk)
        if not q:
            raise ValueError(
                f"checkpoint has no remaining layer for module {path} "
                f"(subkind {sk}); per-subkind counts: the model needs more "
                f"{sk} than the file provides -- wrong model_config for "
                "this checkpoint?")
        entries.append((kind, q.popleft().payload))
    leftover = [l.name for q in queues.values() for l in q]
    if leftover:
        raise ValueError(
            f"checkpoint layers left unmapped: {leftover} -- wrong "
            "model_config for this checkpoint? (pass drop={...} to ignore "
            "layers deliberately)")
    return entries


def import_keras_weights(model: nn.Module, h5_path: str, x: torch.Tensor,
                         train: bool = False, drop: Sequence[str] = ()
                         ) -> Dict[str, torch.Tensor]:
    """A reference legacy-HDF5 checkpoint mapped onto `model`'s state_dict
    (parameters and BatchNorm statistics), which the caller loads. `x` is
    any correctly-shaped input (run once to record the application order,
    in eval mode unless `train`). `drop` names h5 layers to ignore
    (normally unnecessary: the pre-LN attention_block's discarded
    LayerNorms are found and dropped)."""
    order = call_order(model, x, train)
    layers = [l for l in read_legacy_h5(h5_path) if l.name not in set(drop)]
    entries = align_entries(model, order, layers)
    return set_mapped_weights(model.state_dict(), order, entries)
