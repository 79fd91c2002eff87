"""Weight-only quantisation for serving artifacts
(seld_tpu/inference/quantize.py), over a state_dict.

- ``int8``: per-output-channel symmetric int8 (4x smaller than f32, error
  bounded by scale/2 per element). Matmul-class kernels only (ndim >= 2,
  numel >= min_size); biases, BN parameters and running statistics stay
  f32. The port keeps flax's layouts (bridge.py), so the output channel is
  the last axis here as there.
- ``bfloat16``: every float entry cast to bf16, the BN statistics included.

An artifact stores the int8 words and f32 scales (or the bf16 values), and
the weights are dequantised on the device at load: ``w = q.float() *
scale`` in f32, then cast to the original dtype.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Union

import torch

_MODES = ("int8", "bfloat16")


class QTensor(NamedTuple):
    """A per-output-channel symmetric int8 tensor: ``q`` int8 [..., out],
    ``scale`` f32 [1, ..., 1, out], ``dtype`` the original dtype's name."""
    q: torch.Tensor
    scale: torch.Tensor
    dtype: str = "float32"


Entry = Union[torch.Tensor, QTensor]


def _quantize_leaf(w: torch.Tensor, min_size: int) -> Entry:
    if not w.is_floating_point():
        return w
    if w.dim() < 2 or w.numel() < min_size:
        return w
    wf = w.float()
    amax = wf.abs().amax(dim=tuple(range(w.dim() - 1)), keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    # torch.round rounds half to even, as jnp.round does
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return QTensor(q, scale, str(w.dtype).split(".")[-1])


def quantize_tree(state: Dict[str, torch.Tensor], mode: str = "int8", *,
                  min_size: int = 1024) -> Dict[str, Entry]:
    """Quantise a state_dict (parameters and BN statistics).

    mode "int8" replaces each matmul-class kernel by a `QTensor` and leaves
    entries with fewer than `min_size` elements or fewer than 2 dims as
    they are; "bfloat16" casts every float entry to bf16.
    """
    if mode not in _MODES:
        raise ValueError(f"quantize mode {mode!r}: pick from {_MODES}")
    if mode == "bfloat16":
        return {k: w.to(torch.bfloat16) if w.is_floating_point() else w
                for k, w in state.items()}
    return {k: _quantize_leaf(w, min_size) for k, w in state.items()}


def dequantize_tree(qstate: Dict[str, Entry]) -> Dict[str, torch.Tensor]:
    """QTensor -> scale * q (f32 math, cast back to the original dtype);
    other entries pass through as they are."""
    def deq(x):
        if isinstance(x, QTensor):
            return (x.q.float() * x.scale).to(getattr(torch, x.dtype))
        return x
    return {k: deq(x) for k, x in qstate.items()}


def quantization_report(state: Dict[str, torch.Tensor],
                        qstate: Dict[str, Entry]) -> dict:
    """Bytes before and after, and the largest per-element reconstruction
    error over the entries."""
    def nbytes(t):
        return t.numel() * t.element_size()

    before = sum(nbytes(w) for w in state.values())
    after, max_err, n_quantized = 0, 0.0, 0
    deq = dequantize_tree(qstate)
    for k, w in state.items():
        q = qstate[k]
        if isinstance(q, QTensor):
            after += nbytes(q.q) + nbytes(q.scale)
            n_quantized += 1
        else:
            after += nbytes(q)
        if w.numel():
            err = (w.float() - deq[k].float()).abs().max().item()
            max_err = max(max_err, err)
    return {"bytes_before": int(before), "bytes_after": int(after),
            "n_quantized_leaves": n_quantized, "max_abs_error": max_err}
