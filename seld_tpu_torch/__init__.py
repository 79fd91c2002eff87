"""PyTorch/CUDA port of seld_tpu for one NVIDIA H100.

The JAX package `seld_tpu` is the reference; this package mirrors its tree
and names (config/, models/{layers,modules,models}.py, ops/,
inference/export.py, serving/{server,client}.py) so each part has an obvious
counterpart. It imports torch, numpy and the standard library only.

Ported so far: the SS5 window-scoring server. The GRU recurrence runs as a
hand-written CUDA kernel for sm_90a (csrc/gru_fwd.cu); everything else is
plain PyTorch. Entry points take a `device` argument that defaults to
"cuda"; the CPU is used only when the caller passes device="cpu".
"""
