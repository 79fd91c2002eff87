"""PyTorch/CUDA port of seld_tpu for one NVIDIA H100.

The JAX package `seld_tpu` is the reference; this package mirrors its tree
and names (config/, models/{layers,modules,models}.py, ops/,
inference/export.py, serving/{server,client}.py) so each part has an obvious
counterpart. It imports torch, numpy and the standard library only.

Ported so far:
  - the SS5 window-scoring server (serving/, inference/);
  - the SS5 training step, bf16 over f32 master weights (train/steps.py);
  - wav-native training end to end: the FOA feature front-end, the
    device-resident feed, the trainer with its schedule, SWA and
    checkpoints, and `python -m seld_tpu_torch.train`;
  - clip scoring and ensemble inference (inference/ensemble.py): the
    exact and trunk-once sliding-window paths, clip and ensemble
    artifacts with int8/bf16 weights, the trainer's periodic official
    evaluation, and `python -m seld_tpu_torch.{make_answer,search_best,
    bench_infer,dress_rehearsal}`.
Every TPU kernel of those paths is a hand-written CUDA kernel for sm_90a
(csrc/: gru_fwd, gru_bwd, stem_dy, foa_frontend, gather_rows), and so is
train-mode BatchNorm (csrc/batch_norm.cu: the statistics, the normalise
and their backward); everything else is plain PyTorch. Entry points take a `device` argument that defaults
to "cuda"; the CPU is used only when the caller passes device="cpu".
"""
