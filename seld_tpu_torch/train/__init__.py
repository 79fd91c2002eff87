"""Training (seld_tpu/train): losses, optimizers with AGC, the train state,
the streaming SELD metric, the train and eval steps, checkpoints, the
trainer and the `python -m seld_tpu_torch.train` entry point."""
