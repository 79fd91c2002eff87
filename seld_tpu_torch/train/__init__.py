"""Training (seld_tpu/train): losses, optimizers with AGC, the train state,
the streaming SELD metric and the train step."""
