"""Tensor ops of the port: plain PyTorch, plus the hand-written CUDA kernels
(`gru.gru_scan`) that replace the JAX package's Pallas kernels."""
