"""Tensor ops of the port: plain PyTorch, plus the hand-written CUDA kernels
(`gru.gru_scan`, `stem_bwd.stem_dy`, `frontend.foa_frontend`,
`gather.gather_rows`) that replace the JAX package's Pallas kernels."""
