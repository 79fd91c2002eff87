"""Data pipeline (seld_tpu/data): wav and .npy loading, windowing, the
host loader with its CUDA prefetcher, the device-resident feed and the
batch augmentations."""
