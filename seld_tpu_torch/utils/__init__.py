from seld_tpu_torch.utils.common import sorted_block_keys  # noqa: F401
