from seld_tpu_torch.utils.common import (  # noqa: F401
    dict_add,
    force_1d_shape,
    safe_tuple,
    sorted_block_keys,
)
