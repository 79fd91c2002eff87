from seld_tpu_torch.config.registry import (  # noqa: F401
    get_block,
    get_model,
    register_block,
    register_model,
)
from seld_tpu_torch.config.zoo import (  # noqa: F401
    MODEL_CONFIGS,
    get_model_config,
    resolve_model_config,
)
