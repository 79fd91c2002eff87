from seld_tpu_torch.serving.client import SELDClient  # noqa: F401
from seld_tpu_torch.serving.server import SELDServer  # noqa: F401

# `serve`, the function that binds a server, lives in .server: the name
# `seld_tpu_torch.serving.serve` is the command-line module.
