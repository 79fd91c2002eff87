from seld_tpu_torch.inference.export import (  # noqa: F401
    LoadedArtifact,
    export_window,
    load_exported,
)
