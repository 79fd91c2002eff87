"""Inference tooling: sliding-window overlap-add ensembles, submissions,
serving artifacts and their weight-only quantisation, real-time streaming
and its bundles."""
from seld_tpu_torch.inference.ensemble import (  # noqa: F401
    DEFAULT_CLASS_THRESHOLDS,
    average_ensemble,
    ensemble_outputs,
    evaluate_clips_official,
    overlap_add,
    search_thresholds,
    sliding_windows,
)
from seld_tpu_torch.inference.export import (  # noqa: F401
    LoadedArtifact,
    export_clip_fast,
    export_clip_fast_ensemble,
    export_window,
    export_streaming,
    export_window_ensemble,
    load_exported,
)
from seld_tpu_torch.inference.quantize import (  # noqa: F401
    QTensor,
    dequantize_tree,
    quantization_report,
    quantize_tree,
)
from seld_tpu_torch.inference.streaming import (  # noqa: F401
    StreamingSELD,
    measure_trunk_halo,
)
from seld_tpu_torch.inference.streaming_wav import (  # noqa: F401
    StreamingFrontEnd,
    StreamingSELDWav,
)
