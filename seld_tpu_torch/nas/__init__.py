"""NAS subsystem (seld_tpu/nas): analytic complexity, config samplers, the
search driver and result analysis. `plots` (matplotlib) is not imported
here: import seld_tpu_torch.nas.plots where a plot is wanted."""

from seld_tpu_torch.nas import complexity  # noqa: F401
from seld_tpu_torch.nas.sampler import (
    config_sampling,
    conv_temporal_sampler,
    vad_architecture_sampler,
    search_space_sanity_check,
    sample_constraint,
    mother_stage_postprocess,
)
from seld_tpu_torch.nas.search import (
    RandomSearch,
    train_and_eval_candidate,
    merge_results,
)

__all__ = [
    "complexity",
    "config_sampling",
    "conv_temporal_sampler",
    "vad_architecture_sampler",
    "search_space_sanity_check",
    "sample_constraint",
    "mother_stage_postprocess",
    "RandomSearch",
    "train_and_eval_candidate",
    "merge_results",
]
