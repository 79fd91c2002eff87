from seld_tpu_torch.models.models import build_model  # noqa: F401
