# importing the model modules registers their entrypoints
from cotnet_tpu_torch.models import cotnet, cotnet_hybrid  # noqa: F401
from cotnet_tpu_torch.models.factory import create_model
from cotnet_tpu_torch.models.helpers import get_model_default_cfg
from cotnet_tpu_torch.models.registry import (
    is_model,
    list_models,
    model_entrypoint,
)

__all__ = ["create_model", "get_model_default_cfg", "is_model",
           "list_models", "model_entrypoint"]
