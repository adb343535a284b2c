# importing the model modules registers their entrypoints
from cotnet_tpu_torch.models import (botnet, cait,  # noqa: F401
                                     cotnet, cotnet_hybrid, lambda_net,
                                     lr_net, pit, resnet, resnet_dw,
                                     resnetv2, san, swin_transformer,
                                     vision_transformer,
                                     vision_transformer_hybrid, xcit)
from cotnet_tpu_torch.models.factory import create_model
from cotnet_tpu_torch.models.helpers import get_model_default_cfg
from cotnet_tpu_torch.models.registry import (
    is_model,
    list_models,
    model_entrypoint,
)

__all__ = ["create_model", "get_model_default_cfg", "is_model",
           "list_models", "model_entrypoint"]
