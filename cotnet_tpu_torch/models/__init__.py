# importing the model modules registers their entrypoints
from cotnet_tpu_torch.models import (botnet, cait,  # noqa: F401
                                     coat, convit, cotnet, cotnet_hybrid,
                                     densenet, efficientnet, lambda_net,
                                     levit, lr_net, pit, psresnet, regnet,
                                     res2net, resnest, resnet, resnet_dw,
                                     resnet_rs, resnetv2, rexnet, san,
                                     sknet, swin_transformer, tnt, twins,
                                     vision_transformer,
                                     vision_transformer_hybrid, visformer,
                                     xception, xcit)
from cotnet_tpu_torch.models.factory import create_model
from cotnet_tpu_torch.models.helpers import (
    IMAGENET_DEFAULT_MEAN,
    IMAGENET_DEFAULT_STD,
    get_model_default_cfg,
    resolve_data_config,
)
from cotnet_tpu_torch.models.registry import (
    is_model,
    list_models,
    model_entrypoint,
)

__all__ = ["IMAGENET_DEFAULT_MEAN", "IMAGENET_DEFAULT_STD", "create_model",
           "get_model_default_cfg", "is_model", "list_models",
           "model_entrypoint", "resolve_data_config"]
