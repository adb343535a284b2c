"""create_model — registry name -> initialized ``nn.Module``, counterpart of
``cotnet_tpu/models/factory.py`` (reference models/factory.py:6-64).

It takes the JAX factory's arguments and treats each as that factory does:
the batchnorm kwargs (``bn_tf``, ``bn_momentum``, ``bn_eps``) reach only the
EfficientNet / MobileNetV3 entrypoints, ``drop_connect_rate`` becomes
``drop_path_rate`` with a warning, ``pretrained`` is accepted and changes
nothing, ``scriptable``, ``exportable`` and ``no_jit`` are set for the
build (``nn.config.set_layer_config``; no layer of the port reads them),
and a non-empty ``checkpoint_path`` is refused (``utils.convert.
load_checkpoint_into`` loads a file).
"""

from __future__ import annotations

import warnings

import torch

from cotnet_tpu_torch.models.registry import (is_model, is_model_in_modules,
                                              model_entrypoint)
from cotnet_tpu_torch.nn.config import set_layer_config

_BN_KWARGS = ("bn_tf", "bn_momentum", "bn_eps")


def create_model(model_name: str, pretrained: bool = False,
                 num_classes: int = 1000, in_chans: int = 3,
                 checkpoint_path: str = "", scriptable=None, exportable=None,
                 no_jit=None, *, device="cuda",
                 dtype: torch.dtype = torch.float32, seed: int = 0,
                 **kwargs):
    """Build a registered model with weights from a seeded generator.

    ``dtype`` is the compute dtype, as flax's ``dtype=``: parameters and BN
    running stats stay float32 (the state_dict the converter maps) and each
    weight is cast to ``dtype`` where it is used.  Extra kwargs go to the
    entrypoint (e.g. ``drop_rate=``, ``drop_path_rate=``,
    ``block_args=dict(impl=...)``, and for the CoT family
    ``gn_fold_train=`` and ``mega_fuse=``, see ``models/cotnet.py``); None
    values are pruned.  ``bn_momentum`` is torch's (0.01 is flax's 0.99).
    The model is returned on ``device`` in eval mode; call
    ``model.train()`` to train it (``train/step.py`` does).
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("create_model(device='cuda') needs a CUDA device; "
                           "pass device='cpu' to run the plain versions")
    if not is_model(model_name):
        raise RuntimeError(f"Unknown model ({model_name})")
    if checkpoint_path:
        raise ValueError(
            "checkpoint_path is not read by create_model: load the file "
            "with cotnet_tpu_torch.utils.convert.load_checkpoint_into")
    if not is_model_in_modules(model_name, ["efficientnet", "mobilenetv3"]):
        for key in _BN_KWARGS:
            kwargs.pop(key, None)
    drop_connect_rate = kwargs.pop("drop_connect_rate", None)
    if drop_connect_rate is not None and kwargs.get("drop_path_rate") is None:
        warnings.warn("'drop_connect' is deprecated; use 'drop_path'")
        kwargs["drop_path_rate"] = drop_connect_rate
    kwargs = {k: v for k, v in kwargs.items() if v is not None}
    with set_layer_config(scriptable=scriptable, exportable=exportable,
                          no_jit=no_jit):
        model = model_entrypoint(model_name)(pretrained=pretrained,
                                             num_classes=num_classes,
                                             in_chans=in_chans, dtype=dtype,
                                             **kwargs)
    generator = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(generator)
    return model.to(device).eval()
