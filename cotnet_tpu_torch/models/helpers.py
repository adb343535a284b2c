"""Model-construction helpers, counterpart of ``cotnet_tpu/models/helpers.py``
(reference models/helpers.py:311-357 and the default_cfg machinery)."""

from __future__ import annotations

import copy
import sys
from typing import Callable, Dict, List, Tuple

import torch

IMAGENET_DEFAULT_MEAN = (0.485, 0.456, 0.406)
IMAGENET_DEFAULT_STD = (0.229, 0.224, 0.225)
IMAGENET_INCEPTION_MEAN = (0.5, 0.5, 0.5)
IMAGENET_INCEPTION_STD = (0.5, 0.5, 0.5)

_default_cfg_by_model: Dict[str, dict] = {}


def default_cfg(url: str = "", **kwargs) -> dict:
    """Data-config template shared by all model families
    (reference models/cotnet.py:21-29)."""
    cfg = {
        "url": url,
        "num_classes": 1000,
        "input_size": (3, 224, 224),
        "pool_size": (7, 7),
        "crop_pct": 0.875,
        "interpolation": "bicubic",
        "mean": IMAGENET_DEFAULT_MEAN,
        "std": IMAGENET_DEFAULT_STD,
        "first_conv": "conv1",
        "classifier": "fc",
    }
    cfg.update(kwargs)
    return cfg


def get_model_default_cfg(model_name: str) -> dict:
    """The data config of ``model_name``: the one it was last built with,
    else the one its module registered (``registry._model_default_cfgs``,
    filled at import), else the template."""
    if model_name in _default_cfg_by_model:
        return copy.deepcopy(_default_cfg_by_model[model_name])
    from cotnet_tpu_torch.models.registry import _model_default_cfgs

    return copy.deepcopy(_model_default_cfgs.get(model_name, default_cfg()))


def build_model_with_cfg(model_cls: Callable, model_name: str,
                         default_cfg: dict, **kwargs):
    """Construct the model module and record its data config.  Weights come
    from ``create_model``'s seeded initialization or a state_dict;
    ``pretrained`` is accepted and ignored, as in the JAX package."""
    _default_cfg_by_model[model_name] = copy.deepcopy(default_cfg)
    kwargs.pop("pretrained", None)
    return model_cls(**kwargs)


def register_variant_table(module_name: str, build: Callable,
                           table: Dict[str, dict]) -> None:
    """Register one entrypoint per row of ``table`` (the reference's
    near-identical per-variant ``def`` blocks, e.g. resnet.py:614+): each
    calls ``build(name, **row)`` with the caller's kwargs over the
    row's."""
    from cotnet_tpu_torch.models.registry import register_model

    mod = sys.modules[module_name]
    for name, row in table.items():
        def fn(pretrained=False, *, _name=name, _row=row, **kwargs):
            return build(_name, pretrained=pretrained,
                         **dict(_row, **kwargs))
        fn.__name__ = fn.__qualname__ = name
        fn.__module__ = module_name
        fn.__doc__ = f"{name} (an entrypoint of the variant table)"
        setattr(mod, name, fn)
        register_model(fn)


class _Features(torch.nn.Module):
    """``model.forward_features`` as a module's forward, for
    ``functional_call``."""

    def __init__(self, inner):
        super().__init__()
        self.inner = inner

    def forward(self, x):
        return self.inner.forward_features(x)


def meta_call(module, x):
    """``module(x)`` traced on the meta device in eval mode: the parameters
    and buffers are replaced by meta tensors for the call, so nothing is
    computed or allocated and the module is left as it is.  ``x`` is a
    meta tensor."""
    from torch.func import functional_call

    meta = {k: torch.empty_like(v, device="meta")
            for k, v in list(module.named_parameters())
            + list(module.named_buffers())}
    training = module.training
    module.eval()
    try:
        with torch.no_grad():
            return functional_call(module, meta, (x,))
    finally:
        module.train(training)


def feature_shapes(model, input_size: int = 224) -> List[Tuple[int, int, int]]:
    """``(channels, height, width)`` of each of ``model.forward_features``'s
    outputs for one ``input_size`` image (``meta_call``)."""
    x = torch.empty(1, 3, input_size, input_size, device="meta")
    return [tuple(int(d) for d in o.shape[1:])
            for o in meta_call(_Features(model), x)]


def get_feature_info(model, input_size: int = 224) -> List[dict]:
    """Per-stage feature metadata (reference models/features.py
    FeatureInfo): ``[{'num_chs', 'reduction'}]`` of the features at the
    model's ``out_indices``, as the JAX package's ``get_feature_info``
    derives them from its ``features_only`` outputs; from a meta-device
    shape trace (``feature_shapes``)."""
    shapes = feature_shapes(model, input_size)
    return [{"num_chs": shapes[i][0],
             "reduction": int(round(input_size / shapes[i][1]))}
            for i in model.out_indices]
