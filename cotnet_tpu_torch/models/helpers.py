"""Model-construction helpers, counterpart of ``cotnet_tpu/models/helpers.py``
(reference models/helpers.py:311-357 and the default_cfg machinery)."""

from __future__ import annotations

import copy
import sys
from typing import Callable, Dict

IMAGENET_DEFAULT_MEAN = (0.485, 0.456, 0.406)
IMAGENET_DEFAULT_STD = (0.229, 0.224, 0.225)

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
    return copy.deepcopy(_default_cfg_by_model.get(model_name, default_cfg()))


def build_model_with_cfg(model_cls: Callable, model_name: str,
                         default_cfg: dict, **kwargs):
    """Construct the model module and record its data config.  Weights come
    from ``create_model``'s seeded initialization or a state_dict."""
    _default_cfg_by_model[model_name] = copy.deepcopy(default_cfg)
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
