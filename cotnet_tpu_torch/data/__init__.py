"""The data pipeline, counterpart of ``cotnet_tpu/data``.

The names below load their module on first use, so that importing a host
module of this package (as the loader's worker processes do) imports no
torch.
"""

import importlib

_EXPORTS = {
    "Mixup": "mixup", "one_hot_smooth": "mixup",
    "Loader": "loader", "SyntheticLoader": "loader",
    "make_device_augment": "loader",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"),
                   name)
