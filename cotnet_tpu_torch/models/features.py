"""Feature-extraction wrappers (reference models/features.py:20-284),
counterpart of ``cotnet_tpu/models/features.py``.

- ``features_only=True`` on the chassis returns the per-stage pyramid
  (index 0 the stride-2 stem feature, as the reference's FeatureInfo
  indexes it);
- ``FeatureListNet`` / ``FeatureDictNet`` wrap a model and return the
  features at ``out_indices`` as a list, or an OrderedDict keyed by the
  stage labels ``stage0`` ...  (the JAX package's keys), with their
  ``feature_info``; the model's ``forward_features`` computes them, so a
  model built with or without ``features_only`` can be wrapped;
- ``FeatureHookNet`` captures the output of any submodule by its dotted
  name (``"layer2.0"``, ``"fc"``) through forward hooks, the torch form of
  the JAX package's ``capture_intermediates``.

``feature_info`` comes from a shape trace of the features on the meta
device (``helpers.feature_shapes``): nothing is computed or allocated.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Sequence

from torch import nn

from cotnet_tpu_torch.models.helpers import feature_shapes

__all__ = ["FeatureInfo", "FeatureListNet", "FeatureDictNet",
           "FeatureHookNet", "build_feature_net"]


class FeatureInfo:
    """Indexed feature metadata (reference features.py:20-80)."""

    def __init__(self, info: Sequence[dict], out_indices=None):
        self.info = list(info)
        self.out_indices = tuple(
            out_indices if out_indices is not None else range(len(info)))
        for i in self.out_indices:
            if not 0 <= i < len(self.info):
                raise ValueError(f"out_index {i} out of range")

    def from_other(self, out_indices: Sequence[int]) -> "FeatureInfo":
        return FeatureInfo(self.info, out_indices)

    def get(self, key: str, idx=None):
        if idx is None:
            return [self.info[i][key] for i in self.out_indices]
        if isinstance(idx, (tuple, list)):
            return [self.info[i][key] for i in idx]
        return self.info[idx][key]

    def channels(self, idx=None):
        return self.get("num_chs", idx)

    def reduction(self, idx=None):
        return self.get("reduction", idx)

    def module_name(self, idx=None):
        return self.get("module", idx)

    def get_dicts(self, keys=None, idx=None):
        idxs = (self.out_indices if idx is None
                else (idx if isinstance(idx, (tuple, list)) else [idx]))
        if keys is None:
            return [self.info[i] for i in idxs]
        return [{k: self.info[i][k] for k in keys} for i in idxs]

    def __len__(self):
        return len(self.out_indices)


def _trace_info(model, input_size: int) -> list:
    return [{"num_chs": c, "reduction": int(round(input_size / h)),
             "module": f"stage{i}"}
            for i, (c, h, _) in enumerate(feature_shapes(model, input_size))]


class FeatureListNet(nn.Module):
    """Features as a list (reference FeatureListNet, features.py:218-232):
    the wrapped model's features at ``out_indices``, clamped to those it
    emits."""

    def __init__(self, model: nn.Module,
                 out_indices: Sequence[int] = (0, 1, 2, 3, 4),
                 input_size: int = 224):
        super().__init__()
        self.model = model
        info = _trace_info(model, input_size)
        self.out_indices = tuple(i for i in out_indices if i < len(info))
        self.feature_info = FeatureInfo(info, self.out_indices)

    def forward(self, x):
        return self._select(self.model.forward_features(x))

    def _select(self, feats):
        return [feats[i] for i in self.out_indices]


class FeatureDictNet(FeatureListNet):
    """Features as an OrderedDict (reference FeatureDictNet,
    features.py:153-215), keyed by the feature_info module labels."""

    def _select(self, feats):
        names = self.feature_info.module_name()
        return OrderedDict((n, feats[i])
                           for n, i in zip(names, self.out_indices))


class FeatureHookNet(nn.Module):
    """Hook-style extraction (reference FeatureHookNet, features.py:235-284):
    the output of each submodule named in ``module_paths`` (dotted names of
    ``named_modules``; the last call's output for a module called twice).
    ``forward`` returns ``(OrderedDict {path: output}, the model's
    output)``."""

    def __init__(self, model: nn.Module, module_paths: Sequence[str]):
        super().__init__()
        self.model = model
        self.module_paths = list(module_paths)
        modules = dict(model.named_modules())
        missing = [p for p in self.module_paths if p not in modules]
        if missing:
            raise KeyError(f"no submodules {missing}")

    def forward(self, x):
        modules = dict(self.model.named_modules())
        captured = {}
        handles = [modules[p].register_forward_hook(
            lambda _m, _in, out, p=p: captured.__setitem__(p, out))
            for p in self.module_paths]
        try:
            out = self.model(x)
        finally:
            for h in handles:
                h.remove()
        return OrderedDict((p, captured[p]) for p in self.module_paths
                           if p in captured), out


def build_feature_net(model: nn.Module, feature_cls: str = "list",
                      out_indices: Sequence[int] = (0, 1, 2, 3, 4),
                      input_size: int = 224):
    """feature_cfg dispatch (reference helpers.py:345-355 feature wrap)."""
    cls = {"list": FeatureListNet, "dict": FeatureDictNet}.get(feature_cls)
    if cls is None:
        raise ValueError(f"unknown feature_cls {feature_cls!r}; "
                         "use FeatureHookNet directly for hook extraction")
    return cls(model, out_indices=out_indices, input_size=input_size)
