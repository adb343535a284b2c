"""DenseNet (reference models/densenet.py), counterpart of
``cotnet_tpu/models/densenet.py``.  Names are the reference's, under
``features``: the stem's ``conv0`` / ``norm0`` (and ``conv1`` / ``norm1``
/ ``conv2`` / ``norm2`` in the deep stem), ``denseblock{i}.denselayer{j}``
(``norm1``, ``conv1``, ``norm2``, ``conv2``), ``transition{i}`` (``norm``,
``conv``) and ``norm5``; then ``classifier``.  ``densenetblur121d`` blurs
its stem pool (BlurPool, no parameters); ``densenet264d_iabn`` stands in
for the reference's Inplace-ABN with BN and ``leaky_relu`` (slope 0.01),
as the JAX package does (``cotnet_tpu/models/densenet.py:113-127``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from cotnet_tpu_torch.models.helpers import (build_model_with_cfg,
                                             default_cfg,
                                             register_variant_table)
from cotnet_tpu_torch.nn import (BatchNorm2d, BlurPool2d, Conv2d, Dropout,
                                 Linear, avg_pool2d, get_act_fn, max_pool2d)

default_cfgs = {}


class DenseLayer(nn.Module):
    """BN, act, 1x1 conv to ``bn_size * growth_rate``, BN, act, 3x3 conv
    to ``growth_rate``; the output is the input with the new channels
    appended."""

    def __init__(self, in_channels: int, growth_rate: int, bn_size: int = 4,
                 act: str = "relu", dtype: torch.dtype = torch.float32):
        super().__init__()
        mid = bn_size * growth_rate
        self.act = get_act_fn(act)
        self.norm1 = BatchNorm2d(in_channels, dtype=dtype)
        self.conv1 = Conv2d(in_channels, mid, 1, dtype=dtype)
        self.norm2 = BatchNorm2d(mid, dtype=dtype)
        self.conv2 = Conv2d(mid, growth_rate, 3, 1, 1, dtype=dtype)

    def forward(self, x):
        y = self.conv1(self.act(self.norm1(x)))
        y = self.conv2(self.act(self.norm2(y)))
        return torch.cat([x, y], 1)


class DenseNet(nn.Module):
    """The stem (a 7x7 stride-2 conv, or with ``stem_type="deep"`` three
    3x3s, the first at stride 2; each with BN and act), a 3x3 stride-2
    max-pool (a stride-1 one and a BlurPool with ``aa_layer="blur"``), the
    dense blocks with a transition (BN, act, 1x1 conv halving the
    channels, 2x2 average pool) between each two, ``norm5`` and act, the
    pooled ``classifier``.  ``features_only`` returns each block's output
    and builds neither ``norm5`` nor the classifier."""

    def __init__(self, growth_rate: int = 32,
                 block_config: Sequence[int] = (6, 12, 24, 16),
                 stem_width: int = 64, stem_type: str = "",
                 aa_layer: Optional[str] = None, act: str = "relu",
                 num_classes: int = 1000, in_chans: int = 3,
                 drop_rate: float = 0.0, features_only: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if aa_layer not in (None, "blur"):
            raise NotImplementedError(f"aa_layer {aa_layer!r} is not ported")
        self.act = get_act_fn(act)
        self.stem_type, self.features_only = stem_type, features_only
        self.block_config = tuple(block_config)
        f = self.features = nn.ModuleDict()
        if stem_type == "deep":
            w = stem_width // 2
            f["conv0"] = Conv2d(in_chans, w, 3, 2, 1, dtype=dtype)
            f["norm0"] = BatchNorm2d(w, dtype=dtype)
            f["conv1"] = Conv2d(w, w, 3, 1, 1, dtype=dtype)
            f["norm1"] = BatchNorm2d(w, dtype=dtype)
            f["conv2"] = Conv2d(w, stem_width, 3, 1, 1, dtype=dtype)
            f["norm2"] = BatchNorm2d(stem_width, dtype=dtype)
        else:
            f["conv0"] = Conv2d(in_chans, stem_width, 7, 2, 3, dtype=dtype)
            f["norm0"] = BatchNorm2d(stem_width, dtype=dtype)
        self.stem_aa = BlurPool2d(stride=2) if aa_layer else None
        ch = stem_width
        for bi, n_layers in enumerate(self.block_config):
            block = nn.Module()
            for li in range(n_layers):
                block.add_module(f"denselayer{li + 1}", DenseLayer(
                    ch, growth_rate, act=act, dtype=dtype))
                ch += growth_rate
            f[f"denseblock{bi + 1}"] = block
            if bi != len(self.block_config) - 1:
                trans = nn.Module()
                trans.norm = BatchNorm2d(ch, dtype=dtype)
                trans.conv = Conv2d(ch, ch // 2, 1, dtype=dtype)
                f[f"transition{bi + 1}"] = trans
                ch //= 2
        self.num_features = ch
        self.classifier = None
        if not features_only:
            f["norm5"] = BatchNorm2d(ch, dtype=dtype)
            self.drop = Dropout(drop_rate)
            self.classifier = (Linear(ch, num_classes, dtype=dtype)
                               if num_classes > 0 else None)

    def forward_features(self, x):
        """Each dense block's output, in order."""
        f, act = self.features, self.act
        x = act(f["norm0"](f["conv0"](x)))
        if self.stem_type == "deep":
            x = act(f["norm1"](f["conv1"](x)))
            x = act(f["norm2"](f["conv2"](x)))
        if self.stem_aa is not None:
            x = self.stem_aa(max_pool2d(x, 3, 1, 1))
        else:
            x = max_pool2d(x, 3, 2, 1)
        feats = []
        for bi in range(len(self.block_config)):
            for layer in f[f"denseblock{bi + 1}"].children():
                x = layer(x)
            feats.append(x)
            if bi != len(self.block_config) - 1:
                trans = f[f"transition{bi + 1}"]
                x = avg_pool2d(trans.conv(act(trans.norm(x))), 2, 2)
        return feats

    def forward(self, x):
        feats = self.forward_features(x)
        if self.features_only:
            return feats
        x = self.drop(self.act(self.features["norm5"](feats[-1])).mean((2, 3)))
        return x if self.classifier is None else self.classifier(x)


def _densenet(model_name: str, pretrained: bool = False, **kwargs):
    return build_model_with_cfg(DenseNet, model_name,
                                default_cfgs[model_name], **kwargs)


# reference models/densenet.py:288-380
DENSENET_VARIANTS = {
    "densenet121": dict(growth_rate=32, block_config=(6, 12, 24, 16)),
    "densenetblur121d": dict(growth_rate=32, block_config=(6, 12, 24, 16),
                             stem_type="deep", aa_layer="blur"),
    "densenet121d": dict(growth_rate=32, block_config=(6, 12, 24, 16),
                         stem_type="deep"),
    "densenet169": dict(growth_rate=32, block_config=(6, 12, 32, 32)),
    "densenet201": dict(growth_rate=32, block_config=(6, 12, 48, 32)),
    "densenet161": dict(growth_rate=48, block_config=(6, 12, 36, 24),
                        stem_width=96),
    "densenet264": dict(growth_rate=48, block_config=(6, 12, 64, 48),
                        stem_width=96),
    "densenet264d_iabn": dict(growth_rate=48, block_config=(6, 12, 64, 48),
                              stem_width=96, stem_type="deep",
                              act="leaky_relu"),
    "tv_densenet121": dict(growth_rate=32, block_config=(6, 12, 24, 16)),
}
for _name in DENSENET_VARIANTS:
    default_cfgs[_name] = default_cfg(interpolation="bicubic",
                                      first_conv="features.conv0",
                                      classifier="classifier")

register_variant_table(__name__, _densenet, DENSENET_VARIANTS)
