"""RegNet X/Y (reference models/regnet.py), counterpart of
``cotnet_tpu/models/regnet.py``.

Each key's stage widths, depths and group widths come from its published
design-space parameters ``(w0, wa, wm, group_w, depth, se_ratio)`` by the
reference's quantize-and-adjust rule (``_stage_cfg``, bottleneck ratio 1,
widths to multiples of 8), a copy of the JAX module's table and rule.
Names are the reference's: ``stem.conv`` / ``stem.bn``, ``s{i}.b{j}``
with ``conv1``..``conv3`` (each ``.conv`` / ``.bn``), the Y keys' ``se``
(``fc1``/``fc2``) and ``downsample.conv`` / ``.bn``, and ``head.fc``.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Sequence

import numpy as np
import torch
from torch import nn

from cotnet_tpu_torch.models.helpers import (build_model_with_cfg,
                                             default_cfg,
                                             register_variant_table)
from cotnet_tpu_torch.nn import ConvBnAct, Dropout, Linear, SEModule, relu

# design-space parameters (w0, wa, wm, group_w, depth, se_ratio)
# (reference regnet.py:17-43); se_ratio 0.25 for Y
_PARAMS = {
    "regnetx_002": (24, 36.44, 2.49, 8, 13, 0.0),
    "regnetx_004": (24, 24.48, 2.54, 16, 22, 0.0),
    "regnetx_006": (48, 36.97, 2.24, 24, 16, 0.0),
    "regnetx_008": (56, 35.73, 2.28, 16, 16, 0.0),
    "regnetx_016": (80, 34.01, 2.25, 24, 18, 0.0),
    "regnetx_032": (88, 26.31, 2.25, 48, 25, 0.0),
    "regnetx_040": (96, 38.65, 2.43, 40, 23, 0.0),
    "regnetx_064": (184, 60.83, 2.07, 56, 17, 0.0),
    "regnetx_080": (80, 49.56, 2.88, 120, 23, 0.0),
    "regnetx_120": (168, 73.36, 2.37, 112, 19, 0.0),
    "regnetx_160": (216, 55.59, 2.1, 128, 22, 0.0),
    "regnetx_320": (320, 69.86, 2.0, 168, 23, 0.0),
    "regnety_002": (24, 36.44, 2.49, 8, 13, 0.25),
    "regnety_004": (48, 27.89, 2.09, 8, 16, 0.25),
    "regnety_006": (48, 32.54, 2.32, 16, 15, 0.25),
    "regnety_008": (56, 38.84, 2.4, 16, 14, 0.25),
    "regnety_016": (48, 20.71, 2.65, 24, 27, 0.25),
    "regnety_032": (80, 42.63, 2.66, 24, 21, 0.25),
    "regnety_040": (96, 31.41, 2.24, 64, 22, 0.25),
    "regnety_064": (112, 33.22, 2.27, 72, 25, 0.25),
    "regnety_080": (192, 76.82, 2.19, 56, 17, 0.25),
    "regnety_120": (168, 73.36, 2.37, 112, 19, 0.25),
    "regnety_160": (200, 106.23, 2.48, 112, 18, 0.25),
    "regnety_320": (232, 115.89, 2.53, 232, 20, 0.25),
}

default_cfgs = {name: default_cfg(first_conv="stem.conv",
                                  classifier="head.fc")
                for name in _PARAMS}


def _stage_cfg(w0: int, wa: float, wm: float, group_w: int, depth: int):
    """Per-block widths -> (stage widths, depths, per-stage group widths)
    (reference generate_regnet regnet.py:100-110 and
    adjust_widths_groups_comp :90-96, bottleneck ratio 1, q = 8)."""
    widths_cont = np.arange(depth) * wa + w0
    width_exps = np.round(np.log(widths_cont / w0) / np.log(wm))
    widths = (np.round(w0 * np.power(wm, width_exps) / 8) * 8).astype(int)
    sw, sd = [], []
    for w in widths.tolist():
        if sw and sw[-1] == w:
            sd[-1] += 1
        else:
            sw.append(w)
            sd.append(1)
    groups = [min(group_w, w) for w in sw]
    sw = [int(round(w / g) * g) for w, g in zip(sw, groups)]
    return tuple(sw), tuple(sd), tuple(groups)


class RegBottleneck(nn.Module):
    """1x1 -> 3x3 grouped by ``width // group_width`` at the stride -> the
    SE (Y keys; its reduction sized by the block's *input* channels) ->
    1x1, with a strided 1x1 ``ConvBnAct`` shortcut where the stride or the
    width changes (reference regnet.py:112-152)."""

    def __init__(self, in_channels: int, width: int, stride: int = 1,
                 group_width: int = 24, se_ratio: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = ConvBnAct(in_channels, width, 1, dtype=dtype)
        self.conv2 = ConvBnAct(width, width, 3, stride, 1,
                               groups=width // group_width, dtype=dtype)
        self.se = (SEModule(width,
                            reduction_channels=int(round(in_channels
                                                         * se_ratio)),
                            dtype=dtype) if se_ratio else None)
        self.conv3 = ConvBnAct(width, width, 1, act=None, dtype=dtype)
        self.downsample = (ConvBnAct(in_channels, width, 1, stride, 0,
                                     act=None, dtype=dtype)
                           if stride != 1 or in_channels != width else None)

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        if self.se is not None:
            y = self.se(y)
        y = self.conv3(y)
        return relu(y + (x if self.downsample is None
                         else self.downsample(x)))


class RegNet(nn.Module):
    """The stem (a 3x3 stride-2 ``ConvBnAct`` to ``stem_width``), the
    stages ``s1``..``s4`` of ``RegBottleneck``s (the first of each at
    stride 2), the pooled classifier ``head.fc``; ``features_only``
    returns each stage's output and builds no head."""

    def __init__(self, widths: Sequence[int] = (72, 168, 408, 912),
                 depths: Sequence[int] = (2, 4, 10, 2),
                 group_widths: Sequence[int] = (24, 24, 24, 24),
                 se_ratio: float = 0.0, stem_width: int = 32,
                 num_classes: int = 1000, in_chans: int = 3,
                 drop_rate: float = 0.0, features_only: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.features_only = features_only
        self.stem = ConvBnAct(in_chans, stem_width, 3, 2, 1, dtype=dtype)
        ch = stem_width
        self.num_stages = len(widths)
        for si, (w, d, g) in enumerate(zip(widths, depths, group_widths)):
            blocks = []
            for bi in range(d):
                blocks.append((f"b{bi + 1}", RegBottleneck(
                    ch, w, 2 if bi == 0 else 1, g, se_ratio, dtype)))
                ch = w
            self.add_module(f"s{si + 1}", nn.Sequential(OrderedDict(blocks)))
        self.num_features = ch
        self.head = None
        if not features_only:
            self.head = nn.Module()
            self.head.drop = Dropout(drop_rate)
            self.head.fc = (Linear(ch, num_classes, dtype=dtype)
                            if num_classes > 0 else None)

    def forward_features(self, x):
        """Each stage's output, in order."""
        x = self.stem(x)
        feats = []
        for i in range(1, self.num_stages + 1):
            x = getattr(self, f"s{i}")(x)
            feats.append(x)
        return feats

    def forward(self, x):
        feats = self.forward_features(x)
        if self.features_only:
            return feats
        x = self.head.drop(feats[-1].mean((2, 3)))
        return x if self.head.fc is None else self.head.fc(x)


def _regnet(model_name: str, pretrained: bool = False, **kwargs):
    w0, wa, wm, group_w, depth, se_ratio = _PARAMS[model_name]
    widths, depths, groups = _stage_cfg(w0, wa, wm, group_w, depth)
    return build_model_with_cfg(
        RegNet, model_name, default_cfgs[model_name], widths=widths,
        depths=depths, group_widths=groups, se_ratio=se_ratio, **kwargs)


register_variant_table(__name__, _regnet, {name: {} for name in _PARAMS})
