"""ReXNet (reference models/rexnet.py), counterpart of
``cotnet_tpu/models/rexnet.py``: linear-bottleneck inverted residuals
whose channels grow by a fixed step block after block, with an SE that
has a BN between its two 1x1 convs (SEWithNorm).  Names are the
reference's: ``stem.conv`` / ``stem.bn``, ``features.{i}`` with
``conv_exp``, ``conv_dw``, ``conv_pwl`` (each ``.conv`` / ``.bn``) and
``se`` (``fc1``, ``bn``, ``fc2``), the head ``ConvBnAct`` at
``features.{num_blocks}``, ``head.fc``."""

from __future__ import annotations

from math import ceil

import torch
from torch import nn

from cotnet_tpu_torch.models.helpers import (build_model_with_cfg,
                                             default_cfg,
                                             register_variant_table)
from cotnet_tpu_torch.nn import (ConvBnAct, Dropout, Linear, SEModule,
                                 get_act_fn)

default_cfgs = {}


class LinearBottleneck(nn.Module):
    """1x1 expansion to ``round(in * expand)`` with swish (none at
    ``expand`` 1), 3x3 depthwise at the stride, SE (``use_se``), relu6,
    1x1 to ``out_channels`` without act; where the stride is 1 and the
    channels do not shrink, the input is added onto the *first*
    ``in_channels`` output channels (reference rexnet.py:19-58)."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 expand: float = 6.0, use_se: bool = True,
                 se_reduction: int = 12, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.in_channels = in_channels
        self.use_shortcut = stride == 1 and in_channels <= out_channels
        mid = in_channels
        self.conv_exp = None
        if expand != 1.0:
            mid = int(round(in_channels * expand))
            self.conv_exp = ConvBnAct(in_channels, mid, 1, act="swish",
                                      dtype=dtype)
        self.conv_dw = ConvBnAct(mid, mid, 3, stride, 1, groups=mid,
                                 act=None, dtype=dtype)
        self.se = (SEModule(mid, reduction_channels=max(mid // se_reduction,
                                                        1),
                            norm=True, dtype=dtype) if use_se else None)
        self.act = get_act_fn("relu6")
        self.conv_pwl = ConvBnAct(mid, out_channels, 1, act=None,
                                  dtype=dtype)

    def forward(self, x):
        y = x if self.conv_exp is None else self.conv_exp(x)
        y = self.conv_dw(y)
        if self.se is not None:
            y = self.se(y)
        y = self.conv_pwl(self.act(y))
        if self.use_shortcut:
            # out of place: the BN's output is not written over
            c = self.in_channels
            y = torch.cat([y[:, :c] + x, y[:, c:]], 1)
        return y


def _make_divisible(v, divisor=8, min_value=None):
    min_value = min_value or divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class ReXNet(nn.Module):
    """The stem (3x3 stride-2 ``ConvBnAct``, swish), six stages of 1, 2,
    2, 3, 3, 5 blocks (times ``depth_mult``, ceiled) at strides 1, 2, 2,
    2, 1, 2 with SE from the third, block ``i`` of ``n`` widened to
    ``round((16 + 180 i / n) * width_mult)`` (``ch_div`` > 1 rounds every
    width to a multiple of it), the head ``ConvBnAct`` to ``1280 *
    width_mult`` with swish, the pooled ``head.fc`` after dropout
    ``drop_rate``.  ``features_only`` returns each stage's output and
    builds no head."""

    def __init__(self, width_mult: float = 1.0, depth_mult: float = 1.0,
                 ch_div: int = 1, num_classes: int = 1000, in_chans: int = 3,
                 drop_rate: float = 0.2, features_only: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.features_only = features_only
        layers = [ceil(n * depth_mult) for n in (1, 2, 2, 3, 3, 5)]
        strides = (1, 2, 2, 2, 1, 2)
        use_ses = (False, False, True, True, True, True)
        depth = sum(layers)
        stem_ch = int(round(32 * width_mult)) if width_mult >= 1 else 32
        if ch_div > 1:
            stem_ch = _make_divisible(stem_ch, ch_div)
        self.stem = ConvBnAct(in_chans, stem_ch, 3, 2, 1, act="swish",
                              dtype=dtype)
        # the base widths are renormalized only when shrinking the net
        # (reference rexnet.py:126)
        inplanes = 16 / width_mult if width_mult < 1.0 else 16.0
        blocks, self.stage_ends = [], []
        ch, idx = stem_ch, 0
        for n, s, use_se in zip(layers, strides, use_ses):
            for bi in range(n):
                out_ch = int(round((inplanes + idx * 180 / depth)
                                   * width_mult))
                if ch_div > 1:
                    out_ch = _make_divisible(out_ch, ch_div)
                blocks.append(LinearBottleneck(
                    ch, out_ch, s if bi == 0 else 1,
                    1.0 if idx == 0 else 6.0, use_se, dtype=dtype))
                ch, idx = out_ch, idx + 1
            self.stage_ends.append(idx)
        self.head = None
        if not features_only:
            pen = int(round(1280 * width_mult))
            if ch_div > 1:
                pen = _make_divisible(pen, ch_div)
            blocks.append(ConvBnAct(ch, pen, 1, act="swish", dtype=dtype))
            ch = pen
            self.head = nn.Module()
            self.head.drop = Dropout(drop_rate)
            self.head.fc = (Linear(ch, num_classes, dtype=dtype)
                            if num_classes > 0 else None)
        self.features = nn.Sequential(*blocks)
        self.num_features = ch

    def forward_features(self, x):
        """Each stage's output, in order."""
        x = self.stem(x)
        feats = []
        for i, block in enumerate(self.features[:self.stage_ends[-1]]):
            x = block(x)
            if i + 1 in self.stage_ends:
                feats.append(x)
        return feats

    def forward(self, x):
        feats = self.forward_features(x)
        if self.features_only:
            return feats
        x = self.head.drop(self.features[-1](feats[-1]).mean((2, 3)))
        return x if self.head.fc is None else self.head.fc(x)


def _rexnet(model_name: str, pretrained: bool = False, **kwargs):
    return build_model_with_cfg(ReXNet, model_name, default_cfgs[model_name],
                                **kwargs)


# reference models/rexnet.py:216-262; rexnetr_* round the widths to
# multiples of 8
REXNET_VARIANTS = {
    "rexnet_100": dict(width_mult=1.0),
    "rexnet_130": dict(width_mult=1.3),
    "rexnet_150": dict(width_mult=1.5),
    "rexnet_200": dict(width_mult=2.0),
    "rexnetr_100": dict(width_mult=1.0, ch_div=8),
    "rexnetr_130": dict(width_mult=1.3, ch_div=8),
    "rexnetr_150": dict(width_mult=1.5, ch_div=8),
    "rexnetr_200": dict(width_mult=2.0, ch_div=8),
}
for _name in REXNET_VARIANTS:
    default_cfgs[_name] = default_cfg(first_conv="stem.conv",
                                      classifier="head.fc")

register_variant_table(__name__, _rexnet, REXNET_VARIANTS)
