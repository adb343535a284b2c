"""ResNetV2 / Big Transfer (reference models/resnetv2.py), counterpart of
``cotnet_tpu/models/resnetv2.py``.  Every row of the JAX package's
``RESNETV2_VARIANTS`` (22 registry keys) is registered here.

Pre-activation and non-preact bottlenecks with the family's conv / norm
pair: the BiT rows take weight-standardized convs (``StdConv2d``) with the
32-group ``GroupNorm``, the ``resnetv2_50/101/152[d/t]`` rows plain convs
with ``BatchNorm2d`` (global-batch statistics under a process group, as
every BN of the port).  Stem types ``''``, ``fixed`` (a zero pad of 1 and a
VALID 3/2 max-pool, BiT's approximation of SAME), ``same`` (TF-SAME convs
and pool, what the hybrid ViTs' backbones take), ``deep`` and ``tiered``
(three 3x3 convs).

Parameter names are timm's: ``stem.conv`` (``stem.norm`` without preact;
``stem.conv1``/``norm1`` ... ``conv3`` in the deep stems),
``stages.{s}.blocks.{b}.{norm1,conv1,...}``, ``downsample.conv`` (and
``downsample.norm`` without preact), the final ``norm`` and ``head.fc``.
The JAX package's converter looks the deep stems' up under other names
(``stem_c1.conv`` ...), which no timm file holds.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from cotnet_tpu_torch.models.helpers import (build_model_with_cfg,
                                             default_cfg,
                                             register_variant_table)
from cotnet_tpu_torch.nn import (BatchNorm2d, ClassifierHead, Conv2d,
                                 Dropout, GroupNorm, StdConv2d, avg_pool2d,
                                 max_pool2d, max_pool2d_same)

IMAGENET_INCEPTION_MEAN = (0.5, 0.5, 0.5)
IMAGENET_INCEPTION_STD = (0.5, 0.5, 0.5)

default_cfgs = {}  # filled beside the variant table below


class ConvFactory:
    """The family's conv and norm: ``StdConv2d`` (eps ``conv_eps``) or a
    plain ``Conv2d``; the 32-group ``GroupNorm`` (``"gn"``),
    ``BatchNorm2d`` (``"bn"``) or none (``"none"``); TF-SAME padding of
    every conv wider than 1x1 where ``same``."""

    def __init__(self, std_conv: bool = True, norm: str = "gn",
                 same: bool = False, conv_eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        if norm not in ("gn", "bn", "none"):
            raise ValueError(f"unknown norm {norm!r}")
        self.std_conv, self.norm_kind, self.same = std_conv, norm, same
        self.conv_eps, self.dtype = conv_eps, dtype

    def conv(self, cin: int, cout: int, k: int, stride: int = 1,
             padding: Optional[int] = None, groups: int = 1) -> nn.Module:
        if padding is None:
            padding = (k - 1) // 2
        if self.same and k > 1:
            padding = "same"
        if self.std_conv:
            return StdConv2d(cin, cout, k, stride, padding, groups=groups,
                             eps=self.conv_eps, dtype=self.dtype)
        return Conv2d(cin, cout, k, stride, padding, groups=groups,
                      dtype=self.dtype)

    def norm(self, channels: int) -> Optional[nn.Module]:
        if self.norm_kind == "gn":
            return GroupNorm(channels, 32, 1e-5, dtype=self.dtype)
        if self.norm_kind == "bn":
            return BatchNorm2d(channels, dtype=self.dtype)
        return None


def _norm_act(norm: Optional[nn.Module], x, act: bool = True):
    if norm is not None:
        x = norm(x)
    return F.relu(x) if act else x


class DownsampleConv(nn.Module):
    """The projection shortcut: with ``avg`` a 2x2 average pool
    (``ceil_mode``, padding not counted) where it strides and a 1x1 conv at
    stride 1, else the 1x1 conv at the stride; then the norm, without
    preact (``downsample.conv``, ``downsample.norm``)."""

    def __init__(self, f: ConvFactory, cin: int, cout: int, stride: int,
                 avg: bool, preact: bool):
        super().__init__()
        self.pool = avg and stride > 1
        self.stride = stride
        self.conv = f.conv(cin, cout, 1, 1 if avg else stride, 0)
        self.norm = None if preact else f.norm(cout)

    def forward(self, x):
        if self.pool:
            x = avg_pool2d(x, 2, self.stride, ceil_mode=True,
                           count_include_pad=False)
        return _norm_act(self.norm, self.conv(x), act=False)


class PreActBottleneck(nn.Module):
    """norm-act-conv three times, the shortcut off the pre-activated input
    (reference resnetv2.py:138-183, ``cotnet_tpu/models/resnetv2.py:
    78-133``)."""

    def __init__(self, f: ConvFactory, cin: int, cout: int, mid: int,
                 stride: int = 1, avg_down: bool = False):
        super().__init__()
        self.norm1 = f.norm(cin)
        self.conv1 = f.conv(cin, mid, 1, 1, 0)
        self.norm2 = f.norm(mid)
        self.conv2 = f.conv(mid, mid, 3, stride, 1)
        self.norm3 = f.norm(mid)
        self.conv3 = f.conv(mid, cout, 1, 1, 0)
        self.downsample = (DownsampleConv(f, cin, cout, stride, avg_down,
                                          preact=True)
                           if stride != 1 or cin != cout else None)

    def forward(self, x):
        y = _norm_act(self.norm1, x)
        shortcut = x if self.downsample is None else self.downsample(y)
        y = self.conv1(y)
        y = self.conv2(_norm_act(self.norm2, y))
        y = self.conv3(_norm_act(self.norm3, y))
        return y + shortcut


class Bottleneck(nn.Module):
    """The non-preact bottleneck: conv-norm-act twice, conv-norm, the
    residual add and the act (reference resnetv2.py:186-232,
    ``cotnet_tpu/models/resnetv2.py:136-175``)."""

    def __init__(self, f: ConvFactory, cin: int, cout: int, mid: int,
                 stride: int = 1, avg_down: bool = False):
        super().__init__()
        self.downsample = (DownsampleConv(f, cin, cout, stride, avg_down,
                                          preact=False)
                           if stride != 1 or cin != cout else None)
        self.conv1 = f.conv(cin, mid, 1, 1, 0)
        self.norm1 = f.norm(mid)
        self.conv2 = f.conv(mid, mid, 3, stride, 1)
        self.norm2 = f.norm(mid)
        self.conv3 = f.conv(mid, cout, 1, 1, 0)
        self.norm3 = f.norm(cout)

    def forward(self, x):
        shortcut = x if self.downsample is None else self.downsample(x)
        y = _norm_act(self.norm1, self.conv1(x))
        y = _norm_act(self.norm2, self.conv2(y))
        y = _norm_act(self.norm3, self.conv3(y), act=False)
        return F.relu(y + shortcut)


class Stem(nn.Module):
    """The stem and its pool (``cotnet_tpu/models/resnetv2.py:208-247``).
    The 7x7 stride-2 ``conv`` (TF-SAME in the ``same`` stem), with
    ``norm`` and the act where not ``preact``; or the deep and tiered
    stems' three 3x3 convs, the first at stride 2, each with its norm and
    act but the last's under ``preact``.  Then the ``fixed`` stem's zero
    pad of 1 and VALID 3/2 max-pool, the ``same`` stem's TF-SAME one, or a
    3/2 max-pool padded by 1."""

    def __init__(self, f: ConvFactory, in_chans: int, out_chs: int,
                 stem_type: str, preact: bool):
        super().__init__()
        self.stem_type = stem_type
        self.deep = stem_type in ("deep", "tiered")
        if self.deep:
            c1, c2 = ((3 * out_chs // 8, out_chs // 2)
                      if stem_type == "tiered" else (out_chs // 2,) * 2)
            self.conv1 = f.conv(in_chans, c1, 3, 2)
            self.norm1 = f.norm(c1)
            self.conv2 = f.conv(c1, c2, 3, 1)
            self.norm2 = f.norm(c2)
            self.conv3 = f.conv(c2, out_chs, 3, 1)
            self.norm3 = None if preact else f.norm(out_chs)
            self.act3 = not preact
        else:
            self.conv = f.conv(in_chans, out_chs, 7, 2)
            self.norm = None if preact else f.norm(out_chs)
            self.act = not preact

    def forward(self, x):
        if self.deep:
            x = _norm_act(self.norm1, self.conv1(x))
            x = _norm_act(self.norm2, self.conv2(x))
            x = _norm_act(self.norm3, self.conv3(x), act=self.act3)
        else:
            x = _norm_act(self.norm, self.conv(x), act=self.act)
        if "fixed" in self.stem_type:
            return max_pool2d(F.pad(x, (1, 1, 1, 1)), 3, 2)
        if "same" in self.stem_type:
            return max_pool2d_same(x, 3, 2)
        return max_pool2d(x, 3, 2, 1)


class ResNetV2(nn.Module):
    """``cotnet_tpu/models/resnetv2.py:178-287``: stem, four stages of
    bottlenecks (the first of each stage but the first at stride 2), with
    ``preact`` the final norm and act, the global average pool, dropout
    (``drop_rate``) and ``head.fc``.  ``features_only`` returns each
    stage's output and builds no final norm or head; ``conv_eps`` is the
    standardized convs' eps (1e-8 in the hybrid ViTs' backbones)."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3),
                 width_factor: int = 1, num_classes: int = 1000,
                 in_chans: int = 3, stem_type: str = "fixed",
                 preact: bool = True, std_conv: bool = True,
                 norm: str = "gn", avg_down: bool = False,
                 stem_chs: int = 64, drop_rate: float = 0.0,
                 conv_eps: float = 1e-5, features_only: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        wf = width_factor
        f = ConvFactory(std_conv, norm, "same" in stem_type, conv_eps, dtype)
        # the stem's convs pad TF-SAME only in the 'same' stem
        self.stem = Stem(f, in_chans, stem_chs * wf, stem_type, preact)
        block = PreActBottleneck if preact else Bottleneck
        self.features_only = features_only
        cin, ch = stem_chs * wf, 256
        stages = []
        for si, depth in enumerate(layers):
            blocks = []
            for bi in range(depth):
                blocks.append(block(f, cin, ch * wf, ch * wf // 4,
                                    2 if bi == 0 and si > 0 else 1,
                                    avg_down))
                cin = ch * wf
            stage = nn.Module()
            stage.blocks = nn.Sequential(*blocks)
            stages.append(stage)
            ch *= 2
        self.stages = nn.ModuleList(stages)
        self.num_features = cin
        self.norm = self.head = None
        self.drop = Dropout(drop_rate)
        if features_only:
            return
        if preact:
            self.norm = f.norm(cin)
        if num_classes > 0:
            self.head = nn.Module()
            self.head.fc = ClassifierHead(cin, num_classes, "avg", drop_rate,
                                          dtype=dtype)

    def forward(self, x):
        x = self.stem(x)
        feats = []
        for stage in self.stages:
            x = stage.blocks(x)
            feats.append(x)
        if self.features_only:
            return feats
        if self.norm is not None:
            x = F.relu(self.norm(x))
        if self.head is None:
            return self.drop(x.mean((2, 3)))
        return self.head.fc(x)


def _resnetv2(model_name, pretrained=False, **kwargs):
    """Build a row on ``ResNetV2`` (``pretrained`` is accepted and ignored:
    weights load through ``utils.convert``)."""
    return build_model_with_cfg(ResNetV2, model_name,
                                default_cfgs[model_name], **kwargs)


# BiT rows: layers and width factor; the _in21k rows 21843 classes
# (reference resnetv2.py:480-590)
def _bit(layers, wf, num_classes=1000):
    return dict(layers=layers, width_factor=wf, stem_type="fixed",
                num_classes=num_classes)


# BN rows: plain conv, BatchNorm, the torch-style stems (resnetv2.py:592-648)
def _bn(layers, stem_type="", avg_down=False):
    return dict(layers=layers, width_factor=1, stem_type=stem_type,
                std_conv=False, norm="bn", avg_down=avg_down)


RESNETV2_VARIANTS = {
    "resnetv2_50x1_bitm": _bit((3, 4, 6, 3), 1),
    "resnetv2_50x3_bitm": _bit((3, 4, 6, 3), 3),
    "resnetv2_101x1_bitm": _bit((3, 4, 23, 3), 1),
    "resnetv2_101x3_bitm": _bit((3, 4, 23, 3), 3),
    "resnetv2_152x2_bitm": _bit((3, 8, 36, 3), 2),
    "resnetv2_152x4_bitm": _bit((3, 8, 36, 3), 4),
    "resnetv2_50x1_bitm_in21k": _bit((3, 4, 6, 3), 1, 21843),
    "resnetv2_50x3_bitm_in21k": _bit((3, 4, 6, 3), 3, 21843),
    "resnetv2_101x1_bitm_in21k": _bit((3, 4, 23, 3), 1, 21843),
    "resnetv2_101x3_bitm_in21k": _bit((3, 4, 23, 3), 3, 21843),
    "resnetv2_152x2_bitm_in21k": _bit((3, 8, 36, 3), 2, 21843),
    "resnetv2_152x4_bitm_in21k": _bit((3, 8, 36, 3), 4, 21843),
    "resnetv2_50x1_bit_distilled": _bit((3, 4, 6, 3), 1),
    "resnetv2_152x2_bit_teacher": _bit((3, 8, 36, 3), 2),
    "resnetv2_152x2_bit_teacher_384": _bit((3, 8, 36, 3), 2),
    "resnetv2_50": _bn((3, 4, 6, 3)),
    "resnetv2_50d": _bn((3, 4, 6, 3), "deep", True),
    "resnetv2_50t": _bn((3, 4, 6, 3), "tiered", True),
    "resnetv2_101": _bn((3, 4, 23, 3)),
    "resnetv2_101d": _bn((3, 4, 23, 3), "deep", True),
    "resnetv2_152": _bn((3, 8, 36, 3)),
    "resnetv2_152d": _bn((3, 8, 36, 3), "deep", True),
}

for _name, _row in RESNETV2_VARIANTS.items():
    if "bit" in _name:
        _size = 384 if _name.endswith("_384") else (
            224 if _name.endswith(("_in21k", "distilled", "teacher")) else 448)
        default_cfgs[_name] = default_cfg(
            input_size=(3, _size, _size),
            crop_pct=1.0 if _size >= 384 else 0.875,
            num_classes=_row.get("num_classes", 1000),
            mean=IMAGENET_INCEPTION_MEAN, std=IMAGENET_INCEPTION_STD,
            first_conv="stem.conv", classifier="head.fc")
    else:
        default_cfgs[_name] = default_cfg(
            interpolation="bicubic", first_conv="stem.conv",
            classifier="head.fc")

register_variant_table(__name__, _resnetv2, RESNETV2_VARIANTS)
