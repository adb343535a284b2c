"""ResNet-DW (reference models/resnet_dw.py), counterpart of
``cotnet_tpu/models/resnet_dw.py``: a bottleneck whose 3x3 conv is a 1x1
conv, BN and activation followed by a depthwise 3x3, with the stride as an
avg-pool before them.  Its ``conv2`` is the reference's Sequential
``[pw, bn, act, dw]`` (``conv2.0``, ``conv2.1``, ``conv2.3``).  The
depthwise conv is ``F.conv2d`` (cuDNN on the card), as the JAX package's is
``lax.conv``: no Pallas kernel computes it."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from cotnet_tpu_torch.models.helpers import build_model_with_cfg, default_cfg
from cotnet_tpu_torch.models.registry import register_model
from cotnet_tpu_torch.models.resnet import Act, ResNet
from cotnet_tpu_torch.nn import (BatchNorm2d, Conv2d, DropPath, avg_pool2d,
                                 create_attn, get_act_fn)

default_cfgs = {"resnet50_dw": default_cfg()}


class DwBottleneck(nn.Module):
    """1x1 -> [avg-pool where it strides] -> 1x1 + BN + act + depthwise 3x3
    (at dilation ``first_dilation or dilation``) -> 1x1 (JAX
    ``resnet_dw.py:18-84``)."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: Optional[nn.Module] = None,
                 cardinality: int = 1, base_width: int = 64,
                 reduce_first: int = 1, dilation: int = 1,
                 first_dilation: Optional[int] = None, act: str = "relu",
                 attn_layer=None, drop_path_rate: float = 0.0,
                 zero_init_last_bn: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        width = int(math.floor(planes * (base_width / 64))) * cardinality
        first_planes = width // reduce_first
        outplanes = planes * self.expansion
        fd = first_dilation or dilation
        self.stride = stride
        self.act = get_act_fn(act)
        self.conv1 = Conv2d(inplanes, first_planes, 1, dtype=dtype)
        self.bn1 = BatchNorm2d(first_planes, dtype=dtype)
        self.conv2 = nn.Sequential(
            Conv2d(first_planes, width, 1, dtype=dtype),
            BatchNorm2d(width, dtype=dtype), Act(act),
            Conv2d(width, width, 3, 1, fd, fd, groups=width, dtype=dtype))
        self.bn2 = BatchNorm2d(width, dtype=dtype)
        self.conv3 = Conv2d(width, outplanes, 1, dtype=dtype)
        self.bn3 = BatchNorm2d(outplanes, zero_init=zero_init_last_bn,
                               dtype=dtype)
        self.se = create_attn(attn_layer, outplanes, dtype=dtype)
        self.downsample = downsample
        self.drop_path = DropPath(drop_path_rate)

    def forward(self, x):
        y = self.act(self.bn1(self.conv1(x)))
        if self.stride > 1:
            y = avg_pool2d(y, 3, 2, padding=1)
        y = self.act(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if self.se is not None:
            y = self.se(y)
        residual = x if self.downsample is None else self.downsample(x)
        return self.act(self.drop_path(y) + residual)


@register_model
def resnet50_dw(pretrained=False, **kwargs):
    return build_model_with_cfg(ResNet, "resnet50_dw",
                                default_cfgs["resnet50_dw"],
                                block=DwBottleneck,
                                **dict(dict(layers=(3, 4, 6, 3)), **kwargs))
