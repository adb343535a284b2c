"""Res2Net (reference models/res2net.py), counterpart of
``cotnet_tpu/models/res2net.py``: ``Bottle2neck`` on the chassis, whose
3x3 is ``scale - 1`` hierarchical 3x3s over ``scale`` channel splits.
Names are the reference's: ``conv1``, ``bn1``, ``convs.{i}``, ``bns.{i}``,
``conv3``, ``bn3``, ``se``, ``downsample``."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from cotnet_tpu_torch.models.helpers import (build_model_with_cfg,
                                             default_cfg,
                                             register_variant_table)
from cotnet_tpu_torch.models.resnet import ResNet
from cotnet_tpu_torch.nn import (BatchNorm2d, Conv2d, DropPath, avg_pool2d,
                                 create_attn, get_act_fn)

default_cfgs = {}


class Bottle2neck(nn.Module):
    """1x1 to ``width * scale`` (width ``floor(planes * base_width / 64) *
    cardinality``), split into ``scale`` parts; part ``i < scale - 1``
    goes through ``convs.{i}`` / ``bns.{i}`` / act, after the previous
    part's output is added to it except in a stage's first block (stride
    > 1 or a downsample), where each part stands alone; the last part
    passes as it is, 3x3 average-pooled at the stride (padding 1, the
    padding counted) in a strided block; then 1x1 to ``planes * 4``
    (reference res2net.py:24-107)."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: Optional[nn.Module] = None,
                 cardinality: int = 1, base_width: int = 26, scale: int = 4,
                 dilation: int = 1, first_dilation: Optional[int] = None,
                 act: str = "relu", attn_layer=None,
                 drop_path_rate: float = 0.0,
                 zero_init_last_bn: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        width = int(planes * (base_width / 64)) * cardinality
        outplanes = planes * self.expansion
        fd = first_dilation or dilation
        self.scale, self.width, self.stride = scale, width, stride
        self.is_first = stride > 1 or downsample is not None
        num_scales = max(1, scale - 1)
        self.act = get_act_fn(act)
        self.conv1 = Conv2d(inplanes, width * scale, 1, dtype=dtype)
        self.bn1 = BatchNorm2d(width * scale, dtype=dtype)
        self.convs = nn.ModuleList(
            Conv2d(width, width, 3, stride, fd, fd, groups=cardinality,
                   dtype=dtype) for _ in range(num_scales))
        self.bns = nn.ModuleList(BatchNorm2d(width, dtype=dtype)
                                 for _ in range(num_scales))
        self.conv3 = Conv2d(width * scale, outplanes, 1, dtype=dtype)
        self.bn3 = BatchNorm2d(outplanes, zero_init=zero_init_last_bn,
                               dtype=dtype)
        self.se = create_attn(attn_layer, outplanes, dtype=dtype)
        self.downsample = downsample
        self.drop_path = DropPath(drop_path_rate)

    def forward(self, x):
        y = self.act(self.bn1(self.conv1(x)))
        spx = torch.split(y, self.width, 1)
        outs = []
        sp = None
        for i, (conv, bn) in enumerate(zip(self.convs, self.bns)):
            sp = spx[i] if i == 0 or self.is_first else sp + spx[i]
            sp = self.act(bn(conv(sp)))
            outs.append(sp)
        if self.scale > 1:
            last = spx[-1]
            if self.is_first and self.stride > 1:
                last = avg_pool2d(last, 3, self.stride, padding=1)
            outs.append(last)
        y = self.bn3(self.conv3(torch.cat(outs, 1)))
        if self.se is not None:
            y = self.se(y)
        residual = x if self.downsample is None else self.downsample(x)
        return self.act(self.drop_path(y) + residual)


def _create_res2net(model_name: str, pretrained: bool = False, **kwargs):
    return build_model_with_cfg(ResNet, model_name, default_cfgs[model_name],
                                **kwargs)


def _r2(layers=(3, 4, 6, 3), base_width=26, scale=4, cardinality=1):
    return dict(block=Bottle2neck, layers=layers, base_width=base_width,
                cardinality=cardinality, block_args=dict(scale=scale))


# reference models/res2net.py:142-216
RES2NET_VARIANTS = {
    "res2net50_26w_4s": _r2(),
    "res2net101_26w_4s": _r2((3, 4, 23, 3)),
    "res2net50_26w_6s": _r2(scale=6),
    "res2net50_26w_8s": _r2(scale=8),
    "res2net50_48w_2s": _r2(base_width=48, scale=2),
    "res2net50_14w_8s": _r2(base_width=14, scale=8),
    "res2next50": _r2(base_width=4, cardinality=8),
}
for _name in RES2NET_VARIANTS:
    default_cfgs[_name] = default_cfg(interpolation="bilinear")

register_variant_table(__name__, _create_res2net, RES2NET_VARIANTS)
