"""PS-ResNet (reference models/psresnet.py), counterpart of
``cotnet_tpu/models/psresnet.py``: the chassis with ``PSBottleneck``,
whose 3x3 is a poly-scale convolution (``PSConv2d``).  Names are the
reference's: a block's ``conv2.gwconv``, ``conv2.gwconv_shift`` and
``conv2.conv``."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from cotnet_tpu_torch.models.helpers import (build_model_with_cfg,
                                             default_cfg,
                                             register_variant_table)
from cotnet_tpu_torch.models.resnet import ResNet
from cotnet_tpu_torch.nn import (BatchNorm2d, Conv2d, DropPath, create_attn,
                                 get_act_fn)

default_cfgs = {"psresnet50": default_cfg(),
                "psresnet50_32x4d": default_cfg()}


def ps_mask(in_channels: int, out_channels: int, parts: int) -> torch.Tensor:
    """``[O, I, 1, 1]``: 0 where the grouped convs already connect an
    output group to an input group (group ``i`` to ``i``, and to ``(i +
    parts // 2) % parts``, the half-rolled one), 1 elsewhere."""
    mask = torch.ones(out_channels, in_channels, 1, 1)
    ic, oc = in_channels // parts, out_channels // parts
    for i in range(parts):
        for j in (i, (i + parts // 2) % parts):
            mask[j * oc:(j + 1) * oc, i * ic:(i + 1) * ic] = 0
    return mask


class MaskedConv2d(Conv2d):
    """A dense conv whose weight is multiplied by ``ps_mask`` where it is
    used: the masked places add nothing and get a zero gradient, as the
    reference's gradient hook makes them (its ``mask``), and they start at
    zero.  The mask is a non-persistent buffer: not in the state_dict."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int, padding: int, parts: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dtype=dtype)
        self.register_buffer("mask", ps_mask(in_channels, out_channels, parts),
                             persistent=False)
        with torch.no_grad():
            self.weight.mul_(self.mask)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        super().reset_parameters(generator)
        if hasattr(self, "mask"):
            with torch.no_grad():
                self.weight.mul_(self.mask)

    def conv_weight(self):
        return self.weight * self.mask


class PSConv2d(nn.Module):
    """A grouped conv at dilation ``dilation`` (``gwconv``), the same on
    the channels rolled by half at twice the dilation (``gwconv_shift``),
    and the masked dense conv at ``padding`` without dilation (``conv``),
    summed (reference psresnet.py:28-52)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, padding: int = 1,
                 dilation: int = 1, parts: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        d = dilation
        self.gwconv = Conv2d(in_channels, out_channels, kernel_size, stride,
                             d, d, groups=parts, dtype=dtype)
        self.gwconv_shift = Conv2d(in_channels, out_channels, kernel_size,
                                   stride, 2 * d, 2 * d, groups=parts,
                                   dtype=dtype)
        self.conv = MaskedConv2d(in_channels, out_channels, kernel_size,
                                 stride, padding, parts, dtype=dtype)

    def forward(self, x):
        x1, x2 = x.chunk(2, dim=1)
        return (self.gwconv(x) + self.conv(x)
                + self.gwconv_shift(torch.cat([x2, x1], 1)))


class PSBottleneck(nn.Module):
    """1x1 -> ``PSConv2d`` 3x3 (at the block's stride and first dilation)
    -> 1x1, width ``floor(planes * base_width / 64) * cardinality``;
    ``attn_layer`` follows bn3 as ``se``."""

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
        width = int(planes * (base_width / 64)) * cardinality
        first_planes = width // reduce_first
        outplanes = planes * self.expansion
        fd = first_dilation or dilation
        self.act = get_act_fn(act)
        self.conv1 = Conv2d(inplanes, first_planes, 1, dtype=dtype)
        self.bn1 = BatchNorm2d(first_planes, dtype=dtype)
        self.conv2 = PSConv2d(first_planes, width, 3, stride, fd, fd,
                              dtype=dtype)
        self.bn2 = BatchNorm2d(width, dtype=dtype)
        self.conv3 = Conv2d(width, outplanes, 1, dtype=dtype)
        self.bn3 = BatchNorm2d(outplanes, zero_init=zero_init_last_bn,
                               dtype=dtype)
        self.se = create_attn(attn_layer, outplanes, dtype=dtype)
        self.downsample = downsample
        self.drop_path = DropPath(drop_path_rate)

    def forward(self, x):
        y = self.act(self.bn1(self.conv1(x)))
        y = self.act(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if self.se is not None:
            y = self.se(y)
        residual = x if self.downsample is None else self.downsample(x)
        return self.act(self.drop_path(y) + residual)


def _create_psresnet(model_name: str, pretrained: bool = False, **kwargs):
    return build_model_with_cfg(ResNet, model_name, default_cfgs[model_name],
                                **kwargs)


PSRESNET_VARIANTS = {
    "psresnet50": dict(block=PSBottleneck, layers=(3, 4, 6, 3)),
    "psresnet50_32x4d": dict(block=PSBottleneck, layers=(3, 4, 6, 3),
                             cardinality=32, base_width=4),
}

register_variant_table(__name__, _create_psresnet, PSRESNET_VARIANTS)
