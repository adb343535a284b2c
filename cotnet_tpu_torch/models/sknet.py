"""Selective-kernel networks (reference models/sknet.py), counterpart of
``cotnet_tpu/models/sknet.py``: the chassis with a ``SelectiveKernelConv``
in place of a block's first 3x3 (``SelectiveKernelBasic``) or its 3x3
(``SelectiveKernelBottleneck``).  The block's plain convs are
``ConvBnAct``s, so the names are the reference's: ``conv{i}.conv`` /
``conv{i}.bn`` for those, ``conv{i}.paths.{p}.conv`` / ``.bn`` and
``conv{i}.attn.fc_reduce`` / ``.bn`` / ``.fc_select`` for the SK conv, a
block's ``se`` and ``downsample``."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from cotnet_tpu_torch.models.helpers import (build_model_with_cfg,
                                             default_cfg,
                                             register_variant_table)
from cotnet_tpu_torch.models.resnet import ResNet
from cotnet_tpu_torch.nn import (ConvBnAct, DropPath, SelectiveKernelConv,
                                 create_attn, get_act_fn)

default_cfgs = {}


class SelectiveKernelBasic(nn.Module):
    """SK conv (at the block's stride and first dilation) -> 3x3
    ``ConvBnAct`` without act, its BN zero-initialized under
    ``zero_init_last_bn`` (reference sknet.py:15-61)."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: Optional[nn.Module] = None,
                 cardinality: int = 1, base_width: int = 64,
                 reduce_first: int = 1, dilation: int = 1,
                 first_dilation: Optional[int] = None, act: str = "relu",
                 attn_layer=None, drop_path_rate: float = 0.0,
                 zero_init_last_bn: bool = True,
                 sk_kwargs: Optional[dict] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if cardinality != 1 or base_width != 64:
            raise ValueError("SelectiveKernelBasic takes cardinality 1 and "
                             "base_width 64 only")
        first_planes = planes // reduce_first
        outplanes = planes * self.expansion
        self.act = get_act_fn(act)
        self.conv1 = SelectiveKernelConv(
            inplanes, first_planes, stride=stride,
            dilation=first_dilation or dilation, act=act, dtype=dtype,
            **(sk_kwargs or {}))
        self.conv2 = ConvBnAct(first_planes, outplanes, 3, 1, dilation,
                               dilation, act=None,
                               zero_init=zero_init_last_bn, dtype=dtype)
        self.se = create_attn(attn_layer, outplanes, dtype=dtype)
        self.downsample = downsample
        self.drop_path = DropPath(drop_path_rate)

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        if self.se is not None:
            y = self.se(y)
        residual = x if self.downsample is None else self.downsample(x)
        return self.act(self.drop_path(y) + residual)


class SelectiveKernelBottleneck(nn.Module):
    """1x1 ``ConvBnAct`` -> SK conv (grouped by ``cardinality``, at the
    block's stride and first dilation) -> 1x1 ``ConvBnAct`` without act,
    width ``floor(planes * base_width / 64) * cardinality`` (reference
    sknet.py:64-110)."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: Optional[nn.Module] = None,
                 cardinality: int = 1, base_width: int = 64,
                 reduce_first: int = 1, dilation: int = 1,
                 first_dilation: Optional[int] = None, act: str = "relu",
                 attn_layer=None, drop_path_rate: float = 0.0,
                 zero_init_last_bn: bool = True,
                 sk_kwargs: Optional[dict] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        width = int(planes * (base_width / 64)) * cardinality
        first_planes = width // reduce_first
        outplanes = planes * self.expansion
        self.act = get_act_fn(act)
        self.conv1 = ConvBnAct(inplanes, first_planes, 1, act=act,
                               dtype=dtype)
        self.conv2 = SelectiveKernelConv(
            first_planes, width, stride=stride,
            dilation=first_dilation or dilation, groups=cardinality,
            act=act, dtype=dtype, **(sk_kwargs or {}))
        self.conv3 = ConvBnAct(width, outplanes, 1, act=None,
                               zero_init=zero_init_last_bn, dtype=dtype)
        self.se = create_attn(attn_layer, outplanes, dtype=dtype)
        self.downsample = downsample
        self.drop_path = DropPath(drop_path_rate)

    def forward(self, x):
        y = self.conv3(self.conv2(self.conv1(x)))
        if self.se is not None:
            y = self.se(y)
        residual = x if self.downsample is None else self.downsample(x)
        return self.act(self.drop_path(y) + residual)


def _create_sknet(model_name: str, pretrained: bool = False, **kwargs):
    return build_model_with_cfg(ResNet, model_name, default_cfgs[model_name],
                                **kwargs)


_B, _N = SelectiveKernelBasic, SelectiveKernelBottleneck
_sk_small = dict(sk_kwargs=dict(min_attn_channels=16, attn_reduction=8,
                                split_input=True))
_sk_split = dict(sk_kwargs=dict(split_input=True))
# reference models/sknet.py:146-248
SKNET_VARIANTS = {
    "skresnet18": dict(block=_B, layers=(2, 2, 2, 2),
                       zero_init_last_bn=False, block_args=_sk_small),
    "skresnet34": dict(block=_B, layers=(3, 4, 6, 3),
                       zero_init_last_bn=False, block_args=_sk_small),
    "skresnet50": dict(block=_N, layers=(3, 4, 6, 3),
                       zero_init_last_bn=False, block_args=_sk_split),
    "skresnet50_zerobn": dict(block=_N, layers=(3, 4, 6, 3),
                              zero_init_last_bn=True, block_args=_sk_split),
    "skresnet50d": dict(block=_N, layers=(3, 4, 6, 3), stem_width=32,
                        stem_type="deep", avg_down=True,
                        zero_init_last_bn=False, block_args=_sk_split),
    "skresnext50_32x4d": dict(block=_N, layers=(3, 4, 6, 3), cardinality=32,
                              base_width=4, zero_init_last_bn=False),
    "skresnext50_32x4d_zerobn": dict(block=_N, layers=(3, 4, 6, 3),
                                     cardinality=32, base_width=4,
                                     zero_init_last_bn=True),
    "skresnext101_32x4d_zerobn": dict(block=_N, layers=(3, 4, 23, 3),
                                      cardinality=32, base_width=4,
                                      zero_init_last_bn=True),
}
for _name in SKNET_VARIANTS:
    default_cfgs[_name] = default_cfg(
        first_conv="conv1.0" if "50d" in _name else "conv1")

register_variant_table(__name__, _create_sknet, SKNET_VARIANTS)
