"""SE-CoTNetD — the hybrid family (reference models/cotnet_hybrid.py),
counterpart of ``cotnet_tpu/models/cotnet_hybrid.py``.

The hybrid bottleneck's middle layer is a radix-1 ``SplitAttnConv2d`` (a
3x3 conv with a sigmoid channel gate, the "SE") at widths 64 and 128 and in
the odd-indexed blocks of stage 3, and the CoT layer (``models/cotnet.py``)
in the even-indexed blocks of stage 3 and in all of stage 4 (reference
:138-157).  The chassis is ResNet-D: a deep stem, avg-down shortcuts, and
no stem pool, so every stage strides 2 (``ResNet(replace_stem_pool=True)``).
A strided block pools with a 3x3 avg-pool or, with ``aa``, a BlurPool:
before its middle layer with ``avd_first``, after it otherwise, so that
se_cotnetd_152's first CoT layer of stages 3 and 4 runs at the pre-pool map.

The CoT layers take the family's ``gn_fold_train`` and ``mega_fuse``
switches, as those of cotnet50 do.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from cotnet_tpu_torch.models.cotnet import CotLayer
from cotnet_tpu_torch.models.helpers import build_model_with_cfg, default_cfg
from cotnet_tpu_torch.models.registry import register_model
from cotnet_tpu_torch.models.resnet import ResNet
from cotnet_tpu_torch.nn import (
    BatchNorm2d,
    BlurPool2d,
    Conv2d,
    DropBlock2d,
    DropPath,
    SplitAttnConv2d,
    relu,
)

default_cfgs = {
    # input-size tiers (reference cotnet_hybrid.py:33-46)
    "se_cotnetd_50": default_cfg(first_conv="conv1.0"),
    "se_cotnetd_101": default_cfg(first_conv="conv1.0"),
    "se_cotnetd_152": default_cfg(
        input_size=(3, 256, 256), pool_size=(8, 8), crop_pct=0.888,
        first_conv="conv1.0"),
    "se_cotnetd_152_L": default_cfg(
        input_size=(3, 320, 320), pool_size=(10, 10), crop_pct=0.909,
        first_conv="conv1.0"),
    "se_cotnetd_200": default_cfg(
        input_size=(3, 256, 256), pool_size=(8, 8), crop_pct=0.888,
        first_conv="conv1.0"),
    "se_cotnetd_270": default_cfg(
        input_size=(3, 256, 256), pool_size=(8, 8), crop_pct=0.888,
        first_conv="conv1.0"),
}


class CotHybridBottleneck(nn.Module):
    """The reference's CoTBottleneck (cotnet_hybrid.py:118-202): 1x1 conv,
    BN, ReLU; the middle layer (split attention or CoT, by ``width``,
    ``block_idx``, ``conv_dim``, ``c4_dim`` and ``c4_idx``) with its
    stride as a pool (``avd``) before or after it; 1x1 conv and BN; the
    residual ReLU.  ``drop_block`` is ``(rate, block_size, gamma_scale)`` or
    None, applied after bn1 and bn3; ``drop_path_rate`` drops the whole
    residual branch per sample.  ``act`` is the chassis' and unused: the
    split attention takes swish whatever it is, as the JAX block and the
    reference do."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, block_idx: int = 0,
                 stride: int = 1, downsample: Optional[nn.Module] = None,
                 cardinality: int = 1, base_width: int = 64,
                 act: str = "swish", aa: bool = False, radix: int = 1,
                 avd: bool = False, avd_first: bool = True,
                 conv_dim: Sequence[int] = (), c4_dim: int = -1,
                 c4_idx: Sequence[int] = (),
                 drop_block: Optional[tuple] = None,
                 drop_path_rate: float = 0.0, zero_init_last_bn: bool = True,
                 impl: str = "auto", dtype: torch.dtype = torch.float32,
                 gn_fold_train: bool = False, mega_fuse: bool = False):
        super().__init__()
        width = int(math.floor(planes * (base_width / 64))) * cardinality
        outplanes = planes * self.expansion
        self.conv1 = Conv2d(inplanes, width, 1, dtype=dtype)
        self.bn1 = BatchNorm2d(width, dtype=dtype)
        self.split_attn = width in conv_dim or (
            width == c4_dim and block_idx not in c4_idx)
        if self.split_attn:
            # with avd the stride is the pool's, else the conv's
            pooled = stride > 1 and avd
            self.conv2 = SplitAttnConv2d(
                width, width, 3, 1 if pooled else stride, padding=1,
                groups=cardinality, radix=radix, reduction_factor=4,
                act="swish", dtype=dtype)
        else:
            pooled = stride > 1
            self.conv2 = CotLayer(width, 3, impl=impl, dtype=dtype,
                                  gn_fold_train=gn_fold_train,
                                  mega_fuse=mega_fuse)
        self.avd = None
        if pooled:
            self.avd = (BlurPool2d(width, stride=stride) if aa else
                        nn.AvgPool2d(3, stride, padding=1))
        self.avd_first = avd_first
        self.conv3 = Conv2d(width, outplanes, 1, dtype=dtype)
        self.bn3 = BatchNorm2d(outplanes, zero_init=zero_init_last_bn,
                               dtype=dtype)
        self.downsample = downsample
        self.drop_block = (nn.Identity() if drop_block is None
                           else DropBlock2d(*drop_block))
        self.drop_path = DropPath(drop_path_rate)

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        y = relu(self.drop_block(self.bn1(self.conv1(x))))
        if self.avd is not None and self.avd_first:
            y = self.avd(y)
        y = self.conv2(y)
        if self.avd is not None and not self.avd_first:
            y = self.avd(y)
        y = self.drop_block(self.bn3(self.conv3(y)))
        return relu(self.drop_path(y) + residual)


def _se_cotnetd(model_name: str, layers, stem_width: int, aa: bool,
                c4_blocks: int, avd: bool, avd_first: bool,
                gn_fold_train: bool = False, mega_fuse: bool = False,
                block_args: Optional[dict] = None, **kwargs):
    """The family's builder (JAX ``_se_cotnetd``): split attention at
    widths 64 and 128 and in the odd stage-3 blocks (``c4_idx`` holds the
    even ones, which take the CoT layer)."""
    block_args = dict(
        dict(radix=1, avd=avd, avd_first=avd_first, conv_dim=(64, 128),
             c4_dim=256, c4_idx=tuple(range(0, c4_blocks, 2)),
             gn_fold_train=gn_fold_train, mega_fuse=mega_fuse),
        **(block_args or {}))
    return build_model_with_cfg(
        ResNet, model_name, default_cfgs[model_name],
        block=CotHybridBottleneck, layers=layers, stem_type="deep",
        stem_width=stem_width, avg_down=True, replace_stem_pool=True,
        stem_act="relu", act="swish", aa_layer="blur" if aa else None,
        block_args=block_args, **kwargs)


@register_model
def se_cotnetd_50(**kwargs):
    return _se_cotnetd("se_cotnetd_50", (3, 4, 6, 3), stem_width=32,
                       aa=False, c4_blocks=6, avd=False, avd_first=True,
                       **kwargs)


@register_model
def se_cotnetd_101(**kwargs):
    return _se_cotnetd("se_cotnetd_101", (3, 4, 23, 3), stem_width=64,
                       aa=False, c4_blocks=23, avd=False, avd_first=True,
                       **kwargs)


@register_model
def se_cotnetd_152(**kwargs):
    return _se_cotnetd("se_cotnetd_152", (3, 8, 36, 3), stem_width=64,
                       aa=True, c4_blocks=36, avd=True, avd_first=False,
                       **kwargs)


@register_model
def se_cotnetd_152_L(**kwargs):
    return _se_cotnetd("se_cotnetd_152_L", (3, 8, 36, 3), stem_width=64,
                       aa=True, c4_blocks=36, avd=True, avd_first=False,
                       **kwargs)


@register_model
def se_cotnetd_200(**kwargs):
    return _se_cotnetd("se_cotnetd_200", (3, 24, 36, 3), stem_width=64,
                       aa=True, c4_blocks=36, avd=True, avd_first=False,
                       **kwargs)


@register_model
def se_cotnetd_270(**kwargs):
    return _se_cotnetd("se_cotnetd_270", (4, 29, 53, 4), stem_width=64,
                       aa=True, c4_blocks=53, avd=True, avd_first=False,
                       **kwargs)
