"""ResNeSt (reference models/resnest.py), counterpart of
``cotnet_tpu/models/resnest.py``: ``ResNestBottleneck`` on the chassis,
its 3x3 a ``SplitAttnConv2d`` of radix 2 (4 in ``resnest50d_4s2x40d``, 1
in ``resnest50d_1s4x24d``), and the stride of a strided block taken by a
3x3 average pool (``avd``) after the split attention or, with
``avd_first``, before it.  Every row has the deep stem and the ResNet-D
shortcut (``avg_down``): its downsample keys are ``downsample.1``/``.2``
whatever the name says (``utils.convert.model_avg_down`` decides by the
name, and answers False for seven of the ten keys; take ``avg_down`` from
``RESNEST_VARIANTS``).  Names are the reference's: ``conv1``, ``bn1``,
``conv2`` (the split attention's ``conv``, ``bn0``, ``fc1``, ``bn1``,
``fc2``), ``conv3``, ``bn3``, ``downsample``."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from cotnet_tpu_torch.models.helpers import (build_model_with_cfg,
                                             default_cfg,
                                             register_variant_table)
from cotnet_tpu_torch.models.resnet import ResNet
from cotnet_tpu_torch.nn import (BatchNorm2d, Conv2d, DropPath,
                                 SplitAttnConv2d, avg_pool2d, get_act_fn)

default_cfgs = {}  # filled beside the variant table below


class ResNestBottleneck(nn.Module):
    """1x1 -> split-attention 3x3 (radix ``radix``, grouped by
    ``cardinality``; a plain 3x3 + ``bn2`` at radix 0) -> 1x1, width
    ``floor(planes * base_width / 64) * cardinality`` (reference
    resnest.py:20-106).  With ``avd`` a strided block runs its 3x3 at
    stride 1 and pools 3x3 at the stride (padding 1, the padding counted)
    after it, or before it with ``avd_first``."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: Optional[nn.Module] = None,
                 cardinality: int = 1, base_width: int = 64,
                 reduce_first: int = 1, dilation: int = 1,
                 first_dilation: Optional[int] = None, act: str = "relu",
                 radix: int = 2, avd: bool = True, avd_first: bool = False,
                 drop_path_rate: float = 0.0,
                 zero_init_last_bn: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        width = int(planes * (base_width / 64)) * cardinality
        first_planes = width // reduce_first
        outplanes = planes * self.expansion
        fd = first_dilation or dilation
        self.avd_stride = stride if avd and stride > 1 else 0
        self.avd_first = avd_first
        stride = 1 if self.avd_stride else stride
        self.act = get_act_fn(act)
        self.conv1 = Conv2d(inplanes, first_planes, 1, dtype=dtype)
        self.bn1 = BatchNorm2d(first_planes, dtype=dtype)
        if radix >= 1:
            self.conv2 = SplitAttnConv2d(first_planes, width, 3, stride, fd,
                                         fd, groups=cardinality, radix=radix,
                                         act=act, dtype=dtype)
            self.bn2 = None
        else:
            self.conv2 = Conv2d(first_planes, width, 3, stride, fd, fd,
                                groups=cardinality, dtype=dtype)
            self.bn2 = BatchNorm2d(width, dtype=dtype)
        self.conv3 = Conv2d(width, outplanes, 1, dtype=dtype)
        self.bn3 = BatchNorm2d(outplanes, zero_init=zero_init_last_bn,
                               dtype=dtype)
        self.downsample = downsample
        self.drop_path = DropPath(drop_path_rate)

    def _avd(self, y):
        return avg_pool2d(y, 3, self.avd_stride, padding=1)

    def forward(self, x):
        y = self.act(self.bn1(self.conv1(x)))
        if self.avd_stride and self.avd_first:
            y = self._avd(y)
        y = self.conv2(y)
        if self.bn2 is not None:
            y = self.act(self.bn2(y))
        if self.avd_stride and not self.avd_first:
            y = self._avd(y)
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return self.act(self.drop_path(y) + residual)


def _create_resnest(model_name: str, pretrained: bool = False, **kwargs):
    return build_model_with_cfg(ResNet, model_name, default_cfgs[model_name],
                                **kwargs)


def _nest(layers, stem_width=32, base_width=64, cardinality=1, radix=2,
          avd_first=False):
    return dict(block=ResNestBottleneck, layers=layers, stem_type="deep",
                stem_width=stem_width, avg_down=True, base_width=base_width,
                cardinality=cardinality,
                block_args=dict(radix=radix, avd=True, avd_first=avd_first))


# reference models/resnest.py:148-257
RESNEST_VARIANTS = {
    "resnest14d": _nest((1, 1, 1, 1)),
    "resnest26d": _nest((2, 2, 2, 2)),
    "resnest50d": _nest((3, 4, 6, 3)),
    "resnest101e": _nest((3, 4, 23, 3), stem_width=64),
    "resnest200e": _nest((3, 24, 36, 3), stem_width=64),
    "resnest269e": _nest((3, 30, 48, 8), stem_width=64),
    "resnest50d_4s2x40d": _nest((3, 4, 6, 3), base_width=40, cardinality=2,
                                radix=4, avd_first=True),
    "resnest50d_1s4x24d": _nest((3, 4, 6, 3), base_width=24, cardinality=4,
                                radix=1, avd_first=True),
    # the avd_first rows of the paper's models (resnest.py:239-257)
    "resnest50": _nest((3, 4, 6, 3), avd_first=True),
    "resnest101": _nest((3, 4, 23, 3), stem_width=64, avd_first=True),
}

_SIZES = {"resnest101e": 256, "resnest101": 256, "resnest200e": 320,
          "resnest269e": 416}
for _name in RESNEST_VARIANTS:
    _s = _SIZES.get(_name, 224)
    default_cfgs[_name] = default_cfg(
        first_conv="conv1.0", input_size=(3, _s, _s),
        pool_size=(_s // 32, _s // 32),
        crop_pct={320: 0.909, 416: 0.928}.get(_s, 0.875))

register_variant_table(__name__, _create_resnest, RESNEST_VARIANTS)
