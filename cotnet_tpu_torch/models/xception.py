"""Xception (reference models/xception.py), counterpart of
``cotnet_tpu/models/xception.py``: the entry, middle and exit flows of
depthwise-separable convs at 299 px.  Names are the reference's:
``conv1``/``bn1``, ``conv2``/``bn2``, ``block{n}`` with ``skip`` /
``skipbn`` and the ``rep`` Sequential of ``[ReLU,] SeparableConv2d, BN,
ReLU, SeparableConv2d, BN, ...[, MaxPool]`` (a separable conv's
``conv1`` depthwise and ``pointwise``; ``block1`` starts without the
ReLU, so its indices are one less), ``conv3``/``bn3``, ``conv4``/``bn4``
and ``fc``."""

from __future__ import annotations

import torch
from torch import nn

from cotnet_tpu_torch.models.helpers import (build_model_with_cfg,
                                             default_cfg,
                                             register_variant_table)
from cotnet_tpu_torch.nn import (BatchNorm2d, Conv2d, Dropout, Linear,
                                 relu)

default_cfgs = {
    "xception": default_cfg(input_size=(3, 299, 299), crop_pct=0.8975,
                            mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5),
                            first_conv="conv1", classifier="fc"),
}


class SeparableConv2d(nn.Module):
    """A depthwise ``kernel_size`` conv (``conv1``) and a 1x1 conv
    (``pointwise``), without BN."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv2d(in_channels, in_channels, kernel_size, stride,
                            groups=in_channels, dtype=dtype)
        self.pointwise = Conv2d(in_channels, out_channels, 1, dtype=dtype)

    def forward(self, x):
        return self.pointwise(self.conv1(x))


class XceptionBlock(nn.Module):
    """``reps`` (ReLU, separable 3x3, BN), the first ReLU left out unless
    ``start_with_relu``, the channels growing to ``out_channels`` at the
    first separable conv (``grow_first``) or the last; a 3x3 max-pool at
    the stride; plus the input, through a strided 1x1 conv and BN
    (``skip``/``skipbn``) where the stride or the channels change."""

    def __init__(self, in_channels: int, out_channels: int, reps: int,
                 stride: int = 1, start_with_relu: bool = True,
                 grow_first: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.skip = self.skipbn = None
        if out_channels != in_channels or stride != 1:
            self.skip = Conv2d(in_channels, out_channels, 1, stride, 0,
                               dtype=dtype)
            self.skipbn = BatchNorm2d(out_channels, dtype=dtype)
        rep, ch = [], in_channels
        for i in range(reps):
            if i > 0 or start_with_relu:
                rep.append(nn.ReLU())
            grow = (i == 0 and grow_first) or (i == reps - 1
                                               and not grow_first)
            out = out_channels if grow or ch == out_channels else ch
            rep += [SeparableConv2d(ch, out, 3, dtype=dtype),
                    BatchNorm2d(out, dtype=dtype)]
            ch = out
        if stride != 1:
            rep.append(nn.MaxPool2d(3, stride, 1))
        self.rep = nn.Sequential(*rep)

    def forward(self, x):
        skip = x if self.skip is None else self.skipbn(self.skip(x))
        return self.rep(x) + skip


class Xception(nn.Module):
    """The stem (3x3 stride-2 and 3x3 convs without padding, to 32 and 64
    channels, each with BN and ReLU), blocks 1-3 (128, 256, 728 channels,
    stride 2), eight middle blocks of 728 at stride 1, block 12 (to 1024,
    stride 2, growing last), separable convs to 1536 and 2048 with BN and
    ReLU, the pooled ``fc`` after dropout ``drop_rate``."""

    def __init__(self, num_classes: int = 1000, in_chans: int = 3,
                 drop_rate: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv2d(in_chans, 32, 3, 2, 0, dtype=dtype)
        self.bn1 = BatchNorm2d(32, dtype=dtype)
        self.conv2 = Conv2d(32, 64, 3, 1, 0, dtype=dtype)
        self.bn2 = BatchNorm2d(64, dtype=dtype)
        specs = [(64, 128, 2, 2, False, True), (128, 256, 2, 2, True, True),
                 (256, 728, 2, 2, True, True)]
        specs += [(728, 728, 3, 1, True, True)] * 8
        specs += [(728, 1024, 2, 2, True, False)]
        for n, spec in enumerate(specs):
            self.add_module(f"block{n + 1}", XceptionBlock(*spec,
                                                           dtype=dtype))
        self.num_blocks = len(specs)
        self.conv3 = SeparableConv2d(1024, 1536, 3, dtype=dtype)
        self.bn3 = BatchNorm2d(1536, dtype=dtype)
        self.conv4 = SeparableConv2d(1536, 2048, 3, dtype=dtype)
        self.bn4 = BatchNorm2d(2048, dtype=dtype)
        self.num_features = 2048
        self.drop = Dropout(drop_rate)
        self.fc = (Linear(2048, num_classes, dtype=dtype)
                   if num_classes > 0 else None)

    def forward(self, x):
        x = relu(self.bn1(self.conv1(x)))
        x = relu(self.bn2(self.conv2(x)))
        for n in range(1, self.num_blocks + 1):
            x = getattr(self, f"block{n}")(x)
        x = relu(self.bn3(self.conv3(x)))
        x = relu(self.bn4(self.conv4(x)))
        x = self.drop(x.mean((2, 3)))
        return x if self.fc is None else self.fc(x)


def _xception(model_name: str, pretrained: bool = False, **kwargs):
    return build_model_with_cfg(Xception, model_name,
                                default_cfgs[model_name], **kwargs)


register_variant_table(__name__, _xception, {"xception": {}})
