"""Split-attention conv (ResNeSt), counterpart of
``cotnet_tpu/nn/split_attn.py`` (reference models/layers/split_attn.py).

At radix 1 it is a conv followed by a sigmoid channel gate, the "SE" of
SE-CoTNetD; radix > 1 is the full ResNeSt block.  Module names are the
reference's (``conv``, ``bn0``, ``fc1``, ``bn1``, ``fc2``), so its
state_dicts load as they are.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from cotnet_tpu_torch.nn.activations import get_act_fn
from cotnet_tpu_torch.nn.conv import Conv2d
from cotnet_tpu_torch.nn.norm import BatchNorm2d


def radix_softmax(x, radix: int, cardinality: int):
    """``[N, R*C']`` gate logits -> gates (reference split_attn.py:14-28).
    The logits arrive cardinality-major (``[card, radix, c]``, the grouped
    conv's order) and the gates are used radix-major, hence the transpose;
    at radix 1 the gate is a sigmoid."""
    n = x.shape[0]
    if radix > 1:
        x = x.view(n, cardinality, radix, -1).softmax(dim=2)
        return x.transpose(1, 2).reshape(n, -1)
    return torch.sigmoid(x)


class SplitAttnConv2d(nn.Module):
    """``conv`` (groups * radix) + ``bn0`` + act, then the radix-softmax
    gate from the pooled features through the grouped 1x1 convs ``fc1``
    (with ``bn1`` on the pooled ``[N, C', 1, 1]`` tensor) and ``fc2``."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, padding: int = 0,
                 dilation: int = 1, groups: int = 1, radix: int = 2,
                 reduction_factor: int = 4, act: str = "relu",
                 use_bn: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.radix, self.groups, self.out_channels = radix, groups, \
            out_channels
        mid = out_channels * radix
        attn_chs = max(in_channels * radix // reduction_factor, 32)
        self.act = get_act_fn(act)
        self.conv = Conv2d(in_channels, mid, kernel_size, stride, padding,
                           dilation, groups * radix, dtype=dtype)
        self.bn0 = BatchNorm2d(mid, dtype=dtype) if use_bn else None
        self.fc1 = Conv2d(out_channels, attn_chs, 1, groups=groups, bias=True,
                          dtype=dtype)
        self.bn1 = BatchNorm2d(attn_chs, dtype=dtype) if use_bn else None
        self.fc2 = Conv2d(attn_chs, mid, 1, groups=groups, bias=True,
                          dtype=dtype)

    def forward(self, x, drop_block: Optional[nn.Module] = None):
        x = self.conv(x)
        if self.bn0 is not None:
            x = self.bn0(x)
        if drop_block is not None:
            x = drop_block(x)
        x = self.act(x)
        n, _, h, w = x.shape
        if self.radix > 1:
            # channels radix-major [radix, C'], the reference's reshape
            xr = x.view(n, self.radix, self.out_channels, h, w)
            gap = xr.sum(1)
        else:
            gap = x
        gap = self.fc1(gap.mean((2, 3), keepdim=True))
        if self.bn1 is not None:
            gap = self.bn1(gap)
        attn = self.fc2(self.act(gap)).view(n, -1)
        attn = radix_softmax(attn, self.radix, self.groups)
        if self.radix > 1:
            return (xr * attn.view(n, self.radix, self.out_channels, 1, 1)
                    ).sum(1)
        return x * attn.view(n, -1, 1, 1)
