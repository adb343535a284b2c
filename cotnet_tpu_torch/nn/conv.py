"""Convolution (NCHW, OIHW weights), counterpart of ``cotnet_tpu/nn/conv.py``.

The weight is float32 and cast to the module's compute dtype at use, as
flax's ``Conv(dtype=...)`` does; the initialization is the reference's
``kaiming_normal_(mode='fan_out', nonlinearity='relu')``.  ``padding="same"``
pads TF-SAME (``pad_same``) at each call; ``StdConv2d`` standardizes its
weight first.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def to_2tuple(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def get_padding(kernel_size: int, stride: int = 1, dilation: int = 1) -> int:
    """Symmetric 'same-ish' int padding (reference layers/padding.py:9-11)."""
    return ((stride - 1) + dilation * (kernel_size - 1)) // 2


def pad_same(x, kernel_size, stride, dilation=(1, 1), value: float = 0.0):
    """TF-SAME asymmetric padding of NCHW ``x`` (reference
    conv2d_same.py:14-25, ``cotnet_tpu/nn/conv.py:35-50``): per side the
    total ``max((ceil(size/s) - 1)*s + (k - 1)*d + 1 - size, 0)``, its
    smaller half before and the rest after, filled with ``value``."""
    pads = []
    for size, k, s, d in zip(x.shape[2:], to_2tuple(kernel_size),
                             to_2tuple(stride), to_2tuple(dilation)):
        pad = max((-(size // -s) - 1) * s + (k - 1) * d + 1 - size, 0)
        pads.append((pad // 2, pad - pad // 2))
    (top, bottom), (left, right) = pads
    if not (top or bottom or left or right):
        return x
    return F.pad(x, (left, right, top, bottom), value=value)


class Conv2d(nn.Module):
    """``F.conv2d`` with torch-style default padding (or ``"same"``: TF-SAME
    by the input's size), groups and an optional bias; parameters
    ``weight`` ``[O, I/groups, kh, kw]`` and ``bias``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size=1,
                 stride=1, padding=None, dilation=1, groups: int = 1,
                 bias: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        ks, st, di = to_2tuple(kernel_size), to_2tuple(stride), \
            to_2tuple(dilation)
        self.same = padding == "same"
        if self.same:
            padding = 0
        elif padding is None:
            padding = tuple(get_padding(k, s, d) for k, s, d in zip(ks, st, di))
        self.kernel_size = ks
        self.stride, self.padding, self.dilation = st, to_2tuple(padding), di
        self.groups = groups
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels // groups, *ks))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        o, _, kh, kw = self.weight.shape
        with torch.no_grad():
            self.weight.normal_(0.0, math.sqrt(2.0 / (o * kh * kw)),
                                generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def conv_weight(self):
        """The f32 weight the convolution uses."""
        return self.weight

    def forward(self, x):
        dt = self.dtype
        if self.same:
            x = pad_same(x, self.kernel_size, self.stride, self.dilation)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.conv_weight().to(dt), bias,
                        self.stride, self.padding, self.dilation, self.groups)


class StdConv2d(Conv2d):
    """Weight-standardized conv (reference std_conv.py,
    ``cotnet_tpu/nn/conv.py:171-215``): each output channel's weight is
    ``(w - mean) / (std + eps)`` with the biased std, in f32, then cast to
    the compute dtype.  Not ``/ sqrt(var + eps)``, which differs by about
    1e-3 at init-scale variances.  ``eps`` is 1e-5, 1e-8 in the hybrid
    ViTs' backbones."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size=1,
                 stride=1, padding=None, dilation=1, groups: int = 1,
                 bias: bool = False, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, bias, dtype)
        self.eps = eps

    def conv_weight(self):
        w = self.weight
        mean = w.mean((1, 2, 3), keepdim=True)
        std = w.var((1, 2, 3), unbiased=False, keepdim=True).sqrt()
        return (w - mean) * torch.reciprocal(std + self.eps)
