"""Convolution (NCHW, OIHW weights), counterpart of ``cotnet_tpu/nn/conv.py``.

The weight is float32 and cast to the module's compute dtype at use, as
flax's ``Conv(dtype=...)`` does; the initialization is the reference's
``kaiming_normal_(mode='fan_out', nonlinearity='relu')``.  ``padding="same"``
pads TF-SAME (``pad_same``) at each call; ``StdConv2d`` standardizes its
weight first; ``DenseGroupedConv`` computes a grouped conv as a dense one
with a block-diagonal kernel; ``ConvBnAct`` is a conv, a BN and an
activation as the children ``conv`` and ``bn``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from cotnet_tpu_torch.nn.activations import get_act_fn
from cotnet_tpu_torch.nn.norm import BatchNorm2d


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


def normalize_padding(padding, kernel_size, stride, dilation):
    """``padding`` as ``F.conv2d`` takes it for the geometry
    (``cotnet_tpu/nn/conv.py:53-60``, which gives flax's form of the same):
    None becomes the symmetric ``get_padding`` of each axis, an int or a
    pair a pair, and a string (``"same"``, ``"valid"``) lower case."""
    if isinstance(padding, str):
        return padding.lower()
    if padding is None:
        return tuple(get_padding(k, s, d) for k, s, d in zip(
            to_2tuple(kernel_size), to_2tuple(stride), to_2tuple(dilation)))
    return to_2tuple(padding)


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
        self.kernel_size = ks
        self.stride, self.dilation = st, di
        self.padding = (0, 0) if self.same else normalize_padding(
            padding, ks, st, di)
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
        return self._conv(x, self.conv_weight(), self.groups)

    def _conv(self, x, weight, groups: int):
        dt = self.dtype
        if self.same:
            x = pad_same(x, self.kernel_size, self.stride, self.dilation)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), weight.to(dt), bias, self.stride,
                        self.padding, self.dilation, groups)


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


class DenseGroupedConv(Conv2d):
    """A grouped conv computed as a dense one, counterpart of
    ``cotnet_tpu/nn/conv.py:88-141`` (the JAX package's
    ``COTNET_DENSE_GROUPED`` form of the CoT key conv): the parameter is
    the grouped ``weight`` ``[O, I/groups, kh, kw]``, so a state_dict is
    that of ``Conv2d`` with the same groups; each call scatters it into a
    block-diagonal ``[O, I, kh, kw]`` kernel (group g's ``O/groups`` rows
    take the input columns ``g*I/groups ...``) and convolves with
    ``groups=1``.  The same function as the grouped conv, for ``groups``
    times its products; the gradient flows back through the scatter."""

    def dense_weight(self):
        """The block-diagonal f32 kernel ``[O, I, kh, kw]``."""
        w = self.conv_weight()
        g = self.groups
        o, ig, kh, kw = w.shape
        dense = w.new_zeros(g, o // g, g, ig, kh, kw)
        idx = torch.arange(g, device=w.device)
        dense[idx, :, idx] = w.view(g, o // g, ig, kh, kw)
        return dense.view(o, g * ig, kh, kw)

    def forward(self, x):
        return self._conv(x, self.dense_weight(), 1)


class ConvBnAct(nn.Module):
    """conv + BN + act (reference models/layers/conv_bn_act.py,
    ``cotnet_tpu/nn/conv.py:144-168``): the children ``conv`` (a
    ``Conv2d`` without bias) and ``bn`` (None without ``use_bn``), then
    ``act`` (None for none).  ``zero_init`` starts the BN's scale at 0
    (the last BN of a residual branch)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size=1,
                 stride=1, padding=None, dilation=1, groups: int = 1,
                 act: Optional[str] = "relu", use_bn: bool = True,
                 zero_init: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(in_channels, out_channels, kernel_size, stride,
                           padding, dilation, groups, dtype=dtype)
        self.bn = (BatchNorm2d(out_channels, zero_init=zero_init, dtype=dtype)
                   if use_bn else None)
        self.act = get_act_fn(act)

    def forward(self, x):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return self.act(x)
