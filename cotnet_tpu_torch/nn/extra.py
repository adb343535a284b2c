"""The EfficientNet family's two conv layers, counterpart of
``cotnet_tpu/nn/extra.py:282-372`` (reference models/layers/
cond_conv2d.py, mixed_conv2d.py), on NCHW.

- ``MixedConv2d``: the channels split into one group per kernel size
  (``_split_channels``: equal parts, the first takes the remainder), each
  group its own ``Conv2d`` (depthwise, or dense within the group), the
  outputs concatenated.  The convs are children by bare index, as timm's
  ``nn.ModuleDict`` registers them (``conv_dw.0.weight`` ...).  Under
  ``pad_type="same"`` each group pads TF-SAME for its own kernel size.
- ``CondConv2d``: ``num_experts`` kernels mixed per sample by a routing
  vector ``[N, E]`` that the caller passes (one vector feeds all three
  convs of a CondConv block).  The expert bank is the reference's flat
  ``weight`` ``[E, O * I/groups * kh * kw]``, with ``bias`` ``[E, O]``
  where it has one.  The per-sample kernels are mixed in the compute
  dtype, as the JAX layer mixes them in ``x.dtype``; the convolution runs
  as the reference runs it, ``x`` viewed as ``[1, N*C, H, W]`` and one
  conv of ``N * groups`` groups.

- ``SelectiveKernelConv`` (``cotnet_tpu/nn/extra.py:144-200``, reference
  selective_kernel.py): parallel ``ConvBnAct`` paths ``paths.{i}`` (3x3
  at growing dilation under ``keep_3x3``), each on its own slice of the
  input under ``split_input``, mixed by a softmax over the paths from
  the pooled sum through ``attn.fc_reduce``, ``attn.bn`` and
  ``attn.fc_select`` (1x1 convs without bias, the reference's; the JAX
  layer's Dense kernels are their transposes).

The file's other JAX layers (Shiftlution, TBConv, Kerv2d, SpaceToDepth,
EvoNorm, SplitBatchNorm) are not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from cotnet_tpu_torch.nn.activations import get_act_fn
from cotnet_tpu_torch.nn.conv import (Conv2d, ConvBnAct, get_padding,
                                      pad_same, to_2tuple)
from cotnet_tpu_torch.nn.norm import BatchNorm2d


def _split_channels(num_chan: int, num_groups: int):
    """Equal splits, the FIRST group takes the remainder (reference
    mixed_conv2d.py:14-17): load-bearing for checkpoint parity."""
    split = [num_chan // num_groups] * num_groups
    split[0] += num_chan - sum(split)
    return split


class MixedConv2d(nn.ModuleList):
    """Channel groups with their own kernel sizes, concatenated; the
    children ``0``, ``1``, ... are one ``Conv2d`` per kernel size."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_sizes: Sequence[int] = (3, 5), stride: int = 1,
                 dilation: int = 1, depthwise: bool = False,
                 pad_type: str = "", dtype: torch.dtype = torch.float32):
        in_splits = _split_channels(in_channels, len(kernel_sizes))
        out_splits = _split_channels(out_channels, len(kernel_sizes))
        padding = "same" if pad_type == "same" else None
        super().__init__(
            Conv2d(ci, co, k, stride, padding, dilation,
                   groups=co if depthwise else 1, dtype=dtype)
            for k, ci, co in zip(kernel_sizes, in_splits, out_splits))
        self.in_splits = in_splits

    def forward(self, x):
        xs = torch.split(x, self.in_splits, dim=1)
        return torch.cat([conv(xi) for conv, xi in zip(self, xs)], 1)


class CondConv2d(nn.Module):
    """A per-sample mixture of ``num_experts`` kernels: ``forward(x,
    routing)`` with ``routing`` ``[N, E]`` (the JAX layer's own ``routing``
    Dense, used where no vector is passed, is not built: every caller of
    the port passes one).  ``padding`` is an int, None (torch's symmetric
    ``get_padding``) or ``"same"`` (TF-SAME by the input's size)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, padding=None,
                 dilation: int = 1, groups: int = 1, num_experts: int = 4,
                 bias: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel_size = to_2tuple(kernel_size)
        self.stride, self.dilation = to_2tuple(stride), to_2tuple(dilation)
        self.same = padding == "same"
        if self.same:
            padding = 0
        elif padding is None:
            padding = tuple(get_padding(k, s, d) for k, s, d in zip(
                self.kernel_size, self.stride, self.dilation))
        self.padding = to_2tuple(padding)
        self.groups, self.dtype = groups, dtype
        self.weight_shape = (out_channels, in_channels // groups,
                             *self.kernel_size)
        self.weight = nn.Parameter(torch.empty(
            num_experts, math.prod(self.weight_shape)))
        self.bias = (nn.Parameter(torch.empty(num_experts, out_channels))
                     if bias else None)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax's ``variance_scaling(2, "fan_out", "normal")`` on the JAX
        bank ``[E, kh, kw, I/g, O]``: std ``sqrt(2 / (E * O * kh * kw))``
        (its fan-out counts the experts)."""
        e = self.weight.shape[0]
        o, _, kh, kw = self.weight_shape
        with torch.no_grad():
            self.weight.normal_(0.0, math.sqrt(2.0 / (e * o * kh * kw)),
                                generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x, routing):
        dt = self.dtype
        n, c = x.shape[:2]
        route = routing.to(dt)
        kernels = torch.matmul(route, self.weight.to(dt)).view(
            n * self.weight_shape[0], *self.weight_shape[1:])
        if self.same:
            x = pad_same(x, self.kernel_size, self.stride, self.dilation)
        y = F.conv2d(x.to(dt).reshape(1, n * c, *x.shape[2:]), kernels,
                     None, self.stride, self.padding, self.dilation,
                     self.groups * n)
        y = y.view(n, self.weight_shape[0], *y.shape[2:])
        if self.bias is not None:
            # the f32 bias mixed by the routing, then rounded once, as
            # the JAX layer adds it
            bias = torch.matmul(route.float(), self.bias).to(dt)
            y = y + bias[:, :, None, None]
        return y


class SelectiveKernelAttn(nn.Module):
    """The path attention of ``SelectiveKernelConv``: the pooled
    ``[N, C, 1, 1]`` through ``fc_reduce``, ``bn``, ``act`` and
    ``fc_select`` to ``num_paths * C`` logits, path-major."""

    def __init__(self, channels: int, num_paths: int, attn_channels: int,
                 act: str = "relu", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc_reduce = Conv2d(channels, attn_channels, 1, dtype=dtype)
        self.bn = BatchNorm2d(attn_channels, dtype=dtype)
        self.fc_select = Conv2d(attn_channels, channels * num_paths, 1,
                                dtype=dtype)
        self.act = get_act_fn(act)

    def forward(self, x):
        return self.fc_select(self.act(self.bn(self.fc_reduce(x))))


class SelectiveKernelConv(nn.Module):
    """SK conv: ``len(kernel_size)`` paths (default 3 and 5; with
    ``keep_3x3`` each a 3x3 at dilation ``dilation * (k - 1) // 2``), each
    ``ConvBnAct`` grouped by ``min(out_channels, groups)``, on the whole
    input or, with ``split_input``, on its ``i``-th of ``num_paths`` equal
    channel slices; the outputs summed with per-channel softmax weights
    over the paths (``attn``), computed from the spatial mean of their
    sum."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Optional[Sequence[int]] = None,
                 stride: int = 1, dilation: int = 1, groups: int = 1,
                 attn_reduction: int = 16, min_attn_channels: int = 32,
                 keep_3x3: bool = True, split_input: bool = False,
                 act: str = "relu", dtype: torch.dtype = torch.float32):
        super().__init__()
        ks = list(kernel_size or [3, 5])
        if keep_3x3:
            dil = [dilation * (k - 1) // 2 for k in ks]
            ks = [3] * len(ks)
        else:
            dil = [dilation] * len(ks)
        self.num_paths = len(ks)
        if split_input and in_channels % self.num_paths:
            raise ValueError(f"split_input: {in_channels} channels into "
                             f"{self.num_paths} paths")
        self.split = in_channels // self.num_paths if split_input else None
        path_in = self.split or in_channels
        groups = min(out_channels, groups)
        self.paths = nn.ModuleList(
            ConvBnAct(path_in, out_channels, k, stride,
                      get_padding(k, stride, d), d, groups, act=act,
                      dtype=dtype)
            for k, d in zip(ks, dil))
        attn_channels = max(int(out_channels / attn_reduction),
                            min_attn_channels)
        self.attn = SelectiveKernelAttn(out_channels, self.num_paths,
                                        attn_channels, act, dtype)

    def forward(self, x):
        xs = (torch.split(x, self.split, 1) if self.split
              else [x] * self.num_paths)
        stacked = torch.stack([path(xi) for path, xi in zip(self.paths, xs)],
                              1)
        n, p, c = stacked.shape[:3]
        logits = self.attn(stacked.sum(1).mean((2, 3), keepdim=True))
        weights = logits.view(n, p, c, 1, 1).softmax(1)
        return (stacked * weights).sum(1)
