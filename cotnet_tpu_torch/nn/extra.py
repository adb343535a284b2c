"""The extended layer zoo, counterpart of ``cotnet_tpu/nn/extra.py``
(reference models/layers/: shiftlution.py, tbconv.py, kerv2d.py,
space_to_depth.py, selective_kernel.py, evo_norm.py, split_batchnorm.py,
cond_conv2d.py, mixed_conv2d.py, test_time_pool.py), on NCHW.

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
- The layer tail, which no registry key builds: ``Shiftlution`` (channel
  spans shifted by ``_sorted_shifts``' offsets), ``TBConv`` (one conv
  shared by contiguous channel blocks), ``Kerv2d`` (polynomial
  kervolution), ``space_to_depth`` / ``SpaceToDepth``, ``EvoNorm2dB0`` /
  ``EvoNorm2dS0`` with ``instance_std`` / ``group_std``,
  ``SplitBatchNorm`` (timm's layout) and ``test_time_pool``.  Each
  computes what its JAX layer computes, with the channel order its NHWC
  reshapes give.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cotnet_tpu_torch.nn.activations import get_act_fn
from cotnet_tpu_torch.nn.conv import (Conv2d, ConvBnAct, get_padding,
                                      normalize_padding, pad_same, to_2tuple)
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
        self.padding = (0, 0) if self.same else normalize_padding(
            padding, kernel_size, stride, dilation)
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


def _sorted_shifts(kernel_h: int, kernel_w: int) -> List[Tuple[int, int]]:
    """Shiftlution's offsets (reference shiftlution.py:13-26,
    ``cotnet_tpu/nn/extra.py:23-35``): near-centre shifts first, ties
    broken by the small terms, in numpy's ``argsort`` order."""
    shifts, keys = [], []
    sh = range(-(kernel_h - 1) // 2, (kernel_h - 1) // 2 + 1) if kernel_h > 1 else [0]
    sw = range(-(kernel_w - 1) // 2, (kernel_w - 1) // 2 + 1) if kernel_w > 1 else [0]
    for h in sh:
        for w in sw:
            shifts.append((h, w))
            keys.append(max(abs(h) + abs(h) / 10 + abs(w) / 100 + h / 1000 + w / 10000,
                            abs(w) + abs(h) / 20 + abs(w) / 200 + h / 2000 + w / 20000))
    order = np.argsort(keys)
    return [shifts[i] for i in order]


class Shiftlution(nn.Module):
    """Channel-wise spatial shift (reference shiftlution.py): span ``i``
    of ``channels // (kernel_h * kernel_w)`` channels moves by the ``i``-th
    offset ``(ho, wo)`` of ``_sorted_shifts``, ``out[y, x] = in[y - ho,
    x - wo]``, zero outside the map; the leftover channels pass through.
    Odd kernel sizes only, as in the reference."""

    def __init__(self, channels: int, kernel_h: int = 3, kernel_w: int = 3):
        super().__init__()
        self.channels, self.kernel_h, self.kernel_w = channels, kernel_h, \
            kernel_w
        self.shifts = _sorted_shifts(kernel_h, kernel_w)

    def forward(self, x):
        n, c, h, w = x.shape
        if c != self.channels:
            raise ValueError(f"Shiftlution of {self.channels} channels got "
                             f"{c}")
        ph, pw = (self.kernel_h - 1) // 2, (self.kernel_w - 1) // 2
        span = c // (self.kernel_h * self.kernel_w)
        xp = F.pad(x, (pw, pw, ph, ph))
        outs = [xp[:, i * span:(i + 1) * span, ph - ho:ph - ho + h,
                   pw - wo:pw - wo + w]
                for i, (ho, wo) in enumerate(self.shifts)]
        outs.append(x[:, len(self.shifts) * span:])
        return torch.cat(outs, 1)


class TBConv(nn.Module):
    """Tied-block conv (reference tbconv.py): one conv, the child ``conv``
    (``in_channels / blocks`` to ``out_channels / blocks``), shared by
    ``blocks`` contiguous channel blocks, which become images of a batch
    ``N * blocks`` and are put back block-major."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, padding=None,
                 dilation: int = 1, groups: int = 1, blocks: int = 1,
                 bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        if in_channels % blocks or out_channels % blocks:
            raise ValueError(f"TBConv: {in_channels} -> {out_channels} "
                             f"channels in {blocks} blocks")
        self.blocks = blocks
        self.conv = Conv2d(in_channels // blocks, out_channels // blocks,
                           kernel_size, stride, padding, dilation, groups,
                           bias=bias, dtype=dtype)

    def forward(self, x):
        n, c, h, w = x.shape
        y = self.conv(x.reshape(n * self.blocks, c // self.blocks, h, w))
        return y.reshape(n, -1, *y.shape[2:])


class Kerv2d(nn.Module):
    """Polynomial kervolution, 1x1 only (reference kerv2d.py): ``(conv(x)
    + bias + balance) ** power + bias``, the reference's bias added twice
    (kerv2d.py:49-50, ``cotnet_tpu/nn/extra.py:114-122``); the child
    ``conv`` has no bias of its own.  With ``learnable_kernel`` the balance
    is a parameter ``[O]`` starting at ``balance``, else the constant in
    the compute dtype."""

    def __init__(self, in_channels: int, out_channels: int,
                 balance: float = 1.0, power: int = 3, bias: bool = True,
                 learnable_kernel: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(in_channels, out_channels, 1, dtype=dtype)
        self.power, self.balance_init = power, balance
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None
        self.balance = (nn.Parameter(torch.empty(out_channels))
                        if learnable_kernel else None)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            if self.bias is not None:
                self.bias.zero_()
            if self.balance is not None:
                self.balance.fill_(self.balance_init)

    def forward(self, x):
        y = self.conv(x)
        bias = None if self.bias is None else self.bias.to(y.dtype).view(
            -1, 1, 1)
        if bias is not None:
            y = y + bias
        balance = (y.new_full((), self.balance_init) if self.balance is None
                   else self.balance.to(y.dtype).view(-1, 1, 1))
        y = (y + balance).pow(self.power)
        if bias is not None:
            y = y + bias
        return y


def space_to_depth(x, block_size: int = 4):
    """``[N, C, H, W]`` to ``[N, bs*bs*C, H/bs, W/bs]``, the channels
    ``(sh, sw, c)``-major as the reference's permute orders them
    (space_to_depth.py)."""
    n, c, h, w = x.shape
    bs = block_size
    x = x.view(n, c, h // bs, bs, w // bs, bs).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, bs * bs * c, h // bs, w // bs)


class SpaceToDepth(nn.Module):
    def __init__(self, block_size: int = 4):
        super().__init__()
        self.block_size = block_size

    def forward(self, x):
        return space_to_depth(x, self.block_size)


def instance_std(x, eps: float = 1e-5):
    """Each (image, channel)'s standard deviation over H and W, ``[N, C, 1,
    1]``: ``sqrt(var + eps)``, the biased variance."""
    return (x.var((2, 3), unbiased=False, keepdim=True) + eps).sqrt()


def group_std(x, groups: int = 32, eps: float = 1e-5):
    """The standard deviation of each image's ``groups`` contiguous channel
    blocks over the block and H, W, broadcast back to x's shape."""
    n, c, h, w = x.shape
    xg = x.view(n, groups, c // groups, h, w)
    std = (xg.var((2, 3, 4), unbiased=False, keepdim=True) + eps).sqrt()
    return std.expand_as(xg).reshape(n, c, h, w)


class _EvoNorm(nn.Module):
    """The parameters of both EvoNorms, timm's: ``weight``, ``bias`` and,
    with ``apply_act``, ``v``, each ``[1, C, 1, 1]``."""

    def __init__(self, num_features: int, apply_act: bool):
        super().__init__()
        self.apply_act = apply_act
        shape = (1, num_features, 1, 1)
        self.weight = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.empty(shape))
        self.v = nn.Parameter(torch.empty(shape)) if apply_act else None

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            if self.v is not None:
                self.v.fill_(1.0)


class EvoNorm2dB0(_EvoNorm):
    """EvoNorm-B0 (reference evo_norm.py), in f32 and cast back: with
    ``apply_act``, ``x / max(sqrt(var + eps), v*x + instance_std(x,
    eps))``, then ``x * weight + bias``.  ``var`` is the batch's biased
    variance over N, H and W in training, which moves the buffer
    ``running_var`` ``[1, C, 1, 1]`` by flax's ``momentum`` (0.9 keeps the
    old value), and ``running_var`` in eval."""

    def __init__(self, num_features: int, apply_act: bool = True,
                 momentum: float = 0.9, eps: float = 1e-3):
        super().__init__(num_features, apply_act)
        self.momentum, self.eps = momentum, eps
        if apply_act:
            self.register_buffer("running_var",
                                 torch.empty(1, num_features, 1, 1))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        super().reset_parameters(generator)
        if self.apply_act:
            self.running_var.fill_(1.0)

    def forward(self, x):
        xf = x.float()
        if self.apply_act:
            if self.training:
                var = xf.var((0, 2, 3), unbiased=False, keepdim=True)
                with torch.no_grad():
                    self.running_var.mul_(self.momentum).add_(
                        var, alpha=1 - self.momentum)
            else:
                var = self.running_var
            xf = xf / torch.maximum((var + self.eps).sqrt(),
                                    self.v * xf + instance_std(xf, self.eps))
        return (xf * self.weight + self.bias).to(x.dtype)


class EvoNorm2dS0(_EvoNorm):
    """EvoNorm-S0 (reference evo_norm.py:44-83), in f32 and cast back: with
    ``apply_act``, ``x * sigmoid(v*x) / group_std(x, groups)``, then ``x *
    weight + bias``; no running statistics."""

    def __init__(self, num_features: int, groups: int = 32,
                 apply_act: bool = True):
        super().__init__(num_features, apply_act)
        self.groups = groups
        self.reset_parameters()

    def forward(self, x):
        xf = x.float()
        if self.apply_act:
            xf = xf * torch.sigmoid(xf * self.v) / group_std(xf, self.groups)
        return (xf * self.weight + self.bias).to(x.dtype)


class SplitBatchNorm(BatchNorm2d):
    """Aug-split BN (reference split_batchnorm.py:75), in timm's layout:
    the module is the main BN (``weight``, ``bias``, ``running_mean``,
    ``running_var``) and ``aux_bn.{i}`` are the other splits'.  In training
    the batch is ``num_splits`` equal parts, each normalized by its own BN;
    in eval, or with one split, the main BN takes the whole batch.  Each is
    the port's ``BatchNorm2d`` (the biased running variance, as flax's)."""

    def __init__(self, num_features: int, num_splits: int = 2,
                 eps: float = 1e-5, momentum: float = 0.1,
                 dtype: torch.dtype = torch.float32, group=None):
        super().__init__(num_features, eps, momentum, dtype=dtype,
                         group=group)
        self.num_splits = num_splits
        self.aux_bn = nn.ModuleList(
            BatchNorm2d(num_features, eps, momentum, dtype=dtype,
                        group=group)
            for _ in range(num_splits - 1))

    def forward(self, x):
        if not self.training or self.num_splits <= 1:
            return super().forward(x)
        if x.shape[0] % self.num_splits:
            raise ValueError(f"a batch of {x.shape[0]} in {self.num_splits} "
                             "equal splits")
        first, *rest = x.chunk(self.num_splits)
        return torch.cat([super().forward(first)]
                         + [bn(xi) for bn, xi in zip(self.aux_bn, rest)])


def test_time_pool(logits_fn, x, crop_size: int):
    """Test-time pooling (reference test_time_pool.py): ``logits_fn`` maps
    the full image's features to per-position logits ``[N, classes, H,
    W]``, which are averaged over H and W.  ``crop_size`` is the
    reference's and unused, as in the JAX function."""
    return logits_fn(x).mean((2, 3))


test_time_pool.__test__ = False     # its name is no pytest test's
