"""CoTNet / CoTNeXt — the paper's model family (reference models/cotnet.py),
counterpart of ``cotnet_tpu/models/cotnet.py``.

CotLayer (reference :36-104): static context via a grouped KxK conv; a
per-position K^2 attention map from [x; k] through a 2-layer bottleneck with
GroupNorm; dynamic context via the local aggregation; then a radix-2 split
attention over the static and dynamic contexts.  CoXtLayer (:106-178) is its
grouped form for CoTNeXt.

NCHW throughout, with the reference's cw-major attention weight and its
module names, so its checkpoints load as they are.  How the embed GroupNorm
meets the aggregation:

- eval: the GroupNorm is folded into the aggregation
  (``SubChannelGroupNorm.fold``), so the normalized weight, the largest
  activation of the layer, is never written;
- eval with ``mega_fuse``: the embed's second conv, the GroupNorm and the
  aggregation are one op (``local_aggregate_embed_gn``), and the weight
  tensor is not written at all;
- training: the GroupNorm is materialized and the aggregation runs without
  the affine, as the JAX package does by default;
- training with ``gn_fold_train``: the fold, with gradients through the
  affine aggregation and the fold's statistics.

Both switches are constructor arguments, off by default (the JAX package
reads them from ``COTNET_MEGA_FUSE`` and ``COTNET_GN_FOLD_TRAIN``).  Ported:
CotLayer, CoXtLayer, CotBottleneck (eval and training, with DropBlock and
stochastic depth) and the cotnet50 / cotnet101 / cotnext50_2x48d /
cotnext101_2x48d entrypoints.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from cotnet_tpu_torch.models.helpers import build_model_with_cfg, default_cfg
from cotnet_tpu_torch.models.registry import register_model
from cotnet_tpu_torch.models.resnet import ResNet
from cotnet_tpu_torch.nn import (
    BatchNorm2d,
    Conv2d,
    DropBlock2d,
    DropPath,
    SubChannelGroupNorm,
    avg_pool2d,
    get_act_fn,
    swish,
)
from cotnet_tpu_torch.ops import local_aggregate, local_aggregate_embed_gn

default_cfgs = {
    "cotnet50": default_cfg(),
    "cotnet101": default_cfg(),
    "cotnext50_2x48d": default_cfg(),
    "cotnext101_2x48d": default_cfg(),
}

SHARE_PLANES = 8


class CotLayer(nn.Module):
    """Contextual Transformer block (reference models/cotnet.py:36-104).

    ``key_groups`` and ``dw_group`` are what CoXtLayer changes: the groups
    of the key conv, and the channel groups in which the embed convs, the
    value conv and the aggregation itself run."""

    key_groups = 4
    dw_group = 1

    def __init__(self, dim: int, kernel_size: int = 3, impl: str = "auto",
                 dtype: torch.dtype = torch.float32,
                 gn_fold_train: bool = False, mega_fuse: bool = False):
        super().__init__()
        ks, dwg = kernel_size, self.dw_group
        self.dim, self.kernel_size, self.impl = dim, ks, impl
        self.gn_fold_train, self.mega_fuse = gn_fold_train, mega_fuse
        self.cw = dim // SHARE_PLANES    # weight channels, all groups
        k2 = ks * ks
        factor, radix = 2, 2
        self.key_embed = nn.Sequential(
            Conv2d(dim, dim, ks, 1, ks // 2, groups=self.key_groups,
                   dtype=dtype),
            BatchNorm2d(dim, dtype=dtype),
            nn.ReLU())
        # the GroupNorm's groups are blocks of K^2 channels whatever dw_group
        # is: the grouped conv writes group g's Cw/dw_group blocks together
        self.embed = nn.Sequential(
            Conv2d(2 * dim, dim // factor, 1, groups=dwg, dtype=dtype),
            BatchNorm2d(dim // factor, dtype=dtype),
            nn.ReLU(),
            Conv2d(dim // factor, k2 * self.cw, 1, bias=True, groups=dwg,
                   dtype=dtype),
            SubChannelGroupNorm(k2, self.cw, dtype=dtype))
        self.conv1x1 = nn.Sequential(
            Conv2d(dim, dim, 1, groups=dwg, dtype=dtype),
            BatchNorm2d(dim, dtype=dtype))
        self.bn = BatchNorm2d(dim, dtype=dtype)
        attn_chs = max(dim * radix // 4, 32)
        self.se = nn.Sequential(
            Conv2d(dim, attn_chs, 1, bias=True, dtype=dtype),
            BatchNorm2d(attn_chs, dtype=dtype),
            nn.ReLU(),
            Conv2d(attn_chs, radix * dim, 1, bias=True, dtype=dtype))

    def _query_key(self, x, k):
        return torch.cat([x, k], dim=1)

    def forward(self, x):
        ks, dwg = self.kernel_size, self.dw_group
        pad = (ks - 1) // 2
        k = self.key_embed(x)
        w = self.embed[:3](self._query_key(x, k))
        v = self.conv1x1(x)
        n, _, h, wd = v.shape
        conv2, gn = self.embed[3], self.embed[4]
        if self.mega_fuse and not self.training:
            y = local_aggregate_embed_gn(
                v, w, conv2.weight, conv2.bias, *gn.raw(), kernel_size=ks,
                padding=pad, eps=gn.eps, groups=dwg, impl=self.impl)
        else:
            w = conv2(w)
            if self.training and not self.gn_fold_train:
                w = gn(w)
                s = b = None
            else:
                # the GroupNorm is folded into the aggregation
                s, b = (t.view(n * dwg, 1, self.cw // dwg, ks * ks)
                        for t in gn.fold(w))
            # group g of image n is image n*dw_group + g of a batch
            # N*dw_group: in NCHW with cw-major weights these are views, and
            # all groups go through one call (the reference's own form,
            # cotnet.py:157-162)
            y = local_aggregate(
                v.view(n * dwg, self.dim // dwg, h, wd),
                w.view(n * dwg, 1, self.cw // dwg, ks * ks, h, wd),
                kernel_size=ks, padding=pad, impl=self.impl, w_scale=s,
                w_bias=b).view(n, self.dim, h, wd)
        y = swish(self.bn(y))

        gap = (y + k).mean((2, 3), keepdim=True)
        a = F.softmax(self.se(gap).view(n, self.dim, 2), dim=2)
        return y * a[:, :, 0, None, None] + k * a[:, :, 1, None, None]


class CoXtLayer(CotLayer):
    """Grouped (cardinality) CoT for CoTNeXt (reference cotnet.py:106-178):
    key_embed with 8 groups; the embed convs, the value conv and the
    aggregation in ``dw_group`` = 2 channel groups; the embed's input is the
    interleaved ``[x_c, k_c]`` pairs (:153-154), so that each group sees
    its own half of x and of k."""

    key_groups = 8
    dw_group = 2

    def _query_key(self, x, k):
        n, c, h, w = x.shape
        return torch.stack([x, k], dim=2).reshape(n, 2 * c, h, w)


class CotBottleneck(nn.Module):
    """ResNet bottleneck with the 3x3 conv replaced by a CotLayer
    (reference cotnet.py:181-264), or by a CoXtLayer when ``cardinality``
    is not 1; stride is an avg-pool *before* the CoT layer (:199-202).
    ``drop_block`` is ``(rate, block_size, gamma_scale)`` or None, applied
    after bn1 and after bn3; ``drop_path_rate`` drops the whole residual
    branch per sample; ``gn_fold_train`` and ``mega_fuse`` go to the CoT
    layer."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: Optional[nn.Module] = None,
                 cardinality: int = 1, base_width: int = 64,
                 act: str = "relu", zero_init_last_bn: bool = True,
                 drop_block: Optional[tuple] = None,
                 drop_path_rate: float = 0.0,
                 impl: str = "auto", dtype: torch.dtype = torch.float32,
                 gn_fold_train: bool = False, mega_fuse: bool = False):
        super().__init__()
        width = int(math.floor(planes * (base_width / 64))) * cardinality
        outplanes = planes * self.expansion
        self.stride = stride
        self.act = get_act_fn(act)
        self.conv1 = Conv2d(inplanes, width, 1, dtype=dtype)
        self.bn1 = BatchNorm2d(width, dtype=dtype)
        layer_cls = CotLayer if cardinality == 1 else CoXtLayer
        self.conv2 = layer_cls(width, 3, impl=impl, dtype=dtype,
                               gn_fold_train=gn_fold_train,
                               mega_fuse=mega_fuse)
        self.conv3 = Conv2d(width, outplanes, 1, dtype=dtype)
        self.bn3 = BatchNorm2d(outplanes, zero_init=zero_init_last_bn,
                               dtype=dtype)
        self.downsample = downsample
        self.drop_block = (nn.Identity() if drop_block is None
                           else DropBlock2d(*drop_block))
        self.drop_path = DropPath(drop_path_rate)

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        y = self.act(self.drop_block(self.bn1(self.conv1(x))))
        if self.stride > 1:
            y = avg_pool2d(y, 3, self.stride, padding=1)
        y = self.drop_block(self.bn3(self.conv3(self.conv2(y))))
        return self.act(self.drop_path(y) + residual)


def _create_cotnet(model_name: str, gn_fold_train: bool = False,
                   mega_fuse: bool = False, block_args: Optional[dict] = None,
                   **kwargs):
    block_args = dict(block_args or {}, gn_fold_train=gn_fold_train,
                      mega_fuse=mega_fuse)
    return build_model_with_cfg(ResNet, model_name, default_cfgs[model_name],
                                block_args=block_args, **kwargs)


@register_model
def cotnet50(**kwargs):
    return _create_cotnet("cotnet50", block=CotBottleneck,
                          layers=(3, 4, 6, 3), **kwargs)


@register_model
def cotnext50_2x48d(**kwargs):
    return _create_cotnet("cotnext50_2x48d", block=CotBottleneck,
                          layers=(3, 4, 6, 3), cardinality=2, base_width=48,
                          **kwargs)


@register_model
def cotnet101(**kwargs):
    return _create_cotnet("cotnet101", block=CotBottleneck,
                          layers=(3, 4, 23, 3), **kwargs)


@register_model
def cotnext101_2x48d(**kwargs):
    return _create_cotnet("cotnext101_2x48d", block=CotBottleneck,
                          layers=(3, 4, 23, 3), cardinality=2, base_width=48,
                          **kwargs)
