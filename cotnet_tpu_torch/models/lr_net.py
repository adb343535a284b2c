"""LR-Net, local-relation networks (reference models/lr_net.py),
counterpart of ``cotnet_tpu/models/lr_net.py``.

``SelfAttLayer``: q from a 1x1 embed, k from a 1x1 (or ``key_ks``) embed;
per head (head dim 8, so ``dim / 8`` heads) the K x K logits are the dot
products ``q . (k patch + pos_h + pos_w)`` in f32, softmaxed over the K^2
taps.  The softmax is the aggregation weight itself, built in the port's
cw-major layout ``[N, 1, dim/8, K^2, H, W]``: ``dim/8`` weight channels
shared by 8 channel groups of the values, aggregated by
``local_aggregate`` at K = 3 (the Hopper kernels on the card).
``LrBottleneck`` strides by an avg-pool *after* the attention, so a
stage's first block aggregates at the map before the stride.
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
from cotnet_tpu_torch.nn import (BatchNorm2d, Conv2d, DropBlock2d, DropPath,
                                 avg_pool2d, create_attn, get_act_fn, relu)
from cotnet_tpu_torch.ops import extract_patches, local_aggregate

default_cfgs = {
    "lrnet50": default_cfg(),
    "lrnet50_ks3": default_cfg(),
}

HEAD_DIM = 8


class SelfAttLayer(nn.Module):
    """Reference lr_net.py:39-100 (JAX ``lr_net.py:31-96``): ``pos_h``
    ``[dim, K, 1]`` and ``pos_w`` ``[dim, 1, K]`` are the reference's
    parameters; ``impl`` selects the aggregation's implementation."""

    def __init__(self, in_channels: int, dim: int, kernel_size: int = 3,
                 key_ks: int = 1, impl: str = "auto",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        ks = kernel_size
        self.dim, self.kernel_size, self.impl = dim, ks, impl
        self.conv_q = Conv2d(in_channels, dim, 1, dtype=dtype)
        self.bn_q = BatchNorm2d(dim, dtype=dtype)
        self.conv_k = Conv2d(in_channels, dim, key_ks, 1, key_ks // 2,
                             dtype=dtype)
        self.bn_k = BatchNorm2d(dim, dtype=dtype)
        self.conv_v = Conv2d(in_channels, dim, 1, dtype=dtype)
        self.bn_v = BatchNorm2d(dim, dtype=dtype)
        self.pos_h = nn.Parameter(torch.empty(dim, ks, 1))
        self.pos_w = nn.Parameter(torch.empty(dim, 1, ks))
        self.bn = BatchNorm2d(dim, dtype=dtype)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.pos_h.normal_(0.0, 1.0, generator=generator)
            self.pos_w.normal_(0.0, 1.0, generator=generator)

    def forward(self, x):
        ks, dim = self.kernel_size, self.dim
        k2, heads = ks * ks, dim // HEAD_DIM
        n, _, h, w = x.shape
        q = relu(self.bn_q(self.conv_q(x)))
        k = relu(self.bn_k(self.conv_k(x)))
        v = self.bn_v(self.conv_v(x))
        pos = (self.pos_h + self.pos_w).reshape(dim, k2)
        kp = extract_patches(k, ks) + pos.to(k.dtype)[None, :, :, None, None]
        attn = torch.einsum(
            "nhdxy,nhdkxy->nhkxy",
            q.float().view(n, heads, HEAD_DIM, h, w),
            kp.float().view(n, heads, HEAD_DIM, k2, h, w))
        weight = F.softmax(attn, dim=2).to(v.dtype)[:, None]
        y = local_aggregate(v, weight, kernel_size=ks, padding=(ks - 1) // 2,
                            impl=self.impl)
        return relu(self.bn(y))


class LrBottleneck(nn.Module):
    """Reference lr_net.py:103-189 (JAX ``lr_net.py:99-150``): 1x1 ->
    SelfAttLayer -> [3x3 stride-2 avg-pool] -> 1x1.  ``dilation`` and
    ``first_dilation`` are accepted and ignored: the layer is K = 3 at
    dilation 1, as in the JAX block."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: Optional[nn.Module] = None,
                 cardinality: int = 1, base_width: int = 64,
                 reduce_first: int = 1, dilation: int = 1,
                 first_dilation: Optional[int] = None, act: str = "relu",
                 attn_layer=None, drop_block: Optional[tuple] = None,
                 drop_path_rate: float = 0.0,
                 zero_init_last_bn: bool = True, key_ks: int = 1,
                 impl: str = "auto", dtype: torch.dtype = torch.float32):
        super().__init__()
        width = int(math.floor(planes * (base_width / 64))) * cardinality
        first_planes = width // reduce_first
        outplanes = planes * self.expansion
        self.stride = stride
        self.act = get_act_fn(act)
        self.conv1 = Conv2d(inplanes, first_planes, 1, dtype=dtype)
        self.bn1 = BatchNorm2d(first_planes, dtype=dtype)
        self.drop_block = (nn.Identity() if drop_block is None
                           else DropBlock2d(*drop_block))
        self.conv2 = SelfAttLayer(first_planes, width, 3, key_ks, impl=impl,
                                  dtype=dtype)
        self.conv3 = Conv2d(width, outplanes, 1, dtype=dtype)
        self.bn3 = BatchNorm2d(outplanes, zero_init=zero_init_last_bn,
                               dtype=dtype)
        self.se = create_attn(attn_layer, outplanes, dtype=dtype)
        self.downsample = downsample
        self.drop_path = DropPath(drop_path_rate)

    def forward(self, x):
        y = self.act(self.drop_block(self.bn1(self.conv1(x))))
        y = self.conv2(y)
        if self.stride > 1:
            y = avg_pool2d(y, 3, 2, padding=1)
        y = self.bn3(self.conv3(y))
        if self.se is not None:
            y = self.se(y)
        residual = x if self.downsample is None else self.downsample(x)
        return self.act(self.drop_path(y) + residual)


def _create_lrnet(model_name, block_args: Optional[dict] = None, **kwargs):
    return build_model_with_cfg(
        ResNet, model_name, default_cfgs[model_name], block=LrBottleneck,
        block_args=block_args, **dict(dict(layers=(3, 4, 6, 3)), **kwargs))


@register_model
def lrnet50(pretrained=False, **kwargs):
    return _create_lrnet("lrnet50", **kwargs)


@register_model
def lrnet50_ks3(pretrained=False, block_args: Optional[dict] = None,
                **kwargs):
    return _create_lrnet("lrnet50_ks3",
                         block_args=dict(dict(key_ks=3), **(block_args or {})),
                         **kwargs)
