"""LambdaNet (reference models/lambdAnet.py), counterpart of
``cotnet_tpu/models/lambda_net.py``: a bottleneck whose 3x3 conv is a
LambdaLayer of content and position lambdas, the keys softmaxed over the
``dim_k`` dim and the position lambdas an r x r conv of each value channel
by each of the ``dim_k`` embeddings.

The position lambdas are a grouped ``F.conv2d`` with channel multiplier
``dim_k`` (output channel ``v*dim_k + k`` convolves value channel v with
embedding k), as the JAX package's ``lax.conv`` with
``feature_group_count``; every product and sum of the layer is f32, the
result cast back to the compute dtype.  The parameters are the
reference's: ``to_q.{0,1}``, ``to_k``, ``to_v.{0,1}`` and ``embeddings``
``[dim_k, 1, 1, r, r]`` (its conv3d kernel)."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from cotnet_tpu_torch.models.helpers import build_model_with_cfg, default_cfg
from cotnet_tpu_torch.models.registry import register_model
from cotnet_tpu_torch.models.resnet import ResNet
from cotnet_tpu_torch.nn import (BatchNorm2d, Conv2d, DropPath, avg_pool2d,
                                 create_attn, get_act_fn)

default_cfgs = {"lambdanet50": default_cfg()}


class LambdaLayer(nn.Module):
    """Reference lambdAnet.py:33-90 (JAX ``lambda_net.py:24-74``): ``dim``
    output channels in ``heads`` heads of ``dim // heads`` values."""

    def __init__(self, in_channels: int, dim: int, dim_k: int = 16,
                 r: int = 15, heads: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim_k, self.r, self.heads = dim_k, r, heads
        self.dim_v = dim // heads
        self.dtype = dtype
        self.to_q = nn.Sequential(
            Conv2d(in_channels, dim_k * heads, 1, dtype=dtype),
            BatchNorm2d(dim_k * heads, dtype=dtype))
        self.to_k = Conv2d(in_channels, dim_k, 1, dtype=dtype)
        self.to_v = nn.Sequential(
            Conv2d(in_channels, self.dim_v, 1, dtype=dtype),
            BatchNorm2d(self.dim_v, dtype=dtype))
        self.embeddings = nn.Parameter(torch.empty(dim_k, 1, 1, r, r))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.embeddings.normal_(0.0, 1.0, generator=generator)

    def forward(self, x):
        n, _, h, w = x.shape
        hw, dk, dv = h * w, self.dim_k, self.dim_v
        q = self.to_q(x).float().view(n, self.heads, dk, hw)
        k = F.softmax(self.to_k(x).float(), dim=1).view(n, dk, hw)
        v = self.to_v(x).float()
        kern = self.embeddings.view(1, dk, self.r, self.r).expand(
            dv, dk, self.r, self.r).reshape(dv * dk, 1, self.r, self.r)
        pos = F.conv2d(v, kern, padding=(self.r - 1) // 2,
                       groups=dv).view(n, dv, dk, hw)
        v = v.view(n, dv, hw)
        content = torch.einsum("bkm,bvm->bkv", k, v)
        out = (torch.einsum("bhkm,bkv->bhvm", q, content)
               + torch.einsum("bhkm,bvkm->bhvm", q, pos))
        return out.reshape(n, self.heads * dv, h, w).to(self.dtype)


class LambdaBottleneck(nn.Module):
    """1x1 -> LambdaLayer at full resolution, BN, act -> [3x3 stride-2
    avg-pool] -> 1x1 (reference lambdAnet.py:159-169, JAX
    ``lambda_net.py:77-137``)."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: Optional[nn.Module] = None,
                 cardinality: int = 1, base_width: int = 64,
                 reduce_first: int = 1, act: str = "relu",
                 attn_layer=None, drop_path_rate: float = 0.0,
                 zero_init_last_bn: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        width = int(math.floor(planes * (base_width / 64))) * cardinality
        outplanes = planes * self.expansion
        self.stride = stride
        self.act = get_act_fn(act)
        self.conv1 = Conv2d(inplanes, width // reduce_first, 1, dtype=dtype)
        self.bn1 = BatchNorm2d(width // reduce_first, dtype=dtype)
        self.conv2 = LambdaLayer(width // reduce_first, width, dtype=dtype)
        self.bn2 = BatchNorm2d(width, dtype=dtype)
        self.conv3 = Conv2d(width, outplanes, 1, dtype=dtype)
        self.bn3 = BatchNorm2d(outplanes, zero_init=zero_init_last_bn,
                               dtype=dtype)
        self.se = create_attn(attn_layer, outplanes, dtype=dtype)
        self.downsample = downsample
        self.drop_path = DropPath(drop_path_rate)

    def forward(self, x):
        y = self.act(self.bn1(self.conv1(x)))
        y = self.act(self.bn2(self.conv2(y)))
        if self.stride > 1:
            y = avg_pool2d(y, 3, 2, padding=1)
        y = self.bn3(self.conv3(y))
        if self.se is not None:
            y = self.se(y)
        residual = x if self.downsample is None else self.downsample(x)
        return self.act(self.drop_path(y) + residual)


@register_model
def lambdanet50(pretrained=False, **kwargs):
    return build_model_with_cfg(ResNet, "lambdanet50",
                                default_cfgs["lambdanet50"],
                                block=LambdaBottleneck,
                                **dict(dict(layers=(3, 4, 6, 3)), **kwargs))
