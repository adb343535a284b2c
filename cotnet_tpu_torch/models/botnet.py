"""BoTNet-S1 (reference models/botnet.py), counterpart of
``cotnet_tpu/models/botnet.py``: the ResNet chassis whose stage-4 blocks
replace the 3x3 conv by global multi-head self-attention with 2-D relative
position logits, at stride 1 (a stage-4 block that would stride keeps its
map and takes a 1x1 projection shortcut), with swish in every block.

The attention is f32 ``torch.einsum`` work, as the JAX package's is einsum
work with no Pallas kernel; ``scaled_dot_product_attention`` is not used,
since the relative logits are added before the softmax.  The relative
embeddings are sized by the stage-4 map, which the model must know when it
is built: ``img_size`` (default the config's 256 px, a 16x16 map) sets it,
and an input of another size raises.  Parameter names are the reference's:
``conv2`` is the Sequential ``[conv or MHSA, bn, act]``, and the MHSA's
projections are raw ``q_proj.w`` ... ``[C, heads, C/heads]``."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from cotnet_tpu_torch.models.helpers import build_model_with_cfg, default_cfg
from cotnet_tpu_torch.models.registry import register_model
from cotnet_tpu_torch.models.resnet import Act, Downsample, ResNet
from cotnet_tpu_torch.nn import (BatchNorm2d, Conv2d, DropBlock2d, DropPath,
                                 create_attn, swish)

default_cfgs = {
    "BoTNetS1_59": default_cfg(input_size=(3, 256, 256), pool_size=(16, 16),
                               crop_pct=0.888),
    "BoTNetS1_128": default_cfg(input_size=(3, 256, 256), pool_size=(16, 16),
                                crop_pct=0.888),
}


def rel_to_abs(x):
    """``[B, heads, L, 2L-1]`` relative -> ``[B, heads, L, L]`` absolute
    logits (reference botnet.py:95-106, the pad-and-reshape trick; JAX
    ``botnet.py:28-37`` line for line)."""
    b, heads, length, _ = x.shape
    x = F.pad(x, (0, 1))
    x = x.reshape(b, heads, length * 2 * length)
    x = F.pad(x, (0, length - 1))
    x = x.reshape(b, heads, length + 1, 2 * length - 1)
    return x[:, :, :length, length - 1:]


def relative_logits_1d(q, rel_k):
    """q ``[B, heads, H, W, d]``, rel_k ``[2W-1, d]`` -> ``[B, heads, H, W,
    W]`` (reference botnet.py:81-93)."""
    b, heads, h, w, _ = q.shape
    logits = torch.einsum("bnxyd,md->bnxym", q, rel_k)
    logits = rel_to_abs(logits.reshape(b, heads * h, w, 2 * w - 1))
    return logits.reshape(b, heads, h, w, w)


class RelPosSelfAttention(nn.Module):
    """Scaled dot-product attention over all H x W positions plus the
    relative logits along W and along H, in f32 (JAX ``botnet.py:51-93``)."""

    def __init__(self, heads: int, dim_head: int, h: int, w: int):
        super().__init__()
        self.heads, self.dim_head, self.h, self.w = heads, dim_head, h, w
        self.rel_emb_w = nn.Parameter(torch.empty(2 * w - 1, dim_head))
        self.rel_emb_h = nn.Parameter(torch.empty(2 * h - 1, dim_head))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            for p in (self.rel_emb_w, self.rel_emb_h):
                p.normal_(0.0, self.dim_head ** -0.5, generator=generator)

    def forward(self, q, k, v):
        """q, k, v ``[B, heads, H, W, d]`` f32 -> ``[B, heads*d, H, W]``
        f32, channel ``head*d + i``."""
        b, heads, h, w, d = q.shape
        qf = q * (d ** -0.5)
        logits = torch.einsum("bnhwd,bnpqd->bnhwpq", qf, k)
        rel_w = relative_logits_1d(qf, self.rel_emb_w)        # [b,n,h,w,w]
        rel_w = rel_w[:, :, :, None].expand(b, heads, h, h, w, w).permute(
            0, 1, 2, 4, 3, 5)
        rel_h = relative_logits_1d(qf.transpose(2, 3), self.rel_emb_h)
        rel_h = rel_h[:, :, :, None].expand(b, heads, w, w, h, h).permute(
            0, 1, 4, 2, 5, 3)
        logits = logits + rel_w + rel_h
        weights = F.softmax(logits.reshape(b, heads, h, w, h * w), -1)
        out = torch.einsum("bnhwpq,bnpqd->bnhwd",
                           weights.reshape(b, heads, h, w, h, w), v)
        return out.permute(0, 1, 4, 2, 3).reshape(b, heads * d, h, w)


class MHSA(nn.Module):
    """Grouped pointwise q/k/v projections ``[C, heads, C/heads]`` and the
    relative-position attention (reference botnet.py:150-194), on a map of
    ``pos_h x pos_w``, the one it was built for."""

    def __init__(self, channels: int, heads: int = 4, pos_h: int = 16,
                 pos_w: int = 16, dtype: torch.dtype = torch.float32):
        super().__init__()
        d = channels // heads
        self.heads, self.pos_h, self.pos_w = heads, pos_h, pos_w
        self.dtype = dtype
        for name in ("q_proj", "k_proj", "v_proj"):
            self.add_module(name, _Projection(channels, heads, d))
        self.self_attention = RelPosSelfAttention(heads, d, pos_h, pos_w)

    def forward(self, x):
        if tuple(x.shape[2:]) != (self.pos_h, self.pos_w):
            raise ValueError(
                f"BoTNet's attention was built for a {self.pos_h}x"
                f"{self.pos_w} stage-4 map, got {tuple(x.shape[2:])}: build "
                "the model with img_size= the input's size")
        xf = x.float()
        q, k, v = (torch.einsum("bchw,cnp->bnhwp", xf, p.w)
                   for p in (self.q_proj, self.k_proj, self.v_proj))
        return self.self_attention(q, k, v).to(self.dtype)


class _Projection(nn.Module):
    """The reference's GroupPointWise: one raw parameter ``w``."""

    def __init__(self, channels: int, heads: int, dim_head: int):
        super().__init__()
        self.w = nn.Parameter(torch.empty(channels, heads, dim_head))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.w.normal_(0.0, self.w.shape[0] ** -0.5, generator=generator)


class BotBottleneck(nn.Module):
    """Reference botnet.py:196-301 (JAX ``botnet.py:113-197``): a plain
    bottleneck with swish, whose stage-4 form (``planes == 512``) has MHSA
    in place of the 3x3 conv, no ``se``, and stride 1 with a 1x1 projection
    shortcut where the chassis asks for stride 2.  ``fmap`` is the stage-4
    map the MHSA is built for; ``act`` is swish whatever the chassis
    passes, as in the JAX block."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: Optional[nn.Module] = None,
                 cardinality: int = 1, base_width: int = 64,
                 reduce_first: int = 1, dilation: int = 1,
                 first_dilation: Optional[int] = None, act: str = "swish",
                 attn_layer=None, drop_block: Optional[tuple] = None,
                 drop_path_rate: float = 0.0,
                 zero_init_last_bn: bool = True, mhsa_heads: int = 4,
                 fmap: int = 16, dtype: torch.dtype = torch.float32):
        super().__init__()
        width = int(math.floor(planes * (base_width / 64))) * cardinality
        first_planes = width // reduce_first
        outplanes = planes * self.expansion
        fd = first_dilation or dilation
        is_mhsa = planes == 512
        if is_mhsa and stride == 2:
            downsample = Downsample(inplanes, outplanes, 1, dtype=dtype)
            stride = 1
        self.conv1 = Conv2d(inplanes, first_planes, 1, dtype=dtype)
        self.bn1 = BatchNorm2d(first_planes, dtype=dtype)
        self.drop_block = (nn.Identity() if drop_block is None
                           else DropBlock2d(*drop_block))
        core = (MHSA(first_planes, mhsa_heads, fmap, fmap, dtype=dtype)
                if is_mhsa else
                Conv2d(first_planes, width, 3, stride, fd, fd,
                       groups=cardinality, dtype=dtype))
        self.conv2 = nn.Sequential(core, BatchNorm2d(width, dtype=dtype),
                                   Act("swish"))
        self.conv3 = Conv2d(width, outplanes, 1, dtype=dtype)
        self.bn3 = BatchNorm2d(outplanes, zero_init=zero_init_last_bn,
                               dtype=dtype)
        self.se = None if is_mhsa else create_attn(attn_layer, outplanes,
                                                   dtype=dtype)
        self.downsample = downsample
        self.drop_path = DropPath(drop_path_rate)

    def forward(self, x):
        y = swish(self.drop_block(self.bn1(self.conv1(x))))
        y = self.bn3(self.conv3(self.conv2(y)))
        if self.se is not None:
            y = self.se(y)
        residual = x if self.downsample is None else self.downsample(x)
        return swish(self.drop_path(y) + residual)


def stage4_map(img_size: int) -> int:
    """The side of BoTNet's stage-4 map for a square ``img_size`` input:
    the stem conv, the stem pool and stages 2 and 3 each halve it (rounding
    up); stage 4 keeps it."""
    side = img_size
    for _ in range(4):
        side = (side + 1) // 2
    return side


def _create_botnet(model_name, img_size: Optional[int] = None,
                   block_args: Optional[dict] = None, **kwargs):
    cfg = default_cfgs[model_name]
    size = img_size or cfg["input_size"][-1]
    block_args = dict(dict(attn_layer="se"), **(block_args or {}),
                      fmap=stage4_map(size))
    return build_model_with_cfg(ResNet, model_name, cfg,
                                block=BotBottleneck, block_args=block_args,
                                **kwargs)


@register_model
def BoTNetS1_59(pretrained=False, **kwargs):
    return _create_botnet("BoTNetS1_59", **dict(dict(layers=(3, 4, 6, 6)),
                                                **kwargs))


@register_model
def BoTNetS1_128(pretrained=False, **kwargs):
    return _create_botnet("BoTNetS1_128", **dict(dict(layers=(3, 4, 23, 12)),
                                                 **kwargs))
