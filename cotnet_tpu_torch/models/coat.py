"""CoaT, co-scale conv-attentional image transformers (reference
models/coat.py), counterpart of ``cotnet_tpu/models/coat.py``.  Every row
of the JAX package's ``COAT_VARIANTS`` (5 registry keys): the lite models
are four serial stages (patch embed + LN, a class token, serial blocks)
-> LN of the last class token -> head; ``coat_tiny`` and ``coat_mini`` add
parallel blocks over stages 2-4, which exchange their attention outputs
across the scales, and an ``aggregate`` 1x1 Conv1d over the three normed
class tokens before the head.

Factorized attention: ``q (softmax(k)^T v) / sqrt(dh)`` with the softmax
over the tokens, all in f32, plus the conv relative position encoding
(``ConvRelPosEnc``: depthwise 3x3, 5x5 and 7x7 convs on v over 2, 3 and 3
heads, times q, the class row zero).  ``ConvPosEnc`` adds a depthwise 3x3
of the map to itself before each block.  One ``cpe{s}`` and one
``crpe{s}`` per stage, shared by the stage's serial blocks and by the
parallel blocks, and one MLP per parallel block shared by its three
scales: built as timm builds them, so the state_dict carries each shared
tensor under every name timm gives it (``serial_blocks{s}.{b}.cpe``,
``...factoratt_crpe.crpe``, ``parallel_blocks.{p}.factoratt_crpe{s}.crpe``,
``mlp2``/``mlp3``/``mlp4``) and ``parameters()`` counts it once.  The
parallel blocks' bilinear resize of the attention outputs is antialiased
where it shrinks a map, as ``jax.image.resize`` is (the reference's
``F.interpolate`` is not).  No block has stochastic depth: the JAX package
passes none (``cotnet_tpu/models/coat.py:243-247``).  ``drop_rate`` drops
the pooled features in training.  Any input whose size divides by 32 is
taken.

Parameter names are timm's: ``patch_embed{s}.{proj,norm}``,
``cls_token{s}``, ``cpe{s}.proj``, ``crpe{s}.conv_list.{0,1,2}``,
``serial_blocks{s}.{b}.{norm1,factoratt_crpe.{qkv,proj},norm2,mlp.fc1,
mlp.fc2}``, ``parallel_blocks.{p}.{norm12,norm13,norm14,factoratt_crpe2,
factoratt_crpe3,factoratt_crpe4,norm22,norm23,norm24,mlp2}``, ``norm2``,
``norm3``, ``norm4``, ``aggregate`` and ``head`` (``norm4`` and ``head``
in the lite models).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from cotnet_tpu_torch.models.helpers import (build_model_with_cfg,
                                             default_cfg,
                                             register_variant_table)
from cotnet_tpu_torch.models.vision_transformer import Mlp
from cotnet_tpu_torch.nn import Conv2d, Dropout, LayerNorm, Linear

default_cfgs = {}  # filled beside the variant table below

# heads per conv window size (reference coat.py:335)
CRPE_WINDOWS = ((3, 2), (5, 3), (7, 3))


def _to_map(tokens, size):
    """``[N, H*W, C]`` -> ``[N, C, H, W]``."""
    n, _, c = tokens.shape
    return tokens.transpose(1, 2).reshape(n, c, *size)


def _to_tokens(x):
    """``[N, C, H, W]`` -> ``[N, H*W, C]``."""
    return x.flatten(2).transpose(1, 2)


class ConvRelPosEnc(nn.Module):
    """``q * dwconv(v)`` over the image tokens, the heads split across the
    windows of ``CRPE_WINDOWS``; the class row is zero."""

    def __init__(self, head_dim: int, num_heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if sum(h for _, h in CRPE_WINDOWS) != num_heads:
            raise ValueError(f"CoaT splits {sum(h for _, h in CRPE_WINDOWS)}"
                             f" heads across its windows, got {num_heads}")
        self.channel_splits = [h * head_dim for _, h in CRPE_WINDOWS]
        self.conv_list = nn.ModuleList(
            Conv2d(ch, ch, w, 1, w // 2, groups=ch, bias=True, dtype=dtype)
            for (w, _), ch in zip(CRPE_WINDOWS, self.channel_splits))

    def forward(self, q, v, size):
        n, h, length, dh = q.shape
        has_cls = length == size[0] * size[1] + 1
        q_img = q[:, :, 1:] if has_cls else q
        v_img = v[:, :, 1:] if has_cls else v
        vi = v_img.permute(0, 1, 3, 2).reshape(n, h * dh, *size)
        ve = torch.cat([conv(part) for conv, part in zip(
            self.conv_list, vi.split(self.channel_splits, 1))], 1)
        out = q_img * ve.reshape(n, h, dh, -1).transpose(-2, -1)
        if has_cls:
            out = F.pad(out, (0, 0, 1, 0))
        return out


class FactorAttn(nn.Module):
    """timm's ``FactorAtt_ConvRelPosEnc``: ``qkv``, ``proj`` and the shared
    ``crpe``."""

    def __init__(self, dim: int, num_heads: int, crpe: ConvRelPosEnc,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        self.qkv = Linear(dim, 3 * dim, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)
        self.crpe = crpe

    def forward(self, x, size):
        n, length, d = x.shape
        h = self.num_heads
        dh = d // h
        qkv = self.qkv(x).reshape(n, length, 3, h, dh).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.unbind(0)
        factor = torch.matmul(torch.softmax(k.float(), 2).transpose(-2, -1),
                              v.float())
        y = torch.matmul(q.float(), factor) * dh ** -0.5 \
            + self.crpe(q, v, size).float()
        y = y.to(self.dtype).transpose(1, 2).reshape(n, length, d)
        return self.proj(y)


class ConvPosEnc(nn.Module):
    """``x + dwconv3x3(x)`` on the image tokens; the class token passes."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.proj = Conv2d(dim, dim, 3, 1, 1, groups=dim, bias=True,
                           dtype=dtype)

    def forward(self, x, size):
        img = _to_map(x[:, 1:], size)
        return torch.cat([x[:, :1], _to_tokens(img + self.proj(img))], 1)


class SerialBlock(nn.Module):
    """The stage's shared ``cpe``, then pre-LN factorized attention and MLP,
    LayerNorm eps 1e-6."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float,
                 cpe: ConvPosEnc, crpe: ConvRelPosEnc,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cpe = cpe
        self.norm1 = LayerNorm(dim, 1e-6, dtype=dtype)
        self.factoratt_crpe = FactorAttn(dim, num_heads, crpe, dtype=dtype)
        self.norm2 = LayerNorm(dim, 1e-6, dtype=dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype=dtype)

    def forward(self, x, size):
        x = self.cpe(x, size)
        x = x + self.factoratt_crpe(self.norm1(x), size)
        return x + self.mlp(self.norm2(x))


def interpolate_tokens(x, size, out_size):
    """The image tokens of ``x`` resized bilinearly from ``size`` to
    ``out_size`` (half-pixel centres, antialiased where the map shrinks,
    as ``jax.image.resize``); the class token passes."""
    img = F.interpolate(_to_map(x[:, 1:], size), size=tuple(out_size),
                        mode="bilinear", align_corners=False,
                        antialias=out_size[0] < size[0]
                        or out_size[1] < size[1])
    return torch.cat([x[:, :1], _to_tokens(img)], 1)


class ParallelBlock(nn.Module):
    """Factorized attention at each of stages 2-4 (their shared crpes),
    each scale's output added with the others' resized to it, then one MLP
    shared by the three scales (``mlp2``, aliased ``mlp3`` and ``mlp4``)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float,
                 crpes: Sequence[ConvRelPosEnc],
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        for i, crpe in zip((2, 3, 4), crpes):
            self.add_module(f"norm1{i}", LayerNorm(dim, 1e-6, dtype=dtype))
            self.add_module(f"factoratt_crpe{i}",
                            FactorAttn(dim, num_heads, crpe, dtype=dtype))
        for i in (2, 3, 4):
            self.add_module(f"norm2{i}", LayerNorm(dim, 1e-6, dtype=dtype))
        self.mlp2 = self.mlp3 = self.mlp4 = Mlp(dim, int(dim * mlp_ratio),
                                                dtype=dtype)

    def forward(self, x2, x3, x4, sizes):
        s2, s3, s4 = sizes
        c2, c3, c4 = (getattr(self, f"factoratt_crpe{i}")(
            getattr(self, f"norm1{i}")(x), s)
            for i, x, s in zip((2, 3, 4), (x2, x3, x4), sizes))
        x2 = x2 + (c2 + interpolate_tokens(c3, s3, s2)
                   + interpolate_tokens(c4, s4, s2))
        x3 = x3 + (c3 + interpolate_tokens(c4, s4, s3)
                   + interpolate_tokens(c2, s2, s3))
        x4 = x4 + (c4 + interpolate_tokens(c3, s3, s4)
                   + interpolate_tokens(c2, s2, s4))
        return tuple(x + self.mlp2(getattr(self, f"norm2{i}")(x))
                     for i, x in zip((2, 3, 4), (x2, x3, x4)))


class PatchEmbed(nn.Module):
    """A ``patch_size`` strided conv with a bias, then LN (eps 1e-5):
    ``[N, C, H, W]`` -> ``[N, H/p * W/p, D]`` and the map's size."""

    def __init__(self, patch_size: int, in_chans: int, embed_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.proj = Conv2d(in_chans, embed_dim, patch_size, patch_size, 0,
                           bias=True, dtype=dtype)
        self.norm = LayerNorm(embed_dim, 1e-5, dtype=dtype)

    def forward(self, x):
        x = self.proj(x)
        return self.norm(_to_tokens(x)), tuple(x.shape[2:])


class Aggregate(nn.Module):
    """timm's ``Conv1d(3, 1, 1)`` over the three class tokens ``[N, 3,
    D]`` -> ``[N, D]``."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(1, 3, 1))
        self.bias = nn.Parameter(torch.empty(1))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """LeCun normal over the 3 inputs and a zero bias, as the JAX
        package's ``Dense(1)``."""
        with torch.no_grad():
            self.weight.normal_(0.0, 3 ** -0.5, generator=generator)
            self.bias.zero_()

    def forward(self, x):
        dt = self.dtype
        return F.conv1d(x.to(dt), self.weight.to(dt), self.bias.to(dt))[:, 0]


class CoaT(nn.Module):
    """``cotnet_tpu/models/coat.py:190-290``.  ``features_only`` returns
    each stage's map, ``[N, C_s, H_s, W_s]`` (those of stages 2-4 after the
    parallel blocks; the norms, ``aggregate`` and the head are not built);
    ``num_classes=0`` returns the pooled features."""

    def __init__(self, in_chans: int = 3, num_classes: int = 1000,
                 embed_dims: Sequence[int] = (64, 128, 256, 320),
                 serial_depths: Sequence[int] = (2, 2, 2, 2),
                 parallel_depth: int = 0, num_heads: int = 8,
                 mlp_ratios: Sequence[float] = (8, 8, 4, 4),
                 drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 features_only: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.features_only = features_only
        self.parallel_depth = parallel_depth
        chans = in_chans
        for s, (dim, depth, mr) in enumerate(
                zip(embed_dims, serial_depths, mlp_ratios), 1):
            self.add_module(f"patch_embed{s}", PatchEmbed(
                4 if s == 1 else 2, chans, dim, dtype=dtype))
            self.register_parameter(f"cls_token{s}", nn.Parameter(
                torch.empty(1, 1, dim)))
            cpe = ConvPosEnc(dim, dtype=dtype)
            crpe = ConvRelPosEnc(dim // num_heads, num_heads, dtype=dtype)
            self.add_module(f"cpe{s}", cpe)
            self.add_module(f"crpe{s}", crpe)
            self.add_module(f"serial_blocks{s}", nn.ModuleList(
                SerialBlock(dim, num_heads, mr, cpe, crpe, dtype=dtype)
                for _ in range(depth)))
            chans = dim
        self.parallel_blocks = None
        if parallel_depth:
            if len(set(embed_dims[1:])) != 1:
                raise ValueError(f"the parallel blocks need stages 2-4 of "
                                 f"one width, got {embed_dims}")
            self.parallel_blocks = nn.ModuleList(
                ParallelBlock(embed_dims[1], num_heads, mlp_ratios[1],
                              (self.crpe2, self.crpe3, self.crpe4),
                              dtype=dtype)
                for _ in range(parallel_depth))
        self.norm2 = self.norm3 = self.norm4 = None
        self.aggregate = self.head = None
        if not features_only:
            if parallel_depth:
                self.norm2 = LayerNorm(embed_dims[1], 1e-6, dtype=dtype)
                self.norm3 = LayerNorm(embed_dims[2], 1e-6, dtype=dtype)
            self.norm4 = LayerNorm(embed_dims[3], 1e-6, dtype=dtype)
            if parallel_depth:
                self.aggregate = Aggregate(dtype=dtype)
            if num_classes > 0:
                self.head = Linear(embed_dims[3], num_classes, dtype=dtype)
        self.drop = Dropout(drop_rate)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The class tokens normal with std 0.02, as the JAX package
        initializes them."""
        with torch.no_grad():
            for s in range(1, 5):
                getattr(self, f"cls_token{s}").normal_(0.0, 0.02,
                                                       generator=generator)

    def forward(self, x):
        n = x.shape[0]
        tokens, sizes, feats = [], [], []
        for s in range(1, 5):
            t, size = getattr(self, f"patch_embed{s}")(x)
            cls = getattr(self, f"cls_token{s}")
            t = torch.cat([cls.expand(n, -1, -1).to(t.dtype), t], 1)
            for block in getattr(self, f"serial_blocks{s}"):
                t = block(t, size)
            tokens.append(t)
            sizes.append(size)
            x = _to_map(t[:, 1:], size)
            feats.append(x)
        if self.parallel_blocks is None:
            if self.features_only:
                return feats
            out = self.norm4(tokens[3][:, 0])
        else:
            t2, t3, t4 = tokens[1:]
            for block in self.parallel_blocks:
                t2 = self.cpe2(t2, sizes[1])
                t3 = self.cpe3(t3, sizes[2])
                t4 = self.cpe4(t4, sizes[3])
                t2, t3, t4 = block(t2, t3, t4, sizes[1:])
            if self.features_only:
                return [feats[0]] + [_to_map(t[:, 1:], s) for t, s in
                                     zip((t2, t3, t4), sizes[1:])]
            cls = torch.stack([self.norm2(t2[:, 0]), self.norm3(t3[:, 0]),
                               self.norm4(t4[:, 0])], 1)
            out = self.aggregate(cls)
        out = self.drop(out)
        return out if self.head is None else self.head(out)


def _coat(model_name, pretrained=False, **kwargs):
    """Build a row on ``CoaT`` (``pretrained`` is accepted and ignored:
    weights load through ``utils.convert``)."""
    return build_model_with_cfg(CoaT, model_name, default_cfgs[model_name],
                                **kwargs)


# --- variant table (reference coat.py:617-659) ------------------------------

COAT_VARIANTS = {
    "coat_tiny": dict(embed_dims=(152, 152, 152, 152),
                      serial_depths=(2, 2, 2, 2), parallel_depth=6,
                      mlp_ratios=(4, 4, 4, 4)),
    "coat_mini": dict(embed_dims=(152, 216, 216, 216),
                      serial_depths=(2, 2, 2, 2), parallel_depth=6,
                      mlp_ratios=(4, 4, 4, 4)),
    "coat_lite_tiny": dict(embed_dims=(64, 128, 256, 320),
                           serial_depths=(2, 2, 2, 2)),
    "coat_lite_mini": dict(embed_dims=(64, 128, 320, 512),
                           serial_depths=(2, 2, 2, 2)),
    "coat_lite_small": dict(embed_dims=(64, 128, 320, 512),
                            serial_depths=(3, 4, 6, 3)),
}

for _name in COAT_VARIANTS:
    default_cfgs[_name] = default_cfg(crop_pct=0.9, mean=(0.5, 0.5, 0.5),
                                      std=(0.5, 0.5, 0.5),
                                      first_conv="patch_embed1.proj",
                                      classifier="head")

register_variant_table(__name__, _coat, COAT_VARIANTS)
