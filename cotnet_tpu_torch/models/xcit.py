"""XCiT, cross-covariance image transformer (reference models/xcit.py),
counterpart of ``cotnet_tpu/models/xcit.py``: a conv patch embed (3x3
stride-2 convs with BN) + a Fourier position encoding -> XCA blocks
(attention across channels, local patch interaction, MLP) -> the cls token
joins -> class-attention blocks -> LN -> head.  Every row of the JAX
package's ``XCIT_VARIANTS`` (42 registry keys) is registered here.

XCA normalizes q and k over the tokens by their f32 L2 norm plus 1e-6
(timm's ``F.normalize`` divides by ``max(norm, 1e-12)``), so the channel
product, the ``temperature`` scale and the softmax are f32; v is cast to
the compute dtype (``cotnet_tpu/models/xcit.py:24-49``).  The
class-attention blocks keep the reference's two residual quirks that the
JAX package keeps: the attention residual adds the *normed* patch tokens
scaled by ``gamma1``, and the MLP residual doubles the patch tokens
(``:202-224``).  Any input whose size divides by the patch is taken: the
position encoding is computed from the grid (and kept per grid and
device).  The BNs are the port's ``BatchNorm2d``, global-batch under a
process group.  ``drop_rate`` is accepted and unused, as in the JAX
package.

Parameter names are timm's: ``patch_embed.proj.{0,2,4,6}.{0,1}`` (conv,
BN; p8 has three), ``pos_embed.token_projection``, ``blocks.{i}.{norm1,
attn.{qkv,temperature,proj},gamma1,norm3,local_mp.{conv1,bn,conv2},gamma3,
norm2,mlp,gamma2}``, ``cls_token``, ``cls_attn_blocks.{i}.{norm1,attn,
gamma1,norm2,mlp,gamma2}``, ``norm``, ``head``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from cotnet_tpu_torch.models.cait import ClassAttn
from cotnet_tpu_torch.models.helpers import (build_model_with_cfg,
                                             default_cfg,
                                             register_variant_table)
from cotnet_tpu_torch.models.vision_transformer import Mlp
from cotnet_tpu_torch.nn import (BatchNorm2d, Conv2d, DropPath, LayerNorm,
                                 Linear, get_act_fn)

default_cfgs = {}  # filled beside the variant table below


def _layer_scale(dim: int, eta: float) -> nn.Parameter:
    return nn.Parameter(torch.full((dim,), float(eta)))


class XCA(nn.Module):
    """Cross-covariance attention over ``[N, L, D]`` tokens: per head a
    ``dh x dh`` attention between channels (``cotnet_tpu/models/xcit.py:
    24-49``)."""

    def __init__(self, dim: int, num_heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        self.qkv = Linear(dim, 3 * dim, dtype=dtype)
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.proj = Linear(dim, dim, dtype=dtype)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.temperature.fill_(1.0)

    def forward(self, x):
        n, length, d = x.shape
        h = self.num_heads
        qkv = self.qkv(x).reshape(n, length, 3, h, d // h).permute(
            2, 0, 3, 4, 1)
        q, k, v = qkv.unbind(0)                       # [n, h, dh, L]
        q = q / (torch.linalg.vector_norm(q.float(), dim=-1, keepdim=True)
                 + 1e-6)
        k = k / (torch.linalg.vector_norm(k.float(), dim=-1, keepdim=True)
                 + 1e-6)
        attn = torch.matmul(q, k.transpose(-2, -1)) * self.temperature
        attn = torch.softmax(attn, -1).to(self.dtype)
        y = torch.matmul(attn, v.to(self.dtype))      # [n, h, dh, L]
        return self.proj(y.permute(0, 3, 1, 2).reshape(n, length, d))


class LPI(nn.Module):
    """Local patch interaction on the token grid: a depthwise 3x3 conv with
    a bias, GELU, BN, a depthwise 3x3 conv (``cotnet_tpu/models/xcit.py:
    52-70``), on ``[N, D, H, W]``."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv2d(dim, dim, 3, 1, 1, groups=dim, bias=True,
                            dtype=dtype)
        self.act = get_act_fn("gelu")
        self.bn = BatchNorm2d(dim, dtype=dtype)
        self.conv2 = Conv2d(dim, dim, 3, 1, 1, groups=dim, bias=True,
                            dtype=dtype)

    def forward(self, x, hw):
        n, length, d = x.shape
        y = x.transpose(1, 2).reshape(n, d, *hw)
        y = self.conv2(self.bn(self.act(self.conv1(y))))
        return y.reshape(n, d, length).transpose(1, 2)


class XCABlock(nn.Module):
    """norm1 -> XCA -> gamma1, norm3 -> LPI -> gamma3, norm2 -> MLP ->
    gamma2, each a residual branch with stochastic depth
    (``cotnet_tpu/models/xcit.py:73-112``)."""

    def __init__(self, dim: int, num_heads: int, eta: float = 1.0,
                 mlp_ratio: float = 4.0, drop_path_rate: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eta = eta
        self.norm1 = LayerNorm(dim, 1e-6, dtype=dtype)
        self.attn = XCA(dim, num_heads, dtype=dtype)
        self.norm3 = LayerNorm(dim, 1e-6, dtype=dtype)
        self.local_mp = LPI(dim, dtype=dtype)
        self.norm2 = LayerNorm(dim, 1e-6, dtype=dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype=dtype)
        self.drop_path = DropPath(drop_path_rate)
        self.gamma1 = _layer_scale(dim, eta)
        self.gamma3 = _layer_scale(dim, eta)
        self.gamma2 = _layer_scale(dim, eta)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            for g in (self.gamma1, self.gamma2, self.gamma3):
                g.fill_(self.eta)

    def forward(self, x, hw):
        y = self.attn(self.norm1(x))
        x = x + self.drop_path(self.gamma1.to(y.dtype) * y)
        y = self.local_mp(self.norm3(x), hw)
        x = x + self.drop_path(self.gamma3.to(y.dtype) * y)
        y = self.mlp(self.norm2(x))
        return x + self.drop_path(self.gamma2.to(y.dtype) * y)


class ClassAttentionBlock(nn.Module):
    """XCiT's class-attention block (reference ClassAttentionBlock,
    ``cotnet_tpu/models/xcit.py:195-224``), with its residual quirks (see
    the module docstring).  ``tokens_norm=False`` (the nano rows) norms the
    cls token alone before the MLP."""

    def __init__(self, dim: int, num_heads: int, eta: float = 1.0,
                 tokens_norm: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eta, self.tokens_norm = eta, tokens_norm
        self.norm1 = LayerNorm(dim, 1e-6, dtype=dtype)
        self.attn = ClassAttn(dim, num_heads, dtype=dtype)
        self.norm2 = LayerNorm(dim, 1e-6, dtype=dtype)
        self.mlp = Mlp(dim, 4 * dim, dtype=dtype)
        self.gamma1 = _layer_scale(dim, eta)
        self.gamma2 = _layer_scale(dim, eta)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.gamma1.fill_(self.eta)
            self.gamma2.fill_(self.eta)

    def forward(self, x):
        y = self.norm1(x)
        a = self.attn(y)
        x = x + self.gamma1.to(a.dtype) * torch.cat([a, y[:, 1:]], dim=1)
        if self.tokens_norm:
            x = self.norm2(x)
        else:
            x = torch.cat([self.norm2(x[:, :1]), x[:, 1:]], dim=1)
        m = self.mlp(x[:, :1])
        return x + torch.cat([self.gamma2.to(m.dtype) * m, x[:, 1:]], dim=1)


def fourier_features(gh: int, gw: int, device=None, hidden: int = 32):
    """The Fourier position features of a ``gh x gw`` grid, ``[1, 2 *
    hidden, gh, gw]`` f32 (reference PositionalEncodingFourier,
    ``cotnet_tpu/models/xcit.py:152-177``): per axis, coordinates
    ``arange(1, g + 1) / (g + 1e-6) * 2 pi`` over ``10000 ** (2 * (j // 2)
    / hidden)``, sin at even j and cos at odd j; y's features before
    x's."""
    j = torch.arange(hidden, device=device)
    dim_t = 10000.0 ** (2 * (j // 2) / hidden)

    def axis(g):
        coords = torch.arange(1, g + 1, dtype=torch.float32, device=device)
        p = (coords / (g + 1e-6) * (2 * math.pi))[:, None] / dim_t
        return torch.stack([p[:, 0::2].sin(), p[:, 1::2].cos()],
                           -1).reshape(g, hidden)

    pos_y = axis(gh)[:, None, :].expand(gh, gw, hidden)
    pos_x = axis(gw)[None, :, :].expand(gh, gw, hidden)
    return torch.cat([pos_y, pos_x], -1).permute(2, 0, 1)[None]


class PositionalEncodingFourier(nn.Module):
    """``fourier_features`` through a 1x1 conv with a bias,
    ``token_projection``: ``(gh, gw)`` -> ``[1, D, gh, gw]``."""

    def __init__(self, dim: int, hidden: int = 32,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.hidden = hidden
        self.token_projection = Conv2d(2 * hidden, dim, 1, bias=True,
                                       dtype=dtype)
        self._features = {}   # (gh, gw, device) -> fourier_features

    def forward(self, gh: int, gw: int):
        device = self.token_projection.weight.device
        key = (gh, gw, device)
        if key not in self._features:
            self._features[key] = fourier_features(gh, gw, device,
                                                   self.hidden)
        return self.token_projection(self._features[key])


class ConvPatchEmbed(nn.Module):
    """3x3 stride-2 bias-free convs, each followed by BN, with GELU between
    them (``cotnet_tpu/models/xcit.py:136-149``): four of widths D/8, D/4,
    D/2, D at patch 16, three of D/4, D/2, D at patch 8."""

    def __init__(self, patch_size: int, in_chans: int, embed_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if patch_size not in (8, 16):
            raise ValueError(f"XCiT's conv patch embed takes patch 8 or 16, "
                             f"not {patch_size}")
        steps = 4 if patch_size == 16 else 3
        dims = [embed_dim // 8, embed_dim // 4, embed_dim // 2,
                embed_dim][4 - steps:]
        layers, cin = [], in_chans
        for i, dim in enumerate(dims):
            layers.append(nn.Sequential(
                Conv2d(cin, dim, 3, 2, 1, dtype=dtype),
                BatchNorm2d(dim, dtype=dtype)))
            if i < steps - 1:
                layers.append(nn.GELU())
            cin = dim
        self.proj = nn.Sequential(*layers)

    def forward(self, x):
        return self.proj(x)


class XCiT(nn.Module):
    """``cotnet_tpu/models/xcit.py:115-230``.  ``features_only`` returns the
    patch tokens after the XCA blocks as one ``[N, D, gh, gw]`` map (the
    cls token, the class-attention blocks, the norm and the head are not
    built); ``num_classes=0`` returns the normed cls token."""

    def __init__(self, patch_size: int = 16, in_chans: int = 3,
                 num_classes: int = 1000, embed_dim: int = 192,
                 depth: int = 12, num_heads: int = 4,
                 cls_attn_layers: int = 2, eta: float = 1.0,
                 tokens_norm: bool = True, drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0, features_only: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.features_only = features_only
        self.patch_embed = ConvPatchEmbed(patch_size, in_chans, embed_dim,
                                          dtype=dtype)
        self.pos_embed = PositionalEncodingFourier(embed_dim, dtype=dtype)
        self.blocks = nn.ModuleList(
            XCABlock(embed_dim, num_heads, eta,
                     drop_path_rate=drop_path_rate * i / max(depth - 1, 1),
                     dtype=dtype)
            for i in range(depth))
        self.cls_token = self.cls_attn_blocks = self.norm = None
        self.head = None
        if not features_only:
            self.cls_token = nn.Parameter(torch.empty(1, 1, embed_dim))
            self.cls_attn_blocks = nn.ModuleList(
                ClassAttentionBlock(embed_dim, num_heads, eta, tokens_norm,
                                    dtype=dtype)
                for _ in range(cls_attn_layers))
            self.norm = LayerNorm(embed_dim, 1e-6, dtype=dtype)
            if num_classes > 0:
                self.head = Linear(embed_dim, num_classes, dtype=dtype)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The cls token normal with std 0.02, as the JAX package
        initializes it."""
        if self.cls_token is not None:
            with torch.no_grad():
                self.cls_token.normal_(0.0, 0.02, generator=generator)

    def forward(self, x):
        x = self.patch_embed(x)
        n, d, gh, gw = x.shape
        x = (x + self.pos_embed(gh, gw).to(x.dtype)).flatten(2).transpose(1,
                                                                          2)
        for block in self.blocks:
            x = block(x, (gh, gw))
        if self.features_only:
            return [x.transpose(1, 2).reshape(n, d, gh, gw)]
        x = torch.cat([self.cls_token.expand(n, 1, d).to(x.dtype), x], dim=1)
        for block in self.cls_attn_blocks:
            x = block(x)
        out = self.norm(x[:, 0])
        return out if self.head is None else self.head(out)


def _xcit(model_name, pretrained=False, **kwargs):
    """Build a row on ``XCiT`` (``pretrained`` is accepted and ignored:
    weights load through ``utils.convert``)."""
    return build_model_with_cfg(XCiT, model_name, default_cfgs[model_name],
                                **kwargs)


# --- variant table (reference xcit.py:477-810) ------------------------------
# every row follows from its name, xcit_{size}_{depth}_p{patch}_{res}[_dist]:
# eta 1.0 at depth 12 and 1e-5 at depth 24, tokens_norm off for nano only;
# the _dist rows are the plain rows' architecture

_XCIT_SIZES = {"nano": (128, 4), "tiny": (192, 4), "small": (384, 8),
               "medium": (512, 8), "large": (768, 16)}

XCIT_VARIANTS = {}
for _size in ("nano", "tiny", "small", "medium", "large"):
    for _depth in (12, 24):
        if (_size in ("medium", "large") and _depth == 12) or (
                _size == "nano" and _depth == 24):
            continue
        for _patch in (16, 8):
            _dim, _heads = _XCIT_SIZES[_size]
            _row = dict(patch_size=_patch, embed_dim=_dim, depth=_depth,
                        num_heads=_heads, eta=1.0 if _depth == 12 else 1e-5,
                        tokens_norm=_size != "nano")
            for _suffix in ("224", "224_dist", "384_dist"):
                XCIT_VARIANTS[f"xcit_{_size}_{_depth}_p{_patch}_{_suffix}"] = \
                    _row

for _name in XCIT_VARIANTS:
    _size = 384 if "_384_" in _name + "_" else 224
    default_cfgs[_name] = default_cfg(
        input_size=(3, _size, _size), crop_pct=1.0,
        first_conv="patch_embed.proj.0.0", classifier="head")

register_variant_table(__name__, _xcit, XCIT_VARIANTS)
