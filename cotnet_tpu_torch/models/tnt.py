"""TNT, Transformer in Transformer (reference models/tnt.py), counterpart of
``cotnet_tpu/models/tnt.py``: an inner transformer over the pixel tokens of
each patch, projected into an outer transformer over the patch tokens.
The registry keys ``tnt_s_patch16_224`` and ``tnt_b_patch16_224``.

The pixel embed convolves the whole image (7x7 at the inner stride, pad
3) and then cuts the map into the patches' pixel tokens, in raster order
within each patch.  Attention has timm's separate ``qk`` and ``v``
projections, no bias on either; the logits are cast to f32, scaled and
softmaxed there, as the JAX package's ViT attention does.  LayerNorm eps
is 1e-5 throughout.  Stochastic depth drops the outer attention and MLP
only (``cotnet_tpu/models/tnt.py:70-78``) and ramps from 0 at the first
block to ``drop_path_rate`` at the last.  The patch position embedding is
sized when the model is built, by ``img_size`` (default 224); an input of
another size raises.

Parameter names are timm's: ``pixel_embed.proj``, ``norm1_proj``,
``proj``, ``norm2_proj``, ``cls_token``, ``patch_pos``, ``pixel_pos``
(``[1, C_in, ps/s, ps/s]``), ``blocks.{i}.{norm_in,attn_in.{qk,v,proj},
norm_mlp_in,mlp_in.fc1,mlp_in.fc2,norm1_proj,proj,norm_out,attn_out.{qk,v,
proj},norm_mlp,mlp.fc1,mlp.fc2}``, ``norm``, ``head``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from cotnet_tpu_torch.models.helpers import (build_model_with_cfg,
                                             default_cfg,
                                             register_variant_table)
from cotnet_tpu_torch.models.vision_transformer import Mlp
from cotnet_tpu_torch.nn import Conv2d, DropPath, LayerNorm, Linear

default_cfgs = {}  # filled beside the variant table below


class Attention(nn.Module):
    """Multi-head self-attention over ``[N, L, D]`` tokens with timm's TNT
    projections: ``qk`` (``D -> 2D``) and ``v`` (``D -> D``), no bias."""

    def __init__(self, dim: int, num_heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        self.qk = Linear(dim, 2 * dim, bias=False, dtype=dtype)
        self.v = Linear(dim, dim, bias=False, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)

    def forward(self, x):
        n, length, d = x.shape
        h = self.num_heads
        dh = d // h
        qk = self.qk(x).reshape(n, length, 2, h, dh).permute(2, 0, 3, 1, 4)
        q, k = qk.unbind(0)
        v = self.v(x).reshape(n, length, h, dh).transpose(1, 2)
        logits = torch.matmul(q, k.transpose(-2, -1)).float()
        attn = torch.softmax(logits * dh ** -0.5, -1).to(self.dtype)
        y = torch.matmul(attn, v).transpose(1, 2).reshape(n, length, d)
        return self.proj(y)


class TNTBlock(nn.Module):
    """The inner block on ``[N*L, P, C_in]`` pixel tokens, their projection
    into the patch tokens (the class token untouched), then the outer block
    on ``[N, 1 + L, D]``."""

    def __init__(self, dim: int, in_dim: int, num_pixel: int,
                 num_heads: int, in_num_head: int, mlp_ratio: float = 4.0,
                 drop_path_rate: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm_in = LayerNorm(in_dim, 1e-5, dtype=dtype)
        self.attn_in = Attention(in_dim, in_num_head, dtype=dtype)
        self.norm_mlp_in = LayerNorm(in_dim, 1e-5, dtype=dtype)
        self.mlp_in = Mlp(in_dim, int(in_dim * mlp_ratio), dtype=dtype)
        self.norm1_proj = LayerNorm(in_dim, 1e-5, dtype=dtype)
        self.proj = Linear(in_dim * num_pixel, dim, dtype=dtype)
        self.norm_out = LayerNorm(dim, 1e-5, dtype=dtype)
        self.attn_out = Attention(dim, num_heads, dtype=dtype)
        self.drop_path = DropPath(drop_path_rate)
        self.norm_mlp = LayerNorm(dim, 1e-5, dtype=dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype=dtype)

    def forward(self, pixel_embed, patch_embed):
        pixel_embed = pixel_embed + self.attn_in(self.norm_in(pixel_embed))
        pixel_embed = pixel_embed + self.mlp_in(self.norm_mlp_in(pixel_embed))
        n, length, _ = patch_embed.shape
        proj = self.proj(self.norm1_proj(pixel_embed).reshape(
            n, length - 1, -1))
        patch_embed = torch.cat([patch_embed[:, :1], patch_embed[:, 1:]
                                 + proj], dim=1)
        patch_embed = patch_embed + self.drop_path(
            self.attn_out(self.norm_out(patch_embed)))
        patch_embed = patch_embed + self.drop_path(
            self.mlp(self.norm_mlp(patch_embed)))
        return pixel_embed, patch_embed


class PixelEmbed(nn.Module):
    """The 7x7 conv at the inner stride, pad 3, with a bias: ``[N, C, H,
    W]`` -> ``[N, C_in, H/s, W/s]``."""

    def __init__(self, in_chans: int, in_dim: int, stride: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.proj = Conv2d(in_chans, in_dim, 7, stride, 3, bias=True,
                           dtype=dtype)

    def forward(self, x):
        return self.proj(x)


class TNT(nn.Module):
    """``cotnet_tpu/models/tnt.py:82-150``.  ``features_only`` returns the
    last block's patch tokens as one ``[N, D, H/p, W/p]`` map (the norm and
    the head are not built); ``num_classes=0`` returns the normed class
    token."""

    def __init__(self, img_size: int = 224, patch_size: int = 16,
                 in_chans: int = 3, num_classes: int = 1000,
                 embed_dim: int = 384, inner_dim: int = 24, depth: int = 12,
                 outer_heads: int = 6, inner_heads: int = 4,
                 mlp_ratio: float = 4.0, inner_stride: int = 4,
                 drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 features_only: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.img_size, self.patch_size = img_size, patch_size
        self.features_only = features_only
        self.grid = img_size // patch_size
        self.inner_grid = patch_size // inner_stride
        num_pixel = self.inner_grid ** 2
        num_patches = self.grid ** 2
        self.pixel_embed = PixelEmbed(in_chans, inner_dim, inner_stride,
                                      dtype=dtype)
        self.norm1_proj = LayerNorm(num_pixel * inner_dim, 1e-5, dtype=dtype)
        self.proj = Linear(num_pixel * inner_dim, embed_dim, dtype=dtype)
        self.norm2_proj = LayerNorm(embed_dim, 1e-5, dtype=dtype)
        self.cls_token = nn.Parameter(torch.empty(1, 1, embed_dim))
        self.patch_pos = nn.Parameter(torch.empty(1, num_patches + 1,
                                                  embed_dim))
        self.pixel_pos = nn.Parameter(torch.empty(
            1, inner_dim, self.inner_grid, self.inner_grid))
        self.blocks = nn.ModuleList(
            TNTBlock(embed_dim, inner_dim, num_pixel, outer_heads,
                     inner_heads, mlp_ratio,
                     drop_path_rate * i / max(depth - 1, 1), dtype=dtype)
            for i in range(depth))
        self.norm = self.head = None
        if not features_only:
            self.norm = LayerNorm(embed_dim, 1e-5, dtype=dtype)
            if num_classes > 0:
                self.head = Linear(embed_dim, num_classes, dtype=dtype)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The class token and both position embeddings normal with std
        0.02, as the JAX package initializes them."""
        with torch.no_grad():
            for p in (self.cls_token, self.patch_pos, self.pixel_pos):
                p.normal_(0.0, 0.02, generator=generator)

    def forward(self, x):
        if tuple(x.shape[2:]) != (self.img_size, self.img_size):
            raise ValueError(
                f"the position embedding was sized for {self.img_size}x"
                f"{self.img_size} inputs, got {tuple(x.shape[2:])}: build "
                "the model with img_size= the input's size")
        n = x.shape[0]
        g, ig = self.grid, self.inner_grid
        y = self.pixel_embed(x)
        c = y.shape[1]
        # [N, C, g*ig, g*ig] -> [N*g*g, ig*ig, C]: each patch's pixels
        pixel = y.reshape(n, c, g, ig, g, ig).permute(0, 2, 4, 3, 5, 1)
        pixel = pixel.reshape(n * g * g, ig * ig, c)
        pixel = pixel + self.pixel_pos.to(pixel.dtype).flatten(2).transpose(
            1, 2)
        patch = self.norm2_proj(self.proj(self.norm1_proj(
            pixel.reshape(n, g * g, -1))))
        d = patch.shape[-1]
        patch = torch.cat([self.cls_token.expand(n, 1, d).to(patch.dtype),
                           patch], dim=1) + self.patch_pos.to(patch.dtype)
        for block in self.blocks:
            pixel, patch = block(pixel, patch)
        if self.features_only:
            return [patch[:, 1:].transpose(1, 2).reshape(n, d, g, g)]
        out = self.norm(patch[:, 0])
        return out if self.head is None else self.head(out)


def _tnt(model_name, pretrained=False, img_size: Optional[int] = None,
         **kwargs):
    """Build a row on ``TNT`` (``pretrained`` is accepted and ignored:
    weights load through ``utils.convert``)."""
    cfg = default_cfgs[model_name]
    return build_model_with_cfg(TNT, model_name, cfg,
                                img_size=img_size or cfg["input_size"][-1],
                                **kwargs)


# --- variant table (reference tnt.py:246-268) -------------------------------

TNT_VARIANTS = {
    "tnt_s_patch16_224": dict(embed_dim=384, inner_dim=24, depth=12,
                              outer_heads=6, inner_heads=4),
    "tnt_b_patch16_224": dict(embed_dim=640, inner_dim=40, depth=12,
                              outer_heads=10, inner_heads=4),
}

for _name in TNT_VARIANTS:
    default_cfgs[_name] = default_cfg(mean=(0.5, 0.5, 0.5),
                                      std=(0.5, 0.5, 0.5), crop_pct=0.9,
                                      first_conv="pixel_embed.proj",
                                      classifier="head")

register_variant_table(__name__, _tnt, TNT_VARIANTS)
