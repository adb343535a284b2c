"""ConViT (reference models/convit.py), counterpart of
``cotnet_tpu/models/convit.py``: patch embed + position embedding -> gated
positional self-attention (GPSA) blocks -> the class token -> ViT blocks
-> LN -> head.  The three registry keys ``convit_tiny``, ``convit_small``
and ``convit_base``.

GPSA blends a content softmax with a positional one, taken over the
``(dx, dy, dx^2 + dy^2)`` offsets of every pair of patches through
``pos_proj`` in f32, by ``sigmoid(gating_param)`` per head, and
renormalizes the blend (``cotnet_tpu/models/convit.py:46-82``).  Neither
attention has a qkv bias.  The class token enters at block
``local_layers``.  The position embedding is sized when the model is
built, by ``img_size`` (default 224); an input of another size raises.
Stochastic depth ramps from 0 at the first block to ``drop_path_rate`` at
the last; ``drop_rate`` drops in the ViT blocks' projections and MLPs, as
the JAX package has it.

Parameter names are timm's: ``patch_embed.proj``, ``cls_token``,
``pos_embed``, ``blocks.{i}.{norm1,attn.{qk,v,proj,pos_proj,gating_param},
norm2,mlp.fc1,mlp.fc2}`` in the GPSA blocks (``attn.qkv`` in the others),
``norm``, ``head``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from cotnet_tpu_torch.models.helpers import (build_model_with_cfg,
                                             default_cfg,
                                             register_variant_table)
from cotnet_tpu_torch.models.vision_transformer import Block, Mlp, PatchEmbed
from cotnet_tpu_torch.nn import DropPath, LayerNorm, Linear

default_cfgs = {}  # filled beside the variant table below


def rel_indices(num_patches: int) -> np.ndarray:
    """``[1, L, L, 3]`` f32 offsets ``(dx, dy, dx^2 + dy^2)`` between the
    patches of a square grid in raster order (timm's ``get_rel_indices``)."""
    size = int(num_patches ** 0.5)
    ind = np.arange(size).reshape(1, -1) - np.arange(size).reshape(-1, 1)
    indx = np.tile(ind, (size, size))
    indy = np.repeat(np.repeat(ind, size, axis=0), size, axis=1)
    out = np.stack([indx, indy, indx ** 2 + indy ** 2], axis=-1)
    return out.astype(np.float32)[None]


class GPSA(nn.Module):
    """Gated positional self-attention over ``[N, L, D]`` patch tokens."""

    def __init__(self, dim: int, num_heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        self.qk = Linear(dim, 2 * dim, bias=False, dtype=dtype)
        self.v = Linear(dim, dim, bias=False, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)
        self.pos_proj = Linear(3, num_heads, dtype=torch.float32)
        self.gating_param = nn.Parameter(torch.empty(num_heads))
        self._rel = {}   # (L, device) -> the offsets table
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.gating_param.fill_(1.0)

    def rel(self, length: int, device) -> torch.Tensor:
        key = (length, device)
        if key not in self._rel:
            self._rel[key] = torch.from_numpy(rel_indices(length)).to(device)
        return self._rel[key]

    def forward(self, x):
        n, length, d = x.shape
        h = self.num_heads
        dh = d // h
        qk = self.qk(x).reshape(n, length, 2, h, dh).permute(2, 0, 3, 1, 4)
        q, k = qk.unbind(0)
        v = self.v(x).reshape(n, length, h, dh).transpose(1, 2)
        patch = torch.softmax(
            torch.matmul(q * dh ** -0.5, k.transpose(-2, -1)).float(), -1)
        pos = torch.softmax(
            self.pos_proj(self.rel(length, x.device)).permute(0, 3, 1, 2), -1)
        g = torch.sigmoid(self.gating_param).view(1, -1, 1, 1)
        attn = (1.0 - g) * patch + g * pos
        attn = (attn / attn.sum(-1, keepdim=True)).to(self.dtype)
        y = torch.matmul(attn, v).transpose(1, 2).reshape(n, length, d)
        return self.proj(y)


class GPSABlock(nn.Module):
    """Pre-LN block on GPSA: ``x + drop_path(attn(norm1(x)))``, then ``x +
    drop_path(mlp(norm2(x)))``, LayerNorm eps 1e-6."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 drop_path_rate: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = LayerNorm(dim, 1e-6, dtype=dtype)
        self.attn = GPSA(dim, num_heads, dtype=dtype)
        self.drop_path = DropPath(drop_path_rate)
        self.norm2 = LayerNorm(dim, 1e-6, dtype=dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype=dtype)

    def forward(self, x):
        x = x + self.drop_path(self.attn(self.norm1(x)))
        return x + self.drop_path(self.mlp(self.norm2(x)))


class ConViT(nn.Module):
    """``cotnet_tpu/models/convit.py:104-159``.  ``features_only`` returns
    the last block's patch tokens as one ``[N, D, H/p, W/p]`` map (the norm
    and the head are not built); ``num_classes=0`` returns the normed
    class token."""

    def __init__(self, img_size: int = 224, patch_size: int = 16,
                 in_chans: int = 3, num_classes: int = 1000,
                 embed_dim: int = 192, depth: int = 12, num_heads: int = 4,
                 local_layers: int = 10, mlp_ratio: float = 4.0,
                 drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 features_only: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.local_layers, self.features_only = local_layers, features_only
        self.patch_embed = PatchEmbed(img_size, patch_size, in_chans,
                                      embed_dim, dtype=dtype)
        self.cls_token = nn.Parameter(torch.empty(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.empty(
            1, self.patch_embed.num_patches, embed_dim))
        self.blocks = nn.ModuleList()
        for i in range(depth):
            dpr = drop_path_rate * i / max(depth - 1, 1)
            self.blocks.append(
                GPSABlock(embed_dim, num_heads, mlp_ratio, dpr, dtype=dtype)
                if i < local_layers else
                Block(embed_dim, num_heads, mlp_ratio, False, drop_rate, 0.0,
                      dpr, dtype=dtype))
        self.norm = self.head = None
        if not features_only:
            self.norm = LayerNorm(embed_dim, 1e-6, dtype=dtype)
            if num_classes > 0:
                self.head = Linear(embed_dim, num_classes, dtype=dtype)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The class token and the position embedding normal with std 0.02,
        as the JAX package initializes them."""
        with torch.no_grad():
            self.cls_token.normal_(0.0, 0.02, generator=generator)
            self.pos_embed.normal_(0.0, 0.02, generator=generator)

    def forward(self, x):
        x = self.patch_embed(x)
        n, _, d = x.shape
        x = x + self.pos_embed.to(x.dtype)
        for i, block in enumerate(self.blocks):
            if i == self.local_layers:
                x = torch.cat([self.cls_token.expand(n, 1, d).to(x.dtype), x],
                              dim=1)
            x = block(x)
        if self.features_only:
            gh, gw = self.patch_embed.grid
            return [x[:, 1:].transpose(1, 2).reshape(n, d, gh, gw)]
        out = self.norm(x)[:, 0]
        return out if self.head is None else self.head(out)


def _convit(model_name, pretrained=False, img_size: Optional[int] = None,
            **kwargs):
    """Build a row on ``ConViT`` (``pretrained`` is accepted and ignored:
    weights load through ``utils.convert``)."""
    cfg = default_cfgs[model_name]
    return build_model_with_cfg(ConViT, model_name, cfg,
                                img_size=img_size or cfg["input_size"][-1],
                                **kwargs)


# --- variant table (reference convit.py:321-349) ----------------------------

CONVIT_VARIANTS = {
    "convit_tiny": dict(embed_dim=192, num_heads=4),
    "convit_small": dict(embed_dim=432, num_heads=9),
    "convit_base": dict(embed_dim=768, num_heads=16),
}

for _name in CONVIT_VARIANTS:
    default_cfgs[_name] = default_cfg(mean=(0.5, 0.5, 0.5),
                                      std=(0.5, 0.5, 0.5),
                                      first_conv="patch_embed.proj",
                                      classifier="head")

register_variant_table(__name__, _convit, CONVIT_VARIANTS)
