"""CaiT, class-attention image transformer (reference models/cait.py),
counterpart of ``cotnet_tpu/models/cait.py``: patch embed + position
embedding -> LayerScale self-attention blocks with talking heads -> the cls
token joins -> class-attention blocks that update the cls token alone ->
LN -> head.  Every row of the JAX package's ``CAIT_VARIANTS`` (11 registry
keys) is registered here.

Talking heads: q is scaled in the compute dtype, the logits are cast to
f32, and ``proj_l`` and ``proj_w`` mix the heads before and after the
softmax in f32 with f32 weights whatever the compute dtype
(``cotnet_tpu/models/cait.py:36-46``).  Stochastic depth grows linearly
with depth, ``drop_path_rate * i / (depth - 1)``, as in the JAX package
(timm's CaiT takes one rate for every block); the class-attention blocks
take none.  The position embedding is sized when the model is built, by
``img_size`` (default the key's 224, 384 or 448); an input of another size
raises.  ``drop_rate`` is accepted and unused, as in the JAX package.

Parameter names are timm's: ``patch_embed.proj``, ``pos_embed``,
``cls_token``, ``blocks.{i}.{norm1,attn.{qkv,proj_l,proj_w,proj},gamma_1,
norm2,mlp.fc1,mlp.fc2,gamma_2}``, ``blocks_token_only.{i}.{norm1,
attn.{q,k,v,proj},gamma_1,norm2,mlp,gamma_2}``, ``norm``, ``head``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from cotnet_tpu_torch.models.helpers import (build_model_with_cfg,
                                             default_cfg,
                                             register_variant_table)
from cotnet_tpu_torch.models.vision_transformer import Mlp, PatchEmbed
from cotnet_tpu_torch.nn import DropPath, LayerNorm, Linear

default_cfgs = {}  # filled beside the variant table below


def _heads_last(linear, attn):
    """``linear`` over the heads axis of ``[n, h, q, k]`` logits."""
    return linear(attn.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class TalkingHeadAttn(nn.Module):
    """Self-attention with the heads mixed before and after the softmax
    (``cotnet_tpu/models/cait.py:23-47``)."""

    def __init__(self, dim: int, num_heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        self.qkv = Linear(dim, 3 * dim, dtype=dtype)
        self.proj_l = Linear(num_heads, num_heads, dtype=torch.float32)
        self.proj_w = Linear(num_heads, num_heads, dtype=torch.float32)
        self.proj = Linear(dim, dim, dtype=dtype)

    def forward(self, x):
        n, length, d = x.shape
        h = self.num_heads
        dh = d // h
        qkv = self.qkv(x).reshape(n, length, 3, h, dh).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.unbind(0)                       # [n, h, l, dh]
        attn = torch.matmul(q * dh ** -0.5, k.transpose(-2, -1)).float()
        attn = torch.softmax(_heads_last(self.proj_l, attn), -1)
        attn = _heads_last(self.proj_w, attn).to(self.dtype)
        y = torch.matmul(attn, v).transpose(1, 2).reshape(n, length, d)
        return self.proj(y)


class ClassAttn(nn.Module):
    """Attention whose only query is the cls token, ``[n, L, D]`` ->
    ``[n, 1, D]``; separate ``q``, ``k`` and ``v`` projections, q scaled in
    the compute dtype, the softmax in f32 (``cotnet_tpu/models/cait.py:50-72``;
    XCiT's class-attention blocks take it too)."""

    def __init__(self, dim: int, num_heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        self.q = Linear(dim, dim, dtype=dtype)
        self.k = Linear(dim, dim, dtype=dtype)
        self.v = Linear(dim, dim, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)

    def forward(self, x):
        n, length, d = x.shape
        h = self.num_heads
        dh = d // h
        q = self.q(x[:, :1]).reshape(n, 1, h, dh).transpose(1, 2) * dh ** -0.5
        k = self.k(x).reshape(n, length, h, dh).transpose(1, 2)
        v = self.v(x).reshape(n, length, h, dh).transpose(1, 2)
        attn = torch.softmax(torch.matmul(q, k.transpose(-2, -1)).float(),
                             -1).to(self.dtype)
        y = torch.matmul(attn, v).transpose(1, 2).reshape(n, 1, d)
        return self.proj(y)


class LayerScaleBlock(nn.Module):
    """Pre-LN block with per-channel LayerScale ``gamma_1``/``gamma_2``
    (``cotnet_tpu/models/cait.py:75-118``).  ``class_attn``: the block of
    the token-only stage, where the cls token queries every token, the MLP
    runs on it alone and the other tokens pass through unchanged."""

    def __init__(self, dim: int, num_heads: int, init_values: float = 1e-5,
                 mlp_ratio: float = 4.0, drop_path_rate: float = 0.0,
                 class_attn: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.init_values, self.class_attn = init_values, class_attn
        self.norm1 = LayerNorm(dim, 1e-6, dtype=dtype)
        attn = ClassAttn if class_attn else TalkingHeadAttn
        self.attn = attn(dim, num_heads, dtype=dtype)
        self.drop_path = DropPath(drop_path_rate)
        self.norm2 = LayerNorm(dim, 1e-6, dtype=dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype=dtype)
        self.gamma_1 = nn.Parameter(torch.empty(dim))
        self.gamma_2 = nn.Parameter(torch.empty(dim))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.gamma_1.fill_(self.init_values)
            self.gamma_2.fill_(self.init_values)

    def forward(self, x):
        a = self.attn(self.norm1(x))
        a = self.drop_path(self.gamma_1.to(a.dtype) * a)
        if self.class_attn:
            x = torch.cat([x[:, :1] + a, x[:, 1:]], dim=1)
            m = self.mlp(self.norm2(x[:, :1]))
            m = self.drop_path(self.gamma_2.to(m.dtype) * m)
            return torch.cat([x[:, :1] + m, x[:, 1:]], dim=1)
        x = x + a
        m = self.mlp(self.norm2(x))
        return x + self.drop_path(self.gamma_2.to(m.dtype) * m)


class Cait(nn.Module):
    """``cotnet_tpu/models/cait.py:121-172``.  ``features_only`` returns
    the patch tokens after the self-attention blocks as one ``[N, D, gh,
    gw]`` map (the cls token, the token-only blocks, the norm and the head
    are not built); ``num_classes=0`` returns the normed cls token."""

    def __init__(self, img_size: int = 224, patch_size: int = 16,
                 in_chans: int = 3, num_classes: int = 1000,
                 embed_dim: int = 192, depth: int = 24, num_heads: int = 4,
                 depth_token_only: int = 2, init_values: float = 1e-5,
                 drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 features_only: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.features_only = features_only
        self.patch_embed = PatchEmbed(img_size, patch_size, in_chans,
                                      embed_dim, dtype=dtype)
        self.pos_embed = nn.Parameter(torch.empty(
            1, self.patch_embed.num_patches, embed_dim))
        self.blocks = nn.ModuleList(
            LayerScaleBlock(embed_dim, num_heads, init_values,
                            drop_path_rate=drop_path_rate * i
                            / max(depth - 1, 1), dtype=dtype)
            for i in range(depth))
        self.cls_token = self.blocks_token_only = self.norm = None
        self.head = None
        if not features_only:
            self.cls_token = nn.Parameter(torch.empty(1, 1, embed_dim))
            self.blocks_token_only = nn.ModuleList(
                LayerScaleBlock(embed_dim, num_heads, init_values,
                                class_attn=True, dtype=dtype)
                for _ in range(depth_token_only))
            self.norm = LayerNorm(embed_dim, 1e-6, dtype=dtype)
            if num_classes > 0:
                self.head = Linear(embed_dim, num_classes, dtype=dtype)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The position embedding and the cls token normal with std 0.02,
        as the JAX package initializes them."""
        with torch.no_grad():
            self.pos_embed.normal_(0.0, 0.02, generator=generator)
            if self.cls_token is not None:
                self.cls_token.normal_(0.0, 0.02, generator=generator)

    def forward(self, x):
        x = self.patch_embed(x)
        x = x + self.pos_embed.to(x.dtype)
        for block in self.blocks:
            x = block(x)
        if self.features_only:
            gh, gw = self.patch_embed.grid
            return [x.transpose(1, 2).reshape(x.shape[0], -1, gh, gw)]
        n, _, d = x.shape
        x = torch.cat([self.cls_token.expand(n, 1, d).to(x.dtype), x], dim=1)
        for block in self.blocks_token_only:
            x = block(x)
        out = self.norm(x[:, 0])
        return out if self.head is None else self.head(out)


def _cait(model_name, pretrained=False, img_size: Optional[int] = None,
          **kwargs):
    """Build a row on ``Cait`` (``pretrained`` is accepted and ignored:
    weights load through ``utils.convert``)."""
    cfg = default_cfgs[model_name]
    return build_model_with_cfg(Cait, model_name, cfg,
                                img_size=img_size or cfg["input_size"][-1],
                                **kwargs)


# --- variant table (reference cait.py:330-403) ------------------------------

def _cait_row(dim, depth, heads, init_scale):
    return dict(patch_size=16, embed_dim=dim, depth=depth, num_heads=heads,
                init_values=init_scale)


CAIT_VARIANTS = {
    "cait_xxs24_224": _cait_row(192, 24, 4, 1e-5),
    "cait_xxs24_384": _cait_row(192, 24, 4, 1e-5),
    "cait_xxs36_224": _cait_row(192, 36, 4, 1e-5),
    "cait_xxs36_384": _cait_row(192, 36, 4, 1e-5),
    "cait_xs24_384": _cait_row(288, 24, 6, 1e-5),
    "cait_s24_224": _cait_row(384, 24, 8, 1e-5),
    "cait_s24_384": _cait_row(384, 24, 8, 1e-5),
    "cait_s36_224": _cait_row(384, 36, 8, 1e-6),
    "cait_s36_384": _cait_row(384, 36, 8, 1e-6),
    "cait_m36_384": _cait_row(768, 36, 16, 1e-6),
    "cait_m48_448": _cait_row(768, 48, 16, 1e-6),
}

for _name in CAIT_VARIANTS:
    _size = int(_name.rsplit("_", 1)[1])
    default_cfgs[_name] = default_cfg(
        input_size=(3, _size, _size), crop_pct=1.0,
        mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5),
        first_conv="patch_embed.proj", classifier="head")

register_variant_table(__name__, _cait, CAIT_VARIANTS)
