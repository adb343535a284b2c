"""Twins (reference models/twins.py), counterpart of
``cotnet_tpu/models/twins.py``: four stages, each a patch embed + LN, then
blocks of locally-grouped (windowed) or global sub-sampled attention, with
a depthwise conv position encoding (PEG) after each stage's first block ->
LN -> mean over the map -> head.  Every row of the JAX package's
``TWINS_VARIANTS`` (6 registry keys): PCPVT takes global sub-sampled
attention in every block, SVT alternates windows and global attention.

Inside the stages the tokens are ``[N, H, W, C]``; the patch embeds, the
PEG and the sub-sampling conv are NCHW convs.  The window is ``min(ws, h,
w)`` and the windows are not padded, as in the JAX package
(``cotnet_tpu/models/twins.py:31-32``): a map the window does not divide
(16x16 at 64 px) is refused by name.  The patch embeds' and the
sub-sampling's LayerNorms take eps 1e-5, the blocks' and the final one's
1e-6.  Stochastic depth ramps over the blocks of all stages; ``drop_rate``
drops the pooled features in training.

Parameter names are timm's: ``patch_embeds.{s}.{proj,norm}``,
``blocks.{s}.{b}.{norm1,attn.{qkv,proj},norm2,mlp.fc1,mlp.fc2}`` in a
windowed block, ``attn.{q,kv,proj,sr,norm}`` in a global one (``sr`` and
``norm`` where the sub-sampling ratio exceeds 1), ``pos_block.{s}.proj.0``,
``norm``, ``head``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from cotnet_tpu_torch.models.helpers import (build_model_with_cfg,
                                             default_cfg,
                                             register_variant_table)
from cotnet_tpu_torch.models.vision_transformer import Mlp
from cotnet_tpu_torch.nn import Conv2d, DropPath, Dropout, LayerNorm, Linear

default_cfgs = {}  # filled beside the variant table below


def _attend(q, k, v, dtype):
    """``softmax(q k^T / sqrt(dh))`` in f32, cast to ``dtype``, times v:
    ``[B, h, Lq, dh]`` -> ``[B, Lq, h*dh]``."""
    dh = q.shape[-1]
    attn = torch.softmax(torch.matmul(q * dh ** -0.5,
                                      k.transpose(-2, -1)).float(), -1)
    y = torch.matmul(attn.to(dtype), v).transpose(1, 2)
    return y.reshape(*y.shape[:2], -1)


class LocallyGroupedAttn(nn.Module):
    """Self-attention within the ``ws x ws`` windows of ``[N, H, W, C]``."""

    def __init__(self, dim: int, num_heads: int, ws: int = 7,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads, self.ws, self.dtype = num_heads, ws, dtype
        self.qkv = Linear(dim, 3 * dim, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)

    def forward(self, x):
        n, h, w, d = x.shape
        ws = min(self.ws, h, w)
        if h % ws or w % ws:
            raise ValueError(
                f"a {h}x{w} map does not divide into {ws}x{ws} windows, "
                "which Twins does not pad: give an input whose maps divide "
                "by the window at each stage")
        hh, ww, nh = h // ws, w // ws, self.num_heads
        xw = x.reshape(n, hh, ws, ww, ws, d).permute(0, 1, 3, 2, 4, 5)
        qkv = self.qkv(xw.reshape(-1, ws * ws, d)).reshape(
            -1, ws * ws, 3, nh, d // nh).permute(2, 0, 3, 1, 4)
        y = self.proj(_attend(*qkv.unbind(0), self.dtype))
        y = y.reshape(n, hh, ww, ws, ws, d).permute(0, 1, 3, 2, 4, 5)
        return y.reshape(n, h, w, d)


class GlobalSubSampleAttn(nn.Module):
    """Attention of every token of ``[N, H, W, C]`` to the map sub-sampled
    by an ``sr_ratio`` strided conv and LN (the whole map at ratio 1)."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        self.q = Linear(dim, dim, dtype=dtype)
        self.kv = Linear(dim, 2 * dim, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)
        self.sr = self.norm = None
        if sr_ratio > 1:
            self.sr = Conv2d(dim, dim, sr_ratio, sr_ratio, 0, bias=True,
                             dtype=dtype)
            self.norm = LayerNorm(dim, 1e-5, dtype=dtype)

    def forward(self, x):
        n, h, w, d = x.shape
        nh = self.num_heads
        q = self.q(x.reshape(n, h * w, d)).reshape(
            n, h * w, nh, d // nh).transpose(1, 2)
        if self.sr is not None:
            src = self.norm(self.sr(x.permute(0, 3, 1, 2)).permute(
                0, 2, 3, 1)).reshape(n, -1, d)
        else:
            src = x.reshape(n, h * w, d)
        kv = self.kv(src).reshape(n, -1, 2, nh, d // nh).permute(
            2, 0, 3, 1, 4)
        y = self.proj(_attend(q, *kv.unbind(0), self.dtype))
        return y.reshape(n, h, w, d)


class TwinsBlock(nn.Module):
    """Pre-LN block on ``[N, H, W, C]``, LayerNorm eps 1e-6."""

    def __init__(self, dim: int, num_heads: int, local: bool, ws: int = 7,
                 sr_ratio: int = 1, mlp_ratio: float = 4.0,
                 drop_path_rate: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = LayerNorm(dim, 1e-6, dtype=dtype)
        self.attn = (LocallyGroupedAttn(dim, num_heads, ws, dtype=dtype)
                     if local else
                     GlobalSubSampleAttn(dim, num_heads, sr_ratio,
                                         dtype=dtype))
        self.drop_path = DropPath(drop_path_rate)
        self.norm2 = LayerNorm(dim, 1e-6, dtype=dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype=dtype)

    def forward(self, x):
        x = x + self.drop_path(self.attn(self.norm1(x)))
        return x + self.drop_path(self.mlp(self.norm2(x)))


class PosConv(nn.Module):
    """PEG: ``x + dwconv3x3(x)`` on ``[N, H, W, C]`` (timm's ``proj`` is a
    one-conv Sequential)."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.proj = nn.Sequential(Conv2d(dim, dim, 3, 1, 1, groups=dim,
                                         bias=True, dtype=dtype))

    def forward(self, x):
        return x + self.proj(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class PatchEmbed(nn.Module):
    """A ``patch_size`` strided conv with a bias, then LN (eps 1e-5):
    ``[N, C, H, W]`` -> ``[N, H/p, W/p, D]``."""

    def __init__(self, patch_size: int, in_chans: int, embed_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.proj = Conv2d(in_chans, embed_dim, patch_size, patch_size, 0,
                           bias=True, dtype=dtype)
        self.norm = LayerNorm(embed_dim, 1e-5, dtype=dtype)

    def forward(self, x):
        return self.norm(self.proj(x).permute(0, 2, 3, 1))


class Twins(nn.Module):
    """``cotnet_tpu/models/twins.py:112-170``.  ``features_only`` returns
    each stage's map, ``[N, C_s, H_s, W_s]`` (the norm and the head are not
    built); ``num_classes=0`` returns the pooled features."""

    def __init__(self, in_chans: int = 3, num_classes: int = 1000,
                 embed_dims: Sequence[int] = (64, 128, 256, 512),
                 num_heads: Sequence[int] = (2, 4, 8, 16),
                 depths: Sequence[int] = (2, 2, 10, 4),
                 sr_ratios: Sequence[int] = (8, 4, 2, 1),
                 patch_sizes: Sequence[int] = (4, 2, 2, 2),
                 wss: Sequence[int] = (7, 7, 7, 7),
                 mlp_ratios: Sequence[float] = (4, 4, 4, 4),
                 block_style: str = "svt", drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0, features_only: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.features_only = features_only
        total = sum(depths)
        idx = 0
        self.patch_embeds = nn.ModuleList()
        self.blocks = nn.ModuleList()
        self.pos_block = nn.ModuleList()
        chans = in_chans
        for dim, heads, depth, sr, ps, ws, mr in zip(
                embed_dims, num_heads, depths, sr_ratios, patch_sizes, wss,
                mlp_ratios):
            self.patch_embeds.append(PatchEmbed(ps, chans, dim, dtype=dtype))
            stage = nn.ModuleList()
            for bi in range(depth):
                stage.append(TwinsBlock(
                    dim, heads, local=block_style == "svt" and bi % 2 == 0,
                    ws=ws, sr_ratio=sr, mlp_ratio=mr,
                    drop_path_rate=drop_path_rate * idx / max(total - 1, 1),
                    dtype=dtype))
                idx += 1
            self.blocks.append(stage)
            self.pos_block.append(PosConv(dim, dtype=dtype))
            chans = dim
        self.norm = self.head = None
        if not features_only:
            self.norm = LayerNorm(embed_dims[-1], 1e-6, dtype=dtype)
            if num_classes > 0:
                self.head = Linear(embed_dims[-1], num_classes, dtype=dtype)
        self.drop = Dropout(drop_rate)

    def forward(self, x):
        feats = []
        for embed, stage, peg in zip(self.patch_embeds, self.blocks,
                                     self.pos_block):
            x = embed(x)
            for bi, block in enumerate(stage):
                x = block(x)
                if bi == 0:
                    x = peg(x)
            x = x.permute(0, 3, 1, 2)
            feats.append(x)
        if self.features_only:
            return feats
        x = self.drop(self.norm(x.permute(0, 2, 3, 1)).mean((1, 2)))
        return x if self.head is None else self.head(x)


def _twins(model_name, pretrained=False, **kwargs):
    """Build a row on ``Twins`` (``pretrained`` is accepted and ignored:
    weights load through ``utils.convert``)."""
    return build_model_with_cfg(Twins, model_name, default_cfgs[model_name],
                                **kwargs)


# --- variant table (reference twins.py:376-422) -----------------------------

def _pcpvt(depths):
    return dict(embed_dims=(64, 128, 320, 512), num_heads=(1, 2, 5, 8),
                mlp_ratios=(8, 8, 4, 4), depths=depths,
                sr_ratios=(8, 4, 2, 1), block_style="pcpvt")


TWINS_VARIANTS = {
    "twins_pcpvt_small": _pcpvt((3, 4, 6, 3)),
    "twins_pcpvt_base": _pcpvt((3, 4, 18, 3)),
    "twins_pcpvt_large": _pcpvt((3, 8, 27, 3)),
    "twins_svt_small": dict(embed_dims=(64, 128, 256, 512),
                            num_heads=(2, 4, 8, 16), depths=(2, 2, 10, 4)),
    "twins_svt_base": dict(embed_dims=(96, 192, 384, 768),
                           num_heads=(3, 6, 12, 24), depths=(2, 2, 18, 2)),
    "twins_svt_large": dict(embed_dims=(128, 256, 512, 1024),
                            num_heads=(4, 8, 16, 32), depths=(2, 2, 18, 2)),
}

for _name in TWINS_VARIANTS:
    default_cfgs[_name] = default_cfg(crop_pct=0.9,
                                      first_conv="patch_embeds.0.proj",
                                      classifier="head")

register_variant_table(__name__, _twins, TWINS_VARIANTS)
