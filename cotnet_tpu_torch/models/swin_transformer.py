"""Swin Transformer (reference models/swin_transformer.py), counterpart of
``cotnet_tpu/models/swin_transformer.py``: patch embed + LN -> four stages
of windowed attention blocks, every other block on windows shifted by half
a window, with patch merging between the stages -> LN -> mean over the
map -> head.  Every row of the JAX package's ``SWIN_VARIANTS`` (10
registry keys) is registered here.

Inside the stages the tokens are ``[N, H, W, C]``, as in timm; only the
patch embed is an NCHW conv.  Window attention takes the logits in the
compute dtype, casts them to f32 and *then* scales them, adds the relative
position bias (gathered from the f32 table) and the shift mask, and takes
the softmax in f32 (``cotnet_tpu/models/swin_transformer.py:47-76``).  The
window is ``min(window_size, h, w)`` and the shift is 0 wherever the window
covers the map (stage 4 at the configured sizes).  The mask (-100 between
regions) is built once per map, window, shift and device.  Patch merging
concatenates in timm's order ``([0::2, 0::2], [1::2, 0::2], [0::2, 1::2],
[1::2, 1::2])``, where the JAX package's is raster order: the converters
swap channel groups 1 and 2 of the merge's norm and reduction.  Any input
whose maps divide by the window at each stage is taken.  The default
``drop_path_rate`` is 0.1, as in the JAX package.

Parameter names are timm's: ``patch_embed.{proj,norm}``,
``layers.{s}.blocks.{b}.{norm1,attn.{qkv,proj,relative_position_bias_table},
norm2,mlp.fc1,mlp.fc2}``, ``layers.{s}.downsample.{norm,reduction}`` (the
merge closing stage s), ``norm``, ``head``.  ``relative_position_index``
is a non-persistent buffer.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from cotnet_tpu_torch.models.helpers import (build_model_with_cfg,
                                             default_cfg,
                                             register_variant_table)
from cotnet_tpu_torch.models.vision_transformer import Mlp
from cotnet_tpu_torch.nn import (Conv2d, DropPath, Dropout, LayerNorm,
                                 Linear)

default_cfgs = {}  # filled beside the variant table below


def window_partition(x, ws: int):
    """``[n, h, w, c]`` -> ``[n * (h/ws) * (w/ws), ws * ws, c]``, the windows
    in raster order, each window's tokens in raster order."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def window_reverse(windows, ws: int, h: int, w: int):
    """The inverse of ``window_partition``."""
    n = windows.shape[0] // ((h // ws) * (w // ws))
    x = windows.reshape(n, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h, w, -1)


def _rel_pos_index(ws: int) -> np.ndarray:
    """``[ws^2, ws^2]``: the row of the relative position bias table of
    each pair of a window's tokens."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int32)


def shift_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """``[nw, ws^2, ws^2]`` f32: -100 between tokens of a shifted window
    that come from different regions of the rolled map, else 0
    (``cotnet_tpu/models/swin_transformer.py:93-104``)."""
    img = np.zeros((h, w), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    mw = img.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3).reshape(
        -1, ws * ws)
    return np.where(mw[:, None, :] != mw[:, :, None], -100.0,
                    0.0).astype(np.float32)


class WindowAttention(nn.Module):
    """Multi-head attention within ``ws x ws`` windows, ``[B, ws^2, C]``,
    with a learned relative position bias per head."""

    def __init__(self, dim: int, num_heads: int, window_size: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads, self.window_size, self.dtype = (num_heads,
                                                        window_size, dtype)
        self.qkv = Linear(dim, 3 * dim, dtype=dtype)
        self.relative_position_bias_table = nn.Parameter(
            torch.empty((2 * window_size - 1) ** 2, num_heads))
        self.register_buffer(
            "relative_position_index",
            torch.from_numpy(_rel_pos_index(window_size).reshape(-1)).long(),
            persistent=False)
        self.proj = Linear(dim, dim, dtype=dtype)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.relative_position_bias_table.normal_(0.0, 0.02,
                                                      generator=generator)

    def forward(self, x, mask=None):
        b, length, d = x.shape
        h = self.num_heads
        dh = d // h
        qkv = self.qkv(x).reshape(b, length, 3, h, dh).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.unbind(0)                       # [b, h, l, dh]
        attn = torch.matmul(q, k.transpose(-2, -1)).float() * dh ** -0.5
        bias = self.relative_position_bias_table[
            self.relative_position_index].reshape(length, length, h)
        attn = attn + bias.permute(2, 0, 1)
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.reshape(b // nw, nw, h, length, length)
                    + mask[None, :, None]).reshape(b, h, length, length)
        attn = torch.softmax(attn, -1).to(self.dtype)
        y = torch.matmul(attn, v).transpose(1, 2).reshape(b, length, d)
        return self.proj(y)


class SwinBlock(nn.Module):
    """A Swin block on ``[N, H, W, C]``: LN -> (shifted) window attention
    -> residual, LN -> MLP -> residual (``cotnet_tpu/models/
    swin_transformer.py:79-122``)."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 7,
                 shift: int = 0, mlp_ratio: float = 4.0,
                 drop_path_rate: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.window_size, self.shift = window_size, shift
        self.norm1 = LayerNorm(dim, 1e-5, dtype=dtype)
        self.attn = WindowAttention(dim, num_heads, window_size, dtype=dtype)
        self.drop_path = DropPath(drop_path_rate)
        self.norm2 = LayerNorm(dim, 1e-5, dtype=dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype=dtype)
        self._masks = {}   # (h, w, ws, shift, device) -> shift_mask

    def mask(self, h, w, ws, shift, device):
        key = (h, w, ws, shift, device)
        if key not in self._masks:
            self._masks[key] = torch.from_numpy(
                shift_mask(h, w, ws, shift)).to(device)
        return self._masks[key]

    def forward(self, x):
        n, h, w, c = x.shape
        ws = min(self.window_size, h, w)
        if ws != self.window_size or h % ws or w % ws:
            raise ValueError(
                f"a {h}x{w} map does not divide into the block's "
                f"{self.window_size}x{self.window_size} windows: give an "
                "input whose maps divide by the window at each stage")
        shift = self.shift if ws < min(h, w) else 0
        y = self.norm1(x)
        mask = None
        if shift:
            y = torch.roll(y, (-shift, -shift), (1, 2))
            mask = self.mask(h, w, ws, shift, x.device)
        y = window_reverse(self.attn(window_partition(y, ws), mask), ws, h, w)
        if shift:
            y = torch.roll(y, (shift, shift), (1, 2))
        x = x + self.drop_path(y)
        return x + self.drop_path(self.mlp(self.norm2(x)))


class PatchMerging(nn.Module):
    """2x2 neighbours concatenated in timm's order, LN, then a bias-free
    ``4C -> 2C`` reduction: ``[N, H, W, C]`` -> ``[N, H/2, W/2, 2C]``."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm = LayerNorm(4 * dim, 1e-5, dtype=dtype)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False, dtype=dtype)

    def forward(self, x):
        n, h, w, c = x.shape
        # (wp, hp) order: [0::2, 0::2], [1::2, 0::2], [0::2, 1::2], [1::2, 1::2]
        x = x.reshape(n, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 4, 2, 5)
        return self.reduction(self.norm(x.reshape(n, h // 2, w // 2, 4 * c)))


class SwinStage(nn.Module):
    """timm's BasicLayer: the stage's blocks, then the merge into the next
    stage (``downsample``, None in the last)."""

    def __init__(self, blocks, downsample: Optional[nn.Module]):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample


class PatchEmbed(nn.Module):
    """A ``patch_size`` strided conv with a bias, then LN over the channels:
    ``[N, C, H, W]`` -> ``[N, H/p, W/p, D]``."""

    def __init__(self, patch_size: int, in_chans: int, embed_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.proj = Conv2d(in_chans, embed_dim, patch_size, patch_size, 0,
                           bias=True, dtype=dtype)
        self.norm = LayerNorm(embed_dim, 1e-5, dtype=dtype)

    def forward(self, x):
        return self.norm(self.proj(x).permute(0, 2, 3, 1))


class SwinTransformer(nn.Module):
    """``cotnet_tpu/models/swin_transformer.py:125-184``.
    ``features_only`` returns each stage's map before its merge, ``[N,
    C_s, H_s, W_s]`` (the final norm and the head are not built);
    ``num_classes=0`` returns the pooled features.  ``drop_rate`` drops the
    pooled features in training; stochastic depth ramps from 0 at the first
    block to ``drop_path_rate`` at the last."""

    def __init__(self, patch_size: int = 4, in_chans: int = 3,
                 num_classes: int = 1000, embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = 7, mlp_ratio: float = 4.0,
                 drop_rate: float = 0.0, drop_path_rate: float = 0.1,
                 features_only: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.features_only = features_only
        self.patch_embed = PatchEmbed(patch_size, in_chans, embed_dim,
                                      dtype=dtype)
        total = sum(depths)
        idx = 0
        self.layers = nn.ModuleList()
        for si, (depth, heads) in enumerate(zip(depths, num_heads)):
            dim = embed_dim * 2 ** si
            blocks = []
            for bi in range(depth):
                blocks.append(SwinBlock(
                    dim, heads, window_size,
                    shift=0 if bi % 2 == 0 else window_size // 2,
                    mlp_ratio=mlp_ratio,
                    drop_path_rate=drop_path_rate * idx / max(total - 1, 1),
                    dtype=dtype))
                idx += 1
            merge = (PatchMerging(dim, dtype=dtype)
                     if si < len(depths) - 1 else None)
            self.layers.append(SwinStage(blocks, merge))
        width = embed_dim * 2 ** (len(depths) - 1)
        self.norm = self.head = None
        if not features_only:
            self.norm = LayerNorm(width, 1e-5, dtype=dtype)
            if num_classes > 0:
                self.head = Linear(width, num_classes, dtype=dtype)
        self.drop = Dropout(drop_rate)

    def forward(self, x):
        x = self.patch_embed(x)
        feats = []
        for stage in self.layers:
            for block in stage.blocks:
                x = block(x)
            feats.append(x.permute(0, 3, 1, 2))
            if stage.downsample is not None:
                x = stage.downsample(x)
        if self.features_only:
            return feats
        x = self.drop(self.norm(x).mean((1, 2)))
        return x if self.head is None else self.head(x)


def _swin(model_name, pretrained=False, **kwargs):
    """Build a row on ``SwinTransformer`` (``pretrained`` is accepted and
    ignored: weights load through ``utils.convert``)."""
    return build_model_with_cfg(SwinTransformer, model_name,
                                default_cfgs[model_name], **kwargs)


# --- variant table (reference swin_transformer.py:566-651) ------------------

def _swin_row(dim, depths, heads, window):
    return dict(patch_size=4, window_size=window, embed_dim=dim,
                depths=depths, num_heads=heads)


_BASE = (128, (2, 2, 18, 2), (4, 8, 16, 32))
_LARGE = (192, (2, 2, 18, 2), (6, 12, 24, 48))

SWIN_VARIANTS = {
    "swin_tiny_patch4_window7_224": _swin_row(
        96, (2, 2, 6, 2), (3, 6, 12, 24), 7),
    "swin_small_patch4_window7_224": _swin_row(
        96, (2, 2, 18, 2), (3, 6, 12, 24), 7),
    "swin_base_patch4_window7_224": _swin_row(*_BASE, 7),
    "swin_base_patch4_window12_384": _swin_row(*_BASE, 12),
    "swin_large_patch4_window7_224": _swin_row(*_LARGE, 7),
    "swin_large_patch4_window12_384": _swin_row(*_LARGE, 12),
    "swin_base_patch4_window7_224_in22k": _swin_row(*_BASE, 7),
    "swin_base_patch4_window12_384_in22k": _swin_row(*_BASE, 12),
    "swin_large_patch4_window7_224_in22k": _swin_row(*_LARGE, 7),
    "swin_large_patch4_window12_384_in22k": _swin_row(*_LARGE, 12),
}

for _name in SWIN_VARIANTS:
    _size = 384 if "_384" in _name else 224
    default_cfgs[_name] = default_cfg(
        input_size=(3, _size, _size),
        crop_pct=1.0 if _size == 384 else 0.9,
        num_classes=21841 if "in22k" in _name else 1000,
        first_conv="patch_embed.proj", classifier="head")

register_variant_table(__name__, _swin, SWIN_VARIANTS)
