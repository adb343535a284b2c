"""PiT, pooling-based vision transformer (reference models/pit.py),
counterpart of ``cotnet_tpu/models/pit.py``: an overlapping conv patch
embed + position embedding -> ViT blocks in three stages, with token
pooling between them (a depthwise-style conv with channel multiplier 2 on
the patch tokens, a ``Linear`` on the cls tokens) -> LN -> head.  Every
row of the JAX package's ``PIT_VARIANTS`` (8 registry keys) is registered
here.

The blocks are the port's ViT ``Block`` with the qkv bias; stochastic depth
ramps over the blocks of all stages.  The distilled rows carry two tokens
and return the mean of ``head`` and ``head_dist`` in training too, as the
JAX package does.  The position embedding, ``[1, C, H, W]`` as timm's, is
sized when the model is built, by ``img_size`` (default 224); an input of
another size raises.

Parameter names are timm's: ``patch_embed.conv``, ``pos_embed``,
``cls_token``, ``transformers.{s}.blocks.{b}.{norm1,attn.qkv,attn.proj,
norm2,mlp.fc1,mlp.fc2}``, ``transformers.{s}.pool.{conv,fc}`` (the pooling
that closes stage s), ``norm``, ``head``, ``head_dist``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from cotnet_tpu_torch.models.helpers import (build_model_with_cfg,
                                             default_cfg,
                                             register_variant_table)
from cotnet_tpu_torch.models.vision_transformer import Block
from cotnet_tpu_torch.nn import Conv2d, LayerNorm, Linear

default_cfgs = {}  # filled beside the variant table below


class ConvHeadPooling(nn.Module):
    """The pooling between two stages: the patch tokens through a 3x3
    stride-2 conv with ``groups = C_in`` (``[N, C_in, H, W]`` -> ``[N, C_out,
    H/2, W/2]``), the cls tokens through a ``Linear``."""

    def __init__(self, dim_in: int, dim_out: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(dim_in, dim_out, 3, 2, 1, groups=dim_in,
                           bias=True, dtype=dtype)
        self.fc = Linear(dim_in, dim_out, dtype=dtype)

    def forward(self, x, cls_tokens):
        return self.conv(x), self.fc(cls_tokens)


class PitStage(nn.Module):
    """A stage's blocks, then the pooling into the next stage (``pool``,
    None in the last)."""

    def __init__(self, blocks, pool: Optional[nn.Module]):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.pool = pool


class PatchEmbed(nn.Module):
    """A ``patch_size`` conv at ``stride`` with no padding and a bias."""

    def __init__(self, patch_size: int, stride: int, in_chans: int,
                 embed_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(in_chans, embed_dim, patch_size, stride, 0,
                           bias=True, dtype=dtype)

    def forward(self, x):
        return self.conv(x)


class PoolingTransformer(nn.Module):
    """``cotnet_tpu/models/pit.py:23-95``.  ``features_only`` returns each
    stage's patch tokens as an ``[N, C_s, H_s, W_s]`` map (the norm and the
    heads are not built); ``num_classes=0`` returns the normed first
    token."""

    def __init__(self, img_size: int = 224, patch_size: int = 16,
                 stride: int = 8, base_dims: Sequence[int] = (48, 48, 48),
                 depths: Sequence[int] = (2, 6, 4),
                 heads: Sequence[int] = (2, 4, 8), mlp_ratio: float = 4.0,
                 distilled: bool = False, in_chans: int = 3,
                 num_classes: int = 1000, drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0, features_only: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.img_size, self.features_only = img_size, features_only
        self.n_tokens = 2 if distilled else 1
        dims = [bd * h for bd, h in zip(base_dims, heads)]
        self.patch_embed = PatchEmbed(patch_size, stride, in_chans, dims[0],
                                      dtype=dtype)
        grid = (img_size - patch_size) // stride + 1
        self.pos_embed = nn.Parameter(torch.empty(1, dims[0], grid, grid))
        self.cls_token = nn.Parameter(torch.empty(1, self.n_tokens, dims[0]))
        total = sum(depths)
        idx = 0
        self.transformers = nn.ModuleList()
        for si, (depth, h) in enumerate(zip(depths, heads)):
            blocks = []
            for _ in range(depth):
                blocks.append(Block(
                    dims[si], h, mlp_ratio, True, drop_rate, 0.0,
                    drop_path_rate * idx / max(total - 1, 1), dtype=dtype))
                idx += 1
            pool = (ConvHeadPooling(dims[si], dims[si + 1], dtype=dtype)
                    if si < len(depths) - 1 else None)
            self.transformers.append(PitStage(blocks, pool))
        self.norm = self.head = self.head_dist = None
        if not features_only:
            self.norm = LayerNorm(dims[-1], 1e-6, dtype=dtype)
            if num_classes > 0:
                self.head = Linear(dims[-1], num_classes, dtype=dtype)
                if distilled:
                    self.head_dist = Linear(dims[-1], num_classes,
                                            dtype=dtype)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The position embedding and the tokens normal with std 0.02, as
        the JAX package initializes them."""
        with torch.no_grad():
            self.pos_embed.normal_(0.0, 0.02, generator=generator)
            self.cls_token.normal_(0.0, 0.02, generator=generator)

    def forward(self, x):
        if tuple(x.shape[2:]) != (self.img_size, self.img_size):
            raise ValueError(
                f"the position embedding was sized for {self.img_size}x"
                f"{self.img_size} inputs, got {tuple(x.shape[2:])}: build "
                "the model with img_size= the input's size")
        x = self.patch_embed(x)
        x = x + self.pos_embed.to(x.dtype)
        n, t = x.shape[0], self.n_tokens
        cls_tokens = self.cls_token.expand(n, -1, -1).to(x.dtype)
        feats = []
        for stage in self.transformers:
            c, gh, gw = x.shape[1:]
            tokens = torch.cat([cls_tokens, x.flatten(2).transpose(1, 2)],
                               dim=1)
            for block in stage.blocks:
                tokens = block(tokens)
            cls_tokens = tokens[:, :t]
            x = tokens[:, t:].transpose(1, 2).reshape(n, c, gh, gw)
            feats.append(x)
            if stage.pool is not None:
                x, cls_tokens = stage.pool(x, cls_tokens)
        if self.features_only:
            return feats
        cls_tokens = self.norm(cls_tokens)
        if self.head is None:
            return cls_tokens[:, 0]
        logits = self.head(cls_tokens[:, 0])
        if self.head_dist is not None:
            logits = (logits + self.head_dist(cls_tokens[:, 1])) / 2
        return logits


def _pit(model_name, pretrained=False, img_size: Optional[int] = None,
         **kwargs):
    """Build a row on ``PoolingTransformer`` (``pretrained`` is accepted
    and ignored: weights load through ``utils.convert``)."""
    cfg = default_cfgs[model_name]
    return build_model_with_cfg(PoolingTransformer, model_name, cfg,
                                img_size=img_size or cfg["input_size"][-1],
                                **kwargs)


# --- variant table (reference pit.py:283-383) -------------------------------

_PIT_TI = dict(patch_size=16, stride=8, base_dims=(32, 32, 32),
               depths=(2, 6, 4), heads=(2, 4, 8))
_PIT_XS = dict(patch_size=16, stride=8, base_dims=(48, 48, 48),
               depths=(2, 6, 4), heads=(2, 4, 8))
_PIT_S = dict(patch_size=16, stride=8, base_dims=(48, 48, 48),
              depths=(2, 6, 4), heads=(3, 6, 12))
_PIT_B = dict(patch_size=14, stride=7, base_dims=(64, 64, 64),
              depths=(3, 6, 4), heads=(4, 8, 16))

PIT_VARIANTS = {
    "pit_ti_224": dict(_PIT_TI),
    "pit_xs_224": dict(_PIT_XS),
    "pit_s_224": dict(_PIT_S),
    "pit_b_224": dict(_PIT_B),
    "pit_ti_distilled_224": dict(_PIT_TI, distilled=True),
    "pit_xs_distilled_224": dict(_PIT_XS, distilled=True),
    "pit_s_distilled_224": dict(_PIT_S, distilled=True),
    "pit_b_distilled_224": dict(_PIT_B, distilled=True),
}

for _name in PIT_VARIANTS:
    default_cfgs[_name] = default_cfg(crop_pct=0.9,
                                      first_conv="patch_embed.conv",
                                      classifier="head")

register_variant_table(__name__, _pit, PIT_VARIANTS)
