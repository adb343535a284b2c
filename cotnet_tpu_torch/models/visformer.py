"""Visformer (reference models/visformer.py), counterpart of
``cotnet_tpu/models/visformer.py``: a BN/ReLU conv stem, then three
stages, each a patch embed + BN + position embedding and blocks of BN ->
attention on 1x1 convs and BN -> a conv MLP; the first stage has no
attention and a grouped 3x3 in its MLP -> BN -> mean over the map -> head.
The registry keys ``visformer_tiny`` and ``visformer_small``.

Everything is NCHW and every norm is the port's ``BatchNorm2d`` (global
batch statistics under a process group).  The MLP with the grouped 3x3
takes ``hidden = 2 * dim``, the others ``mlp_ratio * dim``; the attention's
head width is ``dim // heads * head_dim_ratio`` (0.5 in the first stage,
which has none, 1 after).  The patch embeds keep their conv bias.  The
position embeddings are sized when the model is built, by ``img_size``
(default 224); an input of another size raises.  Stochastic depth ramps
over the blocks of all stages.

Parameter names are timm's: ``stem.{0,1}``, ``patch_embed{s}.{proj,norm}``,
``pos_embed{s}`` (``[1, C, H, W]``), ``stage{s}.{b}.{norm1,attn.{qkv,proj},
norm2,mlp.{conv1,conv2,conv3}}`` (``norm1``, ``attn`` and ``conv2`` where
the stage has them), ``norm``, ``head``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from cotnet_tpu_torch.models.helpers import (build_model_with_cfg,
                                             default_cfg,
                                             register_variant_table)
from cotnet_tpu_torch.nn import (BatchNorm2d, Conv2d, DropPath, Linear,
                                 get_act_fn)

default_cfgs = {}  # filled beside the variant table below


class SpatialMlp(nn.Module):
    """1x1 conv -> GELU -> [grouped 3x3 -> GELU] -> 1x1 conv, no biases."""

    def __init__(self, dim: int, hidden: int, spatial_conv: bool = False,
                 group: int = 8, dtype: torch.dtype = torch.float32):
        super().__init__()
        if spatial_conv and group >= 2:
            hidden = dim * 2
        self.act = get_act_fn("gelu")
        self.conv1 = Conv2d(dim, hidden, 1, dtype=dtype)
        self.conv2 = (Conv2d(hidden, hidden, 3, 1, 1, groups=group,
                             dtype=dtype) if spatial_conv else None)
        self.conv3 = Conv2d(hidden, dim, 1, dtype=dtype)

    def forward(self, x):
        x = self.act(self.conv1(x))
        if self.conv2 is not None:
            x = self.act(self.conv2(x))
        return self.conv3(x)


class VisAttention(nn.Module):
    """Self-attention over the positions of ``[N, C, H, W]`` with 1x1-conv
    ``qkv`` and ``proj``, no biases."""

    def __init__(self, dim: int, num_heads: int, head_dim_ratio: float = 1.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        self.head_dim = round(dim // num_heads * head_dim_ratio)
        width = self.head_dim * num_heads
        self.qkv = Conv2d(dim, 3 * width, 1, dtype=dtype)
        self.proj = Conv2d(width, dim, 1, dtype=dtype)

    def forward(self, x):
        n, _, h, w = x.shape
        nh, dh = self.num_heads, self.head_dim
        qkv = self.qkv(x).reshape(n, 3, nh, dh, h * w).permute(1, 0, 2, 4, 3)
        q, k, v = qkv.unbind(0)                         # [n, nh, hw, dh]
        attn = torch.softmax(torch.matmul(q * dh ** -0.5,
                                          k.transpose(-2, -1)).float(), -1)
        y = torch.matmul(attn.to(self.dtype), v)        # [n, nh, hw, dh]
        return self.proj(y.transpose(-2, -1).reshape(n, nh * dh, h, w))


class VisBlock(nn.Module):
    """``x + drop_path(attn(norm1(x)))`` (where the stage has attention),
    then ``x + drop_path(mlp(norm2(x)))``, BN norms."""

    def __init__(self, dim: int, num_heads: int, head_dim_ratio: float = 1.0,
                 mlp_ratio: float = 4.0, group: int = 8,
                 attn_disabled: bool = False, spatial_conv: bool = False,
                 drop_path_rate: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = self.attn = None
        if not attn_disabled:
            self.norm1 = BatchNorm2d(dim, dtype=dtype)
            self.attn = VisAttention(dim, num_heads, head_dim_ratio,
                                     dtype=dtype)
        self.drop_path = DropPath(drop_path_rate)
        self.norm2 = BatchNorm2d(dim, dtype=dtype)
        self.mlp = SpatialMlp(dim, int(dim * mlp_ratio), spatial_conv, group,
                              dtype=dtype)

    def forward(self, x):
        if self.attn is not None:
            x = x + self.drop_path(self.attn(self.norm1(x)))
        return x + self.drop_path(self.mlp(self.norm2(x)))


class PatchEmbed(nn.Module):
    """A ``patch_size`` strided conv with a bias, then BN."""

    def __init__(self, patch_size: int, in_chans: int, embed_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.proj = Conv2d(in_chans, embed_dim, patch_size, patch_size, 0,
                           bias=True, dtype=dtype)
        self.norm = BatchNorm2d(embed_dim, dtype=dtype)

    def forward(self, x):
        return self.norm(self.proj(x))


class Visformer(nn.Module):
    """``cotnet_tpu/models/visformer.py:101-165``.  ``features_only``
    returns each stage's map, ``[N, C_s, H_s, W_s]`` (the norm and the head
    are not built); ``num_classes=0`` returns the pooled features."""

    def __init__(self, img_size: int = 224, in_chans: int = 3,
                 num_classes: int = 1000, init_channels: int = 32,
                 embed_dim: int = 384, depths: Sequence[int] = (7, 4, 4),
                 num_heads: int = 6, mlp_ratio: float = 4.0, group: int = 8,
                 attn_stage: str = "011", spatial_conv: str = "100",
                 drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 features_only: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.img_size, self.features_only = img_size, features_only
        self.stem = nn.Sequential(
            Conv2d(in_chans, init_channels, 7, 2, 3, dtype=dtype),
            BatchNorm2d(init_channels, dtype=dtype), nn.ReLU())
        dims = (embed_dim // 2, embed_dim, embed_dim * 2)
        patches, ratios = (4, 2, 2), (0.5, 1.0, 1.0)
        size = (img_size - 1) // 2 + 1
        total = sum(depths)
        idx = 0
        chans = init_channels
        for si in range(3):
            size //= patches[si]
            self.add_module(f"patch_embed{si + 1}", PatchEmbed(
                patches[si], chans, dims[si], dtype=dtype))
            self.register_parameter(f"pos_embed{si + 1}", nn.Parameter(
                torch.empty(1, dims[si], size, size)))
            blocks = []
            for _ in range(depths[si]):
                blocks.append(VisBlock(
                    dims[si], num_heads, ratios[si], mlp_ratio, group,
                    attn_disabled=attn_stage[si] == "0",
                    spatial_conv=spatial_conv[si] == "1",
                    drop_path_rate=drop_path_rate * idx / max(total - 1, 1),
                    dtype=dtype))
                idx += 1
            self.add_module(f"stage{si + 1}", nn.Sequential(*blocks))
            chans = dims[si]
        self.norm = self.head = None
        if not features_only:
            self.norm = BatchNorm2d(dims[-1], dtype=dtype)
            if num_classes > 0:
                self.head = Linear(dims[-1], num_classes, dtype=dtype)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The position embeddings normal with std 0.02, as the JAX package
        initializes them."""
        with torch.no_grad():
            for si in range(1, 4):
                getattr(self, f"pos_embed{si}").normal_(0.0, 0.02,
                                                        generator=generator)

    def forward(self, x):
        if tuple(x.shape[2:]) != (self.img_size, self.img_size):
            raise ValueError(
                f"the position embeddings were sized for {self.img_size}x"
                f"{self.img_size} inputs, got {tuple(x.shape[2:])}: build "
                "the model with img_size= the input's size")
        x = self.stem(x)
        feats = []
        for si in range(1, 4):
            x = getattr(self, f"patch_embed{si}")(x)
            x = x + getattr(self, f"pos_embed{si}").to(x.dtype)
            x = getattr(self, f"stage{si}")(x)
            feats.append(x)
        if self.features_only:
            return feats
        x = self.norm(x).mean((2, 3))
        return x if self.head is None else self.head(x)


def _visformer(model_name, pretrained=False, img_size: Optional[int] = None,
               **kwargs):
    """Build a row on ``Visformer`` (``pretrained`` is accepted and
    ignored: weights load through ``utils.convert``)."""
    cfg = default_cfgs[model_name]
    return build_model_with_cfg(Visformer, model_name, cfg,
                                img_size=img_size or cfg["input_size"][-1],
                                **kwargs)


# --- variant table (reference visformer.py:399-417) -------------------------

VISFORMER_VARIANTS = {
    "visformer_tiny": dict(init_channels=16, embed_dim=192, num_heads=3),
    "visformer_small": dict(init_channels=32, embed_dim=384, num_heads=6),
}

for _name in VISFORMER_VARIANTS:
    default_cfgs[_name] = default_cfg(first_conv="stem.0",
                                      classifier="head")

register_variant_table(__name__, _visformer, VISFORMER_VARIANTS)
