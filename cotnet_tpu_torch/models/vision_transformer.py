"""Vision Transformer and DeiT (reference models/vision_transformer.py),
counterpart of ``cotnet_tpu/models/vision_transformer.py``: patch embed ->
[cls] (+ [dist]) + position embedding -> pre-LN transformer blocks -> LN ->
head.  Every row of the JAX package's ``VIT_VARIANTS`` (34 registry keys)
is registered here; the hybrid ViTs (``models/vision_transformer_hybrid.py``)
put a CNN backbone in front of the patch projection.

Attention is an explicit ``matmul`` / ``softmax`` / ``matmul``, as the JAX
package computes it: the logits in the compute dtype, the softmax in f32 and
cast back.  GELU is the exact ``erf`` form.  The position embedding is sized
when the model is built, by ``img_size`` (default the key's configured
input size, 224 or 384): an input of another size raises, where the JAX
package sizes it from the traced input.  The distilled DeiT rows return the
mean of ``head`` and ``head_dist`` in training too, as the JAX package does
(the reference returns both there, for the distillation loss).

Parameter names are timm's: ``patch_embed.proj``, ``cls_token``,
``dist_token``, ``pos_embed``, ``blocks.{i}.{norm1,attn.qkv,attn.proj,norm2,
mlp.fc1,mlp.fc2}``, ``norm``, ``pre_logits``, ``head``, ``head_dist``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from cotnet_tpu_torch.models.helpers import (build_model_with_cfg,
                                             default_cfg, meta_call,
                                             register_variant_table)
from cotnet_tpu_torch.nn import (Conv2d, DropPath, Dropout, LayerNorm, Linear,
                                 get_act_fn)

default_cfgs = {}  # filled beside the variant table below


class Attention(nn.Module):
    """Multi-head self-attention over ``[N, L, D]`` tokens
    (``cotnet_tpu/models/vision_transformer.py:25-50``)."""

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = True,
                 attn_drop: float = 0.0, proj_drop: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        self.qkv = Linear(dim, 3 * dim, qkv_bias, dtype=dtype)
        self.attn_drop = Dropout(attn_drop)
        self.proj = Linear(dim, dim, dtype=dtype)
        self.proj_drop = Dropout(proj_drop)

    def forward(self, x):
        n, length, d = x.shape
        h = self.num_heads
        dh = d // h
        qkv = self.qkv(x).reshape(n, length, 3, h, dh).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.unbind(0)                       # [n, h, l, dh]
        logits = torch.matmul(q, k.transpose(-2, -1)).float()
        attn = torch.softmax(logits * dh ** -0.5, -1).to(self.dtype)
        attn = self.attn_drop(attn)
        y = torch.matmul(attn, v).transpose(1, 2).reshape(n, length, d)
        return self.proj_drop(self.proj(y))


class Mlp(nn.Module):
    """fc1 -> GELU (erf) -> dropout -> fc2 -> dropout."""

    def __init__(self, dim: int, hidden: int, drop: float = 0.0,
                 act: str = "gelu", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Linear(dim, hidden, dtype=dtype)
        self.act = get_act_fn(act)
        self.drop = Dropout(drop)
        self.fc2 = Linear(hidden, dim, dtype=dtype)

    def forward(self, x):
        x = self.drop(self.act(self.fc1(x)))
        return self.drop(self.fc2(x))


class Block(nn.Module):
    """Pre-LN block: ``x + drop_path(attn(norm1(x)))``, then ``x +
    drop_path(mlp(norm2(x)))``, LayerNorm eps 1e-6."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop: float = 0.0,
                 attn_drop: float = 0.0, drop_path_rate: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = LayerNorm(dim, 1e-6, dtype=dtype)
        self.attn = Attention(dim, num_heads, qkv_bias, attn_drop, drop,
                              dtype=dtype)
        self.drop_path = DropPath(drop_path_rate)
        self.norm2 = LayerNorm(dim, 1e-6, dtype=dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), drop, dtype=dtype)

    def forward(self, x):
        x = x + self.drop_path(self.attn(self.norm1(x)))
        return x + self.drop_path(self.mlp(self.norm2(x)))


class PatchEmbed(nn.Module):
    """The patch projection, a ``patch_size`` strided conv with a bias
    (``proj``), after the hybrids' CNN ``backbone`` where there is one
    (reference HybridEmbed): ``[N, C, H, W]`` -> ``[N, gh*gw, D]``, the
    tokens in raster order."""

    def __init__(self, img_size: int, patch_size: int, in_chans: int,
                 embed_dim: int, backbone: Optional[nn.Module] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.img_size = img_size
        if backbone is not None:
            self.backbone = backbone
            # the backbone's last map for one image, traced on the meta
            # device
            out = meta_call(backbone, torch.empty(
                1, in_chans, img_size, img_size, device="meta"))
            if isinstance(out, (list, tuple)):
                out = out[-1]
            in_chans, h, w = out.shape[1:]
        else:
            self.backbone = None
            h = w = img_size
        self.grid = (h // patch_size, w // patch_size)
        self.num_patches = self.grid[0] * self.grid[1]
        self.proj = Conv2d(in_chans, embed_dim, patch_size, patch_size, 0,
                           bias=True, dtype=dtype)

    def forward(self, x):
        if tuple(x.shape[2:]) != (self.img_size, self.img_size):
            raise ValueError(
                f"the position embedding was sized for {self.img_size}x"
                f"{self.img_size} inputs, got {tuple(x.shape[2:])}: build "
                "the model with img_size= the input's size")
        if self.backbone is not None:
            x = self.backbone(x)
            if isinstance(x, (list, tuple)):
                x = x[-1]
        return self.proj(x).flatten(2).transpose(1, 2)


class VisionTransformer(nn.Module):
    """``cotnet_tpu/models/vision_transformer.py:94-165``.  ``distilled``
    adds the DeiT distillation token and ``head_dist``, whose logits are
    averaged with ``head``'s; ``representation_size`` adds the tanh
    ``pre_logits`` layer (not with ``distilled``); ``num_classes=0``
    returns the class token's features; ``features_only`` returns each
    block's tokens (before the final norm, which is still built, as in the
    JAX package).  ``drop_rate`` drops after the position embedding and in
    every block's projections and MLP, ``attn_drop_rate`` the attention
    weights, and stochastic depth ramps from 0 at the first block to
    ``drop_path_rate`` at the last."""

    def __init__(self, img_size: int = 224, patch_size: int = 16,
                 in_chans: int = 3, num_classes: int = 1000,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 distilled: bool = False,
                 representation_size: Optional[int] = None,
                 drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0,
                 backbone: Optional[nn.Module] = None,
                 features_only: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes, self.distilled = num_classes, distilled
        self.features_only = features_only
        self.dtype = dtype
        self.patch_embed = PatchEmbed(img_size, patch_size, in_chans,
                                      embed_dim, backbone, dtype=dtype)
        n_prefix = 2 if distilled else 1
        self.cls_token = nn.Parameter(torch.empty(1, 1, embed_dim))
        self.dist_token = (nn.Parameter(torch.empty(1, 1, embed_dim))
                           if distilled else None)
        self.pos_embed = nn.Parameter(torch.empty(
            1, self.patch_embed.num_patches + n_prefix, embed_dim))
        self.pos_drop = Dropout(drop_rate)
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, qkv_bias, drop_rate,
                  attn_drop_rate, drop_path_rate * i / max(depth - 1, 1),
                  dtype=dtype)
            for i in range(depth))
        self.norm = LayerNorm(embed_dim, 1e-6, dtype=dtype)
        self.pre_logits = self.head = self.head_dist = None
        width = embed_dim
        if representation_size and not distilled and not features_only:
            self.pre_logits = Linear(embed_dim, representation_size,
                                     dtype=dtype)
            width = representation_size
        if num_classes > 0 and not features_only:
            self.head = Linear(width, num_classes, dtype=dtype)
            if distilled:
                self.head_dist = Linear(embed_dim, num_classes, dtype=dtype)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The token parameters as the JAX package initializes them: the
        class and distillation tokens 0, the position embedding normal
        with std 0.02."""
        with torch.no_grad():
            self.cls_token.zero_()
            if self.dist_token is not None:
                self.dist_token.zero_()
            self.pos_embed.normal_(0.0, 0.02, generator=generator)

    def forward(self, x):
        x = self.patch_embed(x)
        n, _, d = x.shape
        prefix = [self.cls_token.expand(n, 1, d).to(x.dtype)]
        if self.dist_token is not None:
            prefix.append(self.dist_token.expand(n, 1, d).to(x.dtype))
        x = torch.cat(prefix + [x], dim=1) + self.pos_embed.to(x.dtype)
        x = self.pos_drop(x)
        feats = []
        for block in self.blocks:
            x = block(x)
            feats.append(x)
        if self.features_only:
            return feats
        x = self.norm(x)
        out = x[:, 0]
        if self.pre_logits is not None:
            out = torch.tanh(self.pre_logits(out))
        if self.head is None:
            return out
        logits = self.head(out)
        if self.head_dist is not None:
            logits = (logits + self.head_dist(x[:, 1])) / 2
        return logits


def _vit(model_name, pretrained=False, img_size: Optional[int] = None,
         **kwargs):
    """Build a row on ``VisionTransformer`` (``pretrained`` is accepted and
    ignored: weights load through ``utils.convert``).  The pre-logits
    layer is dropped when ``num_classes`` differs from the key's (the
    reference's fine-tuning rule, vision_transformer.py:530-536)."""
    cfg = default_cfgs[model_name]
    if kwargs.get("representation_size") and \
            kwargs.get("num_classes", cfg["num_classes"]) != cfg["num_classes"]:
        kwargs.pop("representation_size")
    return build_model_with_cfg(
        VisionTransformer, model_name, cfg,
        img_size=img_size or cfg["input_size"][-1],
        **kwargs)


# --- variant table (reference vision_transformer.py:548-892) ---------------

def _dims(patch, dim, depth, heads, **extra):
    return dict(patch_size=patch, embed_dim=dim, depth=depth,
                num_heads=heads, **extra)


_TINY = (16, 192, 12, 3)
_SMALL = (16, 384, 12, 6)
_BASE = (16, 768, 12, 12)
_LARGE = (16, 1024, 24, 16)

VIT_VARIANTS = {
    "vit_tiny_patch16_224": _dims(*_TINY),
    "vit_tiny_patch16_384": _dims(*_TINY),
    "vit_small_patch32_224": _dims(32, 384, 12, 6),
    "vit_small_patch32_384": _dims(32, 384, 12, 6),
    "vit_small_patch16_224": _dims(*_SMALL),
    "vit_small_patch16_384": _dims(*_SMALL),
    "vit_base_patch32_224": _dims(32, 768, 12, 12),
    "vit_base_patch32_384": _dims(32, 768, 12, 12),
    "vit_base_patch16_224": _dims(*_BASE),
    "vit_base_patch16_384": _dims(*_BASE),
    "vit_large_patch32_224": _dims(32, 1024, 24, 16),
    "vit_large_patch32_384": _dims(32, 1024, 24, 16),
    "vit_large_patch16_224": _dims(*_LARGE),
    "vit_large_patch16_384": _dims(*_LARGE),
    # SAM-pretrained, the representation layer kept
    "vit_base_patch16_sam_224": _dims(*_BASE, representation_size=768),
    "vit_base_patch32_sam_224": _dims(32, 768, 12, 12,
                                      representation_size=768),
    # in21k (21843 classes; large_p32 and huge keep the pre-logits)
    "vit_tiny_patch16_224_in21k": _dims(*_TINY),
    "vit_small_patch32_224_in21k": _dims(32, 384, 12, 6),
    "vit_small_patch16_224_in21k": _dims(*_SMALL),
    "vit_base_patch32_224_in21k": _dims(32, 768, 12, 12),
    "vit_base_patch16_224_in21k": _dims(*_BASE),
    "vit_large_patch32_224_in21k": _dims(32, 1024, 24, 16,
                                         representation_size=1024),
    "vit_large_patch16_224_in21k": _dims(*_LARGE),
    "vit_huge_patch14_224_in21k": _dims(14, 1280, 32, 16,
                                        representation_size=1280),
    # DeiT (vision_transformer.py:793-876)
    "deit_tiny_patch16_224": _dims(*_TINY),
    "deit_small_patch16_224": _dims(*_SMALL),
    "deit_base_patch16_224": _dims(*_BASE),
    "deit_base_patch16_384": _dims(*_BASE),
    "deit_tiny_distilled_patch16_224": _dims(*_TINY, distilled=True),
    "deit_small_distilled_patch16_224": _dims(*_SMALL, distilled=True),
    "deit_base_distilled_patch16_224": _dims(*_BASE, distilled=True),
    "deit_base_distilled_patch16_384": _dims(*_BASE, distilled=True),
    # MIIL (qkv_bias=False)
    "vit_base_patch16_224_miil_in21k": _dims(*_BASE, qkv_bias=False),
    "vit_base_patch16_224_miil": _dims(*_BASE, qkv_bias=False),
}

for _name in VIT_VARIANTS:
    _size = 384 if "_384" in _name else 224
    if "miil" in _name:
        _mean, _std, _interp = (0, 0, 0), (1, 1, 1), "bilinear"
    elif _name.startswith("deit"):
        _mean, _std, _interp = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225),
                                "bicubic")
    else:
        _mean, _std, _interp = (0.5, 0.5, 0.5), (0.5, 0.5, 0.5), "bicubic"
    default_cfgs[_name] = default_cfg(
        input_size=(3, _size, _size),
        num_classes=21843 if "in21k" in _name else 1000,
        crop_pct=1.0 if _size == 384 else 0.9, interpolation=_interp,
        mean=_mean, std=_std, first_conv="patch_embed.proj",
        classifier="head")

register_variant_table(__name__, _vit, VIT_VARIANTS)
