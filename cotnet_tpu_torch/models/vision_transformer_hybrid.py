"""Hybrid ViTs (reference models/vision_transformer_hybrid.py), counterpart
of ``cotnet_tpu/models/vision_transformer_hybrid.py``: a CNN backbone's
last feature map is the transformer's patch grid (the reference's
HybridEmbed, ``patch_embed.backbone`` then ``patch_embed.proj``).  Every row
of the JAX package's ``VIT_HYBRID_VARIANTS`` (19 registry keys) is
registered here.  Two backbone families:

- ``r``: ResNetV2 with weight-standardized convs (eps 1e-8), GroupNorm and
  TF-SAME padding, non-preact, ``features_only``; ``layers=()`` is the R+Ti
  case, the stem alone, whose ``conv`` and ``norm`` sit right under
  ``patch_embed.backbone``, as timm's stem Sequential puts them;
- ``d``: the port's ResNet chassis (``models/resnet.py``) as resnet26d /
  resnet50d, with the deep stem, ``avg_down``, ``features_only`` and one
  ``out_indices`` entry.  Its names are timm's (``conv1.0``, ``layer1.0``,
  ``downsample.1``); the JAX package's converter looks them up under
  others (``conv1_0``, ``layer1_0``, ``downsample.conv``).
"""

from __future__ import annotations

from typing import Optional

import torch

from cotnet_tpu_torch.models.helpers import (IMAGENET_DEFAULT_MEAN,
                                             IMAGENET_DEFAULT_STD,
                                             build_model_with_cfg,
                                             default_cfg,
                                             register_variant_table)
from cotnet_tpu_torch.models.resnet import Bottleneck as ResNetBottleneck
from cotnet_tpu_torch.models.resnet import ResNet
from cotnet_tpu_torch.models.resnetv2 import ConvFactory, ResNetV2, Stem
from cotnet_tpu_torch.models.vision_transformer import VisionTransformer

default_cfgs = {}  # filled beside the variant table below


def r_backbone(layers, in_chans: int = 3, dtype=torch.float32):
    """The ResNetV2 feature backbone (std conv with eps 1e-8, GN, TF-SAME,
    non-preact), or with no ``layers`` its stem alone (reference
    vision_transformer_hybrid.py:150-162)."""
    if not layers:
        f = ConvFactory(True, "gn", same=True, conv_eps=1e-8, dtype=dtype)
        return Stem(f, in_chans, 64, "same", preact=False)
    return ResNetV2(layers=layers, in_chans=in_chans, stem_type="same",
                    preact=False, std_conv=True, norm="gn",
                    features_only=True, conv_eps=1e-8, dtype=dtype)


def d_backbone(layers, out_stage: int, in_chans: int = 3,
               dtype=torch.float32):
    """resnet26d / resnet50d up to stage ``out_stage``, its output the
    feature map (reference vision_transformer_hybrid.py:323-362)."""
    return ResNet(block=ResNetBottleneck, layers=layers, in_chans=in_chans,
                  stem_width=32, stem_type="deep", avg_down=True,
                  features_only=True, out_indices=(out_stage,), dtype=dtype)


def _vit_hybrid(model_name, pretrained=False, img_size: Optional[int] = None,
                backbone_kind: str = "r", backbone_layers=(),
                in_chans: int = 3, **kwargs):
    """Build a row: the backbone, then ``VisionTransformer`` on it
    (``pretrained`` is accepted and ignored)."""
    cfg = default_cfgs[model_name]
    dtype = kwargs.get("dtype", torch.float32)
    if backbone_kind == "r":
        backbone = r_backbone(backbone_layers, in_chans, dtype)
    else:
        layers, out_stage = backbone_layers
        backbone = d_backbone(layers, out_stage, in_chans, dtype)
    if kwargs.get("representation_size") and \
            kwargs.get("num_classes", cfg["num_classes"]) != cfg["num_classes"]:
        kwargs.pop("representation_size")
    return build_model_with_cfg(
        VisionTransformer, model_name, cfg, backbone=backbone,
        img_size=img_size or cfg["input_size"][-1], in_chans=in_chans,
        **kwargs)


def _r(layers, dim, depth, heads, patch=1, **extra):
    return dict(backbone_kind="r", backbone_layers=tuple(layers),
                patch_size=patch, embed_dim=dim, depth=depth, num_heads=heads,
                **extra)


def _d(layers, out_stage, dim, depth, heads, mlp_ratio=4.0):
    return dict(backbone_kind="d", backbone_layers=(tuple(layers), out_stage),
                patch_size=1, embed_dim=dim, depth=depth, num_heads=heads,
                mlp_ratio=mlp_ratio)


# reference vision_transformer_hybrid.py:166-362
VIT_HYBRID_VARIANTS = {
    "vit_tiny_r_s16_p8_224": _r((), 192, 12, 3, patch=8),
    "vit_tiny_r_s16_p8_384": _r((), 192, 12, 3, patch=8),
    "vit_small_r26_s32_224": _r((2, 2, 2, 2), 384, 12, 6),
    "vit_small_r26_s32_384": _r((2, 2, 2, 2), 384, 12, 6),
    "vit_base_r26_s32_224": _r((2, 2, 2, 2), 768, 12, 12),
    "vit_base_r50_s16_224": _r((3, 4, 9), 768, 12, 12),
    "vit_base_r50_s16_384": _r((3, 4, 9), 768, 12, 12),
    "vit_base_resnet50_384": _r((3, 4, 9), 768, 12, 12),  # deprecated alias
    "vit_large_r50_s32_224": _r((3, 4, 6, 3), 1024, 24, 16),
    "vit_large_r50_s32_384": _r((3, 4, 6, 3), 1024, 24, 16),
    "vit_tiny_r_s16_p8_224_in21k": _r((), 192, 12, 3, patch=8),
    "vit_small_r26_s32_224_in21k": _r((2, 2, 2, 2), 384, 12, 6),
    "vit_base_r50_s16_224_in21k": _r((3, 4, 9), 768, 12, 12,
                                     representation_size=768),
    "vit_base_resnet50_224_in21k": _r((3, 4, 9), 768, 12, 12,
                                      representation_size=768),  # alias
    "vit_large_r50_s32_224_in21k": _r((3, 4, 6, 3), 1024, 24, 16),
    # timm-resnet backbones (vision_transformer_hybrid.py:323-362)
    "vit_small_resnet26d_224": _d((2, 2, 2, 2), 4, 768, 8, 8, mlp_ratio=3.0),
    "vit_small_resnet50d_s16_224": _d((3, 4, 6, 3), 3, 768, 8, 8,
                                      mlp_ratio=3.0),
    "vit_base_resnet26d_224": _d((2, 2, 2, 2), 4, 768, 12, 12),
    "vit_base_resnet50d_224": _d((3, 4, 6, 3), 4, 768, 12, 12),
}

for _name, _row in VIT_HYBRID_VARIANTS.items():
    _size = 384 if "_384" in _name else 224
    if _row["backbone_kind"] == "d":
        _mean, _std = IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD
        _fc = "patch_embed.backbone.conv1.0"
    else:
        _mean, _std = (0.5, 0.5, 0.5), (0.5, 0.5, 0.5)
        _fc = "patch_embed.backbone.stem.conv"
    default_cfgs[_name] = default_cfg(
        input_size=(3, _size, _size),
        num_classes=21843 if "in21k" in _name else 1000,
        crop_pct=1.0 if _size == 384 else 0.9, mean=_mean, std=_std,
        first_conv=_fc, classifier="head")

register_variant_table(__name__, _vit_hybrid, VIT_HYBRID_VARIANTS)
