"""ResNet chassis (reference models/resnet.py:448-613), counterpart of
``cotnet_tpu/models/resnet.py``.

The chassis takes its block class by injection, so the CoT family
(models/cotnet.py) and the SE-CoTNetD family (models/cotnet_hybrid.py) run
on it.  Ported so far, at output stride 32:

- the stems: the default 7x7 stride-2 conv, and the ResNet-D deep stems
  (``stem_type`` ``deep`` / ``deep_tiered`` / ``deep_tiered_narrow``: three
  3x3 convs as ``conv1.{0,1,3,4,6}``), each followed by BN and
  ``stem_act``; then the 3x3 stride-2 max-pool, or with ``aa_layer="blur"``
  a stride-1 max-pool and a BlurPool, or with ``replace_stem_pool`` no pool
  and a stride of 2 in every stage (the hybrid chassis);
- four stages with the plain 1x1 ``Sequential(conv, bn)`` downsample or,
  with ``avg_down``, ``Sequential(avg-pool, conv, bn)``;
- the pooled linear classifier and the training regularizers (classifier
  dropout, the per-block stochastic-depth ramp, DropBlock in stages 3
  and 4).

Blocks that declare ``aa`` or ``block_idx`` get them.  Submodule names are
the reference's (``conv1``, ``bn1``, ``layerX.Y``, ``downsample.0/1`` or
``downsample.1/2``, ``fc``), so its state_dicts load as they are.
"""

from __future__ import annotations

import inspect
from typing import Optional, Sequence

import torch
from torch import nn

from cotnet_tpu_torch.nn import (
    BatchNorm2d,
    BlurPool2d,
    ClassifierHead,
    Conv2d,
    get_act_fn,
    max_pool2d,
)


class Downsample(nn.Sequential):
    """Identity-path projection: 1x1 strided conv + BN as
    ``downsample.0/1`` (reference resnet.py:365-378), or with ``avg`` the
    ResNet-D form, a 2x2 avg-pool (``ceil_mode=True,
    count_include_pad=False``; the identity at stride 1) then a 1x1 conv
    and BN as ``downsample.1/2`` (reference resnet.py:380-395)."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 avg: bool = False, dtype: torch.dtype = torch.float32):
        conv_bn = (Conv2d(in_channels, out_channels, 1, 1 if avg else stride,
                          0, dtype=dtype),
                   BatchNorm2d(out_channels, dtype=dtype))
        if not avg:
            super().__init__(*conv_bn)
            return
        pool = (nn.Identity() if stride == 1 else
                nn.AvgPool2d(2, stride, ceil_mode=True, count_include_pad=False))
        super().__init__(pool, *conv_bn)


class Act(nn.Module):
    """An activation by name, as a module for a Sequential."""

    def __init__(self, name: str):
        super().__init__()
        self.fn = get_act_fn(name)

    def forward(self, x):
        return self.fn(x)


def deep_stem(in_chans: int, stem_type: str, stem_width: int, act: str,
              dtype: torch.dtype) -> nn.Sequential:
    """The ResNet-D stem before its last BN: three 3x3 convs (the first at
    stride 2) with BN and ``act`` between them, at the reference's
    Sequential indices 0, 1, 3, 4, 6 (reference resnet.py:520-533)."""
    c1 = c2 = stem_width
    if "tiered" in stem_type:
        c1 = 3 * (stem_width // 4)
        c2 = stem_width if "narrow" in stem_type else 6 * (stem_width // 4)
    return nn.Sequential(
        Conv2d(in_chans, c1, 3, 2, 1, dtype=dtype),
        BatchNorm2d(c1, dtype=dtype), Act(act),
        Conv2d(c1, c2, 3, 1, 1, dtype=dtype),
        BatchNorm2d(c2, dtype=dtype), Act(act),
        Conv2d(c2, 2 * stem_width, 3, 1, 1, dtype=dtype))


def drop_block_cfgs(drop_block_rate: float):
    """Per-stage DropBlock ``(rate, block_size, gamma_scale)`` (reference
    resnet.py:397-402)."""
    if not drop_block_rate:
        return [None] * 4
    return [None, None, (drop_block_rate, 5, 0.25), (drop_block_rate, 3, 1.00)]


class ResNet(nn.Module):
    """The chassis.  ``block`` is the block class; per-family block kwargs
    arrive via ``block_args`` (reference block_args injection,
    resnet.py:556-561), dropping any the block does not take.
    ``drop_rate`` is the classifier's dropout, ``drop_path_rate`` the
    stochastic depth of the last block (it ramps linearly from 0 at the
    first), ``drop_block_rate`` the DropBlock rate of stages 3 and 4.
    ``stem_type``, ``stem_width``, ``stem_act`` (default ``act``),
    ``replace_stem_pool``, ``avg_down`` and ``aa_layer`` (None or
    ``"blur"``) are the stem and shortcut options of the module
    docstring."""

    def __init__(self, block, layers: Sequence[int], num_classes: int = 1000,
                 in_chans: int = 3, cardinality: int = 1,
                 base_width: int = 64, stem_width: int = 64,
                 stem_type: str = "", replace_stem_pool: bool = False,
                 avg_down: bool = False, act: str = "relu",
                 stem_act: Optional[str] = None,
                 aa_layer: Optional[str] = None,
                 global_pool: str = "avg", zero_init_last_bn: bool = True,
                 drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 drop_block_rate: float = 0.0,
                 block_args: Optional[dict] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        accepted = inspect.signature(block).parameters

        def takes(kwargs):
            return {k: v for k, v in kwargs.items() if k in accepted}

        block_args = takes(block_args or {})
        net_num_blocks = sum(layers)
        net_block_idx = 0
        if aa_layer not in (None, "blur"):
            raise NotImplementedError(f"aa_layer {aa_layer!r} is not ported")
        self.stem_act = get_act_fn(stem_act or act)
        self.replace_stem_pool = replace_stem_pool

        if "deep" in stem_type:
            inplanes = 2 * stem_width
            self.conv1 = deep_stem(in_chans, stem_type, stem_width,
                                   stem_act or act, dtype)
        else:
            inplanes = 64
            self.conv1 = Conv2d(in_chans, inplanes, 7, 2, 3, dtype=dtype)
        self.bn1 = BatchNorm2d(inplanes, dtype=dtype)
        self.stem_aa = (BlurPool2d(stride=2) if aa_layer and
                        not replace_stem_pool else None)
        for stage_idx, (planes, num_blocks, drop_block) in enumerate(
                zip((64, 128, 256, 512), layers,
                    drop_block_cfgs(drop_block_rate))):
            # without the stem's pool every stage halves the map
            stride = 1 if stage_idx == 0 and not replace_stem_pool else 2
            outplanes = planes * block.expansion
            blocks = []
            for block_idx in range(num_blocks):
                b_stride = stride if block_idx == 0 else 1
                downsample = None
                if block_idx == 0 and (b_stride != 1 or inplanes != outplanes):
                    downsample = Downsample(inplanes, outplanes, b_stride,
                                            avg=avg_down, dtype=dtype)
                drop_path_rate_b = drop_path_rate * net_block_idx / max(
                    net_num_blocks - 1, 1)
                blocks.append(block(
                    inplanes, planes, stride=b_stride, downsample=downsample,
                    cardinality=cardinality, base_width=base_width, act=act,
                    zero_init_last_bn=zero_init_last_bn, dtype=dtype,
                    **takes(dict(drop_block=drop_block,
                                 drop_path_rate=drop_path_rate_b,
                                 aa=aa_layer is not None,
                                 block_idx=block_idx)),
                    **block_args))
                inplanes = outplanes
                net_block_idx += 1
            self.add_module(f"layer{stage_idx + 1}", nn.Sequential(*blocks))
        self.num_features = inplanes
        self.fc = ClassifierHead(inplanes, num_classes, global_pool,
                                 drop_rate=drop_rate, dtype=dtype)

    def forward(self, x):
        x = self.stem_act(self.bn1(self.conv1(x)))
        if self.stem_aa is not None:
            x = self.stem_aa(max_pool2d(x, 3, 1, 1))
        elif not self.replace_stem_pool:
            x = max_pool2d(x, 3, 2, 1)
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return self.fc(x)
