"""ResNet chassis and the classic block zoo (reference
models/resnet.py:448-613), counterpart of ``cotnet_tpu/models/resnet.py``.

The chassis takes its block class by injection, so the plain ResNets
(``BasicBlock``, ``Bottleneck``, with SE / ECA / CBAM attention through
``attn_layer``), the CoT family (models/cotnet.py) and the SE-CoTNetD
family (models/cotnet_hybrid.py) run on it.  Every row of the JAX
package's ``RESNET_VARIANTS`` (68 registry keys) is registered here.
Ported so far, at output stride 32:

- the stems: the default 7x7 stride-2 conv, and the ResNet-D deep stems
  (``stem_type`` ``deep`` / ``deep_tiered`` / ``deep_tiered_narrow``: three
  3x3 convs as ``conv1.{0,1,3,4,6}``), each followed by BN and
  ``stem_act``; then the 3x3 stride-2 max-pool, or with ``aa_layer="blur"``
  a stride-1 max-pool and a BlurPool, or with ``replace_stem_pool`` no pool
  and a stride of 2 in every stage (the hybrid chassis);
- four stages with the plain ``Sequential(conv, bn)`` downsample (a 1x1
  conv, or ``down_kernel_size`` where it strides) or, with ``avg_down``,
  ``Sequential(avg-pool, conv, bn)``; ``block_reduce_first`` narrows each
  block's first conv;
- the pooled linear classifier and the training regularizers (classifier
  dropout, the per-block stochastic-depth ramp, DropBlock in stages 3
  and 4).

Blocks that declare ``aa``, ``block_idx``, ``reduce_first``,
``dilation`` or ``first_dilation`` get them.
Submodule names are the reference's (``conv1``, ``bn1``, ``layerX.Y``,
``downsample.0/1`` or ``downsample.1/2``, ``fc``, a block's ``se``), so its
state_dicts load as they are.  Besides:

- ``output_stride`` 8 or 16: once the net's stride reaches it, a stage's
  stride turns into dilation of its 3x3 convs and shortcuts;
- ``features_only``: the forward returns the features at ``out_indices``
  (0 the stem's, after its activation and before the pool; 1-4 the
  stages'), and the stages beyond the largest index and the classifier are
  not built (``models/features.py`` wraps a model for its pyramid);
- ``remat``: in training each block's activations are recomputed in the
  backward (``nn.remat.remat_call``), with the same bits.

``aa_layer`` is None or ``"blur"``, as in the JAX chassis; any other name
raises.
"""

from __future__ import annotations

import inspect
from typing import Optional, Sequence

import torch
from torch import nn

from cotnet_tpu_torch.models.helpers import (build_model_with_cfg,
                                             default_cfg,
                                             register_variant_table)
from cotnet_tpu_torch.nn import (
    BatchNorm2d,
    BlurPool2d,
    ClassifierHead,
    Conv2d,
    DropBlock2d,
    DropPath,
    create_attn,
    get_act_fn,
    get_padding,
    max_pool2d,
)
from cotnet_tpu_torch.nn.remat import remat_call

default_cfgs = {}  # filled beside the variant table below


class Downsample(nn.Sequential):
    """Identity-path projection: strided conv + BN as ``downsample.0/1``
    (reference resnet.py:365-378), the conv 1x1, or ``kernel_size`` at
    dilation ``first_dilation or dilation`` where it strides or the stage
    is dilated; or with ``avg`` the ResNet-D form, a 2x2 avg-pool
    (``ceil_mode=True, count_include_pad=False``; the identity at stride 1
    and dilation 1, stride 1 in a dilated stage) then a 1x1 conv and BN as
    ``downsample.1/2`` (reference resnet.py:380-395; the JAX chassis'
    ``Downsample``, ``cotnet_tpu/models/resnet.py:37-63``)."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 avg: bool = False, kernel_size: int = 1,
                 dilation: int = 1, first_dilation: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        plain = stride == 1 and dilation == 1
        ks = 1 if avg or plain else kernel_size
        fd = (first_dilation or dilation) if ks > 1 else 1
        conv_bn = (Conv2d(in_channels, out_channels, ks, 1 if avg else stride,
                          get_padding(ks, stride, fd), fd, dtype=dtype),
                   BatchNorm2d(out_channels, dtype=dtype))
        if not avg:
            super().__init__(*conv_bn)
            return
        pool = (nn.Identity() if plain else
                nn.AvgPool2d(2, stride if dilation == 1 else 1,
                             ceil_mode=True, count_include_pad=False))
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


class BasicBlock(nn.Module):
    """Two 3x3 convs (reference resnet.py:219-283), the first at dilation
    ``first_dilation or dilation``, the second at ``dilation``.
    ``attn_layer`` (a ``create_attn`` key) follows bn2 as ``se``; with
    ``aa`` a stride-2 block convolves at stride 1 and blurs (``aa``) after
    the first activation; ``drop_block`` ``(rate, block_size,
    gamma_scale)`` follows each BN and ``drop_path_rate`` drops the
    residual branch per sample."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: Optional[nn.Module] = None,
                 cardinality: int = 1, base_width: int = 64,
                 reduce_first: int = 1, dilation: int = 1,
                 first_dilation: Optional[int] = None, act: str = "relu",
                 attn_layer=None, aa: bool = False,
                 drop_block: Optional[tuple] = None,
                 drop_path_rate: float = 0.0,
                 zero_init_last_bn: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if cardinality != 1 or base_width != 64:
            raise ValueError("BasicBlock takes cardinality 1 and base_width "
                             "64 only")
        first_planes = planes // reduce_first
        outplanes = planes * self.expansion
        fd = first_dilation or dilation
        use_aa = aa and stride == 2
        self.act = get_act_fn(act)
        self.conv1 = Conv2d(inplanes, first_planes, 3,
                            1 if use_aa else stride, fd, fd, dtype=dtype)
        self.bn1 = BatchNorm2d(first_planes, dtype=dtype)
        self.aa = BlurPool2d(stride=stride) if use_aa else None
        self.conv2 = Conv2d(first_planes, outplanes, 3, 1, dilation, dilation,
                            dtype=dtype)
        self.bn2 = BatchNorm2d(outplanes, zero_init=zero_init_last_bn,
                               dtype=dtype)
        self.se = create_attn(attn_layer, outplanes, dtype=dtype)
        self.downsample = downsample
        self.drop_block = (nn.Identity() if drop_block is None
                           else DropBlock2d(*drop_block))
        self.drop_path = DropPath(drop_path_rate)

    def forward(self, x):
        y = self.act(self.drop_block(self.bn1(self.conv1(x))))
        if self.aa is not None:
            y = self.aa(y)
        y = self.drop_block(self.bn2(self.conv2(y)))
        if self.se is not None:
            y = self.se(y)
        residual = x if self.downsample is None else self.downsample(x)
        return self.act(self.drop_path(y) + residual)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (grouped by ``cardinality``, at dilation ``first_dilation
    or dilation``) -> 1x1 (reference resnet.py:286-362), width ``planes *
    base_width / 64 * cardinality``;
    ``attn_layer`` (with ``attn_kwargs``) follows bn3 as ``se``; ``aa``,
    ``drop_block`` and ``drop_path_rate`` as in ``BasicBlock``."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: Optional[nn.Module] = None,
                 cardinality: int = 1, base_width: int = 64,
                 reduce_first: int = 1, dilation: int = 1,
                 first_dilation: Optional[int] = None, act: str = "relu",
                 attn_layer=None, attn_kwargs: Optional[dict] = None,
                 aa: bool = False, drop_block: Optional[tuple] = None,
                 drop_path_rate: float = 0.0,
                 zero_init_last_bn: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        width = int(planes * (base_width / 64)) * cardinality
        first_planes = width // reduce_first
        outplanes = planes * self.expansion
        fd = first_dilation or dilation
        use_aa = aa and stride == 2
        self.act = get_act_fn(act)
        self.conv1 = Conv2d(inplanes, first_planes, 1, dtype=dtype)
        self.bn1 = BatchNorm2d(first_planes, dtype=dtype)
        self.conv2 = Conv2d(first_planes, width, 3, 1 if use_aa else stride,
                            fd, fd, groups=cardinality, dtype=dtype)
        self.bn2 = BatchNorm2d(width, dtype=dtype)
        self.aa = BlurPool2d(stride=stride) if use_aa else None
        self.conv3 = Conv2d(width, outplanes, 1, dtype=dtype)
        self.bn3 = BatchNorm2d(outplanes, zero_init=zero_init_last_bn,
                               dtype=dtype)
        self.se = create_attn(attn_layer, outplanes, dtype=dtype,
                              **(attn_kwargs or {}))
        self.downsample = downsample
        self.drop_block = (nn.Identity() if drop_block is None
                           else DropBlock2d(*drop_block))
        self.drop_path = DropPath(drop_path_rate)

    def forward(self, x):
        y = self.act(self.drop_block(self.bn1(self.conv1(x))))
        y = self.act(self.drop_block(self.bn2(self.conv2(y))))
        if self.aa is not None:
            y = self.aa(y)
        y = self.drop_block(self.bn3(self.conv3(y)))
        if self.se is not None:
            y = self.se(y)
        residual = x if self.downsample is None else self.downsample(x)
        return self.act(self.drop_path(y) + residual)


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
    ``replace_stem_pool``, ``avg_down``, ``down_kernel_size``,
    ``block_reduce_first``, ``aa_layer`` (None or ``"blur"``),
    ``output_stride`` (8, 16 or 32), ``features_only`` with
    ``out_indices``, and ``remat`` are the options of the module
    docstring."""

    def __init__(self, block, layers: Sequence[int], num_classes: int = 1000,
                 in_chans: int = 3, cardinality: int = 1,
                 base_width: int = 64, stem_width: int = 64,
                 stem_type: str = "", replace_stem_pool: bool = False,
                 output_stride: int = 32,
                 avg_down: bool = False, down_kernel_size: int = 1,
                 block_reduce_first: int = 1, act: str = "relu",
                 stem_act: Optional[str] = None,
                 aa_layer: Optional[str] = None,
                 global_pool: str = "avg", zero_init_last_bn: bool = True,
                 drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 drop_block_rate: float = 0.0,
                 block_args: Optional[dict] = None,
                 features_only: bool = False,
                 out_indices: Sequence[int] = (1, 2, 3, 4),
                 remat: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        accepted = inspect.signature(block).parameters

        def takes(kwargs):
            return {k: v for k, v in kwargs.items() if k in accepted}

        if output_stride not in (8, 16, 32):
            raise ValueError(f"output_stride {output_stride}: 8, 16 or 32")
        if aa_layer not in (None, "blur"):
            raise NotImplementedError(f"aa_layer {aa_layer!r} is not ported")
        block_args = takes(block_args or {})
        net_num_blocks = sum(layers)
        net_block_idx = 0
        self.stem_act = get_act_fn(stem_act or act)
        self.replace_stem_pool = replace_stem_pool
        self.features_only = features_only
        self.out_indices = tuple(out_indices)
        self.remat = remat

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
        # the stem pool halves the map, or every stage does without it
        net_stride = 2 if replace_stem_pool else 4
        dilation = prev_dilation = 1
        stages = len(layers)
        if features_only:
            # the stages beyond the last index the caller asks for are not
            # built (the JAX chassis stops tracing there)
            stages = min(stages, max(max(self.out_indices), 1))
        self.num_stages = stages
        for stage_idx, (planes, num_blocks, drop_block) in enumerate(
                zip((64, 128, 256, 512)[:stages], layers,
                    drop_block_cfgs(drop_block_rate))):
            stride = 1 if stage_idx == 0 and not replace_stem_pool else 2
            if net_stride >= output_stride:
                dilation *= stride
                stride = 1
            else:
                net_stride *= stride
            outplanes = planes * block.expansion
            blocks = []
            for block_idx in range(num_blocks):
                b_stride = stride if block_idx == 0 else 1
                downsample = None
                if block_idx == 0 and (b_stride != 1 or inplanes != outplanes):
                    downsample = Downsample(inplanes, outplanes, b_stride,
                                            avg=avg_down,
                                            kernel_size=down_kernel_size,
                                            dilation=dilation,
                                            first_dilation=prev_dilation,
                                            dtype=dtype)
                drop_path_rate_b = drop_path_rate * net_block_idx / max(
                    net_num_blocks - 1, 1)
                blocks.append(block(
                    inplanes, planes, stride=b_stride, downsample=downsample,
                    cardinality=cardinality, base_width=base_width, act=act,
                    zero_init_last_bn=zero_init_last_bn, dtype=dtype,
                    **takes(dict(drop_block=drop_block,
                                 drop_path_rate=drop_path_rate_b,
                                 aa=aa_layer is not None,
                                 block_idx=block_idx,
                                 reduce_first=block_reduce_first,
                                 dilation=dilation,
                                 first_dilation=prev_dilation)),
                    **block_args))
                inplanes = outplanes
                prev_dilation = dilation
                net_block_idx += 1
            self.add_module(f"layer{stage_idx + 1}", nn.Sequential(*blocks))
        self.num_features = inplanes
        self.fc = None if features_only else ClassifierHead(
            inplanes, num_classes, global_pool, drop_rate=drop_rate,
            dtype=dtype)

    def _features(self, x):
        """Yields the stem's feature (after its activation, before the
        pool), then each built stage's output."""
        x = self.stem_act(self.bn1(self.conv1(x)))
        yield x
        if self.stem_aa is not None:
            x = self.stem_aa(max_pool2d(x, 3, 1, 1))
        elif not self.replace_stem_pool:
            x = max_pool2d(x, 3, 2, 1)
        remat = self.remat and self.training and torch.is_grad_enabled()
        for i in range(1, self.num_stages + 1):
            for block in getattr(self, f"layer{i}"):
                x = remat_call(block, x) if remat else block(x)
            yield x

    def forward_features(self, x):
        """The stem's feature and each built stage's output, in order."""
        return list(self._features(x))

    def forward(self, x):
        if self.features_only:
            features = self.forward_features(x)
            return [features[i] for i in self.out_indices]
        for x in self._features(x):
            pass  # only the last is kept: an eval frees each as it goes
        return self.fc(x)


def _create_resnet(model_name: str, pretrained: bool = False, **kwargs):
    """Build a row of the table on the chassis (``pretrained`` is accepted
    and ignored: weights load through ``utils.convert``)."""
    return build_model_with_cfg(
        ResNet, model_name, default_cfgs.get(model_name, default_cfg()),
        **_strip(kwargs))


def _strip(kwargs):
    """Drop factory kwargs the chassis doesn't take."""
    kwargs.pop("in_chans_unused", None)
    # pruned channel maps are not shipped by the reference either
    # (models/helpers.py:248-251 reads models/pruned/<variant>.txt, absent
    # from the tree): *_pruned keys build the base architecture
    kwargs.pop("pruned", None)
    return kwargs


# --- variant table (reference models/resnet.py:614-1233) --------------------
# One row per @register_model entrypoint: architecture kwargs on the shared
# chassis.  B/N = BasicBlock/Bottleneck; eca/se rows set block attention.

_B, _N = BasicBlock, Bottleneck
_deep32 = dict(stem_width=32, stem_type="deep", avg_down=True)
_se = dict(block_args=dict(attn_layer="se"))
_eca = dict(block_args=dict(attn_layer="eca"))

RESNET_VARIANTS = {
    # ResNet / ResNet-D (resnet.py:620-737)
    "resnet18": dict(block=_B, layers=(2, 2, 2, 2)),
    "resnet18d": dict(block=_B, layers=(2, 2, 2, 2), **_deep32),
    "resnet34": dict(block=_B, layers=(3, 4, 6, 3)),
    "resnet34d": dict(block=_B, layers=(3, 4, 6, 3), **_deep32),
    "resnet26": dict(block=_N, layers=(2, 2, 2, 2)),
    "resnet26d": dict(block=_N, layers=(2, 2, 2, 2), **_deep32),
    "resnet50": dict(block=_N, layers=(3, 4, 6, 3)),
    "resnet50d": dict(block=_N, layers=(3, 4, 6, 3), **_deep32),
    "resnet66d": dict(block=_B, layers=(3, 4, 23, 3), **_deep32),
    "resnet101": dict(block=_N, layers=(3, 4, 23, 3)),
    "resnet101d": dict(block=_N, layers=(3, 4, 23, 3), **_deep32),
    "resnet152": dict(block=_N, layers=(3, 8, 36, 3)),
    "resnet152d": dict(block=_N, layers=(3, 8, 36, 3), **_deep32),
    "resnet200": dict(block=_N, layers=(3, 24, 36, 3)),
    "resnet200d": dict(block=_N, layers=(3, 24, 36, 3), **_deep32),
    # torchvision-weight aliases (resnet.py:745-773)
    "tv_resnet34": dict(block=_B, layers=(3, 4, 6, 3)),
    "tv_resnet50": dict(block=_N, layers=(3, 4, 6, 3)),
    "tv_resnet101": dict(block=_N, layers=(3, 4, 23, 3)),
    "tv_resnet152": dict(block=_N, layers=(3, 8, 36, 3)),
    # Wide ResNet (resnet.py:777-796)
    "wide_resnet50_2": dict(block=_N, layers=(3, 4, 6, 3), base_width=128),
    "wide_resnet101_2": dict(block=_N, layers=(3, 4, 23, 3), base_width=128),
    # ResNeXt (resnet.py:800-852)
    "resnext26_32x4d": dict(block=_N, layers=(2, 2, 2, 2), cardinality=32,
                            base_width=4),
    "resnext50_32x4d": dict(block=_N, layers=(3, 4, 6, 3), cardinality=32,
                            base_width=4),
    "resnext50d_32x4d": dict(block=_N, layers=(3, 4, 6, 3), cardinality=32,
                             base_width=4, **_deep32),
    "resnext101_32x4d": dict(block=_N, layers=(3, 4, 23, 3), cardinality=32,
                             base_width=4),
    "resnext101_32x8d": dict(block=_N, layers=(3, 4, 23, 3), cardinality=32,
                             base_width=8),
    "resnext101_64x4d": dict(block=_N, layers=(3, 4, 23, 3), cardinality=64,
                             base_width=4),
    "tv_resnext50_32x4d": dict(block=_N, layers=(3, 4, 6, 3), cardinality=32,
                               base_width=4),
    # Instagram WSL ResNeXts (resnet.py:856-896)
    "ig_resnext101_32x8d": dict(block=_N, layers=(3, 4, 23, 3),
                                cardinality=32, base_width=8),
    "ig_resnext101_32x16d": dict(block=_N, layers=(3, 4, 23, 3),
                                 cardinality=32, base_width=16),
    "ig_resnext101_32x32d": dict(block=_N, layers=(3, 4, 23, 3),
                                 cardinality=32, base_width=32),
    "ig_resnext101_32x48d": dict(block=_N, layers=(3, 4, 23, 3),
                                 cardinality=32, base_width=48),
    # SSL / SWSL pretraining aliases (resnet.py:900-1022)
    "ssl_resnet18": dict(block=_B, layers=(2, 2, 2, 2)),
    "ssl_resnet50": dict(block=_N, layers=(3, 4, 6, 3)),
    "ssl_resnext50_32x4d": dict(block=_N, layers=(3, 4, 6, 3),
                                cardinality=32, base_width=4),
    "ssl_resnext101_32x4d": dict(block=_N, layers=(3, 4, 23, 3),
                                 cardinality=32, base_width=4),
    "ssl_resnext101_32x8d": dict(block=_N, layers=(3, 4, 23, 3),
                                 cardinality=32, base_width=8),
    "ssl_resnext101_32x16d": dict(block=_N, layers=(3, 4, 23, 3),
                                  cardinality=32, base_width=16),
    "swsl_resnet18": dict(block=_B, layers=(2, 2, 2, 2)),
    "swsl_resnet50": dict(block=_N, layers=(3, 4, 6, 3)),
    "swsl_resnext50_32x4d": dict(block=_N, layers=(3, 4, 6, 3),
                                 cardinality=32, base_width=4),
    "swsl_resnext101_32x4d": dict(block=_N, layers=(3, 4, 23, 3),
                                  cardinality=32, base_width=4),
    "swsl_resnext101_32x8d": dict(block=_N, layers=(3, 4, 23, 3),
                                  cardinality=32, base_width=8),
    "swsl_resnext101_32x16d": dict(block=_N, layers=(3, 4, 23, 3),
                                   cardinality=32, base_width=16),
    # ECA ResNets (resnet.py:1026-1103)
    "ecaresnet18": dict(block=_B, layers=(2, 2, 2, 2), **_eca),
    "ecaresnet50": dict(block=_N, layers=(3, 4, 6, 3), **_eca),
    "ecaresnet50d": dict(block=_N, layers=(3, 4, 6, 3), **_deep32, **_eca),
    "ecaresnet50d_pruned": dict(block=_N, layers=(3, 4, 6, 3), **_deep32,
                                **_eca),
    "ecaresnetlight": dict(block=_N, layers=(1, 1, 11, 3), stem_width=32,
                           avg_down=True, **_eca),
    "ecaresnet101d": dict(block=_N, layers=(3, 4, 23, 3), **_deep32, **_eca),
    "ecaresnet101d_pruned": dict(block=_N, layers=(3, 4, 23, 3), **_deep32,
                                 **_eca),
    "ecaresnext26tn_32x4d": dict(block=_N, layers=(2, 2, 2, 2),
                                 cardinality=32, base_width=4, stem_width=32,
                                 stem_type="deep_tiered_narrow",
                                 avg_down=True, **_eca),
    # anti-aliased (resnet.py:1107-1119)
    "resnetblur18": dict(block=_B, layers=(2, 2, 2, 2), aa_layer="blur"),
    "resnetblur50": dict(block=_N, layers=(3, 4, 6, 3), aa_layer="blur"),
    # SE ResNets / ResNeXts / SENet (resnet.py:1123-1233)
    "seresnet18": dict(block=_B, layers=(2, 2, 2, 2), **_se),
    "seresnet34": dict(block=_B, layers=(3, 4, 6, 3), **_se),
    "seresnet50": dict(block=_N, layers=(3, 4, 6, 3), **_se),
    "seresnet50tn": dict(block=_N, layers=(3, 4, 6, 3), stem_width=32,
                         stem_type="deep_tiered_narrow", avg_down=True, **_se),
    "seresnet101": dict(block=_N, layers=(3, 4, 23, 3), **_se),
    "seresnet152": dict(block=_N, layers=(3, 8, 36, 3), **_se),
    "seresnext26_32x4d": dict(block=_N, layers=(2, 2, 2, 2), cardinality=32,
                              base_width=4, **_se),
    "seresnext26d_32x4d": dict(block=_N, layers=(2, 2, 2, 2), cardinality=32,
                               base_width=4, **_deep32, **_se),
    "seresnext26t_32x4d": dict(block=_N, layers=(2, 2, 2, 2), cardinality=32,
                               base_width=4, stem_width=32,
                               stem_type="deep_tiered", avg_down=True, **_se),
    "seresnext26tn_32x4d": dict(block=_N, layers=(2, 2, 2, 2), cardinality=32,
                                base_width=4, stem_width=32,
                                stem_type="deep_tiered_narrow", avg_down=True,
                                **_se),
    "seresnext50_32x4d": dict(block=_N, layers=(3, 4, 6, 3), cardinality=32,
                              base_width=4, **_se),
    "seresnext101_32x4d": dict(block=_N, layers=(3, 4, 23, 3), cardinality=32,
                               base_width=4, **_se),
    "seresnext101_32x8d": dict(block=_N, layers=(3, 4, 23, 3), cardinality=32,
                               base_width=8, **_se),
    "senet154": dict(block=_N, layers=(3, 8, 36, 3), cardinality=64,
                     base_width=4, stem_type="deep", down_kernel_size=3,
                     block_reduce_first=2, **_se),
}

# data configs: bilinear for the torchvision/fb-weight lineages, bicubic for
# the timm-trained ones; deep stems expose first_conv=conv1.0
_BILINEAR = {"resnet18", "resnet34", "resnet101", "resnet152", "resnet200",
             "tv_resnet34", "tv_resnet50", "tv_resnet101", "tv_resnet152",
             "tv_resnext50_32x4d", "wide_resnet101_2",
             "resnext101_32x4d", "resnext101_32x8d", "resnext101_64x4d",
             "ecaresnet18", "ecaresnet50",
             "ig_resnext101_32x8d", "ig_resnext101_32x16d",
             "ig_resnext101_32x32d", "ig_resnext101_32x48d",
             "ssl_resnet18", "ssl_resnet50", "ssl_resnext50_32x4d",
             "ssl_resnext101_32x4d", "ssl_resnext101_32x8d",
             "ssl_resnext101_32x16d", "swsl_resnet18", "swsl_resnet50",
             "swsl_resnext50_32x4d", "swsl_resnext101_32x4d",
             "swsl_resnext101_32x8d", "swsl_resnext101_32x16d"}

for _name, _row in RESNET_VARIANTS.items():
    _interp = "bilinear" if _name in _BILINEAR else "bicubic"
    _fc = "conv1.0" if "deep" in str(_row.get("stem_type", "")) else "conv1"
    default_cfgs[_name] = default_cfg(interpolation=_interp, first_conv=_fc)

register_variant_table(__name__, _create_resnet, RESNET_VARIANTS)
