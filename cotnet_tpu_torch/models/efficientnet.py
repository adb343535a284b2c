"""EfficientNet superfamily, counterpart of
``cotnet_tpu/models/efficientnet.py``: EfficientNet B0-B8/L2 (with the TF,
AdvProp and Noisy-Student ports), EdgeTPU (es/em/el), CondConv, Lite,
MixNet S/M/L/XL/XXL, MnasNet A1/B1/small, SE-MnasNet, FBNet-C,
Single-Path-NAS, MobileNetV2 (with 110d/120d/140) and MobileNetV3-Large:
91 registry keys.

A net is decoded from the reference's arch strings
(``ir_r2_k3_s2_e6_c24_se0.25``, reference efficientnet_builder.py:36-152);
the tables, the decoder and the scaling constants are architecture data
and are copied from the JAX module as they are.  Everything is NCHW; a
block's convs are the port's ``Conv2d`` (``"same"`` pads TF-SAME at each
call), ``MixedConv2d`` where the kernel string holds several sizes and
``CondConv2d`` where the block has experts (one ``routing_fn`` vector
feeds its three convs).  The ``tf_*`` rows set eps 1e-3 on every BN and
``pad_type="same"`` on every conv, the stem and the head included.

``bn_momentum`` is torch's (0.1 by default; flax's 0.9).  ``bn_tf``
gives eps 1e-3 and momentum 0.01 (flax's 0.99); an explicit
``bn_momentum`` or ``bn_eps`` passes straight through.

MobileNetV3-Large follows the JAX layout, which is not timm's: the blocks
end at 160 channels, then ``conv_head`` (160 -> 960) with ``bn2``, the
pool, a ``head_hidden`` Linear (960 -> 1280), the activation and the
classifier.  The ``*_pruned`` keys build the unpruned net with a warning:
the reference ships no prune specs.

Parameter names are the reference's: ``conv_stem``, ``bn1``,
``blocks.{stage}.{idx}.{conv_pw,conv_dw,conv_pwl,conv_exp,conv,bn1,bn2,
bn3,se.conv_reduce,se.conv_expand,routing_fn}``, a MixedConv's groups by
bare index (``conv_dw.0``), ``conv_head``, ``bn2``, ``head_hidden``,
``classifier``.
"""

from __future__ import annotations

import logging
import math
import re
from typing import NamedTuple, Optional, Tuple, Union

import torch
from torch import nn

from cotnet_tpu_torch.models.helpers import (IMAGENET_INCEPTION_MEAN,
                                             IMAGENET_INCEPTION_STD,
                                             build_model_with_cfg,
                                             default_cfg,
                                             register_variant_table)
from cotnet_tpu_torch.models.registry import register_model
from cotnet_tpu_torch.nn import (BatchNorm2d, CondConv2d, Conv2d, DropPath,
                                 Dropout, Linear, MixedConv2d, get_act_fn)

_logger = logging.getLogger(__name__)

BN_EPS_TF_DEFAULT = 1e-3          # reference efficientnet_blocks.py:19
BN_MOMENTUM_TF_DEFAULT = 0.01     # torch's; flax/TF momentum 0.99


# ---------------------------------------------------------------------------
# channel / divisor math (reference efficientnet_blocks.py:67-81)
# ---------------------------------------------------------------------------

def make_divisible(v, divisor: int = 8, min_value: Optional[int] = None) -> int:
    min_value = min_value or divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def round_channels(channels, multiplier: float = 1.0, divisor: int = 8,
                   channel_min: Optional[int] = None) -> int:
    if not multiplier:
        return channels
    return make_divisible(channels * multiplier, divisor, channel_min)


# ---------------------------------------------------------------------------
# arch-string decoder (reference efficientnet_builder.py:29-210)
# ---------------------------------------------------------------------------

class BlockArgs(NamedTuple):
    block_type: str
    out_chs: int
    stride: int = 1
    dw_kernel_size: Union[int, Tuple[int, ...]] = 3
    exp_kernel_size: Union[int, Tuple[int, ...]] = 1
    pw_kernel_size: Union[int, Tuple[int, ...]] = 1
    exp_ratio: float = 1.0
    se_ratio: float = 0.0
    act: Optional[str] = None      # None -> model default
    noskip: bool = False
    pw_act: bool = False           # 'dsa' blocks
    num_experts: int = 0           # CondConv
    fake_in_chs: int = 0           # EdgeTPU stem mismatch hack


_ACT_CODES = {"re": "relu", "r6": "relu6", "hs": "hard_swish", "sw": "swish"}


def _parse_ksize(ss: str):
    if ss.isdigit():
        return int(ss)
    return tuple(int(k) for k in ss.split("."))


def _decode_block_str(block_str: str):
    """``ir_r2_k3_s2_e6_c24_se0.25`` -> (BlockArgs, repeats); the option
    letters of efficientnet_builder.py:36-152 (r repeats, k dw-kernel, a
    exp-kernel, p pw-kernel, s stride, e expansion, c channels, se ratio,
    cc experts, fc fake-in-chs, n act, noskip)."""
    ops = block_str.split("_")
    block_type = ops[0]
    options: dict = {}
    noskip = False
    for op in ops[1:]:
        if op == "noskip":
            noskip = True
        elif op.startswith("n") and op[1:] in _ACT_CODES:
            options["n"] = _ACT_CODES[op[1:]]
        else:
            m = re.match(r"([a-z]+)(\d.*)", op)
            if m:
                options[m.group(1)] = m.group(2)

    act = options.get("n")
    num_repeat = int(options["r"])
    common = dict(out_chs=int(options["c"]), stride=int(options["s"]),
                  act=act, noskip=noskip,
                  se_ratio=float(options.get("se", 0.0)))
    if block_type == "ir":
        ba = BlockArgs(
            "ir",
            dw_kernel_size=_parse_ksize(options["k"]),
            exp_kernel_size=_parse_ksize(options.get("a", "1")),
            pw_kernel_size=_parse_ksize(options.get("p", "1")),
            exp_ratio=float(options["e"]),
            num_experts=int(options.get("cc", 0)),
            **common)
    elif block_type in ("ds", "dsa"):
        ba = BlockArgs(
            "ds",
            dw_kernel_size=_parse_ksize(options["k"]),
            pw_kernel_size=_parse_ksize(options.get("p", "1")),
            pw_act=block_type == "dsa",
            **dict(common, noskip=block_type == "dsa" or noskip))
    elif block_type == "er":
        ba = BlockArgs(
            "er",
            exp_kernel_size=_parse_ksize(options["k"]),
            pw_kernel_size=_parse_ksize(options.get("p", "1")),
            exp_ratio=float(options["e"]),
            fake_in_chs=int(options.get("fc", 0)),
            **common)
    elif block_type == "cn":
        ba = BlockArgs(
            "cn", dw_kernel_size=int(options["k"]), **common)
    else:
        raise ValueError(f"unknown block type {block_type!r}")
    return ba, num_repeat


def _scale_stage_depth(stack_args, repeats, depth_multiplier=1.0,
                       depth_trunc="ceil"):
    """Per-stage depth scaling (efficientnet_builder.py:155-190): scale the
    stage total, then allocate in reverse so first blocks scale last."""
    num_repeat = sum(repeats)
    if depth_trunc == "round":
        num_repeat_scaled = max(1, round(num_repeat * depth_multiplier))
    else:
        num_repeat_scaled = int(math.ceil(num_repeat * depth_multiplier))
    repeats_scaled = []
    for r in repeats[::-1]:
        rs = max(1, round(r / num_repeat * num_repeat_scaled))
        repeats_scaled.append(rs)
        num_repeat -= r
        num_repeat_scaled -= rs
    repeats_scaled = repeats_scaled[::-1]
    out = []
    for ba, rep in zip(stack_args, repeats_scaled):
        out.extend([ba] * rep)
    return tuple(out)


def decode_arch_def(arch_def, depth_multiplier=1.0, depth_trunc="ceil",
                    experts_multiplier=1, fix_first_last=False):
    """arch-string table -> tuple of stages, each a tuple of BlockArgs
    (efficientnet_builder.py:193-210)."""
    arch_args = []
    for stack_idx, block_strings in enumerate(arch_def):
        stack_args, repeats = [], []
        for block_str in block_strings:
            ba, rep = _decode_block_str(block_str)
            if ba.num_experts > 0 and experts_multiplier > 1:
                ba = ba._replace(num_experts=ba.num_experts * experts_multiplier)
            stack_args.append(ba)
            repeats.append(rep)
        dm = (1.0 if fix_first_last and stack_idx in (0, len(arch_def) - 1)
              else depth_multiplier)
        arch_args.append(_scale_stage_depth(stack_args, repeats, dm, depth_trunc))
    return tuple(arch_args)


# ---------------------------------------------------------------------------
# blocks (reference efficientnet_blocks.py)
# ---------------------------------------------------------------------------

def _conv(in_chs, out_chs, kernel_size, stride=1, pad_type="",
          depthwise=False, num_experts=0, dtype=torch.float32):
    """create_conv2d dispatch (reference layers/create_conv2d.py:11-31): a
    tuple kernel -> MixedConv2d, experts -> CondConv2d, else Conv2d."""
    if isinstance(kernel_size, tuple):
        return MixedConv2d(in_chs, out_chs, kernel_size, stride,
                           depthwise=depthwise, pad_type=pad_type,
                           dtype=dtype)
    pad = "same" if pad_type == "same" else None
    groups = out_chs if depthwise else 1
    if num_experts > 0:
        return CondConv2d(in_chs, out_chs, kernel_size, stride, pad,
                          groups=groups, num_experts=num_experts,
                          dtype=dtype)
    return Conv2d(in_chs, out_chs, kernel_size, stride, pad, 1, groups,
                  dtype=dtype)


def _call(conv, x, routing):
    """A block's conv; a CondConv takes the block's routing vector."""
    return conv(x, routing) if isinstance(conv, CondConv2d) else conv(x)


class SqueezeExcite(nn.Module):
    """SE of the EfficientNet blocks (efficientnet_blocks.py:105-120): the
    pooled vector through ``conv_reduce`` (1x1 with bias), ``act``,
    ``conv_expand`` and ``gate`` scales the channels.  The JAX package's
    ``SEModule`` computes the same with Dense ``fc1`` / ``fc2``."""

    def __init__(self, channels: int, reduced: int, act: str = "relu",
                 gate: str = "sigmoid", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv_reduce = Conv2d(channels, reduced, 1, bias=True,
                                  dtype=dtype)
        self.conv_expand = Conv2d(reduced, channels, 1, bias=True,
                                  dtype=dtype)
        self.act, self.gate = get_act_fn(act), get_act_fn(gate)

    def forward(self, x):
        s = self.conv_reduce(x.mean((2, 3), keepdim=True))
        return x * self.gate(self.conv_expand(self.act(s)))


class _BlockBase(nn.Module):
    """What the four block kinds share: the BN settings, the SE (sized from
    the block's input channels, or from its mid channels under
    ``se_reduce_mid``) and the residual with its drop path."""

    def __init__(self, ba: BlockArgs, in_chs: int, out_chs: int, stride: int,
                 act: str, pad_type: str = "", se_act: Optional[str] = None,
                 se_reduce_mid: bool = False, se_divisor: int = 1,
                 se_gate: str = "sigmoid", drop_path_rate: float = 0.0,
                 bn_eps: float = 1e-5, bn_momentum: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ba, self.in_chs, self.out_chs = ba, in_chs, out_chs
        self.stride, self.pad_type, self.dtype = stride, pad_type, dtype
        self.act = get_act_fn(act)
        self._act_name = act
        self._se_args = (se_act, se_reduce_mid, se_divisor, se_gate)
        self._bn_args = dict(eps=bn_eps, momentum=bn_momentum, dtype=dtype)
        self.drop_path_rate = drop_path_rate

    def _bn(self, channels):
        return BatchNorm2d(channels, **self._bn_args)

    def _se(self, channels):
        se_act, reduce_mid, divisor, gate = self._se_args
        if not self.ba.se_ratio or self.ba.se_ratio <= 0.0:
            return None
        base = channels if reduce_mid else self.in_chs
        return SqueezeExcite(channels,
                             make_divisible(base * self.ba.se_ratio, divisor),
                             act=se_act or self._act_name, gate=gate,
                             dtype=self.dtype)

    def _residual(self, noskip: bool):
        """A residual where the block keeps its shape and the arch string
        does not say noskip; a drop path on it at a rate above 0."""
        has = (self.stride == 1 and self.in_chs == self.out_chs
               and not noskip)
        self.has_residual = has
        self.drop_path = (DropPath(self.drop_path_rate)
                          if has and self.drop_path_rate > 0 else None)

    def _skip(self, y, shortcut):
        if not self.has_residual:
            return y
        if self.drop_path is not None:
            y = self.drop_path(y)
        return y + shortcut


class ConvBnActBlock(_BlockBase):
    """'cn' (efficientnet_blocks.py:123-144): ``conv``, ``bn1``, act."""

    def __init__(self, ba, in_chs, out_chs, stride, act, **kw):
        super().__init__(ba, in_chs, out_chs, stride, act, **kw)
        self.conv = _conv(in_chs, out_chs, ba.dw_kernel_size, stride,
                          self.pad_type, dtype=self.dtype)
        self.bn1 = self._bn(out_chs)
        self.has_residual = False

    def forward(self, x):
        return self.act(self.bn1(self.conv(x)))


class DepthwiseSeparable(_BlockBase):
    """'ds'/'dsa' (efficientnet_blocks.py:147-204): ``conv_dw``, ``bn1``,
    ``se``, ``conv_pw``, ``bn2`` (act after it for 'dsa')."""

    def __init__(self, ba, in_chs, out_chs, stride, act, **kw):
        super().__init__(ba, in_chs, out_chs, stride, act, **kw)
        self.conv_dw = _conv(in_chs, in_chs, ba.dw_kernel_size, stride,
                             self.pad_type, depthwise=True, dtype=self.dtype)
        self.bn1 = self._bn(in_chs)
        self.se = self._se(in_chs)
        self.conv_pw = _conv(in_chs, out_chs, ba.pw_kernel_size, 1,
                             self.pad_type, dtype=self.dtype)
        self.bn2 = self._bn(out_chs)
        self._residual(ba.noskip)

    def forward(self, x):
        y = self.act(self.bn1(self.conv_dw(x)))
        if self.se is not None:
            y = self.se(y)
        y = self.bn2(self.conv_pw(y))
        if self.ba.pw_act:
            y = self.act(y)
        return self._skip(y, x)


class InvertedResidual(_BlockBase):
    """'ir' (efficientnet_blocks.py:207-332): ``conv_pw``, ``bn1``,
    ``conv_dw``, ``bn2``, ``se``, ``conv_pwl``, ``bn3``; with experts a
    ``routing_fn`` Linear on the pooled input, whose sigmoid feeds the
    three CondConvs (CondConvResidual, efficientnet_blocks.py:301-326)."""

    def __init__(self, ba, in_chs, out_chs, stride, act, **kw):
        super().__init__(ba, in_chs, out_chs, stride, act, **kw)
        mid = make_divisible(in_chs * ba.exp_ratio)
        e, pad, dt = ba.num_experts, self.pad_type, self.dtype
        self.routing_fn = Linear(in_chs, e, dtype=dt) if e > 0 else None
        self.conv_pw = _conv(in_chs, mid, ba.exp_kernel_size, 1, pad,
                             num_experts=e, dtype=dt)
        self.bn1 = self._bn(mid)
        self.conv_dw = _conv(mid, mid, ba.dw_kernel_size, stride, pad,
                             depthwise=True, num_experts=e, dtype=dt)
        self.bn2 = self._bn(mid)
        self.se = self._se(mid)
        self.conv_pwl = _conv(mid, out_chs, ba.pw_kernel_size, 1, pad,
                              num_experts=e, dtype=dt)
        self.bn3 = self._bn(out_chs)
        self._residual(ba.noskip)

    def forward(self, x):
        routing = None
        if self.routing_fn is not None:
            routing = torch.sigmoid(self.routing_fn(x.mean((2, 3))))
        y = self.act(self.bn1(_call(self.conv_pw, x, routing)))
        y = self.act(self.bn2(_call(self.conv_dw, y, routing)))
        if self.se is not None:
            y = self.se(y)
        y = self.bn3(_call(self.conv_pwl, y, routing))
        return self._skip(y, x)


class EdgeResidual(_BlockBase):
    """'er' (efficientnet_blocks.py:335-397): a full k x k ``conv_exp``,
    ``bn1``, ``se``, then the stride on ``conv_pwl``, ``bn2``.  The mid
    channels come from ``fake_in_chs`` where the arch string sets one
    (EdgeTPU's ``fc24``)."""

    def __init__(self, ba, in_chs, out_chs, stride, act, fake_in_chs=0,
                 **kw):
        super().__init__(ba, in_chs, out_chs, stride, act, **kw)
        mid = make_divisible((fake_in_chs or in_chs) * ba.exp_ratio)
        self.conv_exp = _conv(in_chs, mid, ba.exp_kernel_size, 1,
                              self.pad_type, dtype=self.dtype)
        self.bn1 = self._bn(mid)
        self.se = self._se(mid)
        self.conv_pwl = _conv(mid, out_chs, ba.pw_kernel_size, stride,
                              self.pad_type, dtype=self.dtype)
        self.bn2 = self._bn(out_chs)
        self._residual(ba.noskip)

    def forward(self, x):
        y = self.act(self.bn1(self.conv_exp(x)))
        if self.se is not None:
            y = self.se(y)
        y = self.bn2(self.conv_pwl(y))
        return self._skip(y, x)


_BLOCK_CLS = {"ir": InvertedResidual, "ds": DepthwiseSeparable,
              "er": EdgeResidual, "cn": ConvBnActBlock}


# ---------------------------------------------------------------------------
# model (reference efficientnet.py:316-395)
# ---------------------------------------------------------------------------

class EfficientNet(nn.Module):
    """``cotnet_tpu/models/efficientnet.py:367-450``: ``conv_stem`` (3x3
    stride 2), ``bn1``, act, the decoded stages as ``blocks.{s}.{i}`` (only
    a stage's first block strides; the drop-path rate grows as
    ``drop_path_rate * idx / total_blocks``), ``conv_head`` (1x1), ``bn2``,
    act, the spatial mean, ``head_hidden`` and act where set, dropout in
    training, ``classifier`` (none at ``num_classes=0``: the pooled
    features).  ``forward_features`` returns the stem's map where the
    first stage strides, then the output of each stage that the next
    stage strides away from, and the last; ``features_only`` returns them
    and builds no head."""

    def __init__(self, block_args, num_classes: int = 1000,
                 num_features: int = 1280, stem_size: int = 32,
                 in_chans: int = 3, channel_multiplier: float = 1.0,
                 channel_divisor: int = 8,
                 channel_min: Optional[int] = None, fix_stem: bool = False,
                 pad_type: str = "", act: str = "relu",
                 drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 se_act: Optional[str] = None, se_reduce_mid: bool = False,
                 se_divisor: int = 1, se_gate: str = "sigmoid",
                 head_hidden: int = 0, bn_eps: float = 1e-5,
                 bn_momentum: float = 0.1, features_only: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.block_args = block_args
        self.features_only = features_only
        self.act = get_act_fn(act)

        def rnd(chs):
            return round_channels(chs, channel_multiplier, channel_divisor,
                                  channel_min)

        bn = dict(eps=bn_eps, momentum=bn_momentum, dtype=dtype)
        pad = "same" if pad_type == "same" else None
        stem = stem_size if fix_stem else rnd(stem_size)
        self.conv_stem = Conv2d(in_chans, stem, 3, 2, pad, dtype=dtype)
        self.bn1 = BatchNorm2d(stem, **bn)

        total = sum(len(s) for s in block_args)
        chs, idx, stages = stem, 0, []
        for stack in block_args:
            blocks = []
            for bi, ba in enumerate(stack):
                kw = dict(pad_type=pad_type, se_act=se_act,
                          se_reduce_mid=se_reduce_mid, se_divisor=se_divisor,
                          se_gate=se_gate,
                          drop_path_rate=drop_path_rate * idx / total,
                          bn_eps=bn_eps, bn_momentum=bn_momentum,
                          dtype=dtype)
                if ba.block_type == "er" and ba.fake_in_chs:
                    kw["fake_in_chs"] = rnd(ba.fake_in_chs)
                out = rnd(ba.out_chs)
                blocks.append(_BLOCK_CLS[ba.block_type](
                    ba, chs, out, ba.stride if bi == 0 else 1,
                    ba.act or act, **kw))
                chs = out
                idx += 1
            stages.append(nn.Sequential(*blocks))
        self.blocks = nn.Sequential(*stages)

        self.conv_head = self.bn2 = self.head_hidden = None
        self.dropout = self.classifier = None
        if not features_only:
            self.conv_head = Conv2d(chs, num_features, 1, 1, pad,
                                    dtype=dtype)
            self.bn2 = BatchNorm2d(num_features, **bn)
            width = num_features
            if head_hidden:
                self.head_hidden = Linear(num_features, head_hidden,
                                          dtype=dtype)
                width = head_hidden
            self.dropout = Dropout(drop_rate)
            if num_classes > 0:
                self.classifier = Linear(width, num_classes, dtype=dtype)

    def forward_features(self, x):
        x = self.act(self.bn1(self.conv_stem(x)))
        feats = [x] if self.block_args[0][0].stride > 1 else []
        n = len(self.blocks)
        for si, stage in enumerate(self.blocks):
            x = stage(x)
            if si + 1 == n or self.block_args[si + 1][0].stride > 1:
                feats.append(x)
        return feats

    def forward(self, x):
        if self.features_only:
            return self.forward_features(x)
        x = self.act(self.bn1(self.conv_stem(x)))
        x = self.blocks(x)
        x = self.act(self.bn2(self.conv_head(x))).mean((2, 3))
        if self.head_hidden is not None:
            x = self.act(self.head_hidden(x))
        x = self.dropout(x)
        return x if self.classifier is None else self.classifier(x)


# ---------------------------------------------------------------------------
# generators (reference efficientnet.py:472-876); arch strings are data
# ---------------------------------------------------------------------------

def _resolve_bn_args(kwargs):
    """The bn_tf / bn_momentum / bn_eps knobs (efficientnet_blocks.py:
    27-35), in torch's momentum convention, which is the port's
    ``BatchNorm2d``'s: passed through as they are."""
    out = {}
    if kwargs.pop("bn_tf", False):
        out = {"bn_eps": BN_EPS_TF_DEFAULT,
               "bn_momentum": BN_MOMENTUM_TF_DEFAULT}
    m = kwargs.pop("bn_momentum", None)
    if m is not None:
        out["bn_momentum"] = m
    e = kwargs.pop("bn_eps", None)
    if e is not None:
        out["bn_eps"] = e
    return out


def _build(variant, pretrained, pruned=False, **model_kwargs):
    model_kwargs.update(_resolve_bn_args(model_kwargs))
    if pruned:
        _logger.warning(
            "%s: reference prune spec models/pruned/%s.txt is not shipped by "
            "the upstream repo; building the unpruned architecture "
            "(reference helpers.py:248-251 would raise FileNotFoundError)",
            variant, variant)
    return build_model_with_cfg(EfficientNet, variant, default_cfgs[variant],
                                pretrained=pretrained, **model_kwargs)


_EFFNET_ARCH = (
    ("ds_r1_k3_s1_e1_c16_se0.25",),
    ("ir_r2_k3_s2_e6_c24_se0.25",),
    ("ir_r2_k5_s2_e6_c40_se0.25",),
    ("ir_r3_k3_s2_e6_c80_se0.25",),
    ("ir_r3_k5_s1_e6_c112_se0.25",),
    ("ir_r4_k5_s2_e6_c192_se0.25",),
    ("ir_r1_k3_s1_e6_c320_se0.25",),
)


def _gen_efficientnet(variant, pretrained=False, channel_multiplier=1.0,
                      depth_multiplier=1.0, **kwargs):
    """reference efficientnet.py:667-710."""
    kwargs.setdefault("act", "swish")
    return _build(
        variant, pretrained,
        block_args=decode_arch_def(_EFFNET_ARCH, depth_multiplier),
        num_features=round_channels(1280, channel_multiplier, 8, None),
        stem_size=32, channel_multiplier=channel_multiplier, **kwargs)


def _gen_efficientnet_edge(variant, pretrained=False, channel_multiplier=1.0,
                           depth_multiplier=1.0, **kwargs):
    """reference efficientnet.py:713-739."""
    arch = (
        ("er_r1_k3_s1_e4_c24_fc24_noskip",),
        ("er_r2_k3_s2_e8_c32",),
        ("er_r4_k3_s2_e8_c48",),
        ("ir_r5_k5_s2_e8_c96",),
        ("ir_r4_k5_s1_e8_c144",),
        ("ir_r2_k5_s2_e8_c192",),
    )
    kwargs.setdefault("act", "relu")
    return _build(
        variant, pretrained,
        block_args=decode_arch_def(arch, depth_multiplier),
        num_features=round_channels(1280, channel_multiplier, 8, None),
        stem_size=32, channel_multiplier=channel_multiplier, **kwargs)


_CONDCONV_ARCH = (
    ("ds_r1_k3_s1_e1_c16_se0.25",),
    ("ir_r2_k3_s2_e6_c24_se0.25",),
    ("ir_r2_k5_s2_e6_c40_se0.25",),
    ("ir_r3_k3_s2_e6_c80_se0.25",),
    ("ir_r3_k5_s1_e6_c112_se0.25_cc4",),
    ("ir_r4_k5_s2_e6_c192_se0.25_cc4",),
    ("ir_r1_k3_s1_e6_c320_se0.25_cc4",),
)


def _gen_efficientnet_condconv(variant, pretrained=False,
                               channel_multiplier=1.0, depth_multiplier=1.0,
                               experts_multiplier=1, **kwargs):
    """reference efficientnet.py:742-769."""
    kwargs.setdefault("act", "swish")
    return _build(
        variant, pretrained,
        block_args=decode_arch_def(_CONDCONV_ARCH, depth_multiplier,
                                   experts_multiplier=experts_multiplier),
        num_features=round_channels(1280, channel_multiplier, 8, None),
        stem_size=32, channel_multiplier=channel_multiplier, **kwargs)


_LITE_ARCH = (
    ("ds_r1_k3_s1_e1_c16",),
    ("ir_r2_k3_s2_e6_c24",),
    ("ir_r2_k5_s2_e6_c40",),
    ("ir_r3_k3_s2_e6_c80",),
    ("ir_r3_k5_s1_e6_c112",),
    ("ir_r4_k5_s2_e6_c192",),
    ("ir_r1_k3_s1_e6_c320",),
)


def _gen_efficientnet_lite(variant, pretrained=False, channel_multiplier=1.0,
                           depth_multiplier=1.0, **kwargs):
    """reference efficientnet.py:772-810 — no SE, relu6, fixed stem/head."""
    kwargs.setdefault("act", "relu6")
    return _build(
        variant, pretrained,
        block_args=decode_arch_def(_LITE_ARCH, depth_multiplier,
                                   fix_first_last=True),
        num_features=1280, stem_size=32, fix_stem=True,
        channel_multiplier=channel_multiplier, **kwargs)


_MNASNET_A1_ARCH = (
    ("ds_r1_k3_s1_e1_c16_noskip",),
    ("ir_r2_k3_s2_e6_c24",),
    ("ir_r3_k5_s2_e3_c40_se0.25",),
    ("ir_r4_k3_s2_e6_c80",),
    ("ir_r2_k3_s1_e6_c112_se0.25",),
    ("ir_r3_k5_s2_e6_c160_se0.25",),
    ("ir_r1_k3_s1_e6_c320",),
)


def _gen_mnasnet_a1(variant, pretrained=False, channel_multiplier=1.0,
                    **kwargs):
    """reference efficientnet.py:472-505."""
    return _build(variant, pretrained,
                  block_args=decode_arch_def(_MNASNET_A1_ARCH), stem_size=32,
                  channel_multiplier=channel_multiplier, **kwargs)


_MNASNET_B1_ARCH = (
    ("ds_r1_k3_s1_c16_noskip",),
    ("ir_r3_k3_s2_e3_c24",),
    ("ir_r3_k5_s2_e3_c40",),
    ("ir_r3_k5_s2_e6_c80",),
    ("ir_r2_k3_s1_e6_c96",),
    ("ir_r4_k5_s2_e6_c192",),
    ("ir_r1_k3_s1_e6_c320_noskip",),
)


def _gen_mnasnet_b1(variant, pretrained=False, channel_multiplier=1.0,
                    **kwargs):
    """reference efficientnet.py:508-541."""
    return _build(variant, pretrained,
                  block_args=decode_arch_def(_MNASNET_B1_ARCH), stem_size=32,
                  channel_multiplier=channel_multiplier, **kwargs)


_MNASNET_SMALL_ARCH = (
    ("ds_r1_k3_s1_c8",),
    ("ir_r1_k3_s2_e3_c16",),
    ("ir_r2_k3_s2_e6_c16",),
    ("ir_r4_k5_s2_e6_c32_se0.25",),
    ("ir_r3_k3_s1_e6_c32_se0.25",),
    ("ir_r3_k5_s2_e6_c88_se0.25",),
    ("ir_r1_k3_s1_e6_c144",),
)


def _gen_mnasnet_small(variant, pretrained=False, channel_multiplier=1.0,
                       **kwargs):
    """reference efficientnet.py:544-570."""
    return _build(variant, pretrained,
                  block_args=decode_arch_def(_MNASNET_SMALL_ARCH),
                  stem_size=8, channel_multiplier=channel_multiplier,
                  **kwargs)


_MOBILENETV2_ARCH = (
    ("ds_r1_k3_s1_c16",),
    ("ir_r2_k3_s2_e6_c24",),
    ("ir_r3_k3_s2_e6_c32",),
    ("ir_r4_k3_s2_e6_c64",),
    ("ir_r3_k3_s1_e6_c96",),
    ("ir_r3_k3_s2_e6_c160",),
    ("ir_r1_k3_s1_e6_c320",),
)


def _gen_mobilenet_v2(variant, pretrained=False, channel_multiplier=1.0,
                      depth_multiplier=1.0, fix_stem_head=False, **kwargs):
    """reference efficientnet.py:573-599."""
    kwargs.setdefault("act", "relu6")
    return _build(
        variant, pretrained,
        block_args=decode_arch_def(_MOBILENETV2_ARCH, depth_multiplier,
                                   fix_first_last=fix_stem_head),
        num_features=(1280 if fix_stem_head
                      else round_channels(1280, channel_multiplier, 8, None)),
        stem_size=32, fix_stem=fix_stem_head,
        channel_multiplier=channel_multiplier, **kwargs)


_FBNETC_ARCH = (
    ("ir_r1_k3_s1_e1_c16",),
    ("ir_r1_k3_s2_e6_c24", "ir_r2_k3_s1_e1_c24"),
    ("ir_r1_k5_s2_e6_c32", "ir_r1_k5_s1_e3_c32", "ir_r1_k5_s1_e6_c32",
     "ir_r1_k3_s1_e6_c32"),
    ("ir_r1_k5_s2_e6_c64", "ir_r1_k5_s1_e3_c64", "ir_r2_k5_s1_e6_c64"),
    ("ir_r3_k5_s1_e6_c112", "ir_r1_k5_s1_e3_c112"),
    ("ir_r4_k5_s2_e6_c184",),
    ("ir_r1_k3_s1_e6_c352",),
)


def _gen_fbnetc(variant, pretrained=False, channel_multiplier=1.0, **kwargs):
    """reference efficientnet.py:602-629."""
    return _build(variant, pretrained,
                  block_args=decode_arch_def(_FBNETC_ARCH), stem_size=16,
                  num_features=1984,
                  channel_multiplier=channel_multiplier, **kwargs)


_SPNASNET_ARCH = (
    ("ds_r1_k3_s1_c16_noskip",),
    ("ir_r3_k3_s2_e3_c24",),
    ("ir_r1_k5_s2_e6_c40", "ir_r3_k3_s1_e3_c40"),
    ("ir_r1_k5_s2_e6_c80", "ir_r3_k3_s1_e3_c80"),
    ("ir_r1_k5_s1_e6_c96", "ir_r3_k5_s1_e3_c96"),
    ("ir_r4_k5_s2_e6_c192",),
    ("ir_r1_k3_s1_e6_c320_noskip",),
)


def _gen_spnasnet(variant, pretrained=False, channel_multiplier=1.0, **kwargs):
    """reference efficientnet.py:632-664."""
    return _build(variant, pretrained,
                  block_args=decode_arch_def(_SPNASNET_ARCH), stem_size=32,
                  channel_multiplier=channel_multiplier, **kwargs)


_MIXNET_S_ARCH = (
    ("ds_r1_k3_s1_e1_c16",),
    ("ir_r1_k3_a1.1_p1.1_s2_e6_c24", "ir_r1_k3_a1.1_p1.1_s1_e3_c24"),
    ("ir_r1_k3.5.7_s2_e6_c40_se0.5_nsw",
     "ir_r3_k3.5_a1.1_p1.1_s1_e6_c40_se0.5_nsw"),
    ("ir_r1_k3.5.7_p1.1_s2_e6_c80_se0.25_nsw",
     "ir_r2_k3.5_p1.1_s1_e6_c80_se0.25_nsw"),
    ("ir_r1_k3.5.7_a1.1_p1.1_s1_e6_c120_se0.5_nsw",
     "ir_r2_k3.5.7.9_a1.1_p1.1_s1_e3_c120_se0.5_nsw"),
    ("ir_r1_k3.5.7.9.11_s2_e6_c200_se0.5_nsw",
     "ir_r2_k3.5.7.9_p1.1_s1_e6_c200_se0.5_nsw"),
)


def _gen_mixnet_s(variant, pretrained=False, channel_multiplier=1.0,
                  **kwargs):
    """reference efficientnet.py:813-843."""
    return _build(variant, pretrained,
                  block_args=decode_arch_def(_MIXNET_S_ARCH),
                  num_features=1536, stem_size=16,
                  channel_multiplier=channel_multiplier, **kwargs)


_MIXNET_M_ARCH = (
    ("ds_r1_k3_s1_e1_c24",),
    ("ir_r1_k3.5.7_a1.1_p1.1_s2_e6_c32", "ir_r1_k3_a1.1_p1.1_s1_e3_c32"),
    ("ir_r1_k3.5.7.9_s2_e6_c40_se0.5_nsw",
     "ir_r3_k3.5_a1.1_p1.1_s1_e6_c40_se0.5_nsw"),
    ("ir_r1_k3.5.7_s2_e6_c80_se0.25_nsw",
     "ir_r3_k3.5.7.9_a1.1_p1.1_s1_e6_c80_se0.25_nsw"),
    ("ir_r1_k3_s1_e6_c120_se0.5_nsw",
     "ir_r3_k3.5.7.9_a1.1_p1.1_s1_e3_c120_se0.5_nsw"),
    ("ir_r1_k3.5.7.9_s2_e6_c200_se0.5_nsw",
     "ir_r3_k3.5.7.9_p1.1_s1_e6_c200_se0.5_nsw"),
)


def _gen_mixnet_m(variant, pretrained=False, channel_multiplier=1.0,
                  depth_multiplier=1.0, **kwargs):
    """reference efficientnet.py:846-876."""
    return _build(variant, pretrained,
                  block_args=decode_arch_def(_MIXNET_M_ARCH, depth_multiplier,
                                             depth_trunc="round"),
                  num_features=1536, stem_size=24,
                  channel_multiplier=channel_multiplier, **kwargs)


_MOBILENETV3_ARCH = (
    ("ds_r1_k3_s1_c16_nre",),
    ("ir_r1_k3_s2_e4_c24_nre", "ir_r1_k3_s1_e3_c24_nre"),
    ("ir_r1_k5_s2_e3_c40_se0.25_nre", "ir_r2_k5_s1_e3_c40_se0.25_nre"),
    ("ir_r1_k3_s2_e6_c80", "ir_r1_k3_s1_e2.5_c80", "ir_r2_k3_s1_e2.3_c80"),
    ("ir_r2_k3_s1_e6_c112_se0.25",),
    ("ir_r1_k5_s2_e6_c160_se0.25", "ir_r2_k5_s1_e6_c160_se0.25"),
)


def _gen_mobilenet_v3_large(variant, pretrained=False, channel_multiplier=1.0,
                            **kwargs):
    """MobileNetV3-Large in the JAX package's layout (not a reference
    registry key)."""
    kwargs.setdefault("act", "hard_swish")
    return _build(variant, pretrained,
                  block_args=decode_arch_def(_MOBILENETV3_ARCH),
                  num_features=960, head_hidden=1280, stem_size=16,
                  fix_stem=True, se_act="relu", se_reduce_mid=True,
                  se_divisor=8, se_gate="hard_sigmoid",
                  channel_multiplier=channel_multiplier, **kwargs)


# ---------------------------------------------------------------------------
# default_cfgs (reference efficientnet.py:44-311) — pure data
# ---------------------------------------------------------------------------

def _cfg(size=224, crop=0.875, pool=7, **kw):
    return default_cfg(input_size=(3, size, size), crop_pct=crop,
                       pool_size=(pool, pool), first_conv="conv_stem",
                       classifier="classifier", **kw)


_INCEPTION = dict(mean=IMAGENET_INCEPTION_MEAN, std=IMAGENET_INCEPTION_STD)

# (size, crop_pct, pool) per EfficientNet b-index; l2 and l2_475 keyed by str
_BSIZE = {0: (224, 0.875, 7), 1: (240, 0.882, 8), 2: (260, 0.890, 9),
          3: (300, 0.904, 10), 4: (380, 0.922, 12), 5: (456, 0.934, 15),
          6: (528, 0.942, 17), 7: (600, 0.949, 19), 8: (672, 0.954, 21),
          "l2": (800, 0.961, 25), "l2_475": (475, 0.936, 15)}
# (channel_multiplier, depth_multiplier) per b-index
_BSCALE = {0: (1.0, 1.0), 1: (1.0, 1.1), 2: (1.1, 1.2), 3: (1.2, 1.4),
           4: (1.4, 1.8), 5: (1.6, 2.2), 6: (1.8, 2.6), 7: (2.0, 3.1),
           8: (2.2, 3.6), "l2": (4.3, 5.3)}
_BDROP = {0: 0.2, 1: 0.2, 2: 0.3, 3: 0.3, 4: 0.4, 5: 0.4, 6: 0.5, 7: 0.5,
          8: 0.5, "l2": 0.5}

default_cfgs = {
    "mnasnet_050": _cfg(), "mnasnet_075": _cfg(), "mnasnet_100": _cfg(),
    "mnasnet_140": _cfg(), "semnasnet_050": _cfg(), "semnasnet_075": _cfg(),
    "semnasnet_100": _cfg(), "semnasnet_140": _cfg(), "mnasnet_small": _cfg(),
    "mobilenetv2_100": _cfg(), "mobilenetv2_110d": _cfg(),
    "mobilenetv2_120d": _cfg(), "mobilenetv2_140": _cfg(),
    "mobilenetv3_large_100": _cfg(),
    "fbnetc_100": _cfg(interpolation="bilinear"),
    "spnasnet_100": _cfg(interpolation="bilinear"),
    "efficientnet_b2a": _cfg(288, 1.0, 9),
    "efficientnet_b3a": _cfg(320, 1.0, 10),
    "efficientnet_es": _cfg(), "efficientnet_em": _cfg(240, 0.882, 8),
    "efficientnet_el": _cfg(300, 0.904, 10),
    "efficientnet_cc_b0_4e": _cfg(), "efficientnet_cc_b0_8e": _cfg(),
    "efficientnet_cc_b1_8e": _cfg(240, 0.882, 8),
    "tf_efficientnet_es": _cfg(**_INCEPTION),
    "tf_efficientnet_em": _cfg(240, 0.882, 8, **_INCEPTION),
    "tf_efficientnet_el": _cfg(300, 0.904, 10, **_INCEPTION),
    "tf_efficientnet_cc_b0_4e": _cfg(**_INCEPTION),
    "tf_efficientnet_cc_b0_8e": _cfg(**_INCEPTION),
    "tf_efficientnet_cc_b1_8e": _cfg(240, 0.882, 8, **_INCEPTION),
    "mixnet_s": _cfg(), "mixnet_m": _cfg(), "mixnet_l": _cfg(),
    "mixnet_xl": _cfg(), "mixnet_xxl": _cfg(),
    "tf_mixnet_s": _cfg(), "tf_mixnet_m": _cfg(), "tf_mixnet_l": _cfg(),
    "tf_efficientnet_lite3": _cfg(300, 0.904, 10, interpolation="bilinear",
                                  **_INCEPTION),
    "tf_efficientnet_lite4": _cfg(380, 0.920, 12, interpolation="bilinear",
                                  **_INCEPTION),
}
for _i in range(9):
    _s = _BSIZE[_i]
    default_cfgs[f"efficientnet_b{_i}"] = _cfg(*_s)
    default_cfgs[f"tf_efficientnet_b{_i}"] = _cfg(*_s)
    default_cfgs[f"tf_efficientnet_b{_i}_ap"] = _cfg(*_s, **_INCEPTION)
    if _i <= 7:
        default_cfgs[f"tf_efficientnet_b{_i}_ns"] = _cfg(*_s)
    if 1 <= _i <= 3:
        default_cfgs[f"efficientnet_b{_i}_pruned"] = _cfg(*_s, **_INCEPTION)
default_cfgs["efficientnet_l2"] = _cfg(*_BSIZE["l2"])
default_cfgs["tf_efficientnet_l2_ns"] = _cfg(800, 0.96, 25)
default_cfgs["tf_efficientnet_l2_ns_475"] = _cfg(*_BSIZE["l2_475"])
for _i in range(5):
    _s = _BSIZE[_i]
    default_cfgs[f"efficientnet_lite{_i}"] = _cfg(*_s)
    if _i <= 2:
        default_cfgs[f"tf_efficientnet_lite{_i}"] = _cfg(*_s, **_INCEPTION)


# ---------------------------------------------------------------------------
# entrypoints (reference efficientnet.py:879-1727) — one table row each
# ---------------------------------------------------------------------------

_GEN_FNS = {
    "effnet": _gen_efficientnet, "edge": _gen_efficientnet_edge,
    "condconv": _gen_efficientnet_condconv, "lite": _gen_efficientnet_lite,
    "mnasnet_a1": _gen_mnasnet_a1, "mnasnet_b1": _gen_mnasnet_b1,
    "mnasnet_small": _gen_mnasnet_small, "mobilenetv2": _gen_mobilenet_v2,
    "fbnetc": _gen_fbnetc, "spnasnet": _gen_spnasnet,
    "mixnet_s": _gen_mixnet_s, "mixnet_m": _gen_mixnet_m,
    "mobilenetv3": _gen_mobilenet_v3_large,
}

_TF = dict(bn_eps=BN_EPS_TF_DEFAULT, pad_type="same")


def _effnet_entry(name, pretrained=False, gen="effnet", **kwargs):
    return _GEN_FNS[gen](name, pretrained=pretrained, **kwargs)


def _b(i, **extra):
    cm, dm = _BSCALE[i]
    return dict(gen="effnet", channel_multiplier=cm, depth_multiplier=dm,
                drop_rate=_BDROP[i], **extra)


def _edge(cm, dm, **extra):
    return dict(gen="edge", channel_multiplier=cm, depth_multiplier=dm,
                **extra)


def _cc(dm, em=1, **extra):
    return dict(gen="condconv", channel_multiplier=1.0, depth_multiplier=dm,
                experts_multiplier=em, **extra)


def _lite(cm, dm, **extra):
    return dict(gen="lite", channel_multiplier=cm, depth_multiplier=dm,
                **extra)


EFFICIENTNET_VARIANTS = {
    # MNASNet family (reference efficientnet.py:879-955)
    "mnasnet_050": dict(gen="mnasnet_b1", channel_multiplier=0.5),
    "mnasnet_075": dict(gen="mnasnet_b1", channel_multiplier=0.75),
    "mnasnet_100": dict(gen="mnasnet_b1", channel_multiplier=1.0),
    "mnasnet_140": dict(gen="mnasnet_b1", channel_multiplier=1.4),
    "semnasnet_050": dict(gen="mnasnet_a1", channel_multiplier=0.5),
    "semnasnet_075": dict(gen="mnasnet_a1", channel_multiplier=0.75),
    "semnasnet_100": dict(gen="mnasnet_a1", channel_multiplier=1.0),
    "semnasnet_140": dict(gen="mnasnet_a1", channel_multiplier=1.4),
    "mnasnet_small": dict(gen="mnasnet_small", channel_multiplier=1.0),
    # MobileNetV2 (reference efficientnet.py:958-995)
    "mobilenetv2_100": dict(gen="mobilenetv2", channel_multiplier=1.0),
    "mobilenetv2_140": dict(gen="mobilenetv2", channel_multiplier=1.4),
    "mobilenetv2_110d": dict(gen="mobilenetv2", channel_multiplier=1.1,
                             depth_multiplier=1.2, fix_stem_head=True),
    "mobilenetv2_120d": dict(gen="mobilenetv2", channel_multiplier=1.2,
                             depth_multiplier=1.4, fix_stem_head=True),
    "mobilenetv3_large_100": dict(gen="mobilenetv3", channel_multiplier=1.0),
    # FBNet / SPNAS (reference efficientnet.py:998-1017)
    "fbnetc_100": dict(gen="fbnetc", channel_multiplier=1.0),
    "spnasnet_100": dict(gen="spnasnet", channel_multiplier=1.0),
    # EfficientNet core + a-variants + L2 (reference :1020-1180)
    **{f"efficientnet_b{i}": _b(i) for i in range(9)},
    "efficientnet_b2a": _b(2), "efficientnet_b3a": _b(3),
    "efficientnet_l2": _b("l2"),
    # EdgeTPU (reference :1183-1205)
    "efficientnet_es": _edge(1.0, 1.0),
    "efficientnet_em": _edge(1.0, 1.1),
    "efficientnet_el": _edge(1.2, 1.4),
    # CondConv (reference :1208-1237)
    "efficientnet_cc_b0_4e": _cc(1.0),
    "efficientnet_cc_b0_8e": _cc(1.0, 2),
    "efficientnet_cc_b1_8e": _cc(1.1, 2),
    # Lite (reference :1240-1289)
    "efficientnet_lite0": _lite(1.0, 1.0, drop_rate=0.2),
    "efficientnet_lite1": _lite(1.0, 1.1, drop_rate=0.2),
    "efficientnet_lite2": _lite(1.1, 1.2, drop_rate=0.3),
    "efficientnet_lite3": _lite(1.2, 1.4, drop_rate=0.3),
    "efficientnet_lite4": _lite(1.4, 1.8, drop_rate=0.4),
    # pruned (reference :1292-1329; see the module docstring)
    "efficientnet_b1_pruned": _b(1, pruned=True, **_TF),
    "efficientnet_b2_pruned": _b(2, pruned=True, **_TF),
    "efficientnet_b3_pruned": _b(3, pruned=True, **_TF),
    # TF ports (reference :1332-1560): TF bn eps + SAME padding
    **{f"tf_efficientnet_b{i}": _b(i, **_TF) for i in range(9)},
    **{f"tf_efficientnet_b{i}_ap": _b(i, **_TF) for i in range(9)},
    **{f"tf_efficientnet_b{i}_ns": _b(i, **_TF) for i in range(8)},
    "tf_efficientnet_l2_ns": _b("l2", **_TF),
    "tf_efficientnet_l2_ns_475": _b("l2", **_TF),
    "tf_efficientnet_es": _edge(1.0, 1.0, **_TF),
    "tf_efficientnet_em": _edge(1.0, 1.1, **_TF),
    "tf_efficientnet_el": _edge(1.2, 1.4, **_TF),
    "tf_efficientnet_cc_b0_4e": _cc(1.0, **_TF),
    "tf_efficientnet_cc_b0_8e": _cc(1.0, 2, **_TF),
    "tf_efficientnet_cc_b1_8e": _cc(1.1, 2, **_TF),
    "tf_efficientnet_lite0": _lite(1.0, 1.0, **_TF),
    "tf_efficientnet_lite1": _lite(1.0, 1.1, **_TF),
    "tf_efficientnet_lite2": _lite(1.1, 1.2, **_TF),
    "tf_efficientnet_lite3": _lite(1.2, 1.4, **_TF),
    "tf_efficientnet_lite4": _lite(1.4, 1.8, **_TF),
    # MixNet (reference :1650-1727)
    "mixnet_s": dict(gen="mixnet_s", channel_multiplier=1.0),
    "mixnet_m": dict(gen="mixnet_m", channel_multiplier=1.0),
    "mixnet_l": dict(gen="mixnet_m", channel_multiplier=1.3),
    "mixnet_xl": dict(gen="mixnet_m", channel_multiplier=1.6,
                      depth_multiplier=1.2),
    "mixnet_xxl": dict(gen="mixnet_m", channel_multiplier=2.4,
                       depth_multiplier=1.3),
    "tf_mixnet_s": dict(gen="mixnet_s", channel_multiplier=1.0, **_TF),
    "tf_mixnet_m": dict(gen="mixnet_m", channel_multiplier=1.0, **_TF),
    "tf_mixnet_l": dict(gen="mixnet_m", channel_multiplier=1.3, **_TF),
}

register_variant_table(__name__, _effnet_entry, EFFICIENTNET_VARIANTS)


@register_model
def mnasnet_b1(pretrained=False, **kwargs):
    """Alias of mnasnet_100 (reference efficientnet.py:898-901)."""
    return mnasnet_100(pretrained, **kwargs)  # noqa: F821 (table-generated)


@register_model
def mnasnet_a1(pretrained=False, **kwargs):
    """Alias of semnasnet_100 (reference efficientnet.py:931-934)."""
    return semnasnet_100(pretrained, **kwargs)  # noqa: F821
