"""LeViT (reference models/levit.py), counterpart of
``cotnet_tpu/models/levit.py``: a stem of four stride-2 3x3 conv + BN
(hard swish between), then three stages of residual attention and MLP
blocks over ``[N, L, D]`` tokens, with attention subsampling between the
stages -> mean over the tokens -> BN -> head.  Every row of the JAX
package's ``LEVIT_VARIANTS`` (5 registry keys).

Every linear layer is ``Linear_BN``: a bias-free ``Linear`` and a BN over
the tokens' last axis (``nn.TokenBatchNorm``: global batch statistics under
a process group).  Attention adds a learned per-head bias, one for each
distinct ``(|dy|, |dx|)`` offset between a query and a key on the grid,
the offsets numbered in first-seen order (``attention_bias_idxs``, a
buffer; the subsampling's queries sit on the stride-2 grid), to the f32
logits; hard swish precedes each output projection.  The blocks have no
stochastic depth, as the JAX package has none.  The bias tables are sized
when the model is built, by ``img_size`` (default 224); an input of
another size raises.  With ``distillation`` a ``head_dist`` on the same
normed features is averaged with ``head``, as in the JAX package.

Parameter names are timm's: ``patch_embed.{0,2,4,6}.{c,bn}``, the flat
``blocks.{i}``: ``m.{qkv,proj.1}.{c,bn}`` and ``m.attention_biases`` in an
attention block, ``m.{0,2}.{c,bn}`` in an MLP block,
``{kv,q.1,proj.1}.{c,bn}`` and ``attention_biases`` in a subsampling,
``head.{bn,l}``, ``head_dist.l``.  A state_dict without the
``attention_bias_idxs`` buffers loads too: they follow from the shapes.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from cotnet_tpu_torch.models.helpers import (build_model_with_cfg,
                                             default_cfg,
                                             register_variant_table)
from cotnet_tpu_torch.nn import (BatchNorm2d, Conv2d, Linear, TokenBatchNorm,
                                 get_act_fn)

default_cfgs = {}  # filled beside the variant table below


def bias_index(res_q: int, res_kv: int, stride: int = 1
               ) -> Tuple[np.ndarray, int]:
    """``[Lq, Lkv]`` index into the table of distinct offsets between the
    queries (on the ``stride`` grid) and the keys, and the table's size
    (``cotnet_tpu/models/levit.py:36-49``)."""
    pts_kv = [(i, j) for i in range(res_kv) for j in range(res_kv)]
    pts_q = [(i * stride, j * stride) for i in range(res_q)
             for j in range(res_q)]
    offsets = {}
    idx = np.zeros((len(pts_q), len(pts_kv)), np.int64)
    for qi, (qy, qx) in enumerate(pts_q):
        for ki, (ky, kx) in enumerate(pts_kv):
            off = (abs(qy - ky), abs(qx - kx))
            if off not in offsets:
                offsets[off] = len(offsets)
            idx[qi, ki] = offsets[off]
    return idx, len(offsets)


class HardSwish(nn.Module):
    def forward(self, x):
        return get_act_fn("hard_swish")(x)


class LinearBN(nn.Module):
    """timm's ``Linear_BN``: ``c``, a bias-free Linear, then ``bn``."""

    def __init__(self, a: int, b: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.c = Linear(a, b, bias=False, dtype=dtype)
        self.bn = TokenBatchNorm(b, dtype=dtype)

    def forward(self, x):
        return self.bn(self.c(x))


class ConvBN(nn.Module):
    """timm's ``Conv2d_BN`` of the stem: a bias-free 3x3 stride-2 conv,
    then BN."""

    def __init__(self, a: int, b: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.c = Conv2d(a, b, 3, 2, 1, dtype=dtype)
        self.bn = BatchNorm2d(b, dtype=dtype)

    def forward(self, x):
        return self.bn(self.c(x))


class _BiasTable(nn.Module):
    """The attention bias table and its index buffer; a state_dict without
    the buffer keeps the built one."""

    def _init_bias(self, num_heads: int, res_q: int, res: int, stride: int):
        idx, n_off = bias_index(res_q, res, stride)
        self.attention_biases = nn.Parameter(torch.empty(num_heads, n_off))
        self.register_buffer("attention_bias_idxs",
                             torch.tensor(idx, dtype=torch.long))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.attention_biases.zero_()

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        key = prefix + "attention_bias_idxs"
        if key not in state_dict:
            state_dict[key] = self.attention_bias_idxs
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def _attend(self, q, k, v, dtype):
        """``softmax(q k^T / sqrt(kd) + bias)`` in f32, cast to ``dtype``,
        times v; ``[N, h, Lq, *]`` -> ``[N, Lq, h*vd]``."""
        logits = torch.matmul(q * q.shape[-1] ** -0.5,
                              k.transpose(-2, -1)).float()
        bias = self.attention_biases[:, self.attention_bias_idxs]
        attn = torch.softmax(logits + bias, -1).to(dtype)
        y = torch.matmul(attn, v).transpose(1, 2)
        return y.reshape(*y.shape[:2], -1)


class Attention(_BiasTable):
    """Attention over the ``resolution x resolution`` tokens: ``qkv`` gives
    per head a key width ``key_dim`` for q and k and ``attn_ratio *
    key_dim`` for v."""

    def __init__(self, dim: int, key_dim: int, num_heads: int,
                 attn_ratio: float, resolution: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads, self.key_dim, self.dtype = num_heads, key_dim, dtype
        self.d = int(attn_ratio * key_dim)
        self.qkv = LinearBN(dim, num_heads * (2 * key_dim + self.d),
                            dtype=dtype)
        self.proj = nn.Sequential(HardSwish(),
                                  LinearBN(num_heads * self.d, dim,
                                           dtype=dtype))
        self._init_bias(num_heads, resolution, resolution, 1)

    def forward(self, x):
        n, length, _ = x.shape
        kd = self.key_dim
        qkv = self.qkv(x).reshape(n, length, self.num_heads, -1)
        q, k, v = (t.transpose(1, 2) for t in qkv.split([kd, kd, self.d], -1))
        return self.proj(self._attend(q, k, v, self.dtype))


class Subsample(nn.Module):
    """Every ``stride``-th token of the ``resolution`` grid, each way."""

    def __init__(self, stride: int, resolution: int):
        super().__init__()
        self.stride, self.resolution = stride, resolution

    def forward(self, x):
        n, _, d = x.shape
        r, s = self.resolution, self.stride
        return x.reshape(n, r, r, d)[:, ::s, ::s].reshape(n, -1, d)


class AttentionSubsample(_BiasTable):
    """Attention from the stride-2 subgrid's queries to every token, into
    ``out_dim``: ``[N, res^2, in_dim]`` -> ``[N, res_q^2, out_dim]``."""

    def __init__(self, in_dim: int, out_dim: int, key_dim: int,
                 num_heads: int, attn_ratio: float, resolution: int,
                 stride: int = 2, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads, self.key_dim, self.dtype = num_heads, key_dim, dtype
        self.d = int(attn_ratio * key_dim)
        res_q = (resolution - 1) // stride + 1
        self.kv = LinearBN(in_dim, num_heads * (key_dim + self.d),
                           dtype=dtype)
        self.q = nn.Sequential(Subsample(stride, resolution),
                               LinearBN(in_dim, num_heads * key_dim,
                                        dtype=dtype))
        self.proj = nn.Sequential(HardSwish(),
                                  LinearBN(num_heads * self.d, out_dim,
                                           dtype=dtype))
        self._init_bias(num_heads, res_q, resolution, stride)

    def forward(self, x):
        n, length, _ = x.shape
        h, kd = self.num_heads, self.key_dim
        kv = self.kv(x).reshape(n, length, h, -1)
        k, v = (t.transpose(1, 2) for t in kv.split([kd, self.d], -1))
        q = self.q(x)
        q = q.reshape(n, q.shape[1], h, kd).transpose(1, 2)
        return self.proj(self._attend(q, k, v, self.dtype))


class Residual(nn.Module):
    """``x + m(x)``."""

    def __init__(self, m: nn.Module):
        super().__init__()
        self.m = m

    def forward(self, x):
        return x + self.m(x)


def _mlp(dim: int, ratio: float, dtype) -> Residual:
    hidden = int(dim * ratio)
    return Residual(nn.Sequential(LinearBN(dim, hidden, dtype=dtype),
                                  HardSwish(),
                                  LinearBN(hidden, dim, dtype=dtype)))


class NormLinear(nn.Module):
    """timm's ``BN_Linear`` head: ``bn`` (absent in ``head_dist``, which
    takes ``head``'s normed features, as in the JAX package), then the
    ``Linear`` ``l`` (absent at ``num_classes=0``)."""

    def __init__(self, dim: int, num_classes: int, norm: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.bn = TokenBatchNorm(dim, dtype=dtype) if norm else None
        self.l = Linear(dim, num_classes, dtype=dtype) \
            if num_classes > 0 else None


class Levit(nn.Module):
    """``cotnet_tpu/models/levit.py:143-222``.  ``features_only`` returns
    each stage's tokens (before its subsampling) as an ``[N, D_s, res_s,
    res_s]`` map (the head is not built); ``num_classes=0`` returns the
    normed mean token."""

    def __init__(self, img_size: int = 224, in_chans: int = 3,
                 num_classes: int = 1000,
                 embed_dims: Sequence[int] = (128, 256, 384),
                 key_dim: int = 16, num_heads: Sequence[int] = (4, 8, 12),
                 depths: Sequence[int] = (4, 4, 4), attn_ratio: float = 2.0,
                 mlp_ratio: float = 2.0, distillation: bool = False,
                 drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 features_only: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.img_size, self.features_only = img_size, features_only
        e0 = embed_dims[0]
        chans = (in_chans, e0 // 8, e0 // 4, e0 // 2, e0)
        stem = []
        for i in range(4):
            if i:
                stem.append(HardSwish())
            stem.append(ConvBN(chans[i], chans[i + 1], dtype=dtype))
        self.patch_embed = nn.Sequential(*stem)
        res = img_size
        for _ in range(4):
            res = (res - 1) // 2 + 1
        blocks = []
        self.stage_ends = []   # (index of a stage's last block, resolution)
        for si, (dim, heads, depth) in enumerate(zip(embed_dims, num_heads,
                                                     depths)):
            for _ in range(depth):
                blocks.append(Residual(Attention(dim, key_dim, heads,
                                                 attn_ratio, res,
                                                 dtype=dtype)))
                blocks.append(_mlp(dim, mlp_ratio, dtype))
            self.stage_ends.append((len(blocks) - 1, res))
            if si < len(embed_dims) - 1:
                # reference levit.py:442-445: heads = in_dim // key_dim,
                # attn_ratio 4, the stage's MLP ratio after it
                blocks.append(AttentionSubsample(
                    dim, embed_dims[si + 1], key_dim, dim // key_dim, 4.0,
                    res, dtype=dtype))
                res = (res - 1) // 2 + 1
                blocks.append(_mlp(embed_dims[si + 1], mlp_ratio, dtype))
        self.blocks = nn.Sequential(*blocks)
        self.head = self.head_dist = None
        if not features_only:
            self.head = NormLinear(embed_dims[-1], num_classes, dtype=dtype)
            if distillation and num_classes > 0:
                self.head_dist = NormLinear(embed_dims[-1], num_classes,
                                            norm=False, dtype=dtype)

    def forward(self, x):
        if tuple(x.shape[2:]) != (self.img_size, self.img_size):
            raise ValueError(
                f"the attention bias tables were sized for {self.img_size}x"
                f"{self.img_size} inputs, got {tuple(x.shape[2:])}: build "
                "the model with img_size= the input's size")
        x = self.patch_embed(x).flatten(2).transpose(1, 2)
        ends = dict(self.stage_ends)
        feats = []
        for i, block in enumerate(self.blocks):
            x = block(x)
            if i in ends and self.features_only:
                n, _, d = x.shape
                feats.append(x.transpose(1, 2).reshape(n, d, ends[i],
                                                       ends[i]))
                if len(feats) == len(ends):
                    return feats
        out = self.head.bn(x.mean(1))
        if self.head.l is None:
            return out
        logits = self.head.l(out)
        if self.head_dist is not None:
            logits = (logits + self.head_dist.l(out)) / 2
        return logits


def _levit(model_name, pretrained=False, img_size: Optional[int] = None,
           **kwargs):
    """Build a row on ``Levit`` (``pretrained`` is accepted and ignored:
    weights load through ``utils.convert``)."""
    cfg = default_cfgs[model_name]
    return build_model_with_cfg(Levit, model_name, cfg,
                                img_size=img_size or cfg["input_size"][-1],
                                **kwargs)


# --- variant table (reference levit.py:69-81) -------------------------------

LEVIT_VARIANTS = {
    "levit_128s": dict(embed_dims=(128, 256, 384), key_dim=16,
                       num_heads=(4, 6, 8), depths=(2, 3, 4)),
    "levit_128": dict(embed_dims=(128, 256, 384), key_dim=16,
                      num_heads=(4, 8, 12), depths=(4, 4, 4)),
    "levit_192": dict(embed_dims=(192, 288, 384), key_dim=32,
                      num_heads=(3, 5, 6), depths=(4, 4, 4)),
    "levit_256": dict(embed_dims=(256, 384, 512), key_dim=32,
                      num_heads=(4, 6, 8), depths=(4, 4, 4)),
    "levit_384": dict(embed_dims=(384, 512, 768), key_dim=32,
                      num_heads=(6, 9, 12), depths=(4, 4, 4)),
}

for _name in LEVIT_VARIANTS:
    default_cfgs[_name] = default_cfg(crop_pct=0.9,
                                      first_conv="patch_embed.0.c",
                                      classifier="head.l")

register_variant_table(__name__, _levit, LEVIT_VARIANTS)
