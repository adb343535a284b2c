"""SAN, self-attention networks with the low-rank variant (reference
models/san_lowrank.py), counterpart of ``cotnet_tpu/models/san.py``.

``SAM`` (reference :32-58): pairwise attention, the per-position K^2 x Cw
weight an MLP of ``[q; unfold_reflect(k)]`` (the key patches
reflect-padded), consumed by ``local_aggregate`` (the Hopper kernels on
the card).  Its last conv ``conv_w.5`` writes the weight cw-major, the
reference's layout, which is the port's: it is a view of the aggregation's
``[N, 1, Cw, K^2, H, W]`` weight, with Cw = planes/8 shared by 8 channel
groups of the values (the JAX package permutes it to k-major).
``SAMLowRank`` (:60-121): factored K x 1 and 1 x K weights at pooled
resolution, upsampled, one weight channel per value channel.  ``SAN``
(:141-185) is SAN's own 5-stage chassis of pre-activation SAM bottlenecks;
``san19`` aggregates at K = 3 in stage 0 and K = 7 in stages 1-4.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from cotnet_tpu_torch.models.helpers import build_model_with_cfg, default_cfg
from cotnet_tpu_torch.models.registry import register_model
from cotnet_tpu_torch.nn import (BatchNorm2d, ClassifierHead, Conv2d,
                                 avg_pool2d, max_pool2d, relu)
from cotnet_tpu_torch.ops import extract_patches, local_aggregate

default_cfgs = {"san19": default_cfg(pool_size=None)}

SHARE_PLANES = 8
WIDTHS = (64, 256, 512, 1024, 2048)


def _key_patches(k, ks):
    """unfold(reflect_pad(k)) with the reference's c-major channels
    ``c*K^2 + tap``: ``[N, C, H, W] -> [N, C*K^2, H, W]``."""
    n, c, h, w = k.shape
    return extract_patches(k, ks, padding=ks // 2, pad_mode="reflect"
                           ).reshape(n, c * ks * ks, h, w)


class SAM(nn.Module):
    """Pairwise self-attention module (reference san_lowrank.py:32-58):
    ``conv_w`` is its Sequential ``[bn, relu, conv, bn, relu, conv]``."""

    def __init__(self, in_planes: int, rel_planes: int, out_planes: int,
                 share_planes: int = SHARE_PLANES, kernel_size: int = 3,
                 impl: str = "auto", dtype: torch.dtype = torch.float32):
        super().__init__()
        ks = kernel_size
        k2 = ks * ks
        self.kernel_size, self.impl = ks, impl
        self.cw = out_planes // share_planes
        self.conv1 = Conv2d(in_planes, rel_planes, 1, bias=True, dtype=dtype)
        self.conv2 = Conv2d(in_planes, rel_planes, 1, bias=True, dtype=dtype)
        self.conv3 = Conv2d(in_planes, out_planes, 1, bias=True, dtype=dtype)
        self.conv_w = nn.Sequential(
            BatchNorm2d(rel_planes * (k2 + 1), dtype=dtype), nn.ReLU(),
            Conv2d(rel_planes * (k2 + 1), self.cw, 1, dtype=dtype),
            BatchNorm2d(self.cw, dtype=dtype), nn.ReLU(),
            Conv2d(self.cw, k2 * self.cw, 1, bias=True, dtype=dtype))

    def forward(self, x):
        ks = self.kernel_size
        q, k, v = self.conv1(x), self.conv2(x), self.conv3(x)
        w = self.conv_w(torch.cat([q, _key_patches(k, ks)], dim=1))
        n, _, h, wd = w.shape
        return local_aggregate(v, w.view(n, 1, self.cw, ks * ks, h, wd),
                               kernel_size=ks, padding=(ks - 1) // 2,
                               impl=self.impl)


class SAMLowRank(nn.Module):
    """Low-rank factored SAM (reference san_lowrank.py:60-121; JAX
    ``san.py:77-134``): ``conv`` is a 1-entry Sequential, ``key_embed`` and
    ``conv_w`` are ``[bn, relu, conv]``.  The K x 1 and 1 x K factors come
    k-major (``tap*C + c``) at a resolution pooled by ``min(512 / C, 4)``
    and are repeated back up to the map."""

    def __init__(self, in_planes: int, rel_planes: int, out_planes: int,
                 share_planes: int = SHARE_PLANES, kernel_size: int = 3,
                 impl: str = "auto", dtype: torch.dtype = torch.float32):
        super().__init__()
        ks = kernel_size
        self.kernel_size, self.impl = ks, impl
        self.rel_planes, self.out_planes = rel_planes, out_planes
        self.pool_size = min(512 // out_planes, 4)
        self.conv = nn.Sequential(
            Conv2d(in_planes, out_planes + 2 * rel_planes, 1, dtype=dtype))
        self.key_embed = nn.Sequential(
            BatchNorm2d(rel_planes * ks * ks, dtype=dtype), nn.ReLU(),
            Conv2d(rel_planes * ks * ks, rel_planes, 1, dtype=dtype))
        self.conv_w = nn.Sequential(
            BatchNorm2d(2 * rel_planes, dtype=dtype), nn.ReLU(),
            Conv2d(2 * rel_planes, out_planes * ks * 2, 1, dtype=dtype))

    def forward(self, x):
        ks, rel, c = self.kernel_size, self.rel_planes, self.out_planes
        q, k, v = torch.split(self.conv(x), [rel, rel, c], dim=1)
        qk = torch.cat([q, self.key_embed(_key_patches(k, ks))], dim=1)
        p = self.pool_size
        if p > 1:
            qk = avg_pool2d(qk, p, p)
        e = self.conv_w(qk)
        n, _, hh, ww = e.shape
        eh, ew = e.view(n, 2, ks, c, hh, ww).unbind(1)
        # w[n, c, kh*K + kw] = eh[n, kh, c] * ew[n, kw, c]
        w = (eh[:, :, None] * ew[:, None]).permute(0, 3, 1, 2, 4, 5).reshape(
            n, 1, c, ks * ks, hh, ww)
        if p > 1:
            w = w.repeat_interleave(p, dim=4).repeat_interleave(p, dim=5)
            w = w[..., :v.shape[2], :v.shape[3]].contiguous()
        return local_aggregate(v, w, kernel_size=ks, padding=(ks - 1) // 2,
                               impl=self.impl)


class SanBottleneck(nn.Module):
    """Pre-activation SAM bottleneck (reference san_lowrank.py:123-139):
    ``x + conv(relu(bn2(sam(relu(bn1(x))))))``."""

    def __init__(self, rel_planes: int, mid_planes: int, out_planes: int,
                 share_planes: int = SHARE_PLANES, kernel_size: int = 7,
                 impl: str = "auto", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.bn1 = BatchNorm2d(out_planes, dtype=dtype)
        self.sam = SAM(out_planes, rel_planes, mid_planes, share_planes,
                       kernel_size, impl=impl, dtype=dtype)
        self.bn2 = BatchNorm2d(mid_planes, dtype=dtype)
        self.conv = Conv2d(mid_planes, out_planes, 1, bias=True, dtype=dtype)

    def forward(self, x):
        y = self.sam(relu(self.bn1(x)))
        return self.conv(relu(self.bn2(y))) + x


class SAN(nn.Module):
    """SAN's 5-stage chassis (reference san_lowrank.py:141-185): a 1x1 stem
    conv with BN and relu; per stage a 2x2 max-pool, a 1x1 conv to the
    stage's width, its bottlenecks (``rel = C/16``, ``mid = C/4``) and BN +
    relu; the mean over the map and the linear classifier ``fc``.  ``impl``
    (or ``block_args=dict(impl=...)``) selects the aggregation's
    implementation."""

    def __init__(self, layers: Sequence[int] = (3, 3, 4, 6, 3),
                 kernels: Sequence[int] = (3, 7, 7, 7, 7),
                 num_classes: int = 1000, in_chans: int = 3,
                 impl: str = "auto", block_args: Optional[dict] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        impl = (block_args or {}).get("impl", impl)
        self.conv_in = Conv2d(in_chans, 64, 1, dtype=dtype)
        self.bn_in = BatchNorm2d(64, dtype=dtype)
        prev = 64
        for si, (c, n_blocks, ks) in enumerate(zip(WIDTHS, layers, kernels)):
            self.add_module(f"conv{si}", Conv2d(prev, c, 1, dtype=dtype))
            self.add_module(f"layer{si}", nn.Sequential(*(
                SanBottleneck(c // 16, c // 4, c, SHARE_PLANES, ks,
                              impl=impl, dtype=dtype)
                for _ in range(n_blocks))))
            self.add_module(f"bn{si}", BatchNorm2d(c, dtype=dtype))
            prev = c
        self.num_stages = len(layers)
        self.num_features = prev
        self.fc = ClassifierHead(prev, num_classes, dtype=dtype)

    def forward(self, x):
        x = relu(self.bn_in(self.conv_in(x)))
        for si in range(self.num_stages):
            x = getattr(self, f"conv{si}")(max_pool2d(x, 2, 2))
            x = relu(getattr(self, f"bn{si}")(getattr(self, f"layer{si}")(x)))
        return self.fc(x)


@register_model
def san19(pretrained=False, **kwargs):
    return build_model_with_cfg(SAN, "san19", default_cfgs["san19"],
                                **dict(dict(layers=(3, 3, 4, 6, 3),
                                            kernels=(3, 7, 7, 7, 7)),
                                       **kwargs))
