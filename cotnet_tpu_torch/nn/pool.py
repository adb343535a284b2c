"""Pooling with torch semantics on NCHW, counterpart of
``cotnet_tpu/nn/pool.py``."""

from __future__ import annotations

import torch.nn.functional as F


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               count_include_pad=True):
    """torch.nn.AvgPool2d (the CotBottleneck avd pool uses
    ``count_include_pad=True``; the ResNet-D avg-down shortcut
    ``ceil_mode=True, count_include_pad=False``, whose last window on an
    odd map holds one row and column of the image, and divides by that)."""
    return F.avg_pool2d(x, kernel_size, stride, padding, ceil_mode,
                        count_include_pad)


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False):
    """torch.nn.MaxPool2d."""
    return F.max_pool2d(x, kernel_size, stride, padding, ceil_mode=ceil_mode)


def global_pool2d(x, pool_type: str = "avg"):
    """Adaptive global average pooling over the spatial dims of NCHW ->
    ``[N, C]``, the pool of every ported model.  The reference's other
    pool types (max / avgmax / catavgmax) come with a model that uses
    them."""
    if pool_type != "avg":
        raise NotImplementedError(f"pool_type {pool_type!r} is not ported "
                                  "yet")
    return x.mean((2, 3))
