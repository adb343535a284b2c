"""Pooling with torch semantics on NCHW, counterpart of
``cotnet_tpu/nn/pool.py``."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cotnet_tpu_torch.nn.conv import pad_same


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


def max_pool2d_same(x, kernel_size, stride):
    """TF-SAME max-pool (reference pool2d_same.py, ``cotnet_tpu/nn/pool.py:
    139-144``): ``pad_same`` with the most negative finite value of x's
    type, then a VALID pool.  The JAX package pads with float32's, which
    rounds to -inf in bf16; no SAME window is all pad, so the pool is the
    same."""
    x = pad_same(x, kernel_size, stride, value=torch.finfo(x.dtype).min)
    return F.max_pool2d(x, kernel_size, stride)


def global_pool2d(x, pool_type: str = "avg"):
    """Adaptive global pooling over the spatial dims of NCHW (reference
    adaptive_avgmax_pool.py): ``avg``, ``max``, ``avgmax`` (their mean) and
    ``catavgmax`` (both, ``[N, 2C]``) give ``[N, C]``; ``""`` / None /
    ``identity`` return ``x`` as it is."""
    if pool_type == "avg":
        return x.mean((2, 3))
    if pool_type == "max":
        return x.amax((2, 3))
    if pool_type == "avgmax":
        return 0.5 * (x.mean((2, 3)) + x.amax((2, 3)))
    if pool_type == "catavgmax":
        return torch.cat([x.mean((2, 3)), x.amax((2, 3))], dim=1)
    if pool_type in ("", None, "identity"):
        return x
    raise ValueError(f"unknown pool_type {pool_type!r}")
