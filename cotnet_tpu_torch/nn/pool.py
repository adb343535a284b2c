"""Pooling with torch semantics on NCHW, counterpart of
``cotnet_tpu/nn/pool.py``: torch's avg and max pools, the TF-SAME ones
(reference pool2d_same.py), the global pools (adaptive_avgmax_pool.py)
and the median pool (median_pool.py)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cotnet_tpu_torch.nn.conv import pad_same, to_2tuple


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


def avg_pool2d_same(x, kernel_size, stride):
    """TF-SAME avg pool, the padding left out of each window's count
    (reference pool2d_same.py:31-41, ``cotnet_tpu/nn/pool.py:125-136``):
    the window sums of the padded input over those of a padded ones map,
    in f32, cast back to x's type.  ``count_include_pad`` cannot say this:
    it does not see a pad made before the pool."""
    k, s = to_2tuple(kernel_size), to_2tuple(stride)
    ones = pad_same(x.new_ones(1, 1, *x.shape[2:], dtype=torch.float32), k, s)
    sums = F.avg_pool2d(pad_same(x.float(), k, s), k, s, divisor_override=1)
    counts = F.avg_pool2d(ones, k, s, divisor_override=1)
    return (sums / counts).to(x.dtype)


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


def median_pool2d(x, kernel_size=3, stride=1, padding=0):
    """Median pool (reference median_pool.py, ``cotnet_tpu/nn/pool.py:
    164-182``): zero padding, every window's taps sorted, and the mean of
    the two middle ones, ``(lo + hi) * 0.5`` in x's type, as
    ``jnp.median`` takes it.  For an odd window the two are the one middle
    tap; for an even one (2x2, 4x4) ``torch.median`` would return the lower
    of the two instead."""
    (kh, kw), (sh, sw), (ph, pw) = (to_2tuple(v) for v in (kernel_size, stride,
                                                        padding))
    xp = F.pad(x, (pw, pw, ph, ph))
    oh = (x.shape[2] + 2 * ph - kh) // sh + 1
    ow = (x.shape[3] + 2 * pw - kw) // sw + 1
    taps = torch.stack([xp[:, :, i:i + (oh - 1) * sh + 1:sh,
                           j:j + (ow - 1) * sw + 1:sw]
                        for i in range(kh) for j in range(kw)], dim=-1)
    taps = taps.sort(dim=-1).values
    n = kh * kw
    return (taps[..., (n - 1) // 2] + taps[..., n // 2]) * 0.5
