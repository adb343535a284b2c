"""Normalization layers, counterpart of ``cotnet_tpu/nn/norm.py``.

BatchNorm2d: torch defaults (eps 1e-5, running momentum 0.1, which is flax
momentum 0.9), with the arithmetic of ``LeanBatchNorm``: the per-channel
affine ``x*s + b`` is formed in f32 from the parameters and the statistics
(the running ones in eval, the batch's in training), then applied in the
compute dtype.  In training the running variance is updated with the
*biased* batch variance, as flax does, not with torch's unbiased one.  Under
a process group of more than one rank the batch statistics are those of
the global batch, as GSPMD makes the JAX package's.

TokenBatchNorm: the same over the last axis of ``[N, L, D]`` tokens (LeViT's
BN), sharing BatchNorm2d's code.

SubChannelGroupNorm: the CoT attention-embed GroupNorm, the reference's
``nn.GroupNorm(Cw, K^2*Cw)`` on its cw-major channel order (channel =
cw*K^2 + k), so group cw holds every tap of weight channel cw.  Statistics
are one-pass (E[x^2] - E[x]^2) in f32 per (n, cw) over (K^2, H, W).
``fold()`` returns the equivalent per-(n, cw, k) affine for the
aggregation instead of the normalized tensor (differentiable in the input
and the parameters by plain autograd), ``raw()`` the parameters alone for
the fused eval op, which takes its own statistics.

GroupNorm: flax's ``GroupNorm`` as the ResNetV2 family builds it (32
groups, eps 1e-5), one-pass f32 statistics.  LayerNorm: the transformers'
norm over the last dim, two-pass.  Both by plain autograd.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.autograd.function import once_differentiable

from cotnet_tpu_torch.parallel.collectives import (all_reduce_sum,
                                                   group_size,
                                                   replayed_all_reduce_sum)


class BatchStatsReplay:
    """What a block's train-mode BNs computed in its first pass, for its
    recompute under ``remat`` (``nn.remat.remat_call``): the global batch
    sums of each BN in the order they ran.  While one is ``active()`` and
    ``replaying``, a BN takes its sums from here (no collective; the
    gradient is still summed across ranks) and leaves its running
    statistics as they are: the recompute must not move them twice."""

    stack: list = []

    def __init__(self):
        self.sums = []
        self.replaying = False
        self.pos = 0

    @classmethod
    def active(cls) -> Optional["BatchStatsReplay"]:
        return cls.stack[-1] if cls.stack else None


class BatchNorm2d(nn.Module):
    """Batch norm over NCHW with the state_dict of ``torch.nn.BatchNorm2d``
    (weight, bias, running_mean, running_var, num_batches_tracked).
    ``zero_init`` starts the scale at 0 (the last BN of a residual branch
    under ``zero_init_last_bn``).

    Training follows ``LeanBatchNorm`` (``cotnet_tpu/nn/norm.py:142-157``):
    f32 sums of x and x^2 taken from the tensor as it is given (the squares
    round in its dtype), ``var = max(E[x^2] - E[x]^2, 0)``, and the running
    stats move by ``momentum`` under ``no_grad``.  The running variance
    takes the biased batch variance (what flax stores), where
    ``torch.nn.BatchNorm2d`` and ``F.batch_norm`` take the unbiased one: on
    a batch of m values per channel the two differ by m/(m-1).

    Data parallel: in training, where the default process group has more
    than one rank, the f32 ``sum x``, ``sum x^2`` and the count are summed
    across ranks in one all-reduce that carries the gradient
    (``parallel.collectives.all_reduce_sum``), so mean and variance are the
    global batch's, as the JAX layer's ``lax.pmean`` under ``axis_name``
    (``cotnet_tpu/nn/norm.py:147-149``) and GSPMD make them.  ``group``
    names another group (the counterpart of ``axis_name``, for tests and
    subgroups); ``torch.nn.SyncBatchNorm`` is not used: it refuses CPU
    tensors and keeps the unbiased running variance.  In a block recomputed
    under ``remat`` the BN neither all-reduces again nor moves its running
    statistics (``BatchStatsReplay``)."""

    channel_axis = 1

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1, zero_init: bool = False,
                 dtype: torch.dtype = torch.float32, group=None):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.group = group
        self.zero_init = zero_init
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(num_features))
        self.bias = nn.Parameter(torch.empty(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.weight.fill_(0.0 if self.zero_init else 1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)
            self.num_batches_tracked.zero_()

    def forward(self, x):
        axis = self.channel_axis % x.dim()
        if self.training:
            red = tuple(d for d in range(x.dim()) if d != axis)
            c = x.shape[axis]
            count = x.numel() // c
            s1 = x.sum(red, dtype=torch.float32)
            s2 = x.square().sum(red, dtype=torch.float32)
            replay = BatchStatsReplay.active()
            replaying = replay is not None and replay.replaying
            if group_size(self.group) > 1:
                local = torch.cat([s1, s2, s1.new_full((1,), count)])
                if replaying:
                    sums = replayed_all_reduce_sum(
                        local, replay.sums[replay.pos], self.group)
                    replay.pos += 1
                else:
                    sums = all_reduce_sum(local, self.group)
                    if replay is not None:
                        replay.sums.append(sums.detach())
                s1, s2, count = sums[:c], sums[c:2 * c], sums[2 * c]
            mean = s1 / count
            mean2 = s2 / count
            var = (mean2 - mean.square()).clamp_min(0.0)
            if not replaying:
                with torch.no_grad():
                    m = self.momentum
                    self.running_mean.mul_(1 - m).add_(mean, alpha=m)
                    self.running_var.mul_(1 - m).add_(var, alpha=m)
                    self.num_batches_tracked += 1
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps) * self.weight
        b = self.bias - mean * inv
        dt = self.dtype
        shape = [1] * x.dim()
        shape[axis] = -1
        return x.to(dt) * inv.to(dt).view(shape) + b.to(dt).view(shape)


class TokenBatchNorm(BatchNorm2d):
    """``BatchNorm2d``'s arithmetic, running statistics and global-batch
    sums over the last axis: ``[N, L, D]`` tokens or ``[N, D]`` vectors, the
    statistics over every other axis, as the JAX package's ``batch_norm``
    on a token array (``cotnet_tpu/models/levit.py:21-33``) and timm's
    ``BatchNorm1d`` on the flattened tokens.  The same state_dict."""

    channel_axis = -1


class _GroupNormFn(torch.autograd.Function):
    """SubChannelGroupNorm's normalize as one autograd node.  It saves x in
    its own dtype with the per-group mean and inverse std, not the f32
    intermediates autograd would keep (x is the largest activation of a CoT
    layer), and its backward is the closed form

        dx = inv * (g - mean_grp(g) - xhat * mean_grp(g * xhat)),
        g = dy * weight,  dweight = sum(dy * xhat),  dbias = sum(dy),

    all in f32.  No double backward."""

    @staticmethod
    def forward(ctx, x, weight, bias, mean, inv, cw, dtype):
        n, c, h, w = x.shape
        xhat = (x.float().view(n, cw, -1) - mean[..., None]) * inv[..., None]
        y = xhat.view(n, c, h, w) * weight.view(1, c, 1, 1) \
            + bias.view(1, c, 1, 1)
        ctx.save_for_backward(x, weight, mean, inv)
        ctx.cw = cw
        return y.to(dtype)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, weight, mean, inv = ctx.saved_tensors
        n, c, h, w = x.shape
        cw = ctx.cw
        dyf = dy.float()
        xhat = (x.float().view(n, cw, -1) - mean[..., None]) * inv[..., None]
        dyx = dyf * xhat.view(n, c, h, w)
        dweight = dyx.sum((0, 2, 3))
        dbias = dyf.sum((0, 2, 3))
        g = (dyf * weight.view(1, c, 1, 1)).view(n, cw, -1)
        g_mean = g.mean(-1, keepdim=True)
        gx_mean = (g * xhat).mean(-1, keepdim=True)
        dx = (g - g_mean - xhat * gx_mean) * inv[..., None]
        return (dx.view(n, c, h, w).to(x.dtype), dweight, dbias, None, None,
                None, None)


class SubChannelGroupNorm(nn.Module):
    """``nn.GroupNorm(Cw, K^2*Cw)`` over cw-major attention-weight channels
    ``[N, Cw*K^2, H, W]``; parameters ``weight``/``bias`` ``[Cw*K^2]``."""

    def __init__(self, k2: int, cw: int, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.k2, self.cw, self.eps = k2, cw, eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(cw * k2))
        self.bias = nn.Parameter(torch.empty(cw * k2))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def _stats(self, x):
        n, _, h, w = x.shape
        xf = x.float().reshape(n, self.cw, self.k2 * h * w)
        mean = xf.mean(-1)
        var = (xf.square().mean(-1) - mean.square()).clamp_min(0.0)
        return mean, torch.reciprocal(torch.sqrt(var + self.eps))  # [n, cw]

    def forward(self, x):
        """The normalized tensor, in the compute dtype."""
        with torch.no_grad():
            mean, inv = self._stats(x)
        return _GroupNormFn.apply(x.contiguous(), self.weight, self.bias,
                                  mean, inv, self.cw, self.dtype)

    def fold(self, x):
        """Deferred normalize: ``(s, b)`` of shape ``[N, 1, Cw, K^2]`` f32 with
        ``GN(x) == x*s + b`` per (n, cw, k), for local_aggregate's
        ``w_scale``/``w_bias``.  ``b = beta - mean*s`` cancels where
        |mean| >> std, so the fold carries more f32 rounding there than the
        materialized form (see ``cotnet_tpu/nn/norm.py``'s note).  The
        statistics are plain autograd, so gradients arriving at s and b
        flow on to x, ``weight`` and ``bias``; autograd keeps an f32 copy of
        x for that."""
        n = x.shape[0]
        mean, inv = self._stats(x)
        g = self.weight.view(1, self.cw, self.k2)
        be = self.bias.view(1, self.cw, self.k2)
        s = inv[..., None] * g
        b = be - mean[..., None] * s
        return s.view(n, 1, self.cw, self.k2), b.view(n, 1, self.cw, self.k2)

    def raw(self):
        """``(weight, bias)`` alone, for ``local_aggregate_embed_gn``."""
        return self.weight, self.bias


class GroupNorm(nn.Module):
    """``flax.linen.GroupNorm(num_groups=32, epsilon=1e-5)`` on NCHW, the
    norm of the ResNetV2 family (``cotnet_tpu/models/resnetv2.py:66, 93,
    260``), with its arithmetic: per (image, group) over (C/groups, H, W)
    the f32 statistics in one pass, ``var = max(E[x^2] - E[x]^2, 0)``
    (flax's ``use_fast_variance=True`` default), then ``(x - mean) *
    (rsqrt(var + eps) * weight) + bias`` in f32 and one rounding to the
    compute dtype.  The one-pass variance cancels where |mean| >> std, in
    both packages; ``torch.nn.GroupNorm`` takes the two-pass form.
    Parameters ``weight``/``bias`` ``[C]``."""

    def __init__(self, num_channels: int, num_groups: int = 32,
                 eps: float = 1e-5, dtype: torch.dtype = torch.float32):
        super().__init__()
        if num_channels % num_groups:
            raise ValueError(f"{num_channels} channels do not split into "
                             f"{num_groups} groups")
        self.num_groups, self.eps, self.dtype = num_groups, eps, dtype
        self.weight = nn.Parameter(torch.empty(num_channels))
        self.bias = nn.Parameter(torch.empty(num_channels))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        n, c = x.shape[:2]
        xf = x.float().reshape(n, self.num_groups, -1)
        mean = xf.mean(-1, keepdim=True)
        var = (xf.square().mean(-1, keepdim=True)
               - mean.square()).clamp_min(0.0)
        shape = (1, self.num_groups, c // self.num_groups, 1)
        mul = torch.rsqrt(var + self.eps)[..., None] * self.weight.view(shape)
        y = ((xf - mean).view(n, *shape[1:3], -1) * mul
             + self.bias.view(shape))
        return y.view(x.shape).to(self.dtype)


class LayerNorm(nn.Module):
    """LayerNorm over the last dim, ``cotnet_tpu/nn/norm.py:260-271``:
    f32 statistics with the two-pass variance ``E[(x - mean)^2]`` (tokens
    after a residual add have |mean| >> std, where the one-pass form
    cancels), ``(x - mean) * (rsqrt(var + eps) * weight) + bias`` in f32,
    one rounding to the compute dtype.  ViT takes eps 1e-6."""

    def __init__(self, dim: int, eps: float = 1e-6,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        centred = xf - mean
        var = centred.square().mean(-1, keepdim=True)
        y = centred * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(self.dtype)
