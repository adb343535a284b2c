"""Channel and spatial attention modules and their string factory,
counterpart of ``cotnet_tpu/nn/attn.py`` (reference
models/layers/{se.py, eca.py, cbam.py, create_attn.py:11-37}), on NCHW.

The state_dict names are those the JAX package's converter maps
(``convert_torch_state_dict``): SE's ``fc1``/``fc2`` (1x1 convs with bias,
the reference's), eSE's ``fc``, ECA's ``conv`` (a ``[1, 1, k]`` Conv1d
weight), CBAM's ``fc1``/``fc2`` (1x1 convs without bias) and its
spatial ``spatial.conv`` / ``spatial.bn``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from cotnet_tpu_torch.nn.activations import get_act_fn
from cotnet_tpu_torch.nn.conv import Conv2d
from cotnet_tpu_torch.nn.norm import BatchNorm2d


def _squeeze(x):
    """The spatial mean, ``[N, C, 1, 1]``."""
    return x.mean((2, 3), keepdim=True)


class SEModule(nn.Module):
    """Squeeze-and-excitation (reference se.py:5-22): the pooled vector
    through ``fc1`` (to ``reduction_channels``, or ``max(C / reduction,
    min_channels)``), ``act`` (BN first with ``norm``, SEWithNorm), ``fc2``
    and ``gate`` scales the channels."""

    def __init__(self, channels: int, reduction: int = 16,
                 min_channels: int = 8,
                 reduction_channels: Optional[int] = None, act: str = "relu",
                 gate: str = "sigmoid", norm: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        rc = reduction_channels or max(channels // reduction, min_channels)
        self.fc1 = Conv2d(channels, rc, 1, bias=True, dtype=dtype)
        self.bn = BatchNorm2d(rc, dtype=dtype) if norm else None
        self.fc2 = Conv2d(rc, channels, 1, bias=True, dtype=dtype)
        self.act, self.gate = get_act_fn(act), get_act_fn(gate)

    def forward(self, x):
        s = self.fc1(_squeeze(x))
        if self.bn is not None:
            s = self.bn(s)
        return x * self.gate(self.fc2(self.act(s)))


class EffectiveSEModule(nn.Module):
    """eSE from CenterMask (reference se.py:25-37): one 1x1 conv ``fc`` on
    the pooled vector, ``gate`` hard-sigmoid."""

    def __init__(self, channels: int, gate: str = "hard_sigmoid",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc = Conv2d(channels, channels, 1, bias=True, dtype=dtype)
        self.gate = get_act_fn(gate)

    def forward(self, x):
        return x * self.gate(self.fc(_squeeze(x)))


def _eca_kernel_size(channels, kernel_size, gamma, beta):
    if channels is not None:
        t = int(abs(math.log(channels, 2) + beta) / gamma)
        kernel_size = max(t if t % 2 else t + 1, 3)
    return kernel_size


class Conv1d(nn.Module):
    """One-channel 1-D conv without bias, weight ``[1, 1, k]``
    (``torch.nn.Conv1d(1, 1, k, bias=False)``'s state_dict), padded by the
    caller."""

    def __init__(self, kernel_size: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(1, 1, kernel_size))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            k = self.weight.shape[-1]
            self.weight.uniform_(-1 / math.sqrt(k), 1 / math.sqrt(k),
                                 generator=generator)

    def forward(self, x):
        return F.conv1d(x.to(self.dtype), self.weight.to(self.dtype))


class EcaModule(nn.Module):
    """Efficient channel attention (reference eca.py:41-65): a 1-D conv of
    ``k`` taps across the pooled channel vector (``k`` from the channel
    count where it is given), zero-padded, or wrapped around with
    ``circular`` (CecaModule, eca.py:68-108), then a sigmoid gate."""

    def __init__(self, channels: Optional[int] = None, kernel_size: int = 3,
                 gamma: float = 2, beta: float = 1, circular: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.k = _eca_kernel_size(channels, kernel_size, gamma, beta)
        self.circular = circular
        self.conv = Conv1d(self.k, dtype)

    def forward(self, x):
        n, c = x.shape[:2]
        s = x.mean((2, 3))[:, None, :]  # [N, 1, C]
        pad = (self.k - 1) // 2
        if self.circular:
            s = torch.cat([s[..., c - pad:], s, s[..., :pad]], dim=-1)
        else:
            s = F.pad(s, (pad, pad))
        return x * torch.sigmoid(self.conv(s)).view(n, c, 1, 1)


class ConvBn(nn.Module):
    """Conv (no bias) + BN as ``conv`` / ``bn``, the JAX package's
    ``ConvBnAct(act=None)``; CBAM's spatial attention."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 padding: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(in_channels, out_channels, kernel_size, 1, padding,
                           dtype=dtype)
        self.bn = BatchNorm2d(out_channels, dtype=dtype)

    def forward(self, x):
        return self.bn(self.conv(x))


class CbamModule(nn.Module):
    """CBAM (reference cbam.py:19-99): channel attention (a shared MLP
    ``fc1``/``fc2`` over the spatial mean and max, summed; with ``light``
    over their average), then spatial attention (a ``spatial_kernel`` conv
    and BN over the channel mean and max)."""

    def __init__(self, channels: int, reduction: int = 16,
                 spatial_kernel: int = 7, light: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        rc = channels // reduction
        self.light = light
        self.fc1 = Conv2d(channels, rc, 1, dtype=dtype)
        self.fc2 = Conv2d(rc, channels, 1, dtype=dtype)
        self.spatial = ConvBn(2, 1, spatial_kernel,
                              (spatial_kernel - 1) // 2, dtype)

    def forward(self, x):
        avg, mx = _squeeze(x), x.amax((2, 3), keepdim=True)

        def mlp(s):
            return self.fc2(F.relu(self.fc1(s)))

        if self.light:
            attn = mlp(0.5 * avg + 0.5 * mx)
        else:
            attn = mlp(avg) + mlp(mx)
        x = x * torch.sigmoid(attn)
        s = torch.cat([x.mean(1, keepdim=True), x.amax(1, keepdim=True)],
                      dim=1)
        return x * torch.sigmoid(self.spatial(s))


_ATTN = {
    "se": SEModule,
    "ese": EffectiveSEModule,
    "eca": EcaModule,
    "ceca": lambda channels, **kw: EcaModule(channels, circular=True, **kw),
    "cbam": CbamModule,
    "lcbam": lambda channels, **kw: CbamModule(channels, light=True, **kw),
}


def create_attn(attn_type, channels: int, **kwargs) -> Optional[nn.Module]:
    """String -> attention module (reference create_attn.py:11-37): None or
    False for none, True for SE, a key of ``se``, ``ese``, ``eca``,
    ``ceca``, ``cbam``, ``lcbam``, or a module class."""
    if attn_type is None or attn_type is False:
        return None
    if attn_type is True:
        attn_type = "se"
    if isinstance(attn_type, str):
        cls = _ATTN.get(attn_type.lower())
        if cls is None:
            raise ValueError(f"invalid attn module {attn_type!r}")
        return cls(channels, **kwargs)
    return attn_type(channels, **kwargs)
