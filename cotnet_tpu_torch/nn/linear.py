"""Dense layer, counterpart of flax's ``nn.Dense`` as the JAX package's
transformers use it: parameters ``weight`` ``[out, in]`` (torch's layout)
and ``bias``, float32, cast to the compute dtype at use."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class Linear(nn.Module):
    """``F.linear`` in the module's compute dtype; the initialization is
    flax's default for ``Dense``, LeCun normal (std ``1/sqrt(in)``), with a
    zero bias."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.weight.normal_(0.0, self.weight.shape[1] ** -0.5,
                                generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x):
        dt = self.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)
