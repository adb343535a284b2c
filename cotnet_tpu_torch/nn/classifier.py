"""Classifier head (reference models/layers/classifier.py:10-26),
counterpart of ``cotnet_tpu/nn/classifier.py``."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from cotnet_tpu_torch.nn.drop import Dropout
from cotnet_tpu_torch.nn.pool import global_pool2d


class ClassifierHead(nn.Module):
    """Global pool + dropout + linear.  The module holds the linear's own ``weight``
    ``[num_classes, in_features]`` and ``bias``, so a chassis that stores it
    as ``fc`` has the reference's ``fc.weight``/``fc.bias`` keys.
    ``in_features`` is the channels before the pool: ``catavgmax`` doubles
    them.  With the identity pool the linear maps the channels of each
    place, ``[N, C, H, W]`` -> ``[N, H, W, num_classes]`` (the JAX head's
    NHWC result)."""

    def __init__(self, in_features: int, num_classes: int = 1000,
                 pool_type: str = "avg", drop_rate: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pool_type = pool_type
        self.drop = Dropout(drop_rate)
        self.dtype = dtype
        if pool_type == "catavgmax":
            in_features *= 2
        self.weight = nn.Parameter(torch.empty(num_classes, in_features))
        self.bias = nn.Parameter(torch.empty(num_classes))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.weight.normal_(0.0, 1.0 / math.sqrt(self.weight.shape[1]),
                                generator=generator)
            self.bias.zero_()

    def forward(self, x):
        dt = self.dtype
        x = global_pool2d(x, self.pool_type)
        if x.dim() == 4:  # the identity pool: channels last
            x = x.movedim(1, -1)
        x = self.drop(x)
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))
