"""Anti-aliased downsampling, counterpart of ``cotnet_tpu/nn/blur_pool.py``
(reference models/layers/blur_pool.py): reflection pad, then a fixed
depthwise binomial filter at a stride.  SE-CoTNetD-152 and deeper use it as
the ``avd`` pool of their strided blocks.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cotnet_tpu_torch.nn.conv import get_padding


def binomial_filter(filt_size: int) -> torch.Tensor:
    """The normalized 2-D binomial filter ``[k, k]``."""
    coeffs = np.poly1d((0.5, 0.5)) ** (filt_size - 1)
    f1 = torch.tensor(coeffs.coeffs, dtype=torch.float32)
    return f1[:, None] * f1[None, :]


class BlurPool2d(nn.Module):
    """Blur and subsample NCHW.  The filter is a non-persistent buffer: not
    learned and not in the state_dict, as the JAX package's converter
    assumes (``utils/convert.py:464-465``).  ``channels`` is unused (the
    filter is applied per channel, whatever their number)."""

    def __init__(self, channels: int = 0, filt_size: int = 3,
                 stride: int = 2):
        super().__init__()
        if filt_size < 2:
            raise ValueError(f"filt_size {filt_size}: need at least 2")
        self.stride = stride
        self.pad = get_padding(filt_size, stride)
        self.register_buffer("filt", binomial_filter(filt_size),
                             persistent=False)

    def forward(self, x):
        c = x.shape[1]
        k = self.filt.to(x.dtype).expand(c, 1, *self.filt.shape)
        xp = F.pad(x, (self.pad,) * 4, mode="reflect")
        return F.conv2d(xp, k, stride=self.stride, groups=c)
