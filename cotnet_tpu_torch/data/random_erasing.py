"""RandomErasing on the device, in torch; counterpart of
``cotnet_tpu/data/random_erasing.py`` (reference
datasets/random_erasing.py:25-97).

Operates on *normalized* float NCHW batches (the reference erases after the
PrefetchLoader's GPU normalize).  Modes: 'const' (zeros), 'rand' (one normal
value per channel), 'pixel' (per-pixel normal noise — the recipes' mode).
``count`` erase rectangles are attempted per sample; area/aspect sampled
like the reference (area 2%-33%, log-uniform aspect 0.3..3.33).  With
``num_splits`` > 1 the first split of the batch is kept clean.

``draw(generator, n, h, w)`` makes every random value of a batch and
``apply(x, draws)`` is deterministic.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch


class RandomErasing:
    def __init__(self, probability: float = 0.5, min_area: float = 0.02,
                 max_area: float = 1 / 3, min_aspect: float = 0.3,
                 max_aspect=None, mode: str = "const", count: int = 1,
                 num_splits: int = 0):
        self.probability = probability
        self.min_area, self.max_area = min_area, max_area
        max_aspect = max_aspect or 1 / min_aspect
        self.log_aspect = (math.log(min_aspect), math.log(max_aspect))
        if mode not in ("const", "rand", "pixel"):
            raise ValueError(f"unknown random erasing mode {mode!r}")
        self.mode = mode
        self.count = count
        self.num_splits = num_splits  # first split kept clean (aug-splits)

    @staticmethod
    def rect_size(target, aspect, h: int, w: int):
        """(height, width) of the rectangles of area ``target`` (pixels)
        and aspect ``aspect``, rounded and clipped to the image."""
        eh = torch.clamp(torch.round(torch.sqrt(target * aspect)), 1, h)
        ew = torch.clamp(torch.round(torch.sqrt(target / aspect)), 1, w)
        return eh.to(torch.int32), ew.to(torch.int32)

    def draw(self, generator: Optional[torch.Generator], n: int, c: int,
             h: int, w: int, device=None) -> Dict[str, torch.Tensor]:
        """``[count, n]`` each: ``enabled``, ``target`` (the area in
        pixels), ``aspect``, ``y0`` and ``x0`` (the corner, uniform over
        the places the rectangle fits, int); ``fill``, ``[count, n, c, h,
        w]`` in mode 'pixel', ``[count, n, c, 1, 1]`` in 'rand', absent in
        'const'."""
        device = generator.device if generator is not None else device
        shape = (self.count, n)

        def uniform(lo=0.0, hi=1.0):
            return lo + torch.rand(shape, generator=generator,
                                   device=device) * (hi - lo)

        area = float(h * w)
        enabled = uniform() < self.probability
        target = uniform(self.min_area, self.max_area) * area / self.count
        aspect = torch.exp(uniform(*self.log_aspect))
        eh, ew = self.rect_size(target, aspect, h, w)
        y0 = (uniform() * torch.clamp(h - eh, min=1)).to(torch.int32)
        x0 = (uniform() * torch.clamp(w - ew, min=1)).to(torch.int32)
        draws = {"enabled": enabled, "target": target, "aspect": aspect,
                 "y0": y0, "x0": x0}
        if self.mode == "pixel":
            draws["fill"] = torch.randn((*shape, c, h, w),
                                        generator=generator, device=device)
        elif self.mode == "rand":
            draws["fill"] = torch.randn((*shape, c, 1, 1),
                                        generator=generator, device=device)
        return draws

    def apply(self, batch, draws: Dict[str, torch.Tensor]):
        draws = {k: v.to(batch.device) for k, v in draws.items()}
        n, _, h, w = batch.shape
        ys = torch.arange(h, device=batch.device)[None, :, None]
        xs = torch.arange(w, device=batch.device)[None, None, :]
        out = batch
        for i in range(self.count):
            eh, ew = self.rect_size(draws["target"][i], draws["aspect"][i],
                                    h, w)
            y0, x0 = draws["y0"][i], draws["x0"][i]
            inside = ((ys >= y0[:, None, None])
                      & (ys < (y0 + eh)[:, None, None])
                      & (xs >= x0[:, None, None])
                      & (xs < (x0 + ew)[:, None, None])
                      & draws["enabled"][i][:, None, None])
            fill = (draws["fill"][i].to(batch.dtype) if "fill" in draws
                    else torch.zeros((), dtype=batch.dtype,
                                     device=batch.device))
            out = torch.where(inside[:, None], fill, out)
        if self.num_splits > 1:
            # keep the first aug split clean (random_erasing.py:88-93)
            split = n // self.num_splits
            out = torch.cat([batch[:split], out[split:]])
        return out

    def __call__(self, batch, generator: Optional[torch.Generator] = None):
        if self.probability <= 0:
            return batch
        n, c, h, w = batch.shape
        return self.apply(batch, self.draw(generator, n, c, h, w,
                                           batch.device))
