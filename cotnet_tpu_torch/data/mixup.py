"""Mixup / CutMix with soft-label generation, counterpart of
``cotnet_tpu/data/mixup.py`` (reference datasets/mixup.py).

Runs on the batch where it lies (NCHW images and int labels on one device),
inside the train step, and never reads a drawn value back to the host: lam,
the mixup/cutmix switch and the box stay device tensors.  ``Mixup.sample``
draws them from an explicit ``torch.Generator``; ``Mixup.apply`` is the
deterministic rest, so the two can be tested apart.

Modes: ``'batch'`` (one lam for the whole batch), and ``'elem'`` and
``'pair'`` (one per sample; in the JAX package ``'pair'`` is exactly
``'elem'``, ``cotnet_tpu/data/mixup.py:92``); all mix with the flipped
batch.  The reference's semantics: mixup
OR cutmix per draw via ``switch_prob``, lam from Beta(alpha, alpha), the
cutmix box per rand_bbox (mixup.py:30-55), and soft targets
``lam * y + (1 - lam) * y_flipped`` with label smoothing (mixup.py:17-28).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def one_hot_smooth(labels, num_classes: int, smoothing: float = 0.0,
                   dtype: torch.dtype = torch.float32):
    on = 1.0 - smoothing + smoothing / num_classes
    off = smoothing / num_classes
    return F.one_hot(labels, num_classes).to(dtype) * (on - off) + off


def _rand_bbox(h: int, w: int, lam, cy, cx):
    """Cut box of area ratio (1 - lam) centred at (cy, cx), clipped at the
    borders (mixup.py:30-55).  Returns int tensors (yl, yh, xl, xh) of
    lam's shape."""
    ratio = torch.sqrt(1.0 - lam)
    cut_h = (h * ratio).to(torch.int64)
    cut_w = (w * ratio).to(torch.int64)
    yl = (cy - cut_h // 2).clamp(0, h)
    yh = (cy + cut_h // 2).clamp(0, h)
    xl = (cx - cut_w // 2).clamp(0, w)
    xh = (cx + cut_w // 2).clamp(0, w)
    return yl, yh, xl, xh


class Mixup:
    """Callable (images NCHW, int labels, generator) -> (mixed images, soft
    targets).

    Args mirror the reference Mixup (mixup.py:90-121): mixup_alpha,
    cutmix_alpha, cutmix_minmax, prob, switch_prob, mode, correct_lam,
    label_smoothing, num_classes.  ``cutmix_minmax`` is stored so that a
    config carrying it is accepted; neither this package nor the JAX one
    reads it (the box follows lam).
    """

    def __init__(self, mixup_alpha=1.0, cutmix_alpha=0.0, cutmix_minmax=None,
                 prob=1.0, switch_prob=0.5, mode="batch", correct_lam=True,
                 label_smoothing=0.1, num_classes=1000):
        if mode not in ("batch", "elem", "pair"):
            raise ValueError(f"unknown mixup mode {mode!r}")
        self.mixup_alpha = mixup_alpha
        self.cutmix_alpha = cutmix_alpha
        self.cutmix_minmax = cutmix_minmax
        self.mix_prob = prob
        self.switch_prob = switch_prob
        self.mode = mode
        self.correct_lam = correct_lam
        self.label_smoothing = label_smoothing
        self.num_classes = num_classes

    def sample(self, n: int, h: int, w: int, device,
               generator: Optional[torch.Generator] = None):
        """Draw ``(lam, use_cutmix, box)``: lam f32 and use_cutmix bool of
        shape ``[n]`` in modes 'elem' and 'pair' and ``[]`` in mode 'batch',
        box the int
        tensors (yl, yh, xl, xh) of the same shape."""
        shape = () if self.mode == "batch" else (n,)

        def rand():
            return torch.rand(shape, generator=generator, device=device)

        use_mixup = self.mixup_alpha > 0.0
        use_cutmix_any = self.cutmix_alpha > 0.0
        if use_mixup and use_cutmix_any:
            use_cutmix = rand() < self.switch_prob
        else:
            use_cutmix = torch.full(shape, use_cutmix_any, dtype=torch.bool,
                                    device=device)
        if use_mixup or use_cutmix_any:
            alpha = torch.where(use_cutmix, float(self.cutmix_alpha),
                                float(self.mixup_alpha))
            # Beta(alpha, alpha) as a ratio of two Gamma(alpha, 1) draws
            ga = torch._standard_gamma(alpha, generator=generator)
            gb = torch._standard_gamma(alpha, generator=generator)
            lam = ga / (ga + gb)
            lam = torch.where(rand() < self.mix_prob, lam,
                              torch.ones_like(lam))
        else:
            lam = torch.ones(shape, device=device)
        cy = torch.randint(0, h, shape, generator=generator, device=device)
        cx = torch.randint(0, w, shape, generator=generator, device=device)
        return lam, use_cutmix, _rand_bbox(h, w, lam, cy, cx)

    def apply(self, images, labels, lam, use_cutmix,
              box: Tuple[torch.Tensor, ...]):
        """Mix ``images`` with the flipped batch given the drawn values."""
        n, _, h, w = images.shape
        yl, yh, xl, xh = box
        if self.correct_lam:
            lam_cut = 1.0 - ((yh - yl) * (xh - xl)).float() / float(h * w)
        else:
            lam_cut = lam
        flipped = images.flip(0)
        ys = torch.arange(h, device=images.device)[:, None]
        xs = torch.arange(w, device=images.device)[None, :]
        if lam.dim():      # per sample: [n] -> [n, 1, 1, 1]
            yl, yh, xl, xh, lam_b, cut_b = (
                t[:, None, None, None] for t in (yl, yh, xl, xh, lam,
                                                 use_cutmix))
        else:
            lam_b, cut_b = lam, use_cutmix
        in_box = (ys >= yl) & (ys < yh) & (xs >= xl) & (xs < xh)
        mixed_mix = images * lam_b + flipped * (1.0 - lam_b)
        mixed_cut = torch.where(in_box, flipped, images)
        out = torch.where(cut_b, mixed_cut, mixed_mix.to(images.dtype))

        lam_eff = torch.where(use_cutmix, lam_cut, lam)
        y1 = one_hot_smooth(labels, self.num_classes, self.label_smoothing)
        y2 = one_hot_smooth(labels.flip(0), self.num_classes,
                            self.label_smoothing)
        lam_t = lam_eff[:, None] if lam.dim() else lam_eff
        return out, y1 * lam_t + y2 * (1.0 - lam_t)

    def __call__(self, images, labels,
                 generator: Optional[torch.Generator] = None):
        n, _, h, w = images.shape
        lam, use_cutmix, box = self.sample(n, h, w, images.device, generator)
        return self.apply(images, labels, lam, use_cutmix, box)
