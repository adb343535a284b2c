"""Host-side geometric transforms (PIL), feeding uint8 NHWC to the device;
counterpart of ``cotnet_tpu/data/transforms.py``.

Reference: datasets/transforms.py (RandomResizedCropAndInterpolation with
random interpolation choice) and transforms_factory.py:132-166 (eval resize
by crop_pct + center crop).  The policy augments run after the crop and
flips, on the host by default (``host_augment.py``) or on the device
(``rand_augment.py``, ``auto_augment.py``); normalize and random erasing run
on the device (``loader.make_device_augment``).  Every draw here comes from
Python's global ``random``, which the loader seeds per sample in its worker
processes.
"""

from __future__ import annotations

import math
import random
from typing import Optional, Tuple

import numpy as np

_PIL_INTERP = {}


def _interp(name: str):
    from PIL import Image

    if not _PIL_INTERP:
        R = Image.Resampling
        _PIL_INTERP.update({
            "nearest": R.NEAREST, "bilinear": R.BILINEAR,
            "bicubic": R.BICUBIC, "lanczos": R.LANCZOS,
        })
    return _PIL_INTERP[name]


_RANDOM_INTERP = ("bilinear", "bicubic")


class RandomResizedCropAndInterpolation:
    """Random scale/aspect crop + resize; interpolation='random' picks
    bilinear/bicubic per call (reference transforms.py)."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3. / 4., 4. / 3.),
                 interpolation: str = "bilinear"):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.scale, self.ratio = scale, ratio
        self.interpolation = interpolation

    def get_params(self, img):
        w, h = img.size
        area = w * h
        for _ in range(10):
            target_area = random.uniform(*self.scale) * area
            log_ratio = (math.log(self.ratio[0]), math.log(self.ratio[1]))
            aspect = math.exp(random.uniform(*log_ratio))
            cw = int(round(math.sqrt(target_area * aspect)))
            ch = int(round(math.sqrt(target_area / aspect)))
            if cw <= w and ch <= h:
                x = random.randint(0, w - cw)
                y = random.randint(0, h - ch)
                return x, y, cw, ch
        # fallback: center crop at the feasible aspect
        in_ratio = w / h
        if in_ratio < self.ratio[0]:
            cw, ch = w, int(round(w / self.ratio[0]))
        elif in_ratio > self.ratio[1]:
            ch, cw = h, int(round(h * self.ratio[1]))
        else:
            cw, ch = w, h
        return (w - cw) // 2, (h - ch) // 2, cw, ch

    def __call__(self, img):
        x, y, cw, ch = self.get_params(img)
        interp = (random.choice(_RANDOM_INTERP)
                  if self.interpolation == "random" else self.interpolation)
        return img.resize(self.size, _interp(interp),
                          box=(x, y, x + cw, y + ch))


class RandomHorizontalFlip:
    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, img):
        from PIL import Image

        if random.random() < self.p:
            return img.transpose(Image.Transpose.FLIP_LEFT_RIGHT)
        return img


class RandomVerticalFlip:
    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, img):
        from PIL import Image

        if random.random() < self.p:
            return img.transpose(Image.Transpose.FLIP_TOP_BOTTOM)
        return img


class ResizeCenterCrop:
    """Eval path: resize shorter side to size/crop_pct, center crop
    (transforms_factory.py:132-166).

    Implemented as ONE ``resize(box=...)`` of the source region the final
    crop maps to — PIL's resample filter weights are a function of absolute
    source coordinates, so sampling the box directly produces the same
    pixels as resize-whole-then-crop (pinned by tests/test_data.py) while
    resampling size^2 output pixels instead of scale_size x long-side
    (~1.7x less resample work at 4:3)."""

    def __init__(self, size: int, crop_pct: float = 0.875,
                 interpolation: str = "bicubic"):
        self.size = size
        self.scale_size = int(math.floor(size / crop_pct))
        self.interpolation = interpolation

    def __call__(self, img):
        w, h = img.size
        short = min(w, h)
        ratio = self.scale_size / short
        nw, nh = int(round(w * ratio)), int(round(h * ratio))
        left = (nw - self.size) // 2
        top = (nh - self.size) // 2
        box = (left * w / nw, top * h / nh,
               (left + self.size) * w / nw, (top + self.size) * h / nh)
        return img.resize((self.size, self.size),
                          _interp(self.interpolation), box=box)


class ColorJitter:
    """Brightness/contrast/saturation jitter (the reference's non-AA branch,
    transforms_factory.py:60-75: color_jitter=0.4 when no RandAugment)."""

    def __init__(self, brightness=0.4, contrast=0.4, saturation=0.4):
        self.params = [("Brightness", brightness), ("Contrast", contrast),
                       ("Color", saturation)]

    def __call__(self, img):
        from PIL import ImageEnhance

        order = list(range(len(self.params)))
        random.shuffle(order)
        for i in order:
            name, amount = self.params[i]
            if amount > 0:
                factor = random.uniform(max(0.0, 1 - amount), 1 + amount)
                img = getattr(ImageEnhance, name)(img).enhance(factor)
        return img


class ToUint8:
    """PIL -> uint8 numpy HWC (device does normalize — mirrors the
    reference's PrefetchLoader GPU normalize, loader.py:54-125)."""

    def __call__(self, img):
        return np.asarray(img, dtype=np.uint8)


class Compose:
    def __init__(self, fns):
        self.fns = list(fns)

    def __call__(self, x):
        for f in self.fns:
            x = f(x)
        return x


def create_train_transform(size: int, scale=(0.08, 1.0), ratio=(3/4, 4/3),
                           hflip: float = 0.5, vflip: float = 0.0,
                           interpolation: str = "random",
                           color_jitter: Optional[float] = None,
                           policy_augment=None):
    """``policy_augment``: optional PIL-image callable (HostRandAugment /
    HostAutoAugment / HostAugMix) applied after crop/flip, matching the
    reference transform order (transforms_factory.py:80-98)."""
    fns = [RandomResizedCropAndInterpolation(size, scale, ratio, interpolation)]
    if hflip > 0:
        fns.append(RandomHorizontalFlip(hflip))
    if vflip > 0:
        fns.append(RandomVerticalFlip(vflip))
    if policy_augment is not None:
        fns.append(policy_augment)
    elif color_jitter:
        # only when RandAugment is off (transforms_factory.py:86-98)
        fns.append(ColorJitter(color_jitter, color_jitter, color_jitter))
    fns.append(ToUint8())
    return Compose(fns)


def create_eval_transform(size: int, crop_pct: float = 0.875,
                          interpolation: str = "bicubic"):
    return Compose([ResizeCenterCrop(size, crop_pct, interpolation), ToUint8()])
