"""Host-side (PIL) policy augmentation — RandAugment / AutoAugment / AugMix
running in the loader's worker processes, like the reference
(datasets/rand_augment.py PIL ops, wired by transforms_factory.py:86-98);
counterpart of ``cotnet_tpu/data/host_augment.py``.

This is the loader's default backend (``Loader(aug_backend="host")``); the
device backend is ``rand_augment.py`` / ``auto_augment.py``.  Magnitude
mapping is the device ops': lvl = level/10, enhance factor = lvl*1.8 + 0.1,
rotate 30deg, shear 0.3, translate 100px / 0.45*rel, posterize floor(lvl*4)
bits, solarize floor(lvl*256), solarize_add floor(lvl*110), cutout
floor(lvl*40) px, fill 128.  The module imports neither torch nor PIL until
an op runs: the worker processes unpickle these objects.
"""

from __future__ import annotations

import random
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

from cotnet_tpu_torch.data.policies import (CHOICE_WEIGHTS_0, CUTOUT_CONST,
                                           HOST_AUGMIX_OPS, MAX_LEVEL,
                                           N_BASE_OPS, OP_NAMES, POLICIES,
                                           TRANSLATE_CONST, parse_augmix,
                                           parse_rand)

_FILL = (128, 128, 128)

# Per-sample deterministic RNG (thread-local so the loader's thread-pool
# path is reproducible too): the device path derives every augmentation
# draw from PRNGKey(seed*1000+epoch); the host path mirrors that by having
# the loader install a Random seeded per sample before the transform runs.
# Without an installed rng the module-level `random` is the fallback.
_TLS = threading.local()


def seed_sample_rng(seed: int) -> None:
    """Install a per-sample RNG for the current thread/process.  Called by
    the loader (both the worker-process and thread-pool fetch paths) with a
    seed derived from (loader seed, epoch, sample position)."""
    _TLS.rng = random.Random(seed)


def _rng():
    """The active sample RNG; the `random` module (same call surface) when
    none is installed."""
    return getattr(_TLS, "rng", None) or random


def _pil():
    from PIL import Image
    return Image


def _affine(im, mat):
    Image = _pil()
    return im.transform(im.size, Image.AFFINE, mat,
                        resample=Image.BILINEAR, fillcolor=_FILL)


def _posterize(im, bits: int):
    from PIL import ImageOps
    bits = int(max(0, min(8, bits)))
    if bits >= 8:
        return im
    if bits == 0:
        return im.point([0] * 256 * 3)
    return ImageOps.posterize(im, bits)


def _solarize(im, thresh: float):
    from PIL import ImageOps
    return ImageOps.solarize(im, min(256, int(thresh)))


def _solarize_add(im, add: float, thresh: int = 128):
    add = int(add)
    lut = [min(255, i + add) if i < thresh else i for i in range(256)]
    return im.point(lut * 3)


def _enhance(kind: str, im, factor: float):
    from PIL import ImageEnhance
    return getattr(ImageEnhance, kind)(im).enhance(max(0.0, factor))


def _cutout(im, pixels: float):
    if pixels <= 0:
        return im
    arr = np.asarray(im).copy()
    h, w = arr.shape[:2]
    r = _rng()
    cy, cx = r.randint(0, h - 1), r.randint(0, w - 1)
    p = int(pixels)
    y0, y1 = max(0, cy - p), min(h, cy + p)
    x0, x1 = max(0, cx - p), min(w, cx + p)
    arr[y0:y1, x0:x1] = 128
    from PIL import Image
    return Image.fromarray(arr)


def apply_op(name: str, im, level: float, sign: float):
    """One (already magnitude-sampled) op on a PIL image — the host twin of
    rand_augment._apply_op; same level arithmetic, PIL backends pinned by
    tests/test_augment.py."""
    from PIL import ImageOps
    lvl = level / MAX_LEVEL
    enh = lvl * 1.8 + 0.1
    w, h = im.size
    if name == "AutoContrast":
        return ImageOps.autocontrast(im)
    if name == "Equalize":
        return ImageOps.equalize(im)
    if name == "Invert":
        return ImageOps.invert(im)
    if name == "Rotate":
        return im.rotate(sign * lvl * 30.0, resample=_pil().BILINEAR,
                         fillcolor=_FILL)
    if name == "Posterize":
        return _posterize(im, int(np.floor(lvl * 4)))
    if name == "PosterizeIncreasing":
        return _posterize(im, 4 - int(np.floor(lvl * 4)))
    if name == "PosterizeOriginal":
        return _posterize(im, 4 + int(np.floor(lvl * 4)))
    if name == "Solarize":
        return _solarize(im, np.floor(lvl * 256))
    if name == "SolarizeIncreasing":
        return _solarize(im, 256.0 - np.floor(lvl * 256))
    if name == "SolarizeAdd":
        return _solarize_add(im, np.floor(lvl * 110))
    if name == "Color":
        return _enhance("Color", im, enh)
    if name == "ColorIncreasing":
        return _enhance("Color", im, 1.0 + sign * lvl * 0.9)
    if name == "Contrast":
        return _enhance("Contrast", im, enh)
    if name == "ContrastIncreasing":
        return _enhance("Contrast", im, 1.0 + sign * lvl * 0.9)
    if name == "Brightness":
        return _enhance("Brightness", im, enh)
    if name == "BrightnessIncreasing":
        return _enhance("Brightness", im, 1.0 + sign * lvl * 0.9)
    if name == "Sharpness":
        return _enhance("Sharpness", im, enh)
    if name == "SharpnessIncreasing":
        return _enhance("Sharpness", im, 1.0 + sign * lvl * 0.9)
    if name == "ShearX":
        return _affine(im, (1, sign * lvl * 0.3, 0, 0, 1, 0))
    if name == "ShearY":
        return _affine(im, (1, 0, 0, sign * lvl * 0.3, 1, 0))
    if name == "TranslateX":
        return _affine(im, (1, 0, sign * lvl * TRANSLATE_CONST, 0, 1, 0))
    if name == "TranslateY":
        return _affine(im, (1, 0, 0, 0, 1, sign * lvl * TRANSLATE_CONST))
    if name == "TranslateXRel":
        return _affine(im, (1, 0, sign * lvl * 0.45 * w, 0, 1, 0))
    if name == "TranslateYRel":
        return _affine(im, (1, 0, 0, 0, 1, sign * lvl * 0.45 * h))
    if name == "Cutout":
        return _cutout(im, np.floor(lvl * CUTOUT_CONST))
    raise ValueError(f"unknown op {name}")


class HostRandAugment:
    """PIL RandAugment with the same sampling semantics as the on-device
    RandAugment (rand_augment.py:284-324): per layer pick an op (uniform or
    CHOICE_WEIGHTS_0), mag = m + N(0, mstd) clipped to [0, mmax], random
    sign, apply with prob u1 <= U(min_prob, max_prob)."""

    def __init__(self, magnitude: float = 10, num_layers: int = 2,
                 magnitude_std: float = 0.0, min_prob: float = 0.2,
                 max_prob: float = 0.8, weight_idx: Optional[int] = None,
                 max_magnitude: float = 15.0):
        self.magnitude = float(magnitude)
        self.num_layers = num_layers
        self.magnitude_std = magnitude_std
        self.min_prob, self.max_prob = min_prob, max_prob
        self.weights = CHOICE_WEIGHTS_0 if weight_idx == 0 else None
        self.max_magnitude = max_magnitude
        # must stay twinned with the device RandAugment's sampling space
        self.num_ops = N_BASE_OPS

    def __call__(self, im):
        r = _rng()
        for _ in range(self.num_layers):
            if self.weights is not None:
                name = r.choices(OP_NAMES[:N_BASE_OPS],
                                 weights=self.weights)[0]
            else:
                name = OP_NAMES[r.randrange(N_BASE_OPS)]
            mag = self.magnitude
            if self.magnitude_std > 0:
                mag += r.gauss(0.0, self.magnitude_std)
            mag = min(max(mag, 0.0), self.max_magnitude)
            sign = 1.0 if r.random() < 0.5 else -1.0
            if r.random() <= r.uniform(self.min_prob, self.max_prob):
                im = apply_op(name, im, mag, sign)
        return im


class HostAutoAugment:
    """PIL AutoAugment: pick a sub-policy, apply its (op, prob, mag)
    entries (auto_augment.py policy tables are shared data)."""

    def __init__(self, policy: Sequence[Sequence[Tuple[str, float, int]]]):
        self.policy = [list(sp) for sp in policy]

    def __call__(self, im):
        r = _rng()
        for name, prob, mag in r.choice(self.policy):
            if r.random() > prob:
                continue
            sign = 1.0 if r.random() < 0.5 else -1.0
            im = apply_op(name, im, float(mag), sign)
        return im


class HostAugMix:
    """PIL AugMix: ``width`` chains of depth U[1,depth] ops mixed with
    Dirichlet weights, then Beta-blended with the clean image."""

    def __init__(self, magnitude: float = 3, width: int = 3, depth: int = -1,
                 alpha: float = 1.0):
        self.magnitude = float(magnitude)
        self.width, self.depth, self.alpha = width, depth, alpha
        # AugMix op set: the increasing-curve base ops
        self.ops = HOST_AUGMIX_OPS

    def __call__(self, im):
        from PIL import Image
        r = _rng()
        # Dirichlet/Beta ride the same per-sample stream (not module-level
        # np.random, which the loader's per-chunk reseed doesn't cover)
        npr = np.random.RandomState(r.getrandbits(31))
        ws = np.float32(npr.dirichlet([self.alpha] * self.width))
        m = np.float32(npr.beta(self.alpha, self.alpha))
        mix = np.zeros(np.asarray(im).shape, np.float32)
        for i in range(self.width):
            depth = (self.depth if self.depth > 0
                     else r.randint(1, 3))
            cur = im
            for _ in range(depth):
                name = r.choice(self.ops)
                sign = 1.0 if r.random() < 0.5 else -1.0
                cur = apply_op(name, cur, self.magnitude, sign)
            mix += ws[i] * np.asarray(cur, np.float32)
        out = (1 - m) * np.asarray(im, np.float32) + m * mix
        return Image.fromarray(np.clip(out, 0, 255).astype(np.uint8))


def create_host_augment(config_str: Optional[str]):
    """Host twin of auto_augment.create_batch_augment: dispatch on the
    reference 'aa' config string (transforms_factory.py:86-98)."""
    if not config_str:
        return None
    if config_str.startswith("rand"):
        return HostRandAugment(**parse_rand(config_str))
    if config_str.startswith("augmix"):
        return HostAugMix(**parse_augmix(config_str))
    if config_str not in POLICIES:
        raise ValueError(f"unknown auto-augment policy {config_str}")
    return HostAutoAugment(POLICIES[config_str])
