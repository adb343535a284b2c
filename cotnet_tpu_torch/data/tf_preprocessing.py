"""TF-style preprocessing, both train and eval, without a TF dependency
(reference datasets/tf_preprocessing.py:36-236 embeds an actual TF graph);
counterpart of ``cotnet_tpu/data/tf_preprocessing.py``.

Eval (reference ``_decode_and_center_crop``, tf_preprocessing.py:117-135):
square center crop of side ``round(size/(size+CROP_PADDING) * min(h, w))``
with the TF ``(delta+1)//2`` offset rounding, then resize to (size, size).
Note this is a *square* crop of the min side — not an independent 0.875
fraction per axis.

Train (reference ``_decode_and_random_crop``, tf_preprocessing.py:95-114):
``tf.image.sample_distorted_bounding_box`` semantics over the whole image —
up to ``max_attempts`` tries sampling (aspect ratio, area, offset) under the
(aspect_ratio_range, area_range, min_object_covered) constraints; on failure
fall back to the eval center crop.  Then resize and random hflip.  RNG bit
parity with TF is impossible (different generators); the sampled crop
*distribution* follows the same algorithm as TF's
sample_distorted_bounding_box kernel.
"""

from __future__ import annotations

import math

import numpy as np

CROP_PADDING = 32  # reference tf_preprocessing.py:33


def _interp(name):
    from cotnet_tpu_torch.data.transforms import _interp as interp

    return interp(name)


_CUBIC_A = -0.5        # Keys kernel, tf.image.resize v2 bicubic
_CUBIC_TABLE = 1024    # TF quantizes the cubic coefficients to a 1024-entry
#                        LUT (resize_bicubic kernel) — emulating it makes the
#                        port bit-faithful (~1e-7 vs ~6e-4 with exact coeffs)


def _resize_weights_1d(in_size: int, out_size: int, method: str):
    """(idx [out,T], w [out,T]) of tf.image.resize's effective 1-D weights.

    Matches TF v2 semantics (half-pixel centers, antialias=False): sample
    coordinates computed in float32, bicubic coefficients through the
    kernel's quantized table, out-of-range taps dropped and the remaining
    weights renormalized.  Validated against tf.image.resize to <=2e-7 per
    weight across up/down-scales (see tests/test_data.py goldens)."""
    scale = np.float32(in_size / out_size)
    x = ((np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * scale
         - np.float32(0.5)).astype(np.float64)
    base = np.floor(x).astype(np.int64)
    frac = x - base
    if method == "bilinear":
        offsets = np.array([0, 1])
        w = np.stack([1.0 - frac, frac], -1)
    elif method == "bicubic":
        k, a = _CUBIC_TABLE, _CUBIC_A
        i = np.arange(k + 1) / k
        tab0 = ((a + 2) * i - (a + 3)) * i * i + 1        # kernel(t), t in [0,1]
        x1 = i + 1.0
        tab1 = a * (((x1 - 5) * x1 + 8) * x1 - 4)         # kernel(t+1), [1,2]
        off = np.round(frac * k).astype(np.int64)
        offsets = np.array([-1, 0, 1, 2])
        w = np.stack([tab1[off], tab0[off], tab0[k - off], tab1[k - off]], -1)
    else:
        raise ValueError(f"unknown resize method {method!r}")
    idx_raw = base[:, None] + offsets[None, :]
    valid = (idx_raw >= 0) & (idx_raw < in_size)
    w = np.where(valid, w, 0.0)
    w = w / w.sum(-1, keepdims=True)
    return np.clip(idx_raw, 0, in_size - 1), w


def tf_resize(img: np.ndarray, out_h: int, out_w: int,
              method: str = "bicubic") -> np.ndarray:
    """Bit-faithful numpy port of ``tf.image.resize(img, [h, w], method)``
    (v2 semantics, antialias=False) — the resize inside the reference's TF
    preprocessing graph (tf_preprocessing.py:133,157).  HWC float in/out."""
    out = np.asarray(img, np.float32)
    for axis, osz in ((0, out_h), (1, out_w)):
        idx, w = _resize_weights_1d(out.shape[axis], osz, method)
        taps = np.take(out, idx, axis=axis)       # axis -> (osz, T)
        w_shape = [1] * taps.ndim
        w_shape[axis], w_shape[axis + 1] = idx.shape
        out = (taps * w.reshape(w_shape)).sum(axis=axis + 1,
                                              dtype=np.float32)
    return out


def tf_center_crop_box(width: int, height: int, size: int):
    """The TF eval crop window (left, top, side)."""
    side = int((size / (size + CROP_PADDING)) * min(width, height))
    top = ((height - side) + 1) // 2
    left = ((width - side) + 1) // 2
    return left, top, side


class TfEvalPreprocess:
    def __init__(self, size: int, interpolation: str = "bicubic",
                 central_fraction: float = None):
        # central_fraction kept for API compat; the TF path derives the
        # fraction from CROP_PADDING (224 -> 224/256 = 0.875 of min side)
        self.size = size
        self.interpolation = interpolation

    def __call__(self, img):
        w, h = img.size
        left, top, side = tf_center_crop_box(w, h, self.size)
        img = img.convert("RGB").crop((left, top, left + side, top + side))
        # the reference resizes in float32 TF then rounds to uint8
        # (TfPreprocessTransform.__call__, tf_preprocessing.py:228-232)
        out = tf_resize(np.asarray(img, np.float32), self.size, self.size,
                        self.interpolation)
        return np.clip(np.round(out), 0, 255).astype(np.uint8)


class TfTrainPreprocess:
    """Inception-style distorted-bbox crop with TF's sampling algorithm
    (sample_distorted_bounding_box over the full-image bbox) + hflip."""

    def __init__(self, size: int, interpolation: str = "bicubic",
                 area_range=(0.08, 1.0), aspect_ratio_range=(3 / 4, 4 / 3),
                 min_object_covered: float = 0.1, max_attempts: int = 10,
                 hflip: float = 0.5, rng: np.random.RandomState = None):
        self.size = size
        self.interpolation = interpolation
        self.area_range = area_range
        self.aspect_ratio_range = aspect_ratio_range
        self.min_object_covered = min_object_covered
        self.max_attempts = max_attempts
        self.hflip = hflip
        self.rng = rng or np.random.RandomState()

    def _sample_crop(self, width: int, height: int):
        """One (left, top, w, h) sample or None — TF's generator: sample an
        aspect ratio, derive the valid height interval from the area bounds,
        sample a height, then an offset; reject on constraint violation."""
        rng = self.rng
        area = float(width * height)
        min_a, max_a = self.area_range
        for _ in range(self.max_attempts):
            ar = rng.uniform(*self.aspect_ratio_range)  # ar = w/h
            # crop_w = ar * crop_h; area bounds give the h interval
            hmin = int(math.ceil(math.sqrt(min_a * area / ar)))
            hmax = int(math.floor(math.sqrt(max_a * area / ar)))
            hmax = min(hmax, height)
            if hmin > hmax:
                continue
            ch = int(rng.randint(hmin, hmax + 1))
            cw = int(round(ch * ar))
            if cw > width or cw <= 0 or ch <= 0:
                continue
            # min_object_covered vs the whole-image bbox: the crop (inside
            # the image) must cover >= fraction of the image area
            if cw * ch < self.min_object_covered * area:
                continue
            top = int(rng.randint(0, height - ch + 1))
            left = int(rng.randint(0, width - cw + 1))
            return left, top, cw, ch
        return None

    def __call__(self, img):
        w, h = img.size
        box = self._sample_crop(w, h)
        if box is None:
            # reference `bad` branch (tf_preprocessing.py:110-114)
            left, top, side = tf_center_crop_box(w, h, self.size)
            cw = ch = side
        else:
            left, top, cw, ch = box
        img = img.convert("RGB").crop((left, top, left + cw, top + ch))
        out = tf_resize(np.asarray(img, np.float32), self.size, self.size,
                        self.interpolation)
        if self.hflip and self.rng.uniform() < self.hflip:
            out = out[:, ::-1]
        return np.clip(np.round(out), 0, 255).astype(np.uint8)


class TfPreprocessTransform:
    """Dispatcher mirroring the reference class (tf_preprocessing.py:208-236)
    minus the TF session; returns HWC uint8 (our loaders collate HWC —
    the reference emits CHW for torch)."""

    def __init__(self, is_training: bool = False, size=224,
                 interpolation: str = "bicubic"):
        size = size[0] if isinstance(size, (tuple, list)) else size
        self.transform = (TfTrainPreprocess(size, interpolation)
                          if is_training else
                          TfEvalPreprocess(size, interpolation))

    def __call__(self, img):
        return self.transform(img)
