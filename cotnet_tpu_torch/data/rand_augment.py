"""Device RandAugment in torch, counterpart of ``cotnet_tpu/data/rand_augment.py``
(reference datasets/rand_augment.py): the loader's ``aug_backend="device"``.

The ops work on a float32 NCHW batch in [0, 255] with one argument per
sample, with the JAX package's semantics, which are not quite the
reference's:
- the geometric ops are bilinear only (the reference picks bilinear or
  bicubic per call), with PIL's affine rules: an output pixel's centre is
  mapped through the matrix, the fill (128) is decided at the mapped point,
  and the 2x2 support is clamped to the edges (``_affine``, an explicit
  gather; ``F.grid_sample`` has other edge and fill rules);
- ``equalize`` is PIL's integer LUT per image and channel;
- ``color``, ``contrast`` and ``sharpness`` use PIL's rounded fixed-point
  gray and smoothing.

Draws are apart from their application: ``RandAugment.draw(generator, n, h,
w)`` returns every random value of a batch as tensors, ``apply(x, draws)``
is deterministic.  Where the JAX package evaluates all 25 ops for every
sample and selects one (``lax.switch`` under ``vmap``), ``apply_ops`` runs
each op on the samples that drew it, and nothing on a sample whose op was
gated off: the same result for less work, at the cost of one small copy of
the op indices to the host per call.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch

from cotnet_tpu_torch.data.policies import (CHOICE_WEIGHTS_0, CUTOUT_CONST,
                                            FILL, MAX_LEVEL, N_BASE_OPS,
                                            OP_NAMES, TRANSLATE_CONST,
                                            parse_rand)

__all__ = ["OP_NAMES", "N_BASE_OPS", "MAX_LEVEL", "TRANSLATE_CONST",
           "CUTOUT_CONST", "CHOICE_WEIGHTS_0", "RandAugment", "apply_op",
           "apply_ops", "rand_augment_transform"]


def _per_sample(v, img):
    """A per-sample argument ``[n]`` as ``[n, 1, 1, 1]`` against ``img``."""
    return v.reshape(-1, 1, 1, 1).to(img.device)


# --------------------------------------------------------------------------
# photometric ops on float32 [n, 3, H, W] in [0, 255]
# --------------------------------------------------------------------------

def _gray(img):
    # PIL 'L' conversion: fixed-point ITU-R 601-2 with rounding
    # (L = (R*19595 + G*38470 + B*7471 + 0x8000) >> 16); [n, H, W]
    l = img[:, 0] * 19595 + img[:, 1] * 38470 + img[:, 2] * 7471 + 32768
    return torch.floor(l / 65536.0)


def autocontrast(img):
    lo = img.amin(dim=(2, 3), keepdim=True)
    hi = img.amax(dim=(2, 3), keepdim=True)
    scale = 255.0 / torch.clamp(hi - lo, min=1e-9)
    out = (img - lo) * scale
    return torch.where(hi > lo, out, img)


def equalize(img):
    """PIL ImageOps.equalize integer-LUT semantics, per image and channel."""
    n, c, h, w = img.shape
    idx = torch.clamp(img, 0, 255).to(torch.int64).reshape(n * c, h * w)
    rows = torch.arange(n * c, device=img.device)[:, None] * 256
    hist = torch.bincount((idx + rows).reshape(-1),
                          minlength=n * c * 256).reshape(n * c, 256)
    # the last nonzero bin
    last_idx = 255 - torch.argmax((hist > 0).flip(1).to(torch.uint8), dim=1)
    last_cnt = hist.gather(1, last_idx[:, None])[:, 0]
    step = (hist.sum(1) - last_cnt) // 255
    csum = torch.cumsum(hist, 1) - hist
    lut = torch.clamp((step[:, None] // 2 + csum)
                      // torch.clamp(step, min=1)[:, None], 0, 255)
    out = lut.gather(1, idx).to(img.dtype).reshape(n, c, h, w)
    return torch.where((step > 0).reshape(n, c, 1, 1), out, img)


def invert(img):
    return 255.0 - img


def posterize(img, bits_to_keep):
    """Keep the top ``bits_to_keep`` (int ``[n]``) bits; 8 or more is the
    identity (reference rand_augment.py:120-123)."""
    bits = _per_sample(bits_to_keep, img)
    q = torch.pow(2.0, torch.clamp(8 - bits, 0, 8).to(torch.float32))
    out = torch.floor(img / q) * q
    return torch.where(bits >= 8, img, out)


def solarize(img, thresh):
    t = _per_sample(thresh, img)
    return torch.where(img >= t, 255.0 - img, img)


def solarize_add(img, add, thresh=128.0):
    return torch.where(img < thresh,
                       torch.clamp(img + _per_sample(add, img), 0, 255), img)


def _blend(img1, img2, factor):
    """PIL Image.blend(img1, img2, factor): img1 + factor*(img2-img1)."""
    return torch.clamp(img1 + _per_sample(factor, img2) * (img2 - img1),
                       0.0, 255.0)


def color(img, factor):
    gray3 = _gray(img)[:, None].expand_as(img)
    return _blend(gray3, img, factor)


def contrast(img, factor):
    mean = torch.floor(_gray(img).mean(dim=(1, 2)) + 0.5)
    return _blend(_per_sample(mean, img).expand_as(img), img, factor)


def brightness(img, factor):
    return _blend(torch.zeros_like(img), img, factor)


_SMOOTH = ((1.0, 1.0, 1.0), (1.0, 5.0, 1.0), (1.0, 1.0, 1.0))


def sharpness(img, factor):
    # PIL SMOOTH kernel [[1,1,1],[1,5,1],[1,1,1]]/13; borders unfiltered
    n, c, h, w = img.shape
    k = torch.tensor(_SMOOTH, dtype=torch.float32) / 13.0
    pad = torch.nn.functional.pad(img, (1, 1, 1, 1))
    sm = 0
    for i in range(3):
        for j in range(3):
            sm = sm + k[i, j].item() * pad[:, :, i:i + h, j:j + w]
    ys = torch.arange(h, device=img.device)[:, None]
    xs = torch.arange(w, device=img.device)[None, :]
    interior = (ys > 0) & (ys < h - 1) & (xs > 0) & (xs < w - 1)
    # PIL's fixed-point kernel filter rounds to nearest
    sm = torch.where(interior, torch.floor(sm + 0.5), img)
    return _blend(sm, img, factor)


# --------------------------------------------------------------------------
# geometric ops: inverse-affine bilinear resampling with constant fill
# --------------------------------------------------------------------------

def _affine(img, mat: Sequence):
    """PIL AFFINE semantics: output (x, y) samples input at
    (a x + b y + c, d x + e y + f); bilinear, fill=128.  ``mat`` holds six
    per-sample ``[n]`` tensors (or numbers)."""
    n, ch, h, w = img.shape
    a, b, c, d, e, f = (torch.as_tensor(v, dtype=torch.float32,
                                        device=img.device)
                        .expand(n).reshape(n, 1, 1) for v in mat)
    ys = torch.arange(h, dtype=torch.float32, device=img.device)
    xs = torch.arange(w, dtype=torch.float32, device=img.device)
    Y, X = torch.meshgrid(ys, xs, indexing="ij")
    # PIL maps output pixel centers through the matrix, fills only when the
    # mapped point itself is outside [0, size), and samples bilinearly at
    # (point - 0.5) with the 2x2 support clamped to the edges (geometry.c)
    sx_raw = a * (X + 0.5) + b * (Y + 0.5) + c
    sy_raw = d * (X + 0.5) + e * (Y + 0.5) + f
    inside = (sx_raw >= 0) & (sx_raw < w) & (sy_raw >= 0) & (sy_raw < h)
    sx = sx_raw - 0.5
    sy = sy_raw - 0.5
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    wx = (sx - x0)[:, None]
    wy = (sy - y0)[:, None]
    flat = img.reshape(n, ch, h * w)

    def gather(yi, xi):
        yc = torch.clamp(yi, 0, h - 1).to(torch.int64)
        xc = torch.clamp(xi, 0, w - 1).to(torch.int64)
        idx = (yc * w + xc).reshape(n, 1, h * w).expand(n, ch, h * w)
        return flat.gather(2, idx).reshape(n, ch, h, w)

    v00 = gather(y0, x0)
    v01 = gather(y0, x0 + 1)
    v10 = gather(y0 + 1, x0)
    v11 = gather(y0 + 1, x0 + 1)
    out = (v00 * (1 - wx) * (1 - wy) + v01 * wx * (1 - wy)
           + v10 * (1 - wx) * wy + v11 * wx * wy)
    return torch.where(inside[:, None], out, FILL)


def shear_x(img, factor):
    return _affine(img, (1.0, factor, 0.0, 0.0, 1.0, 0.0))


def shear_y(img, factor):
    return _affine(img, (1.0, 0.0, 0.0, factor, 1.0, 0.0))


def translate_x(img, pixels):
    return _affine(img, (1.0, 0.0, pixels, 0.0, 1.0, 0.0))


def translate_y(img, pixels):
    return _affine(img, (1.0, 0.0, 0.0, 0.0, 1.0, pixels))


def rotate(img, degrees):
    """PIL rotate: counterclockwise about the center, same canvas."""
    h, w = img.shape[2:]
    cx, cy = w / 2.0, h / 2.0
    ang = -degrees * math.pi / 180.0
    cos, sin = torch.cos(ang), torch.sin(ang)
    c = cx - cos * cx - sin * cy
    f = cy + sin * cx - cos * cy
    return _affine(img, (cos, sin, c, -sin, cos, f))


def cutout(img, pixels, xy):
    """A gray square of half-side ``pixels`` whose corner is ``xy - pixels``
    (``xy`` ``[n, 2]``: x and y drawn uniformly in [0, w) and [0, h))."""
    h, w = img.shape[2:]
    x0 = torch.clamp(xy[:, 0] - pixels, min=0.0).to(torch.int32)
    y0 = torch.clamp(xy[:, 1] - pixels, min=0.0).to(torch.int32)
    x1 = torch.clamp(x0 + (2 * pixels).to(torch.int32), max=w)
    y1 = torch.clamp(y0 + (2 * pixels).to(torch.int32), max=h)
    ys = torch.arange(h, device=img.device)[None, :, None]
    xs = torch.arange(w, device=img.device)[None, None, :]
    # PIL rectangle() fills inclusive of the end coordinate
    inside = ((ys >= y0[:, None, None]) & (ys <= y1[:, None, None])
              & (xs >= x0[:, None, None]) & (xs <= x1[:, None, None]))
    return torch.where(inside[:, None], FILL, img)


# --------------------------------------------------------------------------
# magnitude -> op arguments (reference rand_augment.py:38-78)
# --------------------------------------------------------------------------

def _floor_int(v):
    return torch.floor(v).to(torch.int32)


# the 25 ops of OP_NAMES, each (img, lvl, enh, sign, xy) -> img, with lvl =
# level / MAX_LEVEL and enh = lvl * 1.8 + 0.1, per sample
_OPS = [
    lambda img, lvl, enh, sign, xy: autocontrast(img),
    lambda img, lvl, enh, sign, xy: equalize(img),
    lambda img, lvl, enh, sign, xy: invert(img),
    lambda img, lvl, enh, sign, xy: rotate(img, sign * lvl * 30.0),
    lambda img, lvl, enh, sign, xy: posterize(img, _floor_int(lvl * 4)),
    lambda img, lvl, enh, sign, xy: solarize(img, torch.floor(lvl * 256)),
    lambda img, lvl, enh, sign, xy: solarize_add(img, torch.floor(lvl * 110)),
    lambda img, lvl, enh, sign, xy: color(img, enh),
    lambda img, lvl, enh, sign, xy: contrast(img, enh),
    lambda img, lvl, enh, sign, xy: brightness(img, enh),
    lambda img, lvl, enh, sign, xy: sharpness(img, enh),
    lambda img, lvl, enh, sign, xy: shear_x(img, sign * lvl * 0.3),
    lambda img, lvl, enh, sign, xy: shear_y(img, sign * lvl * 0.3),
    lambda img, lvl, enh, sign, xy: translate_x(
        img, sign * lvl * TRANSLATE_CONST),
    lambda img, lvl, enh, sign, xy: translate_y(
        img, sign * lvl * TRANSLATE_CONST),
    lambda img, lvl, enh, sign, xy: cutout(
        img, torch.floor(lvl * CUTOUT_CONST), xy),
    # variant curves (reference auto_augment.py:192-260):
    # posterize increasing: more bits DISCARDED with level
    lambda img, lvl, enh, sign, xy: posterize(img, 4 - _floor_int(lvl * 4)),
    # posterize original (paper): bits kept in 4..8
    lambda img, lvl, enh, sign, xy: posterize(img, 4 + _floor_int(lvl * 4)),
    lambda img, lvl, enh, sign, xy: solarize(
        img, 256.0 - torch.floor(lvl * 256)),
    lambda img, lvl, enh, sign, xy: color(img, 1.0 + sign * lvl * 0.9),
    lambda img, lvl, enh, sign, xy: contrast(img, 1.0 + sign * lvl * 0.9),
    lambda img, lvl, enh, sign, xy: brightness(img, 1.0 + sign * lvl * 0.9),
    lambda img, lvl, enh, sign, xy: sharpness(img, 1.0 + sign * lvl * 0.9),
    lambda img, lvl, enh, sign, xy: translate_x(
        img, sign * lvl * 0.45 * img.shape[3]),
    lambda img, lvl, enh, sign, xy: translate_y(
        img, sign * lvl * 0.45 * img.shape[2]),
]
assert len(_OPS) == len(OP_NAMES)


def apply_op(op: int, img, level, sign, xy):
    """Op ``op`` (an index of ``OP_NAMES``) on every sample of ``img`` at
    magnitude ``level`` (``[n]``, already noised and clipped) with ``sign``
    (``[n]``, +1 or -1); ``xy`` (``[n, 2]``) places a cutout."""
    lvl = level.to(torch.float32) / MAX_LEVEL
    enh = lvl * 1.8 + 0.1
    return _OPS[op](img, lvl, enh, sign.to(torch.float32), xy)


def apply_ops(img, ops: List[int], level, sign, xy):
    """Each sample ``i`` of ``img`` through op ``ops[i]`` (a host list; -1
    leaves the sample as it is): each op runs once, on the samples that
    drew it."""
    out = img
    for op in sorted(set(ops) - {-1}):
        rows = torch.tensor([i for i, o in enumerate(ops) if o == op],
                            device=img.device)
        got = apply_op(op, img.index_select(0, rows), level[rows],
                       sign[rows], xy[rows])
        if out is img:
            out = img.clone()
        out.index_copy_(0, rows, got)
    return out


def _uniform(shape, generator, device, lo=0.0, hi=1.0):
    return lo + torch.rand(shape, generator=generator, device=device) * (
        hi - lo)


def _signs(shape, generator, device):
    return torch.where(torch.rand(shape, generator=generator, device=device)
                       < 0.5, 1.0, -1.0)


def _cutout_xy(shape, h, w, generator, device):
    return torch.rand((*shape, 2), generator=generator, device=device) * \
        torch.tensor([float(w), float(h)], device=device)


class RandAugment:
    """Callable (float NCHW batch in 0..255, generator) -> augmented batch.

    Args mirror the reference: magnitude, num_layers, magnitude_std,
    min_prob/max_prob, optional choice weights index.  Per layer and
    sample: an op (uniform over the 16 base ops, or ``CHOICE_WEIGHTS_0``),
    magnitude ``m + N(0, mstd)`` clipped to [0, max_magnitude], a random
    sign, applied if ``u1 <= U(min_prob, max_prob)``.
    """

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
        # op sampling space — must stay twinned with HostRandAugment.num_ops
        self.num_ops = N_BASE_OPS

    def draw(self, generator: Optional[torch.Generator], n: int, h: int,
             w: int, device=None) -> Dict[str, torch.Tensor]:
        """Every draw of a batch of ``n`` images of ``h x w``, ``[layers,
        n]`` each: ``op``, ``mag`` (noised and clipped), ``sign``,
        ``apply`` (the gate ``u1 <= u2``) and ``xy`` (``[layers, n, 2]``,
        the cutout's centre).  On the generator's device (``device`` for
        the default generator)."""
        device = generator.device if generator is not None else device
        shape = (self.num_layers, n)
        if self.weights is not None:
            p = torch.tensor(self.weights, device=device)
            op = torch.multinomial(p, self.num_layers * n, replacement=True,
                                   generator=generator).reshape(shape)
        else:
            op = torch.randint(0, N_BASE_OPS, shape, generator=generator,
                               device=device)
        mag = torch.full(shape, self.magnitude, device=device)
        if self.magnitude_std > 0:
            mag = mag + torch.randn(shape, generator=generator,
                                    device=device) * self.magnitude_std
        mag = torch.clamp(mag, 0.0, self.max_magnitude)
        sign = _signs(shape, generator, device)
        u1 = _uniform(shape, generator, device)
        u2 = _uniform(shape, generator, device, self.min_prob, self.max_prob)
        return {"op": op, "mag": mag, "sign": sign, "apply": u1 <= u2,
                "xy": _cutout_xy(shape, h, w, generator, device)}

    def apply(self, x, draws: Dict[str, torch.Tensor]):
        draws = {k: v.to(x.device) for k, v in draws.items()}
        ops = torch.where(draws["apply"], draws["op"], -1).tolist()
        for layer in range(self.num_layers):
            x = apply_ops(x, ops[layer], draws["mag"][layer],
                          draws["sign"][layer], draws["xy"][layer])
        return x

    def __call__(self, x, generator: Optional[torch.Generator] = None):
        n, _, h, w = x.shape
        return self.apply(x.to(torch.float32),
                          self.draw(generator, n, h, w, x.device))


def rand_augment_transform(config_str: str, magnitude_max: float = 15.0):
    """'rand-m15-mstd0.5-n2' -> RandAugment (parser parity with
    reference rand_augment.py:327-372)."""
    return RandAugment(**parse_rand(config_str), max_magnitude=magnitude_max)
