"""The policy augments' tables and config-string parsers, shared by the
host (PIL) and the device (torch) backends.

Counterpart of the constants of ``cotnet_tpu/data/rand_augment.py:35-56``
and the policy tables of ``cotnet_tpu/data/auto_augment.py:23-98``.  The
module imports neither torch nor PIL: the loader's worker processes read
these tables through ``host_augment`` and must start without torch.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

MAX_LEVEL = 10.0
FILL = 128.0
TRANSLATE_CONST = 100.0
CUTOUT_CONST = 40.0

# uniform-weight op list (reference rand_augment.py:227-244)
OP_NAMES = (
    "AutoContrast", "Equalize", "Invert", "Rotate", "Posterize", "Solarize",
    "SolarizeAdd", "Color", "Contrast", "Brightness", "Sharpness", "ShearX",
    "ShearY", "TranslateX", "TranslateY", "Cutout",
    # ---- variant magnitude curves beyond this point (AutoAugment policies
    # + increasing-severity RandAugment; reference auto_augment.py:192-306).
    # RandAugment samples indices below len=16 only.
    "PosterizeIncreasing", "PosterizeOriginal", "SolarizeIncreasing",
    "ColorIncreasing", "ContrastIncreasing", "BrightnessIncreasing",
    "SharpnessIncreasing", "TranslateXRel", "TranslateYRel",
)
N_BASE_OPS = 16
OP_IDX = {n: i for i, n in enumerate(OP_NAMES)}

# _RAND_CHOICE_WEIGHTS_0 (reference rand_augment.py:246-263)
CHOICE_WEIGHTS_0 = (0.025, 0.005, 0.0, 0.2, 0.0, 0.005, 0.005, 0.025, 0.005,
                    0.005, 0.025, 0.2, 0.2, 0.1, 0.1, 0.1)

Policy = List[List[Tuple[str, float, int]]]

# AutoAugment ImageNet policy V0 (public TF/timm table)
POLICY_V0: Policy = [
    [("Equalize", 0.8, 1), ("ShearY", 0.8, 4)],
    [("Color", 0.4, 9), ("Equalize", 0.6, 3)],
    [("Color", 0.4, 1), ("Rotate", 0.6, 8)],
    [("Solarize", 0.8, 3), ("Equalize", 0.4, 7)],
    [("Solarize", 0.4, 2), ("Solarize", 0.6, 2)],
    [("Color", 0.2, 0), ("Equalize", 0.8, 8)],
    [("Equalize", 0.4, 8), ("SolarizeAdd", 0.8, 3)],
    [("ShearX", 0.2, 9), ("Rotate", 0.6, 8)],
    [("Color", 0.6, 1), ("Equalize", 1.0, 2)],
    [("Invert", 0.4, 9), ("Rotate", 0.6, 0)],
    [("Equalize", 1.0, 9), ("ShearY", 0.6, 3)],
    [("Color", 0.4, 7), ("Equalize", 0.6, 0)],
    [("Posterize", 0.4, 6), ("AutoContrast", 0.4, 7)],
    [("Solarize", 0.6, 8), ("Color", 0.6, 9)],
    [("Solarize", 0.2, 4), ("Rotate", 0.8, 9)],
    [("Rotate", 1.0, 7), ("TranslateYRel", 0.8, 9)],
    [("ShearX", 0.0, 0), ("Solarize", 0.8, 4)],
    [("ShearY", 0.8, 0), ("Color", 0.6, 4)],
    [("Color", 1.0, 0), ("Rotate", 0.6, 2)],
    [("Equalize", 0.8, 4), ("Equalize", 0.0, 8)],
    [("Equalize", 1.0, 4), ("AutoContrast", 0.6, 2)],
    [("ShearY", 0.4, 7), ("SolarizeAdd", 0.6, 7)],
    [("Posterize", 0.8, 2), ("Solarize", 0.6, 10)],
    [("Solarize", 0.6, 8), ("Equalize", 0.6, 1)],
    [("Color", 0.8, 6), ("Rotate", 0.4, 5)],
]

# AutoAugment 'original' (paper) ImageNet policy
POLICY_ORIGINAL: Policy = [
    [("PosterizeOriginal", 0.4, 8), ("Rotate", 0.6, 9)],
    [("Solarize", 0.6, 5), ("AutoContrast", 0.6, 5)],
    [("Equalize", 0.8, 8), ("Equalize", 0.6, 3)],
    [("PosterizeOriginal", 0.6, 7), ("PosterizeOriginal", 0.6, 6)],
    [("Equalize", 0.4, 7), ("Solarize", 0.2, 4)],
    [("Equalize", 0.4, 4), ("Rotate", 0.8, 8)],
    [("Solarize", 0.6, 3), ("Equalize", 0.6, 7)],
    [("PosterizeOriginal", 0.8, 5), ("Equalize", 1.0, 2)],
    [("Rotate", 0.2, 3), ("Solarize", 0.6, 8)],
    [("Equalize", 0.6, 8), ("PosterizeOriginal", 0.4, 6)],
    [("Rotate", 0.8, 8), ("Color", 0.4, 0)],
    [("Rotate", 0.4, 9), ("Equalize", 0.6, 2)],
    [("Equalize", 0.0, 7), ("Equalize", 0.8, 8)],
    [("Invert", 0.6, 4), ("Equalize", 1.0, 8)],
    [("Color", 0.6, 4), ("Contrast", 1.0, 8)],
    [("Rotate", 0.8, 8), ("Color", 1.0, 2)],
    [("Color", 0.8, 8), ("Solarize", 0.8, 7)],
    [("Sharpness", 0.4, 7), ("Invert", 0.6, 8)],
    [("ShearX", 0.6, 5), ("Equalize", 1.0, 9)],
    [("Color", 0.4, 0), ("Equalize", 0.6, 3)],
    [("Equalize", 0.4, 7), ("Solarize", 0.2, 4)],
    [("Solarize", 0.6, 5), ("AutoContrast", 0.6, 5)],
    [("Invert", 0.6, 4), ("Equalize", 1.0, 8)],
    [("Color", 0.6, 4), ("Contrast", 1.0, 8)],
    [("Equalize", 0.8, 8), ("Equalize", 0.6, 3)],
]


def _substitute(policy: Policy, frm: str, to: str) -> Policy:
    return [[(to if name == frm else name, p, m) for name, p, m in sub]
            for sub in policy]


# 'r' variants: the research posterize curve (bits discarded increase with
# magnitude) — reference auto_augment.py:381-412 (v0r) and :448-478
# (originalr)
POLICY_V0R = _substitute(POLICY_V0, "Posterize", "PosterizeIncreasing")
POLICY_ORIGINALR = _substitute(POLICY_ORIGINAL, "PosterizeOriginal",
                               "PosterizeIncreasing")

POLICIES: Dict[str, Policy] = {"v0": POLICY_V0, "v0r": POLICY_V0R,
                               "original": POLICY_ORIGINAL,
                               "originalr": POLICY_ORIGINALR}

# the device AugMix's op set: the base ops that do not overlap the eval
# corruptions (cotnet_tpu/data/auto_augment.py:140-141)
AUGMIX_OPS = ("AutoContrast", "Equalize", "Rotate", "Posterize", "Solarize",
              "ShearX", "ShearY", "TranslateX", "TranslateY")
# the host AugMix's: the increasing-curve forms
# (cotnet_tpu/data/host_augment.py:250-253)
HOST_AUGMIX_OPS = ("AutoContrast", "Equalize", "Rotate",
                   "PosterizeIncreasing", "SolarizeIncreasing", "ShearX",
                   "ShearY", "TranslateXRel", "TranslateYRel")


def _sections(parts):
    """(key, value) of each ``<key><digits...>`` section."""
    for c in parts:
        cs = re.split(r"(\d.*)", c)
        if len(cs) >= 2:
            yield c, cs[0], cs[1]


def parse_rand(config_str: str) -> dict:
    """'rand-m15-mstd0.5-n2[-w0]' -> RandAugment's keyword arguments (parser
    parity with reference rand_augment.py:327-372)."""
    config = config_str.split("-")
    if config[0] != "rand":
        raise ValueError(f"not a RandAugment config: {config_str!r}")
    kw = dict(magnitude=MAX_LEVEL, num_layers=2, magnitude_std=0.0,
              weight_idx=None)
    for c, key, val in _sections(config[1:]):
        if key == "mstd":
            kw["magnitude_std"] = float(val)
        elif key == "m":
            kw["magnitude"] = float(val)
        elif key == "n":
            kw["num_layers"] = int(val)
        elif key == "w":
            kw["weight_idx"] = int(val)
        elif key != "inc":  # the reference ignores 'inc' too
            raise ValueError(f"Unknown RandAugment config section {c!r}")
    return kw


def parse_auto(config_str: str) -> dict:
    """'v0' / 'v0r' / 'original' / 'originalr' / '<name>-mstd0.5' ->
    AutoAugment's keyword arguments (reference auto_augment.py:495-530)."""
    parts = config_str.split("-")
    mstd = 0.0
    for _, key, val in _sections(parts[1:]):
        if key == "mstd":
            mstd = float(val)
    return dict(policy=parts[0], magnitude_std=mstd)


def parse_augmix(config_str: str) -> dict:
    """'augmix-m5-w4-d2[-a1.0]' -> AugMix's keyword arguments (reference
    auto_augment.py's augment_and_mix_transform)."""
    parts = config_str.split("-")
    if parts[0] != "augmix":
        raise ValueError(f"not an AugMix config: {config_str!r}")
    kw = dict(magnitude=3.0, width=3, depth=-1, alpha=1.0)
    for _, key, val in _sections(parts[1:]):
        if key == "m":
            kw["magnitude"] = float(val)
        elif key == "w":
            kw["width"] = int(val)
        elif key == "d":
            kw["depth"] = int(val)
        elif key == "a":
            kw["alpha"] = float(val)
    return kw
