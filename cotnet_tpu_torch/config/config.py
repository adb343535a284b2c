"""Experiment configuration, counterpart of ``cotnet_tpu/config/config.py``
(reference config/config.py).

``load_experiment(folder)`` returns a ``Config`` (a nested dict with
attribute access) merged from ``default_config()`` and the folder's
``config.yaml``.  The section and key names are the reference's, so the
recipes under ``cot_experiments/`` parse unchanged, to the same tree as the
JAX package's.

Sentinel pruning (reference pop_unused_value, config.py:126-148): a YAML
value that is a sentinel (-1 / -1.0 / '' / []) keeps the default, so that
"unset" entries do not override model defaults.
"""

from __future__ import annotations

import copy
import os
from typing import Optional

import yaml


class Config(dict):
    """Nested dict with attribute access."""

    def __getattr__(self, k):
        try:
            v = self[k]
        except KeyError as e:
            raise AttributeError(k) from e
        return Config(v) if isinstance(v, dict) and not isinstance(v, Config) else v

    def __setattr__(self, k, v):
        self[k] = v

    def to_dict(self):
        return {k: (Config(v).to_dict() if isinstance(v, dict) else v)
                for k, v in self.items()}


def default_config() -> Config:
    """The full default tree (the keys of reference config/config.py:15-123
    and of the recipes)."""
    return Config(
        seed=1.0,
        amp=False,   # accepted for the recipes; bf16 runs without scaling
        root_dir="",
        data_loader=Config(
            data_path="", batch_size=128, vbatch_size=128, workers=6,
            pin_mem=False, prefetcher=True, use_multi_epochs_loader=False,
            dataset_type="folder",  # folder | tar | synthetic
        ),
        model=Config(
            name="cotnet50", pretrained=False, initial_checkpoint="",
            resume="", no_resume_opt=False, num_classes=1000, gp="avg",
            drop=0.0, drop_path=None, drop_block=None,
            model_ema=False, model_ema_force_cpu=False,
            model_ema_decay=0.9998, img_size=None, input_size=None,
            crop_pct=None, mean=None, std=None, interpolation="",
            dtype="bfloat16", kernel_impl="auto",
        ),
        BN=Config(
            bn_tf=False, bn_momentum=None, bn_eps=None, sync_bn=False,
            dist_bn="reduce", split_bn=False,
        ),
        augmentation=Config(
            no_aug=False, scale=[0.08, 1.0], ratio=[0.75, 4.0 / 3.0],
            hflip=0.5, vflip=0.0, interpolation="", color_jitter=0.4,
            aa=None, aug_splits=0, reprob=0.0, remode="pixel", recount=1,
            resplit=False, mixup=0.0, mixup_off_epoch=0, cutmix=0.0,
            cutmix_minmax=None, mixup_prob=1.0, mixup_switch_prob=0.5,
            mixup_mode="batch", train_interpolation="random", tta=0,
        ),
        loss=Config(jsd=False, smoothing=0.1),
        solver=Config(
            opt="sgd", opt_eps=1e-8, opt_betas=None, momentum=0.9,
            weight_decay=1e-4, clip_grad=None, clip_mode="norm",
            sched="cosine", lr=0.1, lr_noise=None, lr_noise_pct=0.67,
            lr_noise_std=1.0, lr_cycle_mul=1.0, lr_cycle_limit=1,
            warmup_lr=1e-4, min_lr=1e-5, epochs=200, start_epoch=None,
            decay_epochs=30, warmup_epochs=3, cooldown_epochs=0,
            patience_epochs=10, decay_rate=0.1, log_interval=50,
            recovery_interval=0,
        ),
        eval=Config(eval_metric="top1"),
    )


_SENTINELS = (-1, -1.0, "", [])


def _coerce(v):
    """PyYAML (YAML 1.1) reads '1e-5' as a string: numeric-looking strings
    become numbers, as yacs and the torch configs read them."""
    if isinstance(v, str):
        try:
            return float(v) if any(c in v for c in ".eE") else int(v)
        except ValueError:
            return v
    return v


def _merge(dst: dict, src: dict):
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _merge(dst[k], v)
        else:
            v = _coerce(v)
            if any(v is s or v == s for s in _SENTINELS if type(v) == type(s)):
                continue  # a sentinel keeps the default (pop_unused_value)
            dst[k] = v
    return dst


def load_config(yaml_path: str, base: Optional[Config] = None) -> Config:
    cfg = copy.deepcopy(base) if base is not None else default_config()
    with open(yaml_path) as f:
        overrides = yaml.safe_load(f) or {}
    _merge(cfg, overrides)
    return cfg


def load_experiment(folder: str) -> Config:
    """The ``--folder <exp_dir>`` convention (reference train.py:211-214):
    read ``<folder>/config.yaml``; logs and checkpoints go to the folder."""
    cfg = load_config(os.path.join(folder, "config.yaml"))
    cfg["root_dir"] = folder
    return cfg
