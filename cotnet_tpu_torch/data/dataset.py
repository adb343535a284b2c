"""Datasets, counterpart of ``cotnet_tpu/data/dataset.py`` (reference
datasets/dataset.py).

- ImageFolderDataset: os.walk image tree with natural-sorted class index
  (dataset.py:29-48,65-114);
- TarDataset: tarfile-backed ImageNet with a lazily opened per-worker handle
  (dataset.py:139-178);
- AugMixDataset: clean + N augmented views per sample for JSD training
  (dataset.py:181-218) — here a thin wrapper marking aug splits; the actual
  augmentation runs on the device, so the wrapper only replicates samples.

Framework-free (numpy, PIL at decode): the loader's worker processes unpickle
these objects without importing torch.
"""

from __future__ import annotations

import io
import os
import re
import tarfile
import threading
from typing import Callable, List, Optional, Tuple

import numpy as np

IMG_EXTENSIONS = (".png", ".jpg", ".jpeg", ".ppm", ".bmp", ".pgm", ".tif",
                  ".tiff", ".webp")


def natural_key(s: str):
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s.lower())]


def find_images_and_targets(folder: str, types=IMG_EXTENSIONS,
                            class_to_idx: Optional[dict] = None,
                            sort: bool = True):
    """Walk an image-folder tree; subdirectory (relative path) = class."""
    labels, filenames = [], []
    for root, _, files in os.walk(folder, topdown=False, followlinks=True):
        rel = os.path.relpath(root, folder) if root != folder else ""
        label = rel.replace(os.path.sep, "_")
        for f in files:
            if os.path.splitext(f)[1].lower() in types:
                filenames.append(os.path.join(root, f))
                labels.append(label)
    if class_to_idx is None:
        unique = sorted(set(labels), key=natural_key)
        class_to_idx = {c: i for i, c in enumerate(unique)}
    images_and_targets = [(f, class_to_idx[l]) for f, l in zip(filenames, labels)
                          if l in class_to_idx]
    if sort:
        images_and_targets = sorted(images_and_targets,
                                    key=lambda k: natural_key(k[0]))
    return images_and_targets, class_to_idx


def _open_rgb(data_or_path, draft_size=None):
    """Decode to RGB; ``draft_size=(w, h)`` enables decode-at-scale for
    JPEGs (PIL ``Image.draft``: DCT-domain 1/2-1/8 downscale chosen so both
    dims stay >= the target — the decoder then does 2-4x less IDCT work).
    A no-op for formats without draft support (PNG etc.)."""
    from PIL import Image

    img = (Image.open(io.BytesIO(data_or_path))
           if isinstance(data_or_path, (bytes, bytearray))
           else Image.open(data_or_path))
    if draft_size is not None:
        img.draft("RGB", draft_size)
    return img.convert("RGB")


class ImageFolderDataset:
    """Map-style dataset: __getitem__ -> (PIL image | transformed, target)."""

    def __init__(self, root: str, transform: Optional[Callable] = None,
                 class_to_idx: Optional[dict] = None):
        if not os.path.isdir(root):
            raise FileNotFoundError(root)
        self.root = root
        self.samples, self.class_to_idx = find_images_and_targets(
            root, class_to_idx=class_to_idx)
        if not self.samples:
            raise RuntimeError(f"no images found under {root}")
        self.transform = transform
        self.draft_size = None  # set by the loader (decode-at-scale)

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        path, target = self.samples[idx]
        img = _open_rgb(path, self.draft_size)
        if self.transform is not None:
            img = self.transform(img)
        return img, target

    def filename(self, idx, basename=False):
        path = self.samples[idx][0]
        return os.path.basename(path) if basename else path

    def filenames(self, basename=False):
        return [self.filename(i, basename) for i in range(len(self))]


class TarDataset:
    """ImageNet-in-a-tarball (class sub-tars or flat class dirs inside)."""

    def __init__(self, tar_path: str, transform: Optional[Callable] = None,
                 class_to_idx: Optional[dict] = None):
        if not os.path.isfile(tar_path):
            raise FileNotFoundError(tar_path)
        self.tar_path = tar_path
        self.samples: List[Tuple[tarfile.TarInfo, int]] = []
        with tarfile.open(tar_path) as tf:
            members = [m for m in tf.getmembers() if m.isfile()
                       and os.path.splitext(m.name)[1].lower() in IMG_EXTENSIONS]
        labels = [os.path.dirname(m.name).replace("/", "_") for m in members]
        if class_to_idx is None:
            unique = sorted(set(labels), key=natural_key)
            class_to_idx = {c: i for i, c in enumerate(unique)}
        pairs = [(m, class_to_idx[l]) for m, l in zip(members, labels)]
        self.samples = sorted(pairs, key=lambda p: natural_key(p[0].name))
        self.class_to_idx = class_to_idx
        self.transform = transform
        self.draft_size = None  # set by the loader (decode-at-scale)
        # lazy per-worker AND per-thread handles: TarFile shares one seek
        # position, so the prefetcher's thread pool needs its own handle
        # (reference keeps one lazy handle per dataloader worker process,
        # dataset.py:163-170; threads add the extra dimension here)
        self._local = threading.local()

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        tf = getattr(self._local, "tf", None)
        if tf is None:
            tf = self._local.tf = tarfile.open(self.tar_path)
        member, target = self.samples[idx]
        data = tf.extractfile(member).read()
        img = _open_rgb(data, self.draft_size)
        if self.transform is not None:
            img = self.transform(img)
        return img, target

    def filename(self, idx, basename=False):
        name = self.samples[idx][0].name
        return os.path.basename(name) if basename else name

    def filenames(self, basename=False):
        return [self.filename(i, basename) for i in range(len(self))]


class AugMixDataset:
    """Wrap a dataset to yield (num_splits) views per sample: the first is
    clean, the rest get the augmented transform on-device (loader tags the
    split index; JSD loss consumes the concatenated logits)."""

    def __init__(self, dataset, num_splits: int = 2):
        assert num_splits >= 2
        self.dataset = dataset
        self.num_splits = num_splits

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx):
        img, target = self.dataset[idx]
        return [img] * self.num_splits, target
