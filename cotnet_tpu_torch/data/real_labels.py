"""ImageNet "Real labels" re-assessed evaluation
(reference datasets/real_labels.py:12-42), counterpart of
``cotnet_tpu/data/real_labels.py``: each val image carries a *set* of
acceptable labels from the ReaL re-annotation; top-k is correct if any
predicted class is in the set.  ``add_result`` takes numpy arrays (call
``.cpu().numpy()`` on the eval step's ``topk``)."""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np


class RealLabelsImagenet:
    def __init__(self, filenames: Sequence[str],
                 real_json: str = "real.json", topk=(1, 5)):
        if real_json.endswith(".json"):
            with open(real_json) as f:
                real_labels = json.load(f)
            # real.json is ordered by ILSVRC2012_val_%08d index
            real_labels = {
                f"ILSVRC2012_val_{i + 1:08d}.JPEG": labels
                for i, labels in enumerate(real_labels)}
        else:
            raise ValueError(real_json)
        self.real_labels = real_labels
        self.filenames = list(filenames)
        self.topk = topk
        self.is_correct = {k: [] for k in topk}
        self.sample_idx = 0

    def reset(self):
        """Start a fresh evaluation pass (call before reusing the object)."""
        self.is_correct = {k: [] for k in self.topk}
        self.sample_idx = 0

    def add_result(self, logits_or_topk):
        """Accumulate a batch of predictions (logits [N, K] or precomputed
        top-k index arrays [N, max(topk)])."""
        arr = np.asarray(logits_or_topk)
        if self.sample_idx + len(arr) > len(self.filenames):
            raise IndexError(
                f"add_result past the end of the filename list "
                f"({self.sample_idx}+{len(arr)} > {len(self.filenames)}); "
                f"call reset() before a second evaluation pass")
        if arr.ndim == 2 and arr.shape[1] > max(self.topk):
            pred = np.argsort(-arr, axis=-1)[:, :max(self.topk)]
        else:
            pred = arr
        for sample in pred:
            filename = os.path.basename(self.filenames[self.sample_idx])
            labels = self.real_labels.get(filename)
            if labels:
                for k in self.topk:
                    self.is_correct[k].append(
                        any(int(p) in labels for p in sample[:k]))
            self.sample_idx += 1

    def get_accuracy(self, k: Optional[int] = None):
        if k is None:
            return {k: float(np.mean(v)) * 100
                    for k, v in self.is_correct.items()}
        return float(np.mean(self.is_correct[k])) * 100
