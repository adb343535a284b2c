"""Meters, counterpart of ``cotnet_tpu/utils/meters.py`` (reference
utils/meters.py).

TrainMeter: windowed loss (median and mean over a deque), LR, iteration
time, ETA, images/s and the card's peak memory.  The iteration time is
what the host clock sees between ``iter_tic`` and ``iter_toc``: the train
step does not synchronise with the card, so in the steady state it is the
host's time to enqueue a step, as the JAX package's asynchronous dispatch
gives it too; the loss read at each log interval waits for the card.
TestMeter: top-1/top-5 accumulation of counts the eval step has already
masked and summed, across ranks too under data parallelism (the
reference's ``sum_tensor`` all-reduce, meters.py:160-167, is in
``make_eval_step``).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Optional

import numpy as np
import torch


def accuracy_counts(logits, labels, topk=(1, 5)):
    """Top-k correct counts (reference meters.py:12-19), host-side numpy."""
    logits = np.asarray(logits)
    labels = np.asarray(labels)
    maxk = max(topk)
    top = np.argsort(-logits, axis=-1)[:, :maxk]
    out = []
    for k in topk:
        out.append(float((top[:, :k] == labels[:, None]).any(axis=1).sum()))
    return out


def device_mem_mb() -> float:
    """The card's peak allocated memory in MiB
    (``torch.cuda.max_memory_allocated``); 0 where this process has not
    used a card, as the JAX package reports 0 without memory stats."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        return torch.cuda.max_memory_allocated() / (1024 * 1024)
    return 0.0


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = self.sum = self.count = 0.0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n

    @property
    def avg(self):
        return self.sum / max(self.count, 1)


class ScalarMeter:
    """Windowed scalar with median/average (reference meters.py:59-83)."""

    def __init__(self, window_size: int = 100):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0

    def reset(self):
        self.deque.clear()
        self.total = 0.0
        self.count = 0

    def add_value(self, value):
        self.deque.append(float(value))
        self.count += 1
        self.total += float(value)

    def get_win_median(self):
        return float(np.median(self.deque)) if self.deque else 0.0

    def get_win_avg(self):
        return float(np.mean(self.deque)) if self.deque else 0.0

    def get_global_avg(self):
        return self.total / max(self.count, 1)


class TrainMeter:
    """Per-iteration training telemetry (reference meters.py:85-140)."""

    def __init__(self, epoch_iters: int, max_epoch: int, log_interval: int = 50,
                 logger=None, batch_size: Optional[int] = None):
        self.epoch_iters = epoch_iters
        self.max_epoch = max_epoch
        self.log_interval = log_interval
        self.logger = logger
        self.batch_size = batch_size
        self.loss = ScalarMeter(log_interval)
        self.iter_time = ScalarMeter(log_interval)
        self.lr = 0.0
        self._t = None

    def iter_tic(self):
        self._t = time.perf_counter()

    def iter_toc(self):
        if self._t is not None:
            self.iter_time.add_value(time.perf_counter() - self._t)
            self._t = None

    def update(self, loss: float, lr: float):
        self.loss.add_value(loss)
        self.lr = lr

    def log_iter_stats(self, epoch: int, it: int):
        if (it + 1) % self.log_interval != 0:
            return
        t = self.iter_time.get_win_avg()
        iters_left = (self.max_epoch - epoch) * self.epoch_iters - it - 1
        eta_s = int(iters_left * max(t, 1e-9))
        ips = (self.batch_size / t) if (self.batch_size and t > 0) else 0.0
        msg = (f"epoch {epoch + 1}/{self.max_epoch} iter {it + 1}/"
               f"{self.epoch_iters} loss {self.loss.get_win_median():.4f} "
               f"lr {self.lr:.5f} time {t * 1e3:.1f}ms "
               f"({ips:.0f} img/s) eta {eta_s // 3600}:"
               f"{eta_s % 3600 // 60:02d}:{eta_s % 60:02d} "
               f"mem {device_mem_mb():.0f}MB")
        (self.logger.info if self.logger else print)(msg)


class TestMeter:
    """Eval top-1/top-5 accumulation (reference meters.py:142-177)."""

    def __init__(self, logger=None):
        self.logger = logger
        self.reset()

    def reset(self):
        self.top1 = 0.0
        self.top5 = 0.0
        self.n = 0.0

    def update(self, top1_count: float, top5_count: float, n: float):
        self.top1 += float(top1_count)
        self.top5 += float(top5_count)
        self.n += float(n)

    @property
    def top1_pct(self):
        return 100.0 * self.top1 / max(self.n, 1)

    @property
    def top5_pct(self):
        return 100.0 * self.top5 / max(self.n, 1)

    def log_stats(self, epoch: int, tag: str = ""):
        msg = (f"eval{tag} epoch {epoch + 1}: top1 {self.top1_pct:.3f} "
               f"top5 {self.top5_pct:.3f} ({int(self.n)} samples)")
        (self.logger.info if self.logger else print)(msg)
