"""Wall-clock timer, counterpart of ``cotnet_tpu/utils/timer.py``
(reference utils/timer.py:13-38).  It reads the host's clock: around a
call that does not synchronise with the card it measures the enqueue."""

from __future__ import annotations

import time


class Timer:
    def __init__(self):
        self.reset()

    def reset(self):
        self._start = None
        self.total = 0.0
        self.calls = 0
        self.diff = 0.0

    def tic(self):
        self._start = time.perf_counter()

    def toc(self):
        if self._start is None:
            raise RuntimeError("toc without tic")
        self.diff = time.perf_counter() - self._start
        self.total += self.diff
        self.calls += 1
        self._start = None
        return self.diff

    @property
    def average_time(self):
        return self.total / max(self.calls, 1)
