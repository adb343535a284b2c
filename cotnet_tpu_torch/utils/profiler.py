"""Profiling hooks, counterpart of ``cotnet_tpu/utils/profiler.py``.

- ``trace(dir)``: a context manager that records the host and the card
  with ``torch.profiler`` and writes a Chrome trace
  (``<dir>/trace.json``, for chrome://tracing or Perfetto).
- ``annotate(name)``: a named region in that trace
  (``torch.profiler.record_function``).
- ``device_memory_profile(path)``: the card's allocator snapshot.
- ``start_server``: the JAX package's live-capture endpoint, which
  ``torch.profiler`` has no counterpart of; it raises.
"""

from __future__ import annotations

import contextlib
import os
import pickle

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(log_dir: str):
    """Record everything inside the block and write
    ``<log_dir>/trace.json`` when it ends; yields the
    ``torch.profiler.profile`` object (its ``key_averages()`` sums the
    kernels by name).  The card's activity is recorded where CUDA is
    available."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def start_server(port: int = 9999):
    raise NotImplementedError(
        "torch.profiler has no live-capture server (jax.profiler."
        "start_server's counterpart); record a window with trace(dir)")


def annotate(name: str):
    return record_function(name)


def device_memory_profile(path: str):
    """Write the card's allocator state, ``torch.cuda.memory._snapshot()``
    (every segment and block, with the stack that allocated it where
    ``torch.cuda.memory._record_memory_history`` was on), pickled to
    ``path``; PyTorch's memory viz (pytorch.org/memory_viz) reads it.  The
    JAX package writes pprof instead: the formats differ."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_memory_profile needs a CUDA device")
    with open(path, "wb") as f:
        pickle.dump(torch.cuda.memory._snapshot(), f)
