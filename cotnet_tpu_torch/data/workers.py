"""The loader's worker processes: decode and host transforms of a chunk of
dataset indices, counterpart of ``cotnet_tpu/data/loader.py:33-137``.

This module, and all that a worker unpickles (the dataset, its transform,
``host_augment``), imports neither torch nor CUDA: a worker starts from a
fresh interpreter (``spawn``), and a torch import would cost each one
seconds and hundreds of MB.  The card is hidden from the workers while they
spawn (``CUDA_VISIBLE_DEVICES=""``), so nothing there can initialise it.
Functions are module-level for spawn's pickling.
"""

from __future__ import annotations

import os
import pickle
import random

import numpy as np

_WORKER_DS = None


def _proc_worker_init(ds_bytes: bytes, base_seed: int, wid_counter=None):
    """Runs once in each worker process."""
    global _WORKER_DS

    _WORKER_DS = pickle.loads(ds_bytes)
    # deterministic worker index (a shared counter, NOT the pid — pids vary
    # across runs, so pid-derived seeds are irreproducible by construction)
    if wid_counter is not None:
        with wid_counter.get_lock():
            wid = wid_counter.value
            wid_counter.value += 1
    else:
        wid = 0
    random.seed(base_seed * 100003 + wid)
    np.random.seed((base_seed * 100003 + wid) % (2 ** 31))
    # per-worker reseed for transforms carrying an explicit RandomState
    # (e.g. TfTrainPreprocess): the pickled copy is identical across workers
    t = getattr(_WORKER_DS, "transform", None)
    if getattr(t, "rng", None) is not None:
        t.rng = np.random.RandomState((base_seed + wid) % (2 ** 31))


def _sample_seed(chunk_seed: int, k: int) -> int:
    """Per-sample seed from a chunk seed + position (collision-free for
    batch sizes << 1000003)."""
    return (chunk_seed * 1000003 + k) % (2 ** 31)


def _proc_fetch(args):
    """Decode + transform a chunk of dataset indices in a worker process.

    Every random draw — geometric transform (global `random`) and policy
    augment (host_augment's per-sample rng) — is reseeded per SAMPLE from
    the chunk seed, so a run reproduces given the same loader seed/epoch
    regardless of how chunks land on workers."""
    idxs, seed = args
    from cotnet_tpu_torch.data.host_augment import seed_sample_rng

    transform = getattr(_WORKER_DS, "transform", None)
    has_rng = getattr(transform, "rng", None) is not None
    imgs, targets = [], []
    for k, i in enumerate(idxs):
        s = _sample_seed(seed, k)
        random.seed(s)
        seed_sample_rng(s)
        if has_rng:  # e.g. TfTrainPreprocess — pool scheduling must not
            transform.rng = np.random.RandomState(s)  # matter either
        im, t = _WORKER_DS[i]
        imgs.append(im)
        targets.append(t)
    return np.stack(imgs), np.asarray(targets, np.int64)


def _proc_warmup(secs):
    import sys
    import time

    time.sleep(secs)
    return os.getpid(), sorted(m for m in ("torch", "jax")
                               if m in sys.modules)


def _spawn_worker_pool(dataset, workers: int, seed: int):
    """ProcessPoolExecutor of ``workers`` spawned processes, each holding an
    unpickled copy of ``dataset``; the card is hidden from them.  Returns
    (pool, the modules of ``("torch", "jax")`` that any worker imported)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    # children inherit os.environ at spawn time: hide the card for the
    # spawn window, then restore the parent's setting
    saved = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    try:
        ctx = multiprocessing.get_context("spawn")
        pool = ProcessPoolExecutor(
            workers, mp_context=ctx,
            initializer=_proc_worker_init,
            initargs=(pickle.dumps(dataset), seed, ctx.Value("i", 0)))
        # force every worker to spawn inside the window (executors spawn
        # lazily; the concurrent sleeps need all of them)
        seen = list(pool.map(_proc_warmup, [0.2] * workers))
    finally:
        if saved is None:
            os.environ.pop("CUDA_VISIBLE_DEVICES", None)
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = saved
    return pool, sorted({m for _, mods in seen for m in mods})
