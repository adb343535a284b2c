"""Input pipeline: host decode/crop -> device-side augmentation, counterpart
of ``cotnet_tpu/data/loader.py`` (reference datasets/loader.py).

- Worker processes (``workers.py``) or a thread pool decode and transform
  to uint8 HWC; the prefetch thread collates each batch into a pinned host
  buffer (``native.batch_collate`` where the library built) behind a
  double-buffered queue;
- the uint8 NHWC batch goes to the device with a ``non_blocking`` copy (a
  quarter of the float bytes), where ``make_device_augment`` runs the policy
  augment (if on the device), normalize, RandomErasing and the cast, and
  hands the model a contiguous NCHW batch;
- eval pads the final batch and carries a ``valid`` mask instead of the
  reference's silent rank-striding.  There is one process: a per-rank
  split of the indices comes with data parallelism.

Every draw is seeded.  The host draws per sample, from the loader seed,
the epoch and the sample's place (``workers._sample_seed``); the device
draws per batch from a ``torch.Generator`` on the loader's device, seeded
with ``batch_seed(seed, epoch, i) = ((seed * 1000 + epoch) * 1000003 + i)
mod 2**63`` for batch ``i``, the counterpart of the JAX package's
``fold_in(PRNGKey(seed * 1000 + epoch), i)``.
"""

from __future__ import annotations

import math
import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from cotnet_tpu_torch.data import native
from cotnet_tpu_torch.data.auto_augment import create_batch_augment
from cotnet_tpu_torch.data.host_augment import (create_host_augment,
                                                seed_sample_rng)
from cotnet_tpu_torch.data.random_erasing import RandomErasing
from cotnet_tpu_torch.data.tf_preprocessing import (TfEvalPreprocess,
                                                    TfTrainPreprocess)
from cotnet_tpu_torch.data.transforms import (create_eval_transform,
                                              create_train_transform)
from cotnet_tpu_torch.data.workers import (_proc_fetch, _sample_seed,
                                           _spawn_worker_pool)

IMAGENET_DEFAULT_MEAN = (0.485, 0.456, 0.406)
IMAGENET_DEFAULT_STD = (0.229, 0.224, 0.225)


def batch_seed(seed: int, epoch: int, i: int) -> int:
    """The device generator's seed for batch ``i`` of ``epoch``."""
    return ((seed * 1000 + epoch) * 1000003 + i) % (2 ** 63)


def make_device_augment(mean=IMAGENET_DEFAULT_MEAN, std=IMAGENET_DEFAULT_STD,
                        policy=None,
                        random_erasing: Optional[RandomErasing] = None,
                        dtype: torch.dtype = torch.float32,
                        num_aug_splits: int = 0):
    """The uint8 NHWC batch -> normalized NCHW batch device function,
    ``device_augment(batch_u8, generator)``, in the JAX package's order:
    ``policy`` (a RandAugment / AutoAugment / AugMix of this package, or
    None) -> ``(x - 255 mean) / (255 std)`` -> ``random_erasing`` -> cast
    to ``dtype``.

    ``num_aug_splits`` > 1 produces [clean; aug_1; ...; aug_{S-1}] stacked on
    the batch dim (the AugMixDataset arrangement, dataset.py:181-218) for JSD
    consistency training — the clean split skips the policy augmentation."""
    mean = torch.tensor(mean, dtype=torch.float32) * 255.0
    std = torch.tensor(std, dtype=torch.float32) * 255.0

    def device_augment(batch_u8, generator: Optional[torch.Generator] = None):
        x = batch_u8.permute(0, 3, 1, 2).to(
            torch.float32, memory_format=torch.contiguous_format)
        if num_aug_splits > 1 and policy is not None:
            x = torch.cat([x] + [policy(x, generator)
                                 for _ in range(num_aug_splits - 1)])
        elif policy is not None:
            x = policy(x, generator)
        x = ((x - mean.to(x.device).reshape(1, 3, 1, 1))
             / std.to(x.device).reshape(1, 3, 1, 1))
        if random_erasing is not None:
            x = random_erasing(x, generator)
        return x.to(dtype)

    return device_augment


class _Prefetcher:
    """Prefetch pipeline: index batches -> collated uint8 NHWC batches.

    Yields ``(images, labels, mask)``: ``images`` a uint8 ``[n, H, W, 3]``
    tensor (pinned host memory with ``pin_memory``), ``labels`` int64 and
    ``mask`` float32 numpy arrays.  Decode+transform runs either on a
    worker-process pool (``proc_pool``, scales with cores — the default for
    real training via ``Loader(worker_procs=True)``) or an in-process thread
    pool (cheap to set up; GIL-bound, fine for tests/small runs)."""

    def __init__(self, dataset, indices, batch_size, workers=8, depth=4,
                 drop_last=True, pad_last=False, proc_pool=None, seed=0,
                 pin_memory=False):
        self.dataset = dataset
        self.indices = indices
        self.batch_size = batch_size
        self.workers = max(1, workers)
        self.depth = depth
        self.drop_last = drop_last
        self.pad_last = pad_last
        self.proc_pool = proc_pool
        self.seed = seed
        self.pin_memory = pin_memory

    def _batches(self):
        n = len(self.indices)
        for i in range(0, n, self.batch_size):
            chunk = self.indices[i:i + self.batch_size]
            if len(chunk) < self.batch_size:
                if self.drop_last:
                    return
                if self.pad_last:
                    pad = [chunk[-1]] * (self.batch_size - len(chunk))
                    yield list(chunk) + pad, len(chunk)
                    return
            yield list(chunk), len(chunk)

    def _buffer(self, shape):
        """A uint8 host tensor of ``shape`` (pinned with ``pin_memory``;
        the caching host allocator keeps it until its copy has run)."""
        return torch.empty(shape, dtype=torch.uint8,
                           pin_memory=self.pin_memory)

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        stop = object()
        stopped = threading.Event()  # the consumer left early
        errors = []

        def put(item) -> bool:
            while not stopped.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def fetch_procs(pool, chunk, bidx):
            sub = max(1, -(-len(chunk) // self.workers))
            parts = [(chunk[j:j + sub], self.seed * 1000003 + bidx * 997 + j)
                     for j in range(0, len(chunk), sub)]
            results = list(pool.map(_proc_fetch, parts))
            first = results[0][0]
            imgs = self._buffer((len(chunk), *first.shape[1:]))
            np.concatenate([r[0] for r in results], out=imgs.numpy())
            labels = np.concatenate([r[1] for r in results])
            return imgs, labels

        def worker():
            try:
                from concurrent.futures import ThreadPoolExecutor

                use_native = native.available()

                def fetch_one(args):
                    # per-sample policy-augment seeding (thread-local); the
                    # geometric transforms ride the thread-shared global
                    # `random` here; the worker-procs path seeds those per
                    # sample too (workers._proc_fetch)
                    bseed, k, i = args
                    seed_sample_rng(_sample_seed(bseed, k))
                    return self.dataset[i]

                with ThreadPoolExecutor(self.workers) as pool:
                    for bidx, (chunk, valid) in enumerate(self._batches()):
                        if self.proc_pool is not None:
                            imgs, labels = fetch_procs(self.proc_pool, chunk,
                                                       bidx)
                        else:
                            bseed = self.seed * 1000003 + bidx * 997
                            samples = list(pool.map(
                                fetch_one,
                                [(bseed, k, i)
                                 for k, i in enumerate(chunk)]))
                            arrs = [np.asarray(s[0]) for s in samples]
                            imgs = self._buffer((len(arrs), *arrs[0].shape))
                            if (use_native and arrs[0].ndim == 3
                                    and arrs[0].dtype == np.uint8
                                    and all(a.shape == arrs[0].shape
                                            for a in arrs)):
                                # multithreaded C++ collate — np.stack
                                # memcpys single-threaded, ~19 MB per
                                # bs128@224 batch on the host critical path
                                native.batch_collate(arrs, self.workers,
                                                     out=imgs.numpy())
                            else:
                                np.stack(arrs, out=imgs.numpy())
                            labels = np.asarray([s[1] for s in samples],
                                                np.int64)
                        mask = np.zeros((len(chunk),), np.float32)
                        mask[:valid] = 1.0
                        if not put((imgs, labels, mask)):
                            return
            except BaseException as err:  # re-raised in the consumer
                errors.append(err)
            finally:
                put(stop)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                yield item
        finally:
            stopped.set()
            t.join()
        if errors:
            raise errors[0]


class Loader:
    """Training/eval loader yielding device-ready batches: ``{"image":
    [N, 3, H, W] dtype, contiguous, "label": [N] int64, "valid": [N]
    float32}`` on ``device`` (``[S*N, ...]`` images with ``num_aug_splits``
    S > 1).

    train=True: shuffled (per-epoch seed), drop_last, device augmentation.
    train=False: ordered, final batch padded with a ``valid`` mask (exact
    top-1 counting — fixes the reference OrderedDistributedSampler's silent
    uneven shards, distributed_sampler.py:55).

    The arguments and defaults are the JAX package's, but ``dtype`` is a
    torch dtype, ``device`` is where the batches go (``"cuda"``, which
    raises without a card, or ``"cpu"``), and there is no ``mesh``.  Policy
    augments run on the host unless ``aug_backend="device"``,
    ``num_aug_splits`` or ``tf_preprocessing`` puts them on the device.
    """

    def __init__(self, dataset, batch_size: int, train: bool,
                 image_size: int = 224, workers: int = 8,
                 mean=IMAGENET_DEFAULT_MEAN, std=IMAGENET_DEFAULT_STD,
                 interpolation: str = "random", crop_pct: float = 0.875,
                 scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3), hflip: float = 0.5,
                 vflip: float = 0.0, color_jitter: Optional[float] = 0.4,
                 auto_augment: Optional[str] = None,
                 reprob: float = 0.0, remode: str = "pixel", recount: int = 1,
                 num_aug_splits: int = 0, dtype: torch.dtype = torch.float32,
                 seed: int = 0, tf_preprocessing: bool = False,
                 worker_procs: bool = False, aug_backend: str = "host",
                 draft_decode: bool = True, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Loader(device='cuda') needs a CUDA device; "
                               "pass device='cpu' to load onto the CPU")
        if aug_backend not in ("host", "device"):
            raise ValueError(f"unknown aug_backend {aug_backend!r}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.train = train
        self.workers = workers
        self.seed = seed
        self.epoch = 0
        self.worker_procs = worker_procs
        self._pool = None  # lazy; persists across epochs
        self.worker_imports = None  # what the workers imported, once spawned
        dataset.draft_size = None  # (re)set below; the dataset is shared
        if train:
            # Policy augments (RandAugment/AutoAugment/AugMix) default to
            # the HOST workers (PIL, reference transforms_factory.py:86-98
            # semantics); aug_backend="device" runs them on the device.
            # num_aug_splits (AugMix JSD) keeps the device path: the split
            # semantics are implemented there.
            host_aug = None
            if (aug_backend == "host" and auto_augment
                    and not num_aug_splits and not tf_preprocessing):
                host_aug = create_host_augment(auto_augment)
            if tf_preprocessing:
                # TF-graph-parity host transform (reference loader.py:155,
                # transforms_factory.py:196-198); policy augments still
                # apply on device below.  No draft decode: the TF goldens
                # pin the full-resolution decode.
                dataset.transform = TfTrainPreprocess(
                    image_size, hflip=hflip,
                    interpolation=interpolation
                    if interpolation != "random" else "bicubic")
            else:
                dataset.transform = create_train_transform(
                    image_size, scale, ratio, hflip, vflip, interpolation,
                    color_jitter=None if auto_augment else color_jitter,
                    policy_augment=host_aug)
                if draft_decode:
                    # decode-at-scale with a 2x quality margin: the RRC
                    # crop resamples to image_size anyway; only images
                    # larger than 2x the target take the DCT downscale
                    dataset.draft_size = (2 * image_size, 2 * image_size)
            policy = (None if host_aug is not None
                      else create_batch_augment(auto_augment))
            erasing = (RandomErasing(reprob, mode=remode, count=recount,
                                     num_splits=num_aug_splits)
                       if reprob > 0 else None)
            self.device_augment = make_device_augment(
                mean, std, policy, erasing, dtype,
                num_aug_splits=num_aug_splits)
        else:
            interp = interpolation if interpolation != "random" else "bicubic"
            if tf_preprocessing:
                dataset.transform = TfEvalPreprocess(image_size, interp)
            else:
                dataset.transform = create_eval_transform(image_size,
                                                          crop_pct, interp)
                if draft_decode:
                    # draft to the resize target: the shorter side lands
                    # >= scale_size, the bicubic resize then only
                    # downscales
                    ss = int(math.floor(image_size / crop_pct))
                    dataset.draft_size = (ss, ss)
            self.device_augment = make_device_augment(mean, std, None, None,
                                                      dtype)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def close(self):
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __len__(self):
        n = len(self.dataset)
        if self.train:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def start_workers(self):
        """Spawn the worker processes, with ``worker_procs``, where they are
        not running yet (the first epoch does it otherwise); they persist
        across epochs until ``close``."""
        if self.worker_procs and self._pool is None:
            self._pool, self.worker_imports = _spawn_worker_pool(
                self.dataset, self.workers, self.seed)

    def host_batches(self) -> Iterator[tuple]:
        """The host stage of an epoch: ``(uint8 NHWC images, int64 labels,
        float32 mask)`` per batch, as the prefetcher collates them."""
        n = len(self.dataset)
        if self.train:
            indices = np.random.RandomState(self.seed + self.epoch
                                            ).permutation(n)
        else:
            indices = np.arange(n)
        self.start_workers()
        return iter(_Prefetcher(
            self.dataset, indices, self.batch_size, self.workers,
            drop_last=self.train, pad_last=not self.train,
            proc_pool=self._pool, seed=self.seed * 131 + self.epoch,
            pin_memory=self.device.type == "cuda"))

    def __iter__(self) -> Iterator[dict]:
        generator = torch.Generator(device=self.device)
        for i, (imgs, labels, mask) in enumerate(self.host_batches()):
            generator.manual_seed(batch_seed(self.seed, self.epoch, i))
            batch_u8 = imgs.to(self.device, non_blocking=True)
            yield {"image": self.device_augment(batch_u8, generator),
                   "label": torch.from_numpy(labels).to(self.device),
                   "valid": torch.from_numpy(mask).to(self.device)}


class SyntheticLoader:
    """Random batches for smoke tests and benches (no reference analog):
    one NCHW batch of normal images, drawn once from a generator seeded
    with ``seed`` on ``device``, yielded ``steps`` times."""

    def __init__(self, batch_size: int, image_size: int = 224,
                 num_classes: int = 1000, steps: int = 100,
                 dtype: torch.dtype = torch.float32, seed: int = 0,
                 device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("SyntheticLoader(device='cuda') needs a CUDA "
                               "device; pass device='cpu'")
        self.batch_size, self.image_size = batch_size, image_size
        self.num_classes, self.steps = num_classes, steps
        self.dtype, self.seed = dtype, seed

    def set_epoch(self, epoch: int):
        pass

    def __len__(self):
        return self.steps

    def __iter__(self):
        generator = torch.Generator(device=self.device).manual_seed(self.seed)
        n, s = self.batch_size, self.image_size
        batch = {
            "image": torch.randn((n, 3, s, s), generator=generator,
                                 device=self.device).to(self.dtype),
            "label": torch.arange(n, device=self.device) % self.num_classes,
            "valid": torch.ones((n,), device=self.device)}
        for _ in range(self.steps):
            yield batch
