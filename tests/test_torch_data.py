"""Parity of the port's data pipeline (``cotnet_tpu_torch.data``) with the
JAX package's, on the CPU: the datasets, the host stage of the loader (decode,
geometric transforms, host policy augments, collate) byte for byte, the eval
padding and mask, the device normalize, the TF preprocessing goldens, ReaL
labels, the native batch ops, and the loader's batches, seeds and worker
processes.

The two packages share Python's global ``random`` (the thread path's
geometric draws ride it), so they run one after the other, never at once,
each from the same global seed.  With more than one thread the thread path
is not reproducible in either package; it is compared at ``workers=1``, the
worker processes at ``workers=2``.
"""

import json
import os
import random
import tarfile
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
pytest.importorskip("PIL")

import jax  # noqa: E402
from PIL import Image  # noqa: E402

import cotnet_tpu.data.dataset as jax_dataset  # noqa: E402
import cotnet_tpu.data.loader as jax_loader  # noqa: E402
from cotnet_tpu.data import native as jax_native  # noqa: E402
from cotnet_tpu.data.real_labels import RealLabelsImagenet as JaxReal  # noqa: E402
from cotnet_tpu_torch.data import dataset, native  # noqa: E402
from cotnet_tpu_torch.data import loader as port_loader  # noqa: E402
from cotnet_tpu_torch.data.real_labels import RealLabelsImagenet  # noqa: E402
from cotnet_tpu_torch.data.tf_preprocessing import TfEvalPreprocess  # noqa: E402

SIZE = 16
BATCH = 8


@pytest.fixture(scope="module")
def image_tree(tmp_path_factory):
    """4 classes (natural order a, b, c2, c10) of 5 images each: PNGs, and
    JPEGs of 64x48 and 48x64 that the loader's draft decode shrinks."""
    root = tmp_path_factory.mktemp("imgs")
    rng = np.random.RandomState(0)
    for ci, cls in enumerate(["class_b", "class_a", "class_c10", "class_c2"]):
        d = root / cls
        d.mkdir()
        for i in range(5):
            if i % 2:
                hw = (48, 64) if (ci + i) % 4 == 1 else (64, 48)
                yy, xx = np.mgrid[0:hw[0], 0:hw[1]]
                arr = np.clip(np.stack([
                    120 + 80 * np.sin(xx / (5 + c + ci)) + 40 * np.cos(yy / 7)
                    for c in range(3)], -1) + rng.normal(0, 12, (*hw, 3)),
                    0, 255).astype(np.uint8)
                Image.fromarray(arr).save(d / f"img{i}.jpg", quality=90)
            else:
                arr = rng.randint(0, 255, (40 + i, 50 + 3 * ci, 3),
                                  dtype=np.uint8)
                Image.fromarray(arr).save(d / f"img{i}.png")
    return str(root)


def test_image_folder_dataset_matches_jax(image_tree):
    ds = dataset.ImageFolderDataset(image_tree)
    ref = jax_dataset.ImageFolderDataset(image_tree)
    assert list(ds.class_to_idx.items()) == list(ref.class_to_idx.items())
    assert list(ds.class_to_idx) == ["class_a", "class_b", "class_c2",
                                     "class_c10"]
    assert ds.samples == ref.samples and len(ds) == 20
    assert ds.filenames(basename=True) == ref.filenames(basename=True)
    for i in (0, 3):
        (img, t), (ref_img, ref_t) = ds[i], ref[i]
        assert t == ref_t
        np.testing.assert_array_equal(np.asarray(img), np.asarray(ref_img))
    assert dataset.natural_key("a10b2") == jax_dataset.natural_key("a10b2")
    with pytest.raises(FileNotFoundError):
        dataset.ImageFolderDataset(os.path.join(image_tree, "missing"))


def test_tar_dataset_matches_jax(image_tree, tmp_path):
    tar_path = str(tmp_path / "data.tar")
    with tarfile.open(tar_path, "w") as tf:
        tf.add(image_tree, arcname=".")
    ds, ref = dataset.TarDataset(tar_path), jax_dataset.TarDataset(tar_path)
    assert ds.class_to_idx == ref.class_to_idx
    assert [(m.name, t) for m, t in ds.samples] == [
        (m.name, t) for m, t in ref.samples]
    assert ds.filenames(basename=True) == ref.filenames(basename=True)
    ds.draft_size = ref.draft_size = (16, 16)
    for i in (1, 7):
        (img, t), (ref_img, ref_t) = ds[i], ref[i]
        assert t == ref_t
        np.testing.assert_array_equal(np.asarray(img), np.asarray(ref_img))


def test_augmix_dataset_matches_jax(image_tree):
    ds = dataset.AugMixDataset(dataset.ImageFolderDataset(image_tree), 3)
    ref = jax_dataset.AugMixDataset(
        jax_dataset.ImageFolderDataset(image_tree), 3)
    (views, t), (ref_views, ref_t) = ds[2], ref[2]
    assert len(views) == len(ref_views) == 3 and t == ref_t
    for v, r in zip(views, ref_views):
        np.testing.assert_array_equal(np.asarray(v), np.asarray(r))
    with pytest.raises(AssertionError):
        dataset.AugMixDataset(ds.dataset, 1)


def test_open_rgb_draft_matches_jax(image_tree):
    path = os.path.join(image_tree, "class_a", "img1.jpg")
    for draft in (None, (16, 16), (40, 40)):
        np.testing.assert_array_equal(
            np.asarray(dataset._open_rgb(path, draft)),
            np.asarray(jax_dataset._open_rgb(path, draft)))
    assert max(dataset._open_rgb(path, (16, 16)).size) == 32  # 1/2 scale


# ---- the host stage, byte for byte ------------------------------------------

HOST_CONFIGS = {
    "rand": (True, dict(auto_augment="rand-m15-mstd0.5-n2")),
    "augmix": (True, dict(auto_augment="augmix-m5-w3")),
    "v0": (True, dict(auto_augment="v0")),
    "jitter": (True, dict(color_jitter=0.4)),
    "tf_train": (True, dict(tf_preprocessing=True)),
    "eval": (False, {}),
    "tf_eval": (False, dict(tf_preprocessing=True)),
}


def loader_kwargs(train, procs, **kw):
    return dict(batch_size=BATCH, train=train, image_size=SIZE,
                workers=2 if procs else 1, seed=3, worker_procs=procs, **kw)


def jax_host_batches(image_tree, train, procs, **kw):
    """The JAX ``Loader``'s host stage: its ``_Prefetcher`` as
    ``Loader.__iter__`` builds it (``loader.py:397-411``)."""
    ds = jax_dataset.ImageFolderDataset(image_tree)
    loader = jax_loader.Loader(ds, **loader_kwargs(train, procs, **kw))
    n = len(ds)
    indices = (np.random.RandomState(loader.seed + loader.epoch)
               .permutation(n) if train else np.arange(n))
    if procs:
        loader._pool = jax_loader._spawn_worker_pool(ds, loader.workers,
                                                     loader.seed)
    seed_thread_path(ds, procs)
    try:
        return [tuple(np.array(a) for a in item) for item in
                jax_loader._Prefetcher(
                    ds, indices, BATCH, loader.workers, drop_last=train,
                    pad_last=not train, proc_pool=loader._pool,
                    seed=loader.seed * 131 + loader.epoch)]
    finally:
        # the JAX loader's close does not wait for its workers; a worker
        # still starting then finds the pool's shared counter gone
        # (SemLock._rebuild: FileNotFoundError), so wait for them first
        if loader._pool is not None:
            loader._pool.shutdown(wait=True, cancel_futures=True)
        loader.close()


def port_host_batches(image_tree, train, procs, **kw):
    ds = dataset.ImageFolderDataset(image_tree)
    loader = port_loader.Loader(ds, device="cpu",
                                **loader_kwargs(train, procs, **kw))
    seed_thread_path(ds, procs)
    try:
        return [(imgs.numpy().copy(), labels, mask)
                for imgs, labels, mask in loader.host_batches()]
    finally:
        loader.close()


def seed_thread_path(ds, procs):
    """The thread path's draws: the global ``random`` (geometric
    transforms) and TfTrainPreprocess's own RandomState, which the worker
    processes reseed per sample."""
    if not procs:
        random.seed(5)
        if hasattr(ds.transform, "rng"):
            ds.transform.rng = np.random.RandomState(7)


@pytest.mark.parametrize("procs", [False, True], ids=["threads", "procs"])
@pytest.mark.parametrize("config", list(HOST_CONFIGS))
def test_host_stage_matches_jax(image_tree, config, procs):
    train, kw = HOST_CONFIGS[config]
    ref = jax_host_batches(image_tree, train, procs, **kw)
    got = port_host_batches(image_tree, train, procs, **kw)
    assert len(got) == len(ref) == (2 if train else 3)
    for (imgs, labels, mask), (r_imgs, r_labels, r_mask) in zip(got, ref):
        assert imgs.dtype == np.uint8 and imgs.shape == (BATCH, SIZE, SIZE,
                                                         3)
        np.testing.assert_array_equal(imgs, r_imgs)
        np.testing.assert_array_equal(labels, r_labels)
        np.testing.assert_array_equal(mask, r_mask)
    if not train:
        # 20 images: the last batch pads 4 with the last image, valid 4
        assert [m.sum() for _, _, m in got] == [8, 8, 4]
        np.testing.assert_array_equal(got[-1][0][4:],
                                      np.repeat(got[-1][0][3:4], 4, 0))


def test_epochs_reproduce_across_fresh_pools(image_tree):
    """Worker seeds come from a worker index, not the pid, and every draw
    from the per-sample seed: two fresh pools give the same bytes; the
    next epoch differs.  The workers import no torch."""
    ds = dataset.ImageFolderDataset(image_tree)

    def epoch(e):
        loader = port_loader.Loader(
            ds, device="cpu", auto_augment="augmix-m5-w3",
            **loader_kwargs(True, True))
        loader.set_epoch(e)
        try:
            out = [imgs.numpy().copy() for imgs, _, _ in loader.host_batches()]
            assert loader.worker_imports == []
            return np.stack(out)
        finally:
            loader.close()

    first = epoch(0)
    np.testing.assert_array_equal(first, epoch(0))
    assert not np.array_equal(first, epoch(1))


# ---- the loader's batches ---------------------------------------------------

def test_device_augment_normalize_matches_jax():
    """Without a policy or erasing the device function is the normalize:
    JAX's NHWC output, permuted, within 1e-5."""
    batch = np.random.RandomState(0).randint(0, 256, (3, 9, 7, 3), np.uint8)
    ref = np.asarray(jax_loader.make_device_augment()(
        jax.random.PRNGKey(0), batch)).transpose(0, 3, 1, 2)
    got = port_loader.make_device_augment()(torch.from_numpy(batch))
    assert got.is_contiguous() and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    bf16 = port_loader.make_device_augment(dtype=torch.bfloat16)(
        torch.from_numpy(batch))
    assert bf16.dtype == torch.bfloat16


def test_loader_batches(image_tree):
    """Train with the device policy, aug splits and erasing, and eval:
    contiguous NCHW images of the dtype, int64 labels, float32 valid."""
    ds = dataset.ImageFolderDataset(image_tree)
    loader = port_loader.Loader(
        ds, batch_size=4, train=True, image_size=SIZE, workers=2, seed=1,
        auto_augment="augmix-m3-w2", num_aug_splits=3, reprob=0.5,
        dtype=torch.bfloat16, device="cpu")
    batches = list(loader)
    assert len(batches) == len(loader) == 5
    b = batches[0]
    assert b["image"].shape == (12, 3, SIZE, SIZE)
    assert b["image"].dtype == torch.bfloat16 and b["image"].is_contiguous()
    assert b["label"].dtype == torch.int64 and b["label"].shape == (4,)
    assert b["valid"].dtype == torch.float32
    assert torch.isfinite(b["image"].float()).all()
    # the clean split is the normalized host batch; augmented ones differ
    assert not torch.equal(b["image"][:4], b["image"][4:8])
    val = port_loader.Loader(ds, batch_size=8, train=False, image_size=SIZE,
                             workers=2, device="cpu")
    batches = list(val)
    assert [int(b["valid"].sum()) for b in batches] == [8, 8, 4]
    assert batches[-1]["image"].shape == (8, 3, SIZE, SIZE)


def test_loader_device_draws_follow_the_batch_seed(image_tree):
    """Batch ``i`` of epoch ``e`` is the device augment of the host batch
    with a generator seeded by ``batch_seed(seed, e, i)``."""
    ds = dataset.ImageFolderDataset(image_tree)
    loader = port_loader.Loader(
        ds, batch_size=8, train=True, image_size=SIZE, workers=1, seed=4,
        auto_augment="rand-m9-n2", aug_backend="device", reprob=0.5,
        device="cpu")
    loader.set_epoch(2)
    random.seed(0)
    got = [b["image"] for b in loader]
    random.seed(0)
    host = [imgs for imgs, _, _ in loader.host_batches()]
    for i, (imgs, image) in enumerate(zip(host, got)):
        gen = torch.Generator().manual_seed(port_loader.batch_seed(4, 2, i))
        torch.testing.assert_close(loader.device_augment(imgs, gen), image,
                                   rtol=0, atol=0)
    assert port_loader.batch_seed(4, 2, 1) == (4002 * 1000003 + 1)


def test_loader_sets_draft_size(image_tree):
    ds = dataset.ImageFolderDataset(image_tree)
    kw = dict(batch_size=4, image_size=224, device="cpu")
    port_loader.Loader(ds, train=False, crop_pct=0.875, **kw)
    assert ds.draft_size == (256, 256)
    port_loader.Loader(ds, train=False, draft_decode=False, **kw)
    assert ds.draft_size is None
    port_loader.Loader(ds, train=True, **kw)
    assert ds.draft_size == (448, 448)
    port_loader.Loader(ds, train=True, tf_preprocessing=True, **kw)
    assert ds.draft_size is None


def test_loader_places_the_policy_as_jax_does(image_tree, monkeypatch):
    """Host by default; on the device with aug_backend='device',
    num_aug_splits or tf_preprocessing."""
    from cotnet_tpu_torch.data.host_augment import HostRandAugment
    from cotnet_tpu_torch.data.rand_augment import RandAugment

    ds = dataset.ImageFolderDataset(image_tree)
    make = port_loader.make_device_augment
    device_policy = []

    def spy(mean, std, policy, *args, **kwargs):
        device_policy.append(policy)
        return make(mean, std, policy, *args, **kwargs)

    monkeypatch.setattr(port_loader, "make_device_augment", spy)

    def placed(**kw):
        port_loader.Loader(ds, batch_size=4, train=True, device="cpu",
                           auto_augment="rand-m9-n2", **kw)
        host = any(isinstance(f, HostRandAugment)
                   for f in getattr(ds.transform, "fns", []))
        return host, isinstance(device_policy[-1], RandAugment)

    assert placed() == (True, False)
    assert placed(aug_backend="device") == (False, True)
    assert placed(num_aug_splits=2) == (False, True)
    assert placed(tf_preprocessing=True) == (False, True)
    with pytest.raises(ValueError):
        placed(aug_backend="gpu")


def test_prefetcher_stops_when_left_early(image_tree):
    """Closing an epoch after its first batch stops the prefetch thread,
    which would otherwise wait forever on a full queue."""
    import threading
    import time

    ds = dataset.ImageFolderDataset(image_tree)
    loader = port_loader.Loader(ds, batch_size=2, train=False,
                                image_size=SIZE, workers=2, device="cpu")
    before = threading.active_count()
    for _ in range(3):
        batches = loader.host_batches()
        next(batches)
        batches.close()
    deadline = time.monotonic() + 10
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.05)
    assert threading.active_count() == before
    # an epoch run to its end after that is whole
    assert len(list(loader)) == 10


def test_loader_needs_a_card_for_cuda(image_tree):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    ds = dataset.ImageFolderDataset(image_tree)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_loader.Loader(ds, batch_size=4, train=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_loader.SyntheticLoader(4)


def test_synthetic_loader():
    loader = port_loader.SyntheticLoader(batch_size=4, image_size=16,
                                         num_classes=3, steps=3,
                                         dtype=torch.bfloat16, device="cpu")
    batches = list(loader)
    assert len(batches) == len(loader) == 3
    b = batches[0]
    assert b["image"].shape == (4, 3, 16, 16)
    assert b["image"].dtype == torch.bfloat16
    assert b["label"].tolist() == [0, 1, 2, 0]
    again = next(iter(loader))["image"]
    assert torch.equal(again, b["image"])


# ---- TF preprocessing, ReaL labels, native ops -------------------------------

def test_tf_preprocessing_goldens():
    """``tests/data/tf_goldens.npz`` (recorded TensorFlow output) through
    the port's TfEvalPreprocess, at the JAX test's bounds."""
    import io

    z = np.load(os.path.join(os.path.dirname(__file__), "data",
                             "tf_goldens.npz"))
    n_imgs = len([k for k in z.files if k.startswith("jpeg_")])
    assert n_imgs >= 5
    for i in range(n_imgs):
        img = Image.open(io.BytesIO(z[f"jpeg_{i}"].tobytes()))
        for size, method in ((224, "bicubic"), (224, "bilinear"),
                             (240, "bicubic")):
            gold = z[f"gold_{i}_{size}_{method}"]
            d = np.abs(TfEvalPreprocess(size, method)(img).astype(np.int32)
                       - gold.astype(np.int32))
            assert d.max() <= 1 and (d > 0).mean() <= 1e-4, (i, size, method)


def test_real_labels_match_jax(tmp_path):
    rng = np.random.RandomState(0)
    n, k = 12, 10
    labels = [sorted(rng.choice(k, rng.randint(0, 3), replace=False).tolist())
              for _ in range(n)]
    path = tmp_path / "real.json"
    path.write_text(json.dumps(labels))
    names = [f"/val/ILSVRC2012_val_{i + 1:08d}.JPEG" for i in range(n)]
    logits = rng.randn(n, k).astype(np.float32)
    real, ref = (RealLabelsImagenet(names, str(path)),
                 JaxReal(names, str(path)))
    for lo in (0, 5):
        real.add_result(logits[lo:lo + 5] if lo == 0 else logits[lo:])
        ref.add_result(logits[lo:lo + 5] if lo == 0 else logits[lo:])
    assert real.get_accuracy() == ref.get_accuracy()
    assert real.get_accuracy(1) == ref.get_accuracy(1)
    scored = sum(1 for v in labels if v)
    assert len(real.is_correct[1]) == scored
    with pytest.raises(IndexError):
        real.add_result(logits[:1])
    real.reset()
    real.add_result(np.argsort(-logits, -1)[:, :5])
    ref.reset()
    ref.add_result(np.argsort(-logits, -1)[:, :5])
    assert real.get_accuracy() == ref.get_accuracy()


def _jax_native_settled(tries: int = 60, wait_s: float = 0.5) -> bool:
    """Whether the JAX package's native library loads, given time to settle.

    Its loader has g++ write ``native/libbatchops.so`` in place, and a test
    process that loads the file while another one is still writing it keeps
    ``_lib = False`` for good.  So forget a failed load and try again, a
    bounded number of times, with a short sleep between."""
    for _ in range(tries):
        if jax_native.available():
            return True
        jax_native._lib = None
        time.sleep(wait_s)
    return jax_native.available()


def test_native_ops_match_jax():
    assert native.available() and _jax_native_settled()
    assert native.library_path().parent.name == "_build"
    rng = np.random.RandomState(3)
    imgs = [rng.randint(0, 255, (20 + i, 30 - i, 3), np.uint8)
            for i in range(5)]
    boxes = [(1, 2, 17, 15), (0, 0, 29, 21), (5, 3, 10, 12), (2, 1, 20, 20),
             (0, 4, 26, 19)]
    np.testing.assert_array_equal(
        native.batch_crop_resize(imgs, boxes, (13, 11), num_threads=3),
        jax_native.batch_crop_resize(imgs, boxes, (13, 11), num_threads=3))
    same = [rng.randint(0, 255, (8, 9, 3), np.uint8) for _ in range(6)]
    ref = jax_native.batch_collate(same, num_threads=3)
    np.testing.assert_array_equal(native.batch_collate(same, 3), ref)
    out = torch.empty((6, 8, 9, 3), dtype=torch.uint8)
    assert native.batch_collate(same, 2, out=out.numpy()) is not None
    np.testing.assert_array_equal(out.numpy(), ref)
    with pytest.raises(ValueError):
        native.batch_collate(same, 2, out=np.empty((5, 8, 9, 3), np.uint8))
    img = rng.randint(0, 255, (7, 9, 3), np.uint8)
    np.testing.assert_array_equal(native.hflip_inplace(img.copy()),
                                  jax_native.hflip_inplace(img.copy()))
    with pytest.raises(ValueError):
        native.batch_crop_resize(imgs[:1], [(0, 0, 40, 5)], (4, 4))
