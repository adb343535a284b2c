"""Host cost per image of the port's loader transforms, one process.

    PYTHONPATH=. python tools/torch_loader_host_cost.py [--images 64]

Writes ``chip_smoke.py``'s seeded JPEGs (500x375 and 375x500, quality 90)
to a temporary directory and times, per image on this host's CPU, each
stage of the CoTNet-50 recipe's train transform as ``Loader`` builds it
(decode with the train draft, RandomResizedCrop bicubic to 224 with hflip,
host ``rand-m15-mstd0.5-n2``, to uint8) and of the eval transform (decode
with the eval draft, ResizeCenterCrop 0.875 bicubic).  Prints one JSON
line: the mean ms of each stage, the host's CPU count, and the images/s
that ``--workers`` processes would reach if the stages scaled linearly.
Needs Pillow; runs without a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import statistics
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from cotnet_tpu_torch.data.dataset import _open_rgb  # noqa: E402
from cotnet_tpu_torch.data.host_augment import (create_host_augment,  # noqa: E402
                                                seed_sample_rng)
from cotnet_tpu_torch.data.transforms import (RandomHorizontalFlip,  # noqa: E402
                                              RandomResizedCropAndInterpolation,
                                              ResizeCenterCrop, ToUint8)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--images", type=int, default=64)
    ap.add_argument("--workers", type=int, default=chip_smoke.DATA_WORKERS)
    args = ap.parse_args()
    size = chip_smoke.IMAGE
    loader = chip_smoke.DATA_LOADER
    rrc = RandomResizedCropAndInterpolation(size, loader["scale"],
                                            loader["ratio"], "bicubic")
    flip = RandomHorizontalFlip(loader["hflip"])
    policy = create_host_augment(loader["auto_augment"])
    to_u8 = ToUint8()
    eval_crop = ResizeCenterCrop(size, 0.875, "bicubic")
    stages = {k: [] for k in ("decode_train", "crop_flip", "rand_augment",
                              "to_uint8", "decode_eval", "eval_crop")}
    with tempfile.TemporaryDirectory() as tmp:
        chip_smoke.write_image_tree(tmp, args.images, seed=0)
        paths = sorted(os.path.join(root, f) for root, _, files in
                       os.walk(tmp) for f in files)
        for i, path in enumerate(paths):
            random.seed(i)
            seed_sample_rng(i)
            t = [time.perf_counter()]
            img = _open_rgb(path, (2 * size, 2 * size))
            t.append(time.perf_counter())
            img = flip(rrc(img))
            t.append(time.perf_counter())
            img = policy(img)
            t.append(time.perf_counter())
            to_u8(img)
            t.append(time.perf_counter())
            img = _open_rgb(path, (int(size / 0.875),) * 2)
            t.append(time.perf_counter())
            to_u8(eval_crop(img))
            t.append(time.perf_counter())
            for key, a, b in zip(stages, t, t[1:]):
                stages[key].append((b - a) * 1e3)
    ms = {k: statistics.fmean(v) for k, v in stages.items()}
    train_ms = sum(ms[k] for k in ("decode_train", "crop_flip",
                                   "rand_augment", "to_uint8"))
    eval_ms = ms["decode_eval"] + ms["eval_crop"]
    print(json.dumps({
        "cpus": os.cpu_count(), "images": len(paths), "ms": ms,
        "train_ms_per_image": train_ms, "eval_ms_per_image": eval_ms,
        "workers": args.workers,
        "train_img_s_at_workers": args.workers * 1e3 / train_ms,
        "eval_img_s_at_workers": args.workers * 1e3 / eval_ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
