"""Benchmark: cotnet50 at 224x224, bs128, bf16 on one CUDA card, the
counterpart of the root ``bench.py``.

    python -m cotnet_tpu_torch.bench

Prints ONE JSON line: ``{"metric": ..., "value": N, "unit":
"images/sec/chip", "vs_baseline": N, "detail": {...}}``, with ``bench.py``'s
metric name and ``detail`` keys where PyTorch has a counterpart ("pallas"
names the Hopper kernels and "xla" the plain versions, the counterpart of
``impl="xla"``):

- the eval forward (``make_eval_step``'s forward) and the train step
  (``make_train_step``: forward, backward, plain SGD at LR 0.01, cross
  entropy), each through the Hopper kernels and through the plain versions
  (``block_args=dict(impl="torch")``), seeded random weights;
- ``repeats`` timed runs of ``iters`` (eval) / ``train_iters`` (train)
  back-to-back calls each, host clock from a synchronised start to a
  synchronised end, divided by the calls: what a user of the step sees,
  the host's enqueue included.  The kernel and plain runs alternate, the
  first of each pair swapping every repeat, so drift on the card falls on
  both alike;
- the median ms a batch with the (min, max) spread of the repeats, and
  images/s from the median; ``vs_baseline`` is the kernels' eval images/s
  over the plain versions'; ``value`` the better of the two;
- ``mfu``: the flop counter's multiply-adds (``ops/flops.py``) times two,
  over the kernels' eval time, over the H100's dense bf16 rate of its data
  sheet (989 TFLOP/s at 700 W; null on the CPU);
- the card's name and power limit from nvidia-smi.

Not carried over: ``bench.py``'s ``ideal_traffic_gb`` (a walk of the jaxpr,
which PyTorch has no counterpart of), its result cache, ``drift_vs_prev_run``
read from that cache, and its supervisor, which printed the cached number
after a timeout and exited 0.  Here a run that passes ``deadline_s`` raises
and the process exits non-zero, printing no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

import torch

# the dtype's name in the metric, as bench.py names bf16
DTYPE_NAMES = {torch.bfloat16: "bf16", torch.float16: "f16",
               torch.float32: "f32"}
# H100 SXM data sheet: dense tensor-core rate in bf16 (the same figure as
# chip_smoke.py's MATMUL_FLOPS_PER_S)
BF16_FLOPS_PER_S = 989e12


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def build(model_name: str, batch: int, size: int, impl: str, dtype,
          device, train: bool):
    """``(run, model)``: ``run()`` is one eval forward or one train step of
    the model on a fixed batch."""
    from cotnet_tpu_torch.models import create_model
    from cotnet_tpu_torch.train.loss import cross_entropy
    from cotnet_tpu_torch.train.state import TrainState
    from cotnet_tpu_torch.train.step import make_train_step

    model = create_model(model_name, device=device, dtype=dtype, seed=0,
                         block_args=dict(impl=impl))
    gen = torch.Generator(device=device).manual_seed(1)
    images = torch.randn((batch, 3, size, size), generator=gen,
                         device=device).to(dtype)
    if not train:
        def run():
            with torch.no_grad():
                return model(images)
        return run, model
    labels = torch.arange(batch, device=device) % 1000
    optimizer = torch.optim.SGD(model.parameters(), lr=0.01)
    step = make_train_step(model, optimizer, lambda s: 0.01, cross_entropy)
    state = TrainState.create(model, optimizer)
    batch_ = {"image": images, "label": labels}

    def run():
        return step(state, batch_, gen)[1]["loss"]
    return run, model


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def time_pair(runs: dict, iters: int, repeats: int, device,
              deadline: float, warmup: int = 3) -> dict:
    """Median, min and max seconds a call of each of ``runs``' functions,
    over ``repeats`` timed runs of ``iters`` calls after ``warmup`` calls
    each; the functions take turns, the first of each pair swapping every
    repeat."""
    names = list(runs)
    for name in names:
        for _ in range(warmup):
            runs[name]()
    _sync(device)
    times = {name: [] for name in names}
    for r in range(repeats):
        for name in (names if r % 2 == 0 else names[::-1]):
            if time.monotonic() > deadline:
                raise TimeoutError("bench passed its deadline")
            _sync(device)
            t = time.perf_counter()
            for _ in range(iters):
                runs[name]()
            _sync(device)
            times[name].append((time.perf_counter() - t) / iters)
    return {name: (statistics.median(ts), min(ts), max(ts))
            for name, ts in times.items()}


def main(model_name: str = "cotnet50", batch: int = 128, size: int = 224,
         dtype: torch.dtype = torch.bfloat16, iters: int = 50,
         train_iters: int = 40, repeats: int = 3, device="cuda",
         deadline_s: float = 1500.0) -> dict:
    """Run the bench and print its JSON line; returns the result.  The
    defaults are ``bench.py``'s; a test passes a toy size and ``device=
    "cpu"``."""
    from cotnet_tpu_torch.ops.flops import get_model_complexity

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the bench needs a CUDA device; pass "
                           "device='cpu' for a toy run of the plain versions")
    deadline = time.monotonic() + deadline_s
    on_card = device.type == "cuda"

    t = {}
    for train, n in ((False, iters), (True, train_iters)):
        built = {impl: build(model_name, batch, size, impl, dtype, device,
                             train)
                 for impl in ("auto", "torch")}
        t[train] = time_pair({k: v[0] for k, v in built.items()}, n, repeats,
                             device, deadline)
        if not train:
            gmacs, _ = get_model_complexity(built["auto"][1],
                                            (1, 3, size, size))
        del built
        if on_card:
            torch.cuda.empty_cache()

    ms = {k: [v * 1e3 for v in vals] for k, vals in t[False].items()}
    train_ms = {k: [v * 1e3 for v in vals] for k, vals in t[True].items()}
    ips, ips_xla = batch / t[False]["auto"][0], batch / t[False]["torch"][0]
    flops = 2 * gmacs * 1e9 * batch
    result = {
        "metric": f"{model_name}_{size}_bs{batch}_{DTYPE_NAMES[dtype]}"
                  "_infer_imgs_per_sec_chip",
        "value": max(ips, ips_xla),
        "unit": "images/sec/chip",
        "vs_baseline": ips / ips_xla,
        "detail": {
            "pallas_ips": ips, "xla_ips": ips_xla,
            "ms_per_batch_pallas": ms["auto"][0],
            "ms_per_batch_pallas_spread": ms["auto"][1:],
            "ms_per_batch_xla": ms["torch"][0],
            "ms_per_batch_xla_spread": ms["torch"][1:],
            "train_imgs_per_sec": batch / t[True]["auto"][0],
            "train_ms_per_batch": train_ms["auto"][0],
            "train_ms_per_batch_spread": train_ms["auto"][1:],
            "train_imgs_per_sec_xla": batch / t[True]["torch"][0],
            "train_ms_per_batch_xla": train_ms["torch"][0],
            "train_ms_per_batch_xla_spread": train_ms["torch"][1:],
            "train_vs_baseline": t[True]["torch"][0] / t[True]["auto"][0],
            "repeats": repeats, "iters": iters, "train_iters": train_iters,
            "gmacs_per_image": gmacs,
            "mfu": (flops / t[False]["auto"][0] / BF16_FLOPS_PER_S
                    if on_card else None),
            "platform": "gpu" if on_card else "cpu",
            "device": torch.cuda.get_device_name(device) if on_card
            else "cpu",
            "name_power_limit": nvidia_smi() if on_card else None,
        },
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
