#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``cotnet_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the run exits non-zero without
printing the last line:

1. Device: the card's name and power limit (nvidia-smi), and the set-up
   time, which includes building the CUDA kernels from the sources in
   ``cotnet_tpu_torch/ops/csrc`` with nvcc, one compiler per source, all
   started together; per kernel function, its registers, shared memory
   and spills (ptxas) and its SASS instruction count (cuobjdump).
2. Model, eval: cotnet50 with seeded random weights (random BN running
   stats and a non-zero ``bn3`` scale, so every residual branch reaches the
   logits).  f32 logits through the kernel against the plain path; the
   kernel's launch count per forward; then the eval main path, the bf16
   eval step at 224x224 bs128, with its images/s, its kernel launches
   counted by input shape, the bf16 logits against the f32 ones, and one
   step under torch.profiler.
3. Model, training: f32 gradients of one loss through the three kernels
   against the plain path (bs16, TF32 off), with 16 forward, 16 dx and 16
   dw launches and no plain call, and every backward launch held against
   the plain backward on the model's own tensors; five f32 steps on one
   batch at a constant LR, which must lower the loss; then the train main
   path, the bf16 ``make_train_step`` at 224x224 bs128 under the CoTNet-50
   recipe (mixup and cutmix, dropout 0.25, stochastic depth 0.1, nesterov
   SGD with masked weight decay, cosine warm-up, EMA), 2 warm-up and 8
   timed steps, with its images/s, peak memory, launches of each kernel by
   input shape, and one step under torch.profiler.
4. The switches and CoTNeXt.  For cotnet50 and for cotnext50_2x48d, in f32
   at bs16 with TF32 off: the logits of the fused-embed eval
   (``mega_fuse=True``) against the unfused ones of the same weights; one
   loss and backward of the folded model (``gn_fold_train=True``) with
   every affine backward launch held against the plain affine backward on
   the model's own tensors; five f32 steps of the folded model, which must
   lower the loss.  Then the bf16 main paths at 224x224 bs128, each with
   its images/s, launches of every kernel by input shape, no plain call
   and one step under torch.profiler: path A, the folded train step, and
   path B, the fused-embed eval, for both models; for cotnext50_2x48d its
   default eval and train steps as well.
5. SE-CoTNetD: se_cotnetd_152 with seeded random weights, calibrated
   as in phase 2.  In f32 at bs4 and 256x256 with TF32 off: logits
   through the kernels against the plain path, 21 forward launches and no
   plain call; every dx and dw launch of one backward held against the
   plain backward on the model's own tensors; five steps that lower the
   loss.  Then its bf16 main paths: the eval step at 256x256 bs128 and the
   train step at 256x256 bs64 under its recipe
   (``cot_experiments/SE-CoTNetD-152_350epoch/config.yaml``: drop 0.25,
   drop path 0.15, LR 0.2, the rest as CoTNet-50's), each with images/s,
   peak memory, launches by kernel and input shape (21 a step, at the
   pre-pool 32x32 and 16x16 maps too), no plain call and a profile.
6. The op entry points: the mix op's main path, one autograd call of
   ``local_aggregate_mix`` (and of ``_merge`` with the packed weight) at
   cotnet50's four geometries in bf16 at bs128, each one launch of each
   mix kernel, the forward, dx and dw on their ``tiles`` route, and no
   plain call;
   ``local_aggregate_dilated`` with dilations 1 and 2 in f32, forward and
   gradients against the plain path, one forward, dx and dw launch per
   distinct dilation.
7. Kernels: each Hopper kernel against its plain PyTorch version on the
   card.  The forward at the four aggregation geometries of cotnet50
   (N=128), the four per-group ones of cotnext50_2x48d (N=256) and those
   of se_cotnetd_152 (N=128 and 64), bf16, with and without the GroupNorm
   affine, general f32 cases (heads=2, K=5 and 7, dilation 2, odd H != W),
   a reflect-padded case, the edges of the halo tiles in bf16 (a 3x3 map,
   57x57, 13x11 with Cw=6, N=1 at 56x56) and the geometries beyond them
   (K=5 on 3x513 and K=3 on 2x2049 in bf16, K=9 in bf16, K=7 at dilation
   8 on 16x256 in f32), each forward, dx, dw and affine dw entry naming
   the route its launcher took (``variant``: ``k3``, ``general`` or
   ``pointwise``; the geometries beyond the tiles must take ``pointwise``,
   every main path ``k3``); the backward kernels (dx, dw, and with the
   affine dx and dw+ds+db) at the same geometries, the reflect case
   through autograd as well, each affine dw launched twice and its dw, ds
   and db bit-identical; the fused embed kernels at the eight
   geometries of the two models with a fused-embed path, at general f32
   cases (K=5 with dilation 2 and K=7, non-square maps, two groups), at
   the halo tiles' edges in bf16 and f32, at whole 7x7 planes with Cp=256
   and at K=3 on 2x2049 (which must take ``pointwise``), each naming its
   route (``ops.local_agg.embed_gn_route``), launched twice for the same
   bits, with the device time of its statistics and aggregation kernels
   (torch.profiler; no statistics launch where a block holds whole
   planes, ``embed_gn_stats_rows`` on the tiled routes), the statistics
   pass's own bound, and the device time of one torch.matmul that forms
   w_raw of the same shapes; where a plane spans several row tiles (57x57,
   N=1 at 56x56, the two models' 56x56), the statistics pass's plane totals
   against the pointwise route's, in bf16 and f32 within 1e-6 of the
   largest, and equal on integer inputs; the
   three mix kernels (forward, dx, dw) at cotnet50's four geometries in
   bf16, at a general f32 case (heads 2, 13x11, Cw dividing C four
   times), at the edges of the dx and dw tiles in bf16 (3x3, 57x57, 13x11
   with Cw=6, N=1 at 56x56) and at 2x2049 (which must take
   ``pointwise``), the weights separate and packed, each naming its route
   (``ops.local_agg.mix_route``: ``tiles`` or ``pointwise``; the mix
   path's launches must take ``tiles``), launched twice for the same bits,
   and timed on the pointwise route too (the first kernels, one thread per
   output, which are that route), the forward's and dw's two routes
   compared bit for bit (the forward's must agree).  CUDA-event times of kernel and plain version beside the bound
   (data-sheet rates) and the byte bound at the device copy rate measured
   first; each case's launches in the main paths' runs (0 for a shape no
   main path launches).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch

# H100 SXM data sheet: HBM3 rate, the f32 rate outside the tensor cores (the
# taps' products and sums are f32 FMAs), and the dense tensor-core rate of a
# matrix product by the type of its operands (an f32 product at the f32 rate)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
MATMUL_FLOPS_PER_S = {torch.bfloat16: 989e12, torch.float16: 989e12,
                      torch.float32: 67e12}
L2_FLUSH_BYTES = 256 << 20
# the main paths' batch; the train step of se_cotnetd_152 takes its
# recipe's per-process batch instead (TRAIN_BATCH)
BATCH = 128
# the image size of cotnet50 and cotnext50_2x48d
IMAGE = 224
# (C, map size, CoT layers at that size): the launches per forward the
# main path must make at each shape
COTNET50_GEOMETRIES = ((64, 56, 3), (128, 28, 4), (256, 14, 6), (512, 7, 3))
# se_cotnetd_152 at 256 px: stage 3's even blocks (the first before its
# BlurPool, at 32x32) and all of stage 4 (the first at 16x16)
SE_COTNETD_152_GEOMETRIES = ((256, 32, 1), (256, 16, 17), (512, 16, 1),
                             (512, 8, 2))
# model -> (channel groups of its CoT layers, geometries per group, image
# size): the groups of a CoXtLayer run as images of a batch BATCH * groups
MODELS = {
    "cotnet50": (1, COTNET50_GEOMETRIES, 224),
    "cotnext50_2x48d": (2, ((48, 56, 3), (96, 28, 4), (192, 14, 6),
                            (384, 7, 3)), 224),
    "se_cotnetd_152": (1, SE_COTNETD_152_GEOMETRIES, 256),
}
# the models whose main paths include path B (the fused-embed eval)
FUSED_MODELS = ("cotnet50", "cotnext50_2x48d")
TRAIN_BATCH = {"se_cotnetd_152": 64}
REPLACES = ("cotnet_tpu/ops/local_agg_pallas.py:447 _fwd_kernel, "
            ":451 _fwd_kernel_affine, :952 _fwd_chwn_kernel, "
            ":1066 _fwd_chwn_strip_kernel")
_REPLACES_FUSED_BWD = (
    "cotnet_tpu/ops/local_agg_pallas.py:1210 _bwd_chwn_strip_g_kernel, "
    ":977 _dxdw_chwn_kernel, :571 _dxdw_gather_kernel, "
    ":628 _dxdw_scatter_kernel")
REPLACES_BWD = {
    "dx": _REPLACES_FUSED_BWD + ", :481 _dx_gather_kernel, :477 _dx_kernel",
    "dw": _REPLACES_FUSED_BWD + ", :516 _dw_kernel, :548 _dw_kernel_dot, "
          ":765 _dw_wloop_kernel, :836 _dw_strip_kernel",
}
# the recipe of cot_experiments/CoTNet-50-350epoch/config.yaml
RECIPE = {
    "model": dict(drop_rate=0.25, drop_path_rate=0.1),
    "mixup": dict(mixup_alpha=0.8, cutmix_alpha=1.0, prob=1.0,
                  switch_prob=0.5, mode="batch", label_smoothing=0.1,
                  num_classes=1000),
    "loss": dict(smoothing=0.1),
    "solver": dict(opt="sgd", momentum=0.9, weight_decay=4e-5,
                   sched="cosine", lr=0.25, warmup_lr=1e-4, min_lr=1e-5,
                   epochs=350, warmup_epochs=5, decay_rate=0.1),
    "ema_decay": 0.9999,
}
# the recipe of cot_experiments/SE-CoTNetD-152_350epoch/config.yaml: drop
# path 0.15 and LR 0.2, the rest as CoTNet-50's
RECIPES = {
    "cotnet50": RECIPE,
    "cotnext50_2x48d": RECIPE,
    "se_cotnetd_152": dict(
        RECIPE, model=dict(drop_rate=0.25, drop_path_rate=0.15),
        solver=dict(RECIPE["solver"], lr=0.2)),
}
REPLACES_MIX = {
    "fwd": "cotnet_tpu/ops/local_agg_pallas.py:2217 _mix_fwd_kernel",
    "dx": "cotnet_tpu/ops/local_agg_pallas.py:2233 _mix_dx_kernel",
    "dw": "cotnet_tpu/ops/local_agg_pallas.py:2248 _mix_dw_kernel",
}
# the route of every main-path launch of a kernel; "k3" where not named
MAIN_ROUTE = {"local_agg_mix_fwd": "tiles", "local_agg_mix_dx": "tiles",
              "local_agg_mix_dw": "tiles"}
REPLACES_AFFINE_BWD = {
    "dx": "cotnet_tpu/ops/local_agg_pallas.py:512 _dx_kernel_affine",
    "dw": "cotnet_tpu/ops/local_agg_pallas.py:697 _dw_kernel_affine",
}
REPLACES_EMBED_GN = "cotnet_tpu/ops/local_agg_pallas.py:1985 _fused_embed_kernel"
# the fused embed op's kernels, as the profiler names them: the statistics
# pass (not launched where a block holds whole planes) on its tiled routes
# or its pointwise one, and the aggregation on each
EMBED_GN_STATS = ("embed_gn_stats_rows", "embed_gn_stats")
EMBED_GN_AGG = ("embed_gn_agg", "embed_gn_agg_pointwise")
IMAGENET_TRAIN_IMAGES = 1281167
# the kernels a main path of each kind must launch once per CoT layer a
# step (16 in cotnet50 and cotnext50_2x48d, 21 in se_cotnetd_152); every
# other count, the plain versions' and the mix kernels' included, must be 0
PATH_KERNELS = {
    "eval": ("fwd_affine",),
    "eval_fused": ("embed_gn",),
    "train": ("fwd", "dx", "dw"),
    "train_fold": ("fwd_affine", "dx_affine", "dw_affine"),
}


def log(*args):
    print(*args, flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def device_ms(fn, runs: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn()`` in ms over ``runs`` CUDA-event timed
    calls.  Before each call the L2 is flushed and the stream is held busy
    with a spin, so the timed window holds the device work only, started
    cold, and not the host's time to enqueue it."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_ms_by_name(fn, names, runs: int = 20, warmup: int = 3) -> dict:
    """Device time a call of ``fn()`` spends in the kernels of each name
    (a template's name ends at its "<", any other at its "("), in ms: under
    torch.profiler over ``runs`` cold-L2 calls as ``device_ms`` makes them,
    the total by name over ``runs``.  None where the profiler recorded no
    device time at all (not measured)."""
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            flush.zero_()
            torch.cuda._sleep(2_000_000)
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    if not rows:
        return {name: None for name in names}
    return {name: sum(ms for key, ms in rows
                      if f"{name}<" in key or f"{name}(" in key) / runs
            for name in names}


def copy_rate() -> float:
    """Device memory rate in bytes/s, measured: a 1 GiB device-to-device
    copy reads and writes 1 GiB each."""
    src = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    ms = device_ms(lambda: dst.copy_(src), runs=10)
    return 2 * src.numel() / (ms * 1e-3)


def bounds_ms(nbytes: int, flops: int, matmul_flops: int = 0,
              matmul_dtype=torch.float32) -> tuple:
    """(bound ms, 'bytes' or 'operations') at the data-sheet rates: the
    bytes, or the f32 operations plus those of a matrix product at the
    rate of its operands' type, whichever takes longer."""
    bounds = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
              "operations": (flops / F32_FLOPS_PER_S + matmul_flops
                             / MATMUL_FLOPS_PER_S[matmul_dtype]) * 1e3}
    by = max(bounds, key=bounds.get)
    return bounds[by], by


def tolerance(dtype, ref) -> tuple:
    """(rtol, atol) of a kernel against its plain version."""
    if dtype == torch.float32:
        # only the summation order differs
        return 1e-5, 1e-5
    # both sides sum in f32 from the same 16-bit inputs and round once: at
    # most 1 bf16 ulp of the reference apart
    return 8e-3, 1e-3 * float(ref.float().abs().max())


def check_close(what, got, ref, dtype) -> tuple:
    """Raise unless ``got`` is within the tolerance of ``ref``; returns
    (max |err|, rtol, atol)."""
    rtol, atol = tolerance(dtype, ref)
    err = (got.float() - ref.float()).abs()
    bad = int((err > atol + rtol * ref.float().abs()).sum())
    if bad:
        raise AssertionError(f"kernel != plain at {what}: {bad} elements, "
                             f"max |err| {float(err.max())}")
    return float(err.max()), rtol, atol


def kernel_cases() -> list:
    cases = []
    for name, (groups, geometries, _) in MODELS.items():
        for batch in sorted({BATCH, TRAIN_BATCH.get(name, BATCH)},
                            reverse=True):
            for c, hw, _ in geometries:
                case = dict(n=batch * groups, c=c, h=hw, w=hw, heads=1,
                            cw=c // 8, k=3, dil=1, pad_mode="zeros",
                            dtype=torch.bfloat16)
                if case not in cases:
                    cases.append(case)
    for k in (5, 7):
        cases.append(dict(n=4, c=32, h=13, w=11, heads=2, cw=8, k=k, dil=2,
                          pad_mode="zeros", dtype=torch.float32))
    cases.append(dict(n=8, c=64, h=14, w=14, heads=1, cw=8, k=3, dil=1,
                      pad_mode="reflect", dtype=torch.float32))
    # the edges of the forward's and dx's row tiles and vectors: a map
    # smaller than one tile, a height no multiple of the tile, an odd width
    # with Cw no multiple of the vector width, N = 1
    for n, c, cw, h, w in ((2, 64, 8, 3, 3), (2, 64, 8, 57, 57),
                           (4, 48, 6, 13, 11), (1, 64, 8, 56, 56)):
        cases.append(dict(n=n, c=c, h=h, w=w, heads=1, cw=cw, k=3, dil=1,
                          pad_mode="zeros", dtype=torch.bfloat16))
    # the geometries the halo tiles do not take, which the forward, dx and
    # dw run on their pointwise route: a row of more than 512 thread items
    # in the general instantiation (K = 5, Wo = 513) and at K = 3 (Wo =
    # 2049), K = 9, and an f32 halo tile beyond a block's shared memory
    # (K = 7 at dilation 8 on 16x256: 49 staged rows of 304 elements, four
    # stages, 238 KB)
    for n, c, cw, h, w, k, dil, dt in (
            (1, 16, 8, 3, 513, 5, 1, torch.bfloat16),
            (1, 16, 8, 2, 2049, 3, 1, torch.bfloat16),
            (2, 16, 4, 13, 11, 9, 1, torch.bfloat16),
            (1, 16, 8, 16, 256, 7, 8, torch.float32)):
        cases.append(dict(n=n, c=c, h=h, w=w, heads=1, cw=cw, k=k, dil=dil,
                          pad_mode="zeros", dtype=dt, route="pointwise"))
    return cases


def route(la, kernel: str, cs, x, w, pad: int) -> str:
    """The route (``k3``, ``general`` or ``pointwise``) that the launcher of
    ``kernel`` (fwd, dx, dw or dw_affine) takes for x and w with the
    kernel's own padding, as the kernel's library decides it; raises unless
    it is the case's own (``route``, where the case names one)."""
    k, dil = cs["k"], cs["dil"]
    got = la.kernel_route(kernel, x, w, kernel_size=(k, k),
                          dilation=(dil, dil), padding=(pad, pad))
    if got != cs.get("route", got):
        raise AssertionError(f"{kernel} at {describe(cs, pad)} took the "
                             f"{got} route, not {cs['route']}")
    return got


def describe(cs, pad, affine=False) -> str:
    return (f"N={cs['n']} C={cs['c']} {cs['h']}x{cs['w']} "
            f"heads={cs['heads']} Cw={cs['cw']} K={cs['k']} dil={cs['dil']} "
            f"pad={pad} {cs['pad_mode']} "
            f"{str(cs['dtype']).replace('torch.', '')}"
            f"{' affine' if affine else ''}")


def new_key(counts: dict, before: dict):
    """The one key of ``counts`` that grew by one since ``before``."""
    new = [key for key, count in counts.items()
           if count != before.get(key, 0)]
    if len(new) != 1 or counts[new[0]] != before.get(new[0], 0) + 1:
        raise AssertionError("the kernel did not launch once")
    return new[0]


def launch_snapshot(la) -> dict:
    """The wrappers' counts as they stand: ``by_key`` maps (kernel, launch
    key) to launches, with the kernel named fwd, dx, dw (``_affine`` added
    where the GroupNorm affine was folded in) or embed_gn; ``plain`` is the
    number of calls of any plain version."""
    by_key = {}
    for key, count in la.LAUNCHES_BY_SHAPE.items():
        by_key[("fwd_affine" if key[1] else "fwd", key)] = count
    for (kernel, key), count in la.BWD_LAUNCHES_BY_SHAPE.items():
        by_key[(kernel + ("_affine" if key[1] else ""), key)] = count
    for key, count in la.EMBED_GN_LAUNCHES_BY_SHAPE.items():
        by_key[("embed_gn", key)] = count
    for (kernel, key), count in la.MIX_LAUNCHES_BY_SHAPE.items():
        by_key[("mix_" + kernel, key)] = count

    def total(*kernels):
        return sum(c for (k, _), c in by_key.items() if k in kernels)

    # the totals and the counts by shape are kept apart in the wrappers
    if (la.LAUNCHES, la.BWD_LAUNCHES, la.AFFINE_BWD_LAUNCHES,
            la.EMBED_GN_LAUNCHES, la.MIX_LAUNCHES) != (
            total("fwd", "fwd_affine"),
            {"dx": total("dx"), "dw": total("dw")},
            {"dx": total("dx_affine"), "dw": total("dw_affine")},
            total("embed_gn"),
            {k: total("mix_" + k) for k in ("fwd", "dx", "dw")}):
        raise AssertionError("launch totals disagree with the counts by "
                             "shape")
    return {"by_key": by_key,
            "plain": (la.PLAIN_CALLS + la.PLAIN_BWD_CALLS
                      + la.PLAIN_EMBED_GN_CALLS + la.PLAIN_MIX_CALLS)}


class PathCounts:
    """What each main path launched: (kernel, launch key) -> {path label:
    (launches, steps of that path's run)}."""

    def __init__(self):
        self.by_key = {}

    def record(self, la, label: str, steps: int) -> dict:
        """Read the counts a main path's run left; returns the snapshot."""
        snapshot = launch_snapshot(la)
        for key, count in snapshot["by_key"].items():
            self.by_key.setdefault(key, {})[label] = (count, steps)
        return snapshot

    def entry(self, kernel: str, key) -> dict:
        """The ``launches`` keys of a kernel entry."""
        by_path = self.by_key.get((kernel, key), {})
        return {"launches": sum(c for c, _ in by_path.values()),
                "launches_by_path": {
                    label: {"launches": c, "steps": n}
                    for label, (c, n) in by_path.items()}}


def check_path_launches(snapshot: dict, kind: str, model_name: str,
                        steps: int, batch: int = BATCH):
    """Raise unless a main path's run launched exactly the kernels of its
    kind, each once per CoT layer and step at the model's bf16 geometries
    at ``batch``, no other kernel of the op (the mix kernels included), and
    called no plain version."""
    groups, geometries, _ = MODELS[model_name]
    want = {(c, hw): per_step * steps for c, hw, per_step in geometries}
    kernels = {kernel for kernel, _ in snapshot["by_key"]}
    for kernel in kernels | set(PATH_KERNELS[kind]):
        got = {}
        for (kern, key), count in snapshot["by_key"].items():
            if kern != kernel:
                continue
            if kernel not in PATH_KERNELS[kind]:
                raise AssertionError(f"{model_name} {kind}: {kernel} "
                                     f"launched {count} times at {key}")
            if kernel == "embed_gn":
                dtype, (n, c, h, w), _, key_groups, *_ = key
                n, c = n * key_groups, c // key_groups
            else:
                dtype, _, (n, c, h, w), *_ = key
            if not (dtype == "bfloat16" and n == batch * groups and h == w):
                raise AssertionError(f"{model_name} {kind}: {kernel} "
                                     f"launched at {key}")
            got[(c, h)] = got.get((c, h), 0) + count
        if got != (want if kernel in PATH_KERNELS[kind] else {}):
            raise AssertionError(f"{model_name} {kind}: {kernel} launches by "
                                 f"(C, map) {got} in {steps} steps")
    if snapshot["plain"]:
        raise AssertionError(f"{model_name} {kind}: {snapshot['plain']} "
                             "calls of a plain version")


def kernel_phase(la, hbm_rate: float, paths: PathCounts) -> list:
    """Forward kernel vs plain version on the card; returns the kernel
    entries.  ``hbm_rate`` is the measured copy rate, for a second byte
    bound; ``paths`` holds what the main paths launched."""
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, dtype=torch.float32, scale=1.0, shift=0.0):
        t = torch.randn(*shape, generator=gen, device="cuda") * scale + shift
        return t.to(dtype)

    entries = []
    for cs in kernel_cases():
        for affine in ((True,) if cs["pad_mode"] == "reflect"
                       else (False, True)):
            n, c, h, w, heads, cw, k = (cs[key] for key in (
                "n", "c", "h", "w", "heads", "cw", "k"))
            dt, dil = cs["dtype"], cs["dil"]
            pad = (dil * (k - 1) + 1) // 2
            x = randn(n, c, h, w, dtype=dt)
            wt = randn(n, heads, cw, k * k, h, w, dtype=dt)
            # what the kernel sees: a reflect pad is made outside it
            xk, kpad = x, pad
            if cs["pad_mode"] == "reflect":
                xk = x.new_empty(n, c, h + 2 * pad, w + 2 * pad,
                                 device="meta")
                kpad = 0
            s = b = None
            if affine:
                s = randn(n, heads, cw, k * k, scale=0.5, shift=1.0)
                b = randn(n, heads, cw, k * k, scale=0.5)
            kw = dict(kernel_size=k, padding=pad, dilation=dil,
                      pad_mode=cs["pad_mode"], w_scale=s, w_bias=b)
            before = dict(la.LAUNCHES_BY_SHAPE)
            with torch.no_grad():
                got = la.local_aggregate(x, wt, impl="hopper", **kw)
                torch.cuda.synchronize()
                launches = paths.entry(
                    "fwd_affine" if affine else "fwd",
                    new_key(la.LAUNCHES_BY_SHAPE, before))
                ref = la.local_aggregate(x, wt, impl="torch", **kw)
                geometry = describe(cs, pad, affine)
                max_err, rtol, atol = check_close(geometry, got, ref, dt)
                ms = device_ms(lambda: la.local_aggregate(
                    x, wt, impl="hopper", **kw))
                plain_ms = device_ms(lambda: la.local_aggregate(
                    x, wt, impl="torch", **kw))
            item = x.element_size()
            nbytes = (x.numel() + wt.numel() + got.numel()) * item
            if s is not None:
                nbytes += (s.numel() + b.numel()) * 4
            # a multiply and an add per tap, and w*s + b once per weight
            flops = 2 * got.numel() * k * k + (2 * wt.numel() if affine
                                               else 0)
            bound, bound_by = bounds_ms(nbytes, flops)
            entries.append({
                "name": "local_agg_fwd", "route": "cuda",
                "source": "cotnet_tpu_torch/ops/csrc/local_agg_fwd.cu",
                "replaces": REPLACES, "geometry": geometry,
                "variant": route(la, "fwd", cs, xk, wt, kpad),
                **launches,
                "max_abs_err": max_err, "tol": {"rtol": rtol, "atol": atol},
                "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": bound_by,
                "bound_ms_at_copy_rate": nbytes / hbm_rate * 1e3,
                "library_ms": None})
            log_entry(entries[-1])
    return entries


def log_entry(e):
    variant_note = f" ({e['variant']})" if "variant" in e else ""
    if "pointwise_ms" in e:
        variant_note += (f" [pointwise route {e['pointwise_ms']:.4f} ms"
                         + (f", same bits: {e['same_bits_as_pointwise']}"
                            if "same_bits_as_pointwise" in e else "") + "]")
    log(f"kernel {e['name']}{variant_note} {e['geometry']}: max|err| "
        f"{e['max_abs_err']:.3g} (rtol {e['tol']['rtol']}, atol "
        f"{e['tol']['atol']:.3g}); kernel {e['ms']:.4f} ms, plain "
        f"{e['plain_ms']:.4f} ms, bound {e['bound_ms']:.4f} ms "
        f"({e['bound_by']}; {100 * e['bound_ms'] / e['ms']:.1f}% of it), "
        f"{e['bound_ms_at_copy_rate']:.4f} ms at the copy rate; "
        f"{e['launches']} launches in the main paths")


def valid_taps(size_in, size_out, k, pad, dil) -> int:
    """Along one axis: the (output position, tap) pairs whose input
    position lies inside the image."""
    return sum(1 for o in range(size_out) for i in range(k)
               if 0 <= o - pad + i * dil < size_in)


def bwd_kernel_phase(la, hbm_rate: float, paths: PathCounts) -> list:
    """The two backward kernels vs the plain backward on the card; returns
    their entries."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(1)

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    entries = []
    for cs in kernel_cases():
        n, c, h, w, heads, cw, k = (cs[key] for key in (
            "n", "c", "h", "w", "heads", "cw", "k"))
        dt, dil = cs["dtype"], cs["dil"]
        pad = (dil * (k - 1) + 1) // 2
        x = randn(n, c, h, w, dtype=dt)
        wt = randn(n, heads, cw, k * k, h, w, dtype=dt)
        dy = randn(n, heads * c, h, w, dtype=dt)
        geometry = describe(cs, pad)
        if cs["pad_mode"] == "reflect":
            # through autograd: the reflect pad is differentiated outside
            # the op, the kernels see the padded input with no pad of
            # their own
            grads = {}
            for impl in ("hopper", "torch"):
                xg, wg = x.clone().requires_grad_(), wt.clone().requires_grad_()
                out = la.local_aggregate(xg, wg, kernel_size=k, padding=pad,
                                         dilation=dil, pad_mode="reflect",
                                         impl=impl)
                grads[impl] = torch.autograd.grad(out, (xg, wg), dy)
            for name, got, ref in zip(("dx", "dw"), *grads.values()):
                check_close(f"{geometry} autograd {name}", got, ref, dt)
            x, kpad = F.pad(x, (pad,) * 4, mode="reflect"), 0
        else:
            kpad = pad
        xp = F.pad(x, (kpad,) * 4)
        hi, wi = x.shape[2:]
        geo = dict(kernel_size=(k, k), dilation=(dil, dil),
                   padding=(kpad, kpad))
        pairs = (valid_taps(hi, h, k, kpad, dil)
                 * valid_taps(wi, w, k, kpad, dil))
        for kernel in ("dx", "dw"):
            need = dict(need_dx=kernel == "dx", need_dw=kernel == "dw")
            pick = 0 if kernel == "dx" else 1
            before = dict(la.BWD_LAUNCHES_BY_SHAPE)
            got = la.local_aggregate_bwd_hopper(x, wt, dy, **geo, **need)[pick]
            torch.cuda.synchronize()
            launches = paths.entry(
                kernel, new_key(la.BWD_LAUNCHES_BY_SHAPE, before)[1])
            ref = la.local_aggregate_bwd_plain(xp, wt, dy, (k, k), (dil, dil),
                                               **need)[pick]
            if kernel == "dx":
                ref = ref[..., kpad:kpad + hi, kpad:kpad + wi]
            max_err, rtol, atol = check_close(f"{geometry} {kernel}", got,
                                              ref, dt)
            ms = device_ms(lambda: la.local_aggregate_bwd_hopper(
                x, wt, dy, **geo, **need))
            plain_ms = device_ms(lambda: la.local_aggregate_bwd_plain(
                xp, wt, dy, (k, k), (dil, dil), **need))
            # dx reads w and dy and writes dx; dw reads x and dy and writes
            # dw; a multiply and an add per (channel, head, in-image tap)
            other = wt if kernel == "dx" else x
            nbytes = (other.numel() + dy.numel() + got.numel()) \
                * x.element_size()
            flops = 2 * n * heads * c * pairs
            bound, bound_by = bounds_ms(nbytes, flops)
            entries.append({
                "name": f"local_agg_bwd_{kernel}", "route": "cuda",
                "source": "cotnet_tpu_torch/ops/csrc/local_agg_bwd.cu",
                "replaces": REPLACES_BWD[kernel], "geometry": geometry,
                "variant": route(la, kernel, cs, x, wt, kpad),
                **launches, "max_abs_err": max_err, "tol": {"rtol": rtol, "atol": atol},
                "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": bound_by,
                "bound_ms_at_copy_rate": nbytes / hbm_rate * 1e3,
                "library_ms": None})
            log_entry(entries[-1])
    return entries


def check_sums(what, got, ref, factor: float = 1.0) -> float:
    """ds and db are f32 sums over Ho*Wo positions of f32 terms that kernel
    and plain version form alike; only the order of the sum differs (a
    thread's stride, a warp's butterfly, the warps in turn, against
    torch's own).  So they are held as a whole: ``max|err| <= factor *
    1e-5 * max|ref|``; the largest ratio seen at any geometry is 3e-7.
    Returns max|err|."""
    err = float((got - ref).abs().max())
    if not err <= factor * 1e-5 * float(ref.abs().max()):
        raise AssertionError(f"kernel != plain at {what}: max|err| {err}, "
                             f"max|ref| {float(ref.abs().max())}")
    return err


def affine_bwd_kernel_phase(la, hbm_rate: float, paths: PathCounts) -> list:
    """The two backward kernels of the aggregation with the folded affine
    (dx; dw with ds and db) vs the plain affine backward on the card;
    returns their entries."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(8)

    def randn(*shape, dtype=torch.float32, scale=1.0, shift=0.0):
        t = torch.randn(*shape, generator=gen, device="cuda") * scale + shift
        return t.to(dtype)

    entries = []
    for cs in kernel_cases():
        n, c, h, w, heads, cw, k = (cs[key] for key in (
            "n", "c", "h", "w", "heads", "cw", "k"))
        dt, dil = cs["dtype"], cs["dil"]
        pad = (dil * (k - 1) + 1) // 2
        x = randn(n, c, h, w, dtype=dt)
        wt = randn(n, heads, cw, k * k, h, w, dtype=dt)
        s = randn(n, heads, cw, k * k, scale=0.5, shift=1.0)
        b = randn(n, heads, cw, k * k, scale=0.5)
        dy = randn(n, heads * c, h, w, dtype=dt)
        geometry = describe(cs, pad, affine=True)
        if cs["pad_mode"] == "reflect":
            # through autograd: the reflect pad is differentiated outside
            # the op, the kernels see the padded input
            grads = {}
            for impl in ("hopper", "torch"):
                leaves = [t.clone().requires_grad_() for t in (x, wt, s, b)]
                out = la.local_aggregate(
                    leaves[0], leaves[1], kernel_size=k, padding=pad,
                    dilation=dil, pad_mode="reflect", impl=impl,
                    w_scale=leaves[2], w_bias=leaves[3])
                grads[impl] = torch.autograd.grad(out, leaves, dy)
            for name, got, ref in zip(("dx", "dw"), *grads.values()):
                check_close(f"{geometry} autograd {name}", got, ref, dt)
            for name, got, ref in zip(("ds", "db"), grads["hopper"][2:],
                                      grads["torch"][2:]):
                check_sums(f"{geometry} autograd {name}", got, ref)
            x, kpad = F.pad(x, (pad,) * 4, mode="reflect"), 0
        else:
            kpad = pad
        xp = F.pad(x, (kpad,) * 4)
        hi, wi = x.shape[2:]
        geo = dict(kernel_size=(k, k), dilation=(dil, dil),
                   padding=(kpad, kpad))
        pairs = (valid_taps(hi, h, k, kpad, dil)
                 * valid_taps(wi, w, k, kpad, dil))
        item = x.element_size()
        for kernel in ("dx", "dw"):
            need = dict(need_dx=kernel == "dx", need_dw=kernel == "dw")
            before = dict(la.BWD_LAUNCHES_BY_SHAPE)
            got = la.local_aggregate_bwd_affine_hopper(x, wt, s, b, dy, **geo,
                                                       **need)
            torch.cuda.synchronize()
            launches = paths.entry(
                f"{kernel}_affine",
                new_key(la.BWD_LAUNCHES_BY_SHAPE, before)[1])
            ref = la.local_aggregate_bwd_affine_plain(
                xp, wt, s, b, dy, (k, k), (dil, dil), **need)
            extra = {}
            if kernel == "dx":
                max_err, rtol, atol = check_close(
                    f"{geometry} dx", got[0],
                    ref[0][..., kpad:kpad + hi, kpad:kpad + wi], dt)
                # reads w, dy, s and b, writes dx; per (channel, head,
                # in-image tap) a multiply and an add, and w*s + b once per
                # weight
                nbytes = (wt.numel() + dy.numel() + x.numel()) * item \
                    + (s.numel() + b.numel()) * 4
                flops = 2 * n * heads * c * pairs + 2 * wt.numel()
            else:
                max_err, rtol, atol = check_close(f"{geometry} dw", got[1],
                                                  ref[1], dt)
                # a second launch gives the same bits: ds and db are summed
                # in a fixed order, across a plane's row tiles too
                again = la.local_aggregate_bwd_affine_hopper(
                    x, wt, s, b, dy, **geo, **need)
                if not all(torch.equal(a, g)
                           for a, g in zip(again[1:], got[1:])):
                    raise AssertionError(f"affine dw at {geometry}: a second "
                                         "launch gave other bits")
                # ds's and db's partial sums across a plane's row tiles,
                # written once and read once (0: one tile a plane)
                part = la.dw_affine_workspace_bytes(x, wt, **geo)
                extra = {"ds_max_abs_err": check_sums(f"{geometry} ds",
                                                      got[2], ref[2]),
                         "db_max_abs_err": check_sums(f"{geometry} db",
                                                      got[3], ref[3]),
                         "sums_tol": "1e-5 * max|ref|",
                         "deterministic": True, "workspace_bytes": part,
                         "bound_ms_with_workspace": (
                             ((x.numel() + dy.numel() + 2 * wt.numel())
                              * item + 3 * s.numel() * 4 + 2 * part)
                             / HBM_BYTES_PER_S * 1e3)}
                # reads x, dy, w and s, writes dw, ds and db; the group sum
                # per in-image tap, then gn*s, gn*w summed and gn summed
                nbytes = (x.numel() + dy.numel() + 2 * wt.numel()) * item \
                    + 3 * s.numel() * 4
                flops = 2 * n * heads * c * pairs + 4 * wt.numel()
            ms = device_ms(lambda: la.local_aggregate_bwd_affine_hopper(
                x, wt, s, b, dy, **geo, **need))
            plain_ms = device_ms(lambda: la.local_aggregate_bwd_affine_plain(
                xp, wt, s, b, dy, (k, k), (dil, dil), **need))
            bound, bound_by = bounds_ms(nbytes, flops)
            entries.append({
                "name": f"local_agg_bwd_{kernel}_affine", "route": "cuda",
                "source": "cotnet_tpu_torch/ops/csrc/local_agg_bwd.cu",
                "replaces": REPLACES_AFFINE_BWD[kernel], "geometry": geometry,
                "variant": route(la, "dx" if kernel == "dx" else "dw_affine",
                                 cs, x, wt, kpad),
                **launches, "max_abs_err": max_err,
                "tol": {"rtol": rtol, "atol": atol}, **extra,
                "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": bound_by,
                "bound_ms_at_copy_rate": nbytes / hbm_rate * 1e3,
                "library_ms": None})
            log_entry(entries[-1])
    return entries


def embed_gn_cases() -> list:
    """x ``[n, c, h, w]``, w_pre ``[n, cp, h, w]`` as the models call the
    fused op (cp = c/2, Cw = c/8 over all groups), then general f32 cases.
    ``stats_check``: the cases whose planes span several row tiles, where
    ``stats_totals_check`` holds the statistics pass against the pointwise
    route's."""
    cases = []
    for name in FUSED_MODELS:
        groups, geometries, _ = MODELS[name]
        for c, hw, _ in geometries:
            cases.append(dict(n=BATCH, c=c * groups, cp=c * groups // 2,
                              h=hw, w=hw, k=3, dil=1, groups=groups,
                              dtype=torch.bfloat16, stats_check=hw == 56))
    cases.append(dict(n=3, c=32, cp=24, h=13, w=11, k=5, dil=2, groups=1,
                      dtype=torch.float32))
    cases.append(dict(n=2, c=16, cp=40, h=6, w=5, k=7, dil=1, groups=1,
                      dtype=torch.float32))
    cases.append(dict(n=4, c=96, cp=48, h=9, w=14, k=3, dil=1, groups=2,
                      dtype=torch.float32))
    # the edges of the aggregation's halo tiles (as the forward's): a map
    # smaller than one tile, planes over several row tiles with a height no
    # multiple of the tile (57x57: the statistics kernel runs), an odd width
    # with Cw no multiple of the vector width, N = 1; whole 7x7 planes at
    # cotnet50's Cp = 256, several to a block; and a geometry beyond the
    # tiles (a row of 513 thread items), which must take the pointwise route
    for dt in (torch.bfloat16, torch.float32):
        for n, c, cw, h, w in ((2, 64, 8, 3, 3), (2, 64, 8, 57, 57),
                               (4, 48, 6, 13, 11), (1, 64, 8, 56, 56)):
            cases.append(dict(n=n, c=c, cp=c // 2, cw=cw, h=h, w=w, k=3,
                              dil=1, groups=1, dtype=dt,
                              stats_check=h >= 56))
    cases.append(dict(n=4, c=512, cp=256, h=7, w=7, k=3, dil=1, groups=1,
                      dtype=torch.bfloat16))
    cases.append(dict(n=1, c=16, cp=8, h=2, w=2049, k=3, dil=1, groups=1,
                      dtype=torch.bfloat16, route="pointwise"))
    return cases


def embed_gn_inputs(cs, gen) -> tuple:
    """Seeded inputs of an embed_gn case from the CUDA generator ``gen``:
    (x, w_pre, w2, b2, gamma, beta), the op's keyword arguments, and the
    case's description."""
    def randn(*shape, dtype=torch.float32, scale=1.0, shift=0.0):
        t = torch.randn(*shape, generator=gen, device="cuda") * scale + shift
        return t.to(dtype)

    n, c, cp, h, w, k, dil, groups = (cs[key] for key in (
        "n", "c", "cp", "h", "w", "k", "dil", "groups"))
    dt = cs["dtype"]
    pad = (dil * (k - 1) + 1) // 2
    cw = cs.get("cw", c // 8)
    f = cw * k * k
    x = randn(n, c, h, w, dtype=dt)
    w_pre = randn(n, cp, h, w, dtype=dt).relu()      # it follows a ReLU
    w2 = randn(f, cp // groups, scale=(2.0 / f) ** 0.5).to(dt)
    b2, beta = randn(f, scale=0.1), randn(f, scale=0.2)
    gamma = randn(f, scale=0.2, shift=1.0)
    kw = dict(kernel_size=k, padding=pad, dilation=dil, groups=groups)
    geometry = (f"N={n} C={c} Cp={cp} {h}x{w} groups={groups} "
                f"Cw={cw} K={k} dil={dil} pad={pad} "
                f"{str(dt).replace('torch.', '')}")
    return (x, w_pre, w2, b2, gamma, beta), kw, geometry


def stats_totals_check(la, cs, geometry) -> dict:
    """The statistics pass of the case's route (``embed_gn_stats_rows``)
    against the pointwise route's (``embed_gn_stats``) on the same inputs,
    in the case's dtype and, for a bf16 case, in f32 too: each plane's
    totals (sum over its tiles' partial sums) of w_raw and w_raw^2 within
    ``1e-6 * max|ref|`` (f32 sums in another order); then on integer-valued
    w_pre, w2 and b2 small enough that every product and sum is exact in
    f32, equal.  Returns the entry's fields."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    errs = {}
    for dt in dict.fromkeys((cs["dtype"], torch.float32)):
        (x, w_pre, w2, b2, _, _), kw, _ = embed_gn_inputs(
            dict(cs, dtype=dt), gen)
        geo = {key: (v, v) for key, v in kw.items() if key != "groups"}
        cpg = w2.shape[1]
        # w_pre in {0, 1, 2}, w2 in {-1, 0, 1} at every fourth cp and 0
        # elsewhere, b2 in {-2, ..., 2}: |w_raw| <= bound, and a plane's
        # sum of squares stays below 2^24
        ints = (torch.randint(0, 3, w_pre.shape, generator=gen,
                              device="cuda").to(dt),
                (torch.randint(-1, 2, w2.shape, generator=gen, device="cuda")
                 * (torch.arange(cpg, device="cuda") % 4 == 0)).to(dt),
                torch.randint(-2, 3, b2.shape, generator=gen,
                              device="cuda").float())
        bound = 2 * ((cpg + 3) // 4) + 2
        if cs["k"] ** 2 * cs["h"] * cs["w"] * bound ** 2 >= 2 ** 24:
            raise AssertionError(f"stats check at {geometry}: integer sums "
                                 "not exact in f32")
        for integer, (wp, ww, bb) in ((False, (w_pre, w2, b2)),
                                      (True, ints)):
            tiled, ref = (la.embed_gn_statistics(
                x, wp, ww, bb, **geo, groups=kw["groups"], pointwise=pw)
                          for pw in (False, True))
            torch.cuda.synchronize()
            got, want = tiled.double().sum(2), ref.double().sum(2)
            if integer:
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"stats totals at {geometry} {dt}, integer inputs: "
                        f"max|diff| {float((got - want).abs().max())}")
                continue
            rel = [float((got[..., i] - want[..., i]).abs().max()
                         / want[..., i].abs().max()) for i in (0, 1)]
            if max(rel) > 1e-6:
                raise AssertionError(f"stats totals at {geometry} {dt}: "
                                     f"max|err|/max|ref| {rel}")
            errs[str(dt).replace("torch.", "")] = max(rel)
    log(f"  statistics pass at {geometry}: plane totals against the "
        f"pointwise route's within {errs} of max|ref| (limit 1e-6), equal "
        "on integer inputs")
    return {"stats_totals_max_rel_err": errs,
            "stats_totals_exact_on_integers": True}


def embed_gn_kernel_phase(la, hbm_rate: float, paths: PathCounts) -> list:
    """The fused embed conv + GroupNorm + aggregation kernels vs the plain
    version on the card, each case launched twice (the same bits), with
    the route its launcher takes and the device time of each of its
    kernels; returns their entries."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    entries = []
    for cs in embed_gn_cases():
        args, kw, geometry = embed_gn_inputs(cs, gen)
        x, w_pre, w2 = args[:3]
        n, cp, h, w, k, dil, groups = (cs[key] for key in (
            "n", "cp", "h", "w", "k", "dil", "groups"))
        dt = cs["dtype"]
        f = w2.shape[0]
        pad = kw["padding"]
        geo = dict(kernel_size=(k, k), dilation=(dil, dil),
                   padding=(pad, pad), groups=groups)
        variant = la.embed_gn_route(x, w_pre, w2, **geo)
        if variant != cs.get("route", variant):
            raise AssertionError(f"embed_gn at {geometry} took the {variant} "
                                 f"route, not {cs['route']}")
        workspace = la.embed_gn_workspace_bytes(x, w_pre, w2, **geo)
        before = dict(la.EMBED_GN_LAUNCHES_BY_SHAPE)
        with torch.no_grad(), tf32_off():
            got = la.local_aggregate_embed_gn(*args, impl="hopper", **kw)
            torch.cuda.synchronize()
            launches = paths.entry(
                "embed_gn", new_key(la.EMBED_GN_LAUNCHES_BY_SHAPE, before))
            # every sum has one owner and a fixed order
            if not torch.equal(la.local_aggregate_embed_gn(
                    *args, impl="hopper", **kw), got):
                raise AssertionError(f"embed_gn at {geometry}: a second "
                                     "launch gave other bits")
            ref = la.local_aggregate_embed_gn(*args, impl="torch", **kw)
            scale = float(ref.float().abs().max())
            if dt == torch.float32:
                # the product's and the statistics' sums in another order
                rtol, atol = 1e-5, 1e-5 * scale
            else:
                # besides the output's own rounding, a w_raw whose f32 sum
                # lies at a rounding boundary may round to the neighbouring
                # bf16 value in one of the two, which moves that tap's
                # weight by one bf16 ulp
                rtol, atol = 8e-3, 4e-3 * scale
            err = (got.float() - ref.float()).abs()
            bad = int((err > atol + rtol * ref.float().abs()).sum())
            if bad:
                raise AssertionError(
                    f"kernel != plain at {geometry}: {bad} elements, max "
                    f"|err| {float(err.max())}")

            def run():
                return la.local_aggregate_embed_gn(*args, impl="hopper", **kw)

            ms = device_ms(run)
            split = kernel_ms_by_name(run, EMBED_GN_STATS + EMBED_GN_AGG)
            plain_ms = device_ms(lambda: la.local_aggregate_embed_gn(
                *args, impl="torch", **kw))
            # the yardstick of a tensor-core product: w_raw of the same
            # shapes in T by one torch.matmul (no bias, no rounding step)
            w2g = w2.view(groups, f // groups, cp // groups)
            wp = w_pre.view(n, groups, cp // groups, h * w)
            product_matmul_ms = device_ms(lambda: torch.matmul(w2g, wp))
        # a statistics kernel runs exactly where its partial sums need a
        # workspace: not where a block holds whole planes; on the tiled
        # routes it is embed_gn_stats_rows
        stats_ms = (None if split[EMBED_GN_STATS[0]] is None
                    else sum(split[name] for name in EMBED_GN_STATS))
        if stats_ms is not None and (
                bool(stats_ms) != bool(workspace)
                or (variant != "pointwise"
                    and bool(split[EMBED_GN_STATS[0]]) != bool(workspace))):
            raise AssertionError(f"embed_gn at {geometry}: workspace "
                                 f"{workspace} bytes, statistics kernels "
                                 f"{[split[n] for n in EMBED_GN_STATS]} ms")
        # the statistics pass alone, where it runs: its bytes (w_pre and w2
        # read, the partial sums written), or its product at the tensor
        # cores' rate for its type, whichever takes longer; beside it the
        # floor of its design, the product in f32 FMAs (two operations
        # each) at the f32 rate, which the bit-identity with the
        # aggregation's w_raw keeps it to
        stats_bound = stats_bound_by = stats_fma_floor = None
        item = x.element_size()
        if workspace:
            product = 2 * n * f * h * w * (cp // groups)
            stats_bound, stats_bound_by = bounds_ms(
                (w_pre.numel() + w2.numel()) * item + workspace, 0,
                matmul_flops=product, matmul_dtype=dt)
            stats_fma_floor = product / F32_FLOPS_PER_S * 1e3
        totals = {}
        if cs.get("stats_check"):
            totals = stats_totals_check(la, cs, geometry)
            # the statistics pass alone at these inputs, on this route
            # (embed_gn_stats_rows) and on the pointwise one (embed_gn_stats,
            # the tiled routes' statistics kernel before it)
            for key, pw in (("stats_alone_ms", False),
                            ("stats_pointwise_ms", True)):
                totals[key] = device_ms(lambda: la.embed_gn_statistics(
                    *args[:4], **geo, pointwise=pw))
            log(f"  statistics pass alone {totals['stats_alone_ms']:.4f} ms, "
                f"on the pointwise route {totals['stats_pointwise_ms']:.4f} "
                "ms")
        # x, w_pre and w2 read, out written, the three f32 vectors; the
        # product w_pre @ w2 once, at the tensor cores' rate for its type
        # (that this kernel forms it in f32 FMAs, and twice where the
        # statistics kernel runs, is its own cost), then per w_raw element
        # the bias, the two statistics' terms and the normalize, and the
        # taps, in f32
        nbytes = (2 * x.numel() + w_pre.numel() + w2.numel()) * item \
            + 3 * f * 4
        w_raw = n * f * h * w
        bound, bound_by = bounds_ms(
            nbytes, 8 * w_raw + 2 * x.numel() * k * k,
            matmul_flops=2 * w_raw * (cp // groups), matmul_dtype=dt)
        entries.append({
            "name": "local_agg_embed_gn", "route": "cuda",
            "source": "cotnet_tpu_torch/ops/csrc/local_agg_embed_gn.cu",
            "replaces": REPLACES_EMBED_GN, "geometry": geometry,
            "variant": variant, **launches,
            "max_abs_err": float(err.max()),
            "mean_abs_err": float(err.mean()),
            "tol": {"rtol": rtol, "atol": atol},
            "deterministic": True, "workspace_bytes": workspace,
            "ms": ms, "plain_ms": plain_ms,
            "stats_ms": stats_ms,
            "stats_bound_ms": stats_bound, "stats_bound_by": stats_bound_by,
            "stats_fma_floor_ms": stats_fma_floor,
            **totals,
            "agg_ms": (None if split[EMBED_GN_AGG[0]] is None
                       else sum(split[name] for name in EMBED_GN_AGG)),
            "product_matmul_ms": product_matmul_ms,
            "bound_ms": bound, "bound_by": bound_by,
            "bound_ms_at_copy_rate": nbytes / hbm_rate * 1e3,
            "library_ms": None})
        log_entry(entries[-1])
        log(f"  stats {fmt_ms(entries[-1]['stats_ms'])}"
            + (f" (bound {stats_bound:.4f} ms, {stats_bound_by}; f32-FMA "
               f"floor {stats_fma_floor:.4f} ms)" if stats_bound else "")
            + f", aggregation {fmt_ms(entries[-1]['agg_ms'])} "
            "(torch.profiler); "
            f"workspace {workspace} bytes; w_raw by torch.matmul "
            f"{product_matmul_ms:.4f} ms")
    return entries


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def calibrate_bn(model, x, seed: int):
    """Seeded BN running stats drawn from each BN's real input on ``x``, and
    a non-zero bn3 scale.  Random stats unrelated to the input let the
    activations grow block after block; with the default zero-init bn3
    every residual branch is multiplied by zero and the logits never see
    the aggregation."""
    from cotnet_tpu_torch.nn import BatchNorm2d

    gen = torch.Generator(device=x.device).manual_seed(seed)

    def rand(like):
        return torch.rand(like.shape, generator=gen, device=like.device)

    def set_stats(m, args):
        # a random part of the mean, and the second moment about it: the
        # BN then scales each channel to about unit size without the
        # cancellation of centring a channel whose mean dwarfs its spread
        xin = args[0].float()
        mean = xin.mean((0, 2, 3)) * 0.5 * rand(m.running_mean)
        msq = (xin - mean[:, None, None]).square().mean((0, 2, 3))
        m.running_mean.copy_(mean)
        m.running_var.copy_(msq * (0.5 + rand(msq)))

    bns = [(n, m) for n, m in model.named_modules()
           if isinstance(m, BatchNorm2d)]
    hooks = [m.register_forward_pre_hook(set_stats) for _, m in bns]
    try:
        with torch.no_grad():
            for name, m in bns:
                if name.endswith("bn3"):
                    m.weight.copy_(0.1 + 0.2 * rand(m.weight))
            model(x)
    finally:
        for h in hooks:
            h.remove()



class tf32_off:
    """TF32 off in cuDNN and in matmuls, for an f32 comparison."""

    def __enter__(self):
        self.old = (torch.backends.cudnn.allow_tf32,
                    torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = self.old


def images_f32(n: int = 16, size: int = IMAGE):
    """n f32 images, each with its own contrast and brightness: with images
    of one distribution the pooled vector that feeds each CotLayer's se BN
    is nearly the same for all samples, its one-pass variance cancels, and
    f32 rounding alone moves the train-mode gradients by 1e-4 relative."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(n, 3, size, size, generator=gen, device="cuda")
    return x * torch.linspace(0.3, 2.0, n, device="cuda")[:, None, None, None] \
        + torch.linspace(-1, 1, n, device="cuda")[:, None, None, None]


def make_batch(n: int = BATCH, size: int = IMAGE) -> dict:
    """A main path's batch: bf16 images, labels, and 8 invalid samples."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    return {
        "image": torch.randn(n, 3, size, size, generator=gen,
                             device="cuda").to(torch.bfloat16),
        "label": torch.randint(0, 1000, (n,), generator=gen, device="cuda"),
        "valid": (torch.arange(n, device="cuda") < n - 8).float(),
    }


def model_phase(la, paths: PathCounts) -> dict:
    """Phases 2 and 3, on cotnet50; records the two main paths' launches
    in ``paths``.  Returns the calibrated f32 state_dict, for phase 4."""
    from cotnet_tpu_torch.models import create_model
    from cotnet_tpu_torch.train.step import make_eval_step

    model = create_model("cotnet50", device="cuda", seed=0)
    x = images_f32()
    calibrate_bn(model, x, seed=1)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    plain = create_model("cotnet50", device="cuda",
                         block_args=dict(impl="torch"))
    plain.load_state_dict(state)

    # f32: the kernel path against the plain path, TF32 off on both
    with tf32_off(), torch.no_grad():
        la.reset_counts()
        got = model(x)
        torch.cuda.synchronize()
        counts = (la.LAUNCHES, la.PLAIN_CALLS)
        ref = plain(x)
    if counts != (16, 0):
        raise AssertionError(f"one f32 forward: {counts[0]} kernel launches "
                             f"and {counts[1]} plain calls, want 16 and 0")
    if not (torch.isfinite(got).all() and got.shape == (16, 1000)):
        raise AssertionError(f"f32 logits {tuple(got.shape)} not finite")
    diff = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    if not diff <= 1e-3 * scale:
        raise AssertionError(f"f32 logits: max|diff| {diff} > 1e-3 * "
                             f"max|logit| {scale}")
    log(f"model f32 parity: max|logit diff| {diff:.3g} (max|logit| "
        f"{scale:.3g}); per forward {counts[0]} kernel launches, "
        f"{counts[1]} plain calls")
    f32_logits = got
    del ref, got

    gradient_parity(la, model, plain, x)
    del plain
    loss_falls(la, model, x)
    del model
    torch.cuda.empty_cache()

    # the eval main path: bf16 eval step at 224x224 bs128
    model16 = create_model("cotnet50", device="cuda", dtype=torch.bfloat16)
    model16.load_state_dict(state)
    with torch.no_grad():
        d16 = (model16(x.to(torch.bfloat16)).float() - f32_logits).abs()
    d_max, d_mean = float(d16.max()) / scale, float(d16.mean()) / scale
    # loose: bf16 keeps 8 bits through some 50 layers
    if not d_max <= 0.2:
        raise AssertionError(f"bf16 logits differ from f32 by {d_max} of "
                             "max|logit|, more than 0.2")
    log(f"bf16 eval logits against f32, same weights and batch of 16: max "
        f"|diff| {d_max:.4g}, mean |diff| {d_mean:.4g} of max|logit| "
        f"{scale:.3g} (limit 0.2 on the max)")
    eval_step = make_eval_step(model16)
    batch = make_batch()
    warmup, timed = 2, 10
    steps = warmup + timed
    la.reset_counts()
    times = []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eval_step(batch)
        torch.cuda.synchronize()
        if i >= warmup:
            times.append(time.perf_counter() - t0)
    launches = la.LAUNCHES
    # 16 affine forward launches a step, by map size as cotnet50's
    # (3, 4, 6, 3) CoT layers, and nothing else
    check_path_launches(paths.record(la, "cotnet50 eval", steps), "eval",
                        "cotnet50", steps)
    top1, top5, n = (float(out[key]) for key in
                     ("top1_count", "top5_count", "n"))
    if not (0 <= top1 <= top5 <= n == BATCH - 8):
        raise AssertionError(f"eval counts top1 {top1} top5 {top5} n {n}")
    log(f"bf16 eval cotnet50 {IMAGE}x{IMAGE} bs{BATCH}: "
        f"{BATCH / statistics.median(times):.1f} img/s (median of {timed} "
        f"eval steps) on {nvidia_smi()}; top1 {top1:.0f} top5 {top5:.0f} of "
        f"{n:.0f}; {launches} kernel launches in {steps} forwards, 0 plain "
        f"calls")
    profile_step(lambda: eval_step(batch), "bf16 eval step")
    del model16, eval_step
    torch.cuda.empty_cache()

    train_main_path(la, batch, paths)
    return state


def train_loss(model, x, labels):
    from cotnet_tpu_torch.train.loss import label_smoothing_cross_entropy

    return label_smoothing_cross_entropy(model(x), labels, 0.1)


def gradient_parity(la, model, plain, x):
    """f32, TF32 off: one loss and backward in training mode through the
    three kernels against the same model on the plain versions.

    The net's f32 gradients are ill-conditioned: each CotLayer's ``se`` BN
    normalizes 16 pooled vectors that are nearly alike, and its one-pass
    variance amplifies rounding layer after layer.  So the plain model's
    gradients are taken a second time with the input perturbed by one f32
    ulp (relative 1e-7), and the kernel path is held to be no further from
    the plain path than the plain path is from itself: the relative L2
    distance of the whole gradient, and the median and the worst over the
    parameters of ``max|dg| / max|g|``, each within 3 times that noise (or
    1e-3 where the noise is smaller).  What is held strictly is each
    backward launch inside the model: ``backward_launches_match_plain``."""
    labels = torch.randint(0, 1000, (x.shape[0],), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(4))
    noise = torch.randn(x.shape, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(7))
    runs = {}
    with tf32_off():
        for name, m, inp in (("kernel", model, x), ("plain", plain, x),
                             ("perturbed", plain, x * (1 + 1e-7 * noise))):
            m.train()
            m.zero_grad(set_to_none=True)
            la.reset_counts()
            loss = train_loss(m, inp, labels)
            loss.backward()
            torch.cuda.synchronize()
            runs[name] = (float(loss.detach()),
                          (la.LAUNCHES, dict(la.BWD_LAUNCHES), la.PLAIN_CALLS,
                           la.PLAIN_BWD_CALLS),
                          [p.grad for p in m.parameters()])
            m.zero_grad(set_to_none=True)
            m.eval()
    (loss, counts, grads), (ref_loss, ref_counts, ref_grads) = \
        runs["kernel"], runs["plain"]
    if counts != (16, {"dx": 16, "dw": 16}, 0, 0):
        raise AssertionError(f"one f32 loss and backward through the kernels: "
                             f"(launches, bwd launches, plain, plain bwd) = "
                             f"{counts}")
    if ref_counts != (0, {"dx": 0, "dw": 0}, 16, 16):
        raise AssertionError(f"the plain model's counts: {ref_counts}")
    if not abs(loss - ref_loss) <= 1e-5 * abs(ref_loss):
        raise AssertionError(f"f32 train loss {loss} != plain {ref_loss}")
    if any(g.dtype != torch.float32 for g in grads):
        raise AssertionError("a parameter's gradient is not f32")

    def distance(got):
        """(relative L2 of the whole gradient, median and worst over the
        parameters of max|dg| / max|g|) against the plain gradients."""
        num = sum(float((g - r).double().square().sum())
                  for g, r in zip(got, ref_grads))
        den = sum(float(r.double().square().sum()) for r in ref_grads)
        # a bias that a train-mode BN cancels has a zero gradient but for
        # rounding, and is left out
        rel = [float((g - r).abs().max() / r.abs().max())
               for g, r in zip(got, ref_grads) if float(r.abs().max()) > 1e-6]
        return (num / den) ** 0.5, statistics.median(rel), max(rel)

    got, floor = distance(grads), distance(runs["perturbed"][2])
    strict = backward_launches_match_plain(la, model, x, labels)
    for what, g, f in zip(("relative L2", "median", "worst"), got, floor):
        if not g <= max(1e-3, 3 * f):
            raise AssertionError(
                f"f32 gradients, {what}: kernel path {g} from the plain "
                f"path, the plain path {f} from itself under a 1e-7 input "
                "perturbation")
    log(f"model f32 gradient parity (bs{x.shape[0]}, train mode): loss "
        f"{loss:.6f} against {ref_loss:.6f}; kernel path against plain path "
        f"(in brackets: plain path against itself with the input perturbed "
        f"by 1e-7, the limit being 3 times that): relative L2 of the whole "
        f"gradient {got[0]:.3g} ({floor[0]:.3g}); max|dg|/max|g| per "
        f"parameter: median {got[1]:.3g} ({floor[1]:.3g}), worst "
        f"{got[2]:.3g} ({floor[2]:.3g}); launches fwd {counts[0]}, dx "
        f"{counts[1]['dx']}, dw {counts[1]['dw']}; {counts[2]} plain "
        f"forward and {counts[3]} plain backward calls; each of the 16 dx "
        f"and 16 dw launches against the plain backward on the model's own "
        f"tensors: worst max|err| {strict:.3g} of max|ref| (limit 1e-5)")


def backward_launches_match_plain(la, model, x, labels,
                                  layers: int = 16) -> float:
    """One more f32 loss and backward through the kernels, with every
    backward launch held, on the model's own x, w and dy, against the plain
    backward: ``max|err| <= 1e-5 * max|ref|`` for dx and for dw (f32 sums of
    9 and of 8 to 72 products in another order).  Unlike the end-to-end
    gradients this compares like with like at every layer, so the net's
    conditioning does not enter.  Returns the worst ratio seen."""
    import torch.nn.functional as F

    launch = la.local_aggregate_bwd_hopper
    ratios = []

    def checked(x_, w_, dy, *, kernel_size, dilation, padding, **need):
        got = launch(x_, w_, dy, kernel_size=kernel_size, dilation=dilation,
                     padding=padding, **need)
        ph, pw = padding
        dxp, dw = la.local_aggregate_bwd_plain(
            F.pad(x_, (pw, pw, ph, ph)), w_, dy, kernel_size, dilation,
            **need)
        ref = (dxp[..., ph:ph + x_.shape[2], pw:pw + x_.shape[3]], dw)
        for g, r in zip(got, ref):
            if g is not None:
                ratios.append(float((g - r).abs().max() / r.abs().max()))
        return got

    la.local_aggregate_bwd_hopper = checked
    try:
        with tf32_off():
            model.train()
            train_loss(model, x, labels).backward()
            torch.cuda.synchronize()
    finally:
        la.local_aggregate_bwd_hopper = launch
        model.zero_grad(set_to_none=True)
        model.eval()
    if len(ratios) != 2 * layers or not max(ratios) <= 1e-5:
        raise AssertionError(f"backward launches in the model against the "
                             f"plain backward: {len(ratios)} gradients, "
                             f"max|err| / max|ref| {ratios}")
    return max(ratios)


def loss_falls(la, model, x, steps: int = 5, lr: float = 0.01):
    """Five f32 train steps on one fixed batch at a constant LR, no mixup
    and no drop: the loss of the last step is below that of the first."""
    from cotnet_tpu_torch.train.loss import create_loss_fn
    from cotnet_tpu_torch.train.optim import create_optimizer
    from cotnet_tpu_torch.train.state import TrainState
    from cotnet_tpu_torch.train.step import make_train_step

    optimizer = create_optimizer(RECIPE["solver"], model.parameters())
    loss_fn, _ = create_loss_fn(RECIPE["loss"], False)
    step = make_train_step(model, optimizer, lambda s: lr, loss_fn)
    state = TrainState.create(model, optimizer)
    labels = torch.randint(0, 1000, (x.shape[0],), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(5))
    batch = {"image": x, "label": labels}
    losses = []
    la.reset_counts()
    for _ in range(steps):
        state, metrics = step(state, batch, None)
        losses.append(metrics["loss"])
    losses = [float(v) for v in losses]
    if la.PLAIN_CALLS or la.PLAIN_BWD_CALLS:
        raise AssertionError("the f32 train steps made plain calls")
    if not (all(v == v for v in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"the loss did not fall: {losses}")
    log(f"f32 train, {steps} steps on one batch of {x.shape[0]} at LR {lr}: "
        f"loss {', '.join(f'{v:.4f}' for v in losses)}")


def recipe_train_step(model, recipe=RECIPE, batch: int = BATCH):
    """``make_train_step`` on ``model`` under ``recipe`` at ``batch`` images
    a step; returns (step, its TrainState with an EMA)."""
    from cotnet_tpu_torch.data.mixup import Mixup
    from cotnet_tpu_torch.train.loss import create_loss_fn
    from cotnet_tpu_torch.train.optim import create_optimizer
    from cotnet_tpu_torch.train.schedule import create_scheduler
    from cotnet_tpu_torch.train.state import TrainState
    from cotnet_tpu_torch.train.step import make_train_step

    schedule_fn, _ = create_scheduler(recipe["solver"],
                                      IMAGENET_TRAIN_IMAGES // batch)
    optimizer = create_optimizer(recipe["solver"], model.parameters())
    loss_fn, _ = create_loss_fn(recipe["loss"], mixup_active=True)
    step = make_train_step(model, optimizer, schedule_fn, loss_fn,
                           ema_decay=recipe["ema_decay"],
                           mixup_fn=Mixup(**recipe["mixup"]))
    return step, TrainState.create(model, optimizer, ema=True)


def train_main_path(la, batch, paths: PathCounts):
    """The train main path: bf16 ``make_train_step`` on cotnet50 at 224x224
    bs128 under the recipe."""
    from cotnet_tpu_torch.models import create_model
    from cotnet_tpu_torch.train.state import float_state

    torch.cuda.reset_peak_memory_stats()
    model = create_model("cotnet50", device="cuda", dtype=torch.bfloat16,
                         seed=0, **RECIPE["model"])
    start = {k: v.detach().clone() for k, v in float_state(model).items()}
    step, state = recipe_train_step(model)
    gen = torch.Generator(device="cuda").manual_seed(6)
    batch = {"image": batch["image"], "label": batch["label"]}

    warmup, timed = 2, 8
    steps = warmup + timed
    la.reset_counts()
    times, metrics = [], []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch, gen)
        torch.cuda.synchronize()
        if i >= warmup:
            times.append(time.perf_counter() - t0)
        metrics.append(m)
    peak = torch.cuda.max_memory_allocated()
    # 16 forward, 16 dx and 16 dw launches a step without the affine, by
    # map size as cotnet50's (3, 4, 6, 3) CoT layers, and nothing else
    check_path_launches(paths.record(la, "cotnet50 train", steps), "train",
                        "cotnet50", steps)
    totals = (la.LAUNCHES, dict(la.BWD_LAUNCHES))

    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    lrs = [m["lr"] for m in metrics]
    if not all(v == v and abs(v) < float("inf") for v in losses + norms):
        raise AssertionError(f"train losses {losses}, grad norms {norms}")
    if not (state.step == steps and lrs[0] == 1e-4
            and all(a < b for a, b in zip(lrs, lrs[1:]))):
        raise AssertionError(f"step {state.step}, warm-up LRs {lrs}")
    live = float_state(model)
    # what must have changed, live and in the EMA: every bn3 scale (it
    # starts at zero, so any update shows, and its gradient comes through
    # the whole backward) and the running stats; of all the weights only
    # half, since in ten warm-up steps at an LR of 1e-4 an update of a BN
    # scale of 1.0 can round away in f32, and an EMA moves by 1e-4 of that
    for what, now in (("live", live), ("EMA", state.ema)):
        for kind, share in (("bn3.weight", 1.0), ("running_mean", 0.9),
                            ("running_var", 0.9), ("weight", 0.5)):
            if (what, kind) == ("EMA", "weight"):
                continue
            keys = [k for k in start if k.endswith(kind)]
            moved = sum(not torch.equal(now[k], start[k]) for k in keys)
            if moved < share * len(keys):
                raise AssertionError(f"{what} {kind}: only {moved} of "
                                     f"{len(keys)} tensors changed")
    if any(not torch.isfinite(v).all() for v in live.values()):
        raise AssertionError("a parameter or running stat is not finite")
    log(f"bf16 train cotnet50 {IMAGE}x{IMAGE} bs{BATCH} (mixup/cutmix, drop "
        f"0.25, drop_path 0.1, nesterov, cosine warm-up, EMA): "
        f"{BATCH / statistics.median(times):.1f} img/s (median of {timed} "
        f"train steps, {statistics.median(times) * 1e3:.1f} ms a step) on "
        f"{nvidia_smi()}; peak memory {peak / 2 ** 30:.2f} GiB; loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}, grad norm {norms[0]:.3f} -> "
        f"{norms[-1]:.3f}, LR {lrs[0]:.3g} -> {lrs[-1]:.3g}; launches in "
        f"{steps} steps: fwd {totals[0]}, dx {totals[1]['dx']}, dw "
        f"{totals[1]['dw']}, 0 plain calls")
    profile_step(lambda: step(state, batch, gen), "bf16 train step")


def affine_backward_launches_match_plain(la, model, x, labels) -> tuple:
    """One f32 loss and backward of a folded model through the kernels,
    with every affine backward launch held, on the model's own x, w, s, b
    and dy, against the plain affine backward: ``max|err| <= 1e-5 *
    max|ref|`` for dx and dw, and ``check_sums`` for ds and db.  Returns
    the worst ratio of (dx and dw, ds and db)."""
    import torch.nn.functional as F

    launch = la.local_aggregate_bwd_affine_hopper
    ratios = {"dx": [], "dw": [], "ds": [], "db": []}

    def checked(x_, w_, s_, b_, dy, *, kernel_size, dilation, padding,
                **need):
        got = launch(x_, w_, s_, b_, dy, kernel_size=kernel_size,
                     dilation=dilation, padding=padding, **need)
        ph, pw = padding
        ref = la.local_aggregate_bwd_affine_plain(
            F.pad(x_, (pw, pw, ph, ph)), w_, s_, b_, dy, kernel_size,
            dilation, **need)
        ref = (ref[0][..., ph:ph + x_.shape[2], pw:pw + x_.shape[3]],) \
            + ref[1:]
        for name, g, r in zip(ratios, got, ref):
            if g is not None:
                ratios[name].append(float((g - r).abs().max()
                                          / r.abs().max()))
        return got

    la.local_aggregate_bwd_affine_hopper = checked
    try:
        with tf32_off():
            model.train()
            la.reset_counts()
            train_loss(model, x, labels).backward()
            torch.cuda.synchronize()
    finally:
        la.local_aggregate_bwd_affine_hopper = launch
        model.zero_grad(set_to_none=True)
        model.eval()
    counts = (la.LAUNCHES, dict(la.AFFINE_BWD_LAUNCHES), dict(la.BWD_LAUNCHES),
              la.PLAIN_CALLS)
    if counts != (16, {"dx": 16, "dw": 16}, {"dx": 0, "dw": 0}, 0):
        raise AssertionError(f"one f32 loss and backward of the folded "
                             f"model: (fwd, affine bwd, plain-form bwd, "
                             f"plain forward calls) = {counts}")
    worst = (max(ratios["dx"] + ratios["dw"]), max(ratios["ds"] + ratios["db"]))
    if any(len(v) != 16 for v in ratios.values()) or not max(worst) <= 1e-5:
        raise AssertionError(f"affine backward launches in the model "
                             f"against the plain affine backward: {ratios}")
    return worst


def switch_checks_f32(la, model_name: str, state=None):
    """Phase 4's f32 checks for one model, at bs16 with TF32 off: the
    fused-embed eval against the unfused one, and the folded model's
    backward and five train steps.  ``state`` is a calibrated f32
    state_dict; without one the model is calibrated here."""
    from cotnet_tpu_torch.models import create_model

    x = images_f32()
    if state is None:
        model = create_model(model_name, device="cuda", seed=0)
        calibrate_bn(model, x, seed=1)
        state = {k: v.clone() for k, v in model.state_dict().items()}
        del model

    logits = {}
    for fused in (False, True):
        model = create_model(model_name, device="cuda", mega_fuse=fused)
        model.load_state_dict(state)
        with tf32_off(), torch.no_grad():
            la.reset_counts()
            logits[fused] = model(x)
            torch.cuda.synchronize()
        counts = (la.LAUNCHES, la.EMBED_GN_LAUNCHES,
                  launch_snapshot(la)["plain"])
        if counts != ((0, 16, 0) if fused else (16, 0, 0)):
            raise AssertionError(f"{model_name} f32 forward, mega_fuse="
                                 f"{fused}: (fwd launches, fused launches, "
                                 f"plain calls) = {counts}")
        del model
    diff = float((logits[True] - logits[False]).abs().max())
    scale = float(logits[False].abs().max())
    if not (torch.isfinite(logits[True]).all()
            and logits[True].shape == (16, 1000) and diff <= 1e-3 * scale):
        raise AssertionError(f"{model_name} f32 logits, fused embed against "
                             f"unfused: max|diff| {diff}, max|logit| {scale}")

    model = create_model(model_name, device="cuda", gn_fold_train=True)
    model.load_state_dict(state)
    labels = torch.randint(0, 1000, (x.shape[0],), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(4))
    worst = affine_backward_launches_match_plain(la, model, x, labels)
    log(f"{model_name} f32, bs{x.shape[0]}: fused-embed eval logits against "
        f"the unfused ones max|diff| {diff:.3g} of max|logit| {scale:.3g} "
        f"(limit 1e-3), 16 fused launches and no aggregation launch per "
        f"forward; folded backward, each of the 16 affine dx and 16 affine "
        f"dw launches against the plain affine backward on the model's own "
        f"tensors: worst max|err|/max|ref| {worst[0]:.3g} for dx and dw, "
        f"{worst[1]:.3g} for ds and db (limit 1e-5)")
    loss_falls(la, model, x)
    if la.AFFINE_BWD_LAUNCHES != {"dx": 80, "dw": 80} or la.BWD_LAUNCHES != {
            "dx": 0, "dw": 0}:
        raise AssertionError(f"five folded f32 steps: affine backward "
                             f"launches {la.AFFINE_BWD_LAUNCHES}, others "
                             f"{la.BWD_LAUNCHES}")


def run_main_path(la, paths: PathCounts, model_name: str, kind: str,
                  timed: int):
    """One bf16 main path at the model's image size with seeded random
    weights: ``kind`` is eval, eval_fused (path B, ``mega_fuse``), train, or
    train_fold (path A, ``gn_fold_train``); eval at bs128, the train kinds
    at the model's train batch under its recipe.  2 warm-up and ``timed``
    timed steps; the launches are checked against the kind's and recorded
    in ``paths``."""
    from cotnet_tpu_torch.models import create_model
    from cotnet_tpu_torch.train.step import make_eval_step

    label = f"{model_name} {kind}"
    training = kind.startswith("train")
    recipe, size = RECIPES[model_name], MODELS[model_name][2]
    n = TRAIN_BATCH.get(model_name, BATCH) if training else BATCH
    batch = make_batch(n, size)
    torch.cuda.reset_peak_memory_stats()
    model = create_model(
        model_name, device="cuda", dtype=torch.bfloat16, seed=0,
        gn_fold_train=kind == "train_fold", mega_fuse=kind == "eval_fused",
        **(recipe["model"] if training else {}))
    if training:
        step, state = recipe_train_step(model, recipe, n)
        gen = torch.Generator(device="cuda").manual_seed(6)
        images = {"image": batch["image"], "label": batch["label"]}

        def run():
            return step(state, images, gen)[1]
    else:
        eval_step = make_eval_step(model)

        def run():
            return eval_step(batch)

    warmup = 2
    steps = warmup + timed
    la.reset_counts()
    times, outs = [], []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(run())
        torch.cuda.synchronize()
        if i >= warmup:
            times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    check_path_launches(paths.record(la, label, steps), kind, model_name,
                        steps, n)
    if training:
        values = [float(m[key]) for m in outs for key in ("loss", "grad_norm")]
        if not (all(v == v and abs(v) < float("inf") for v in values)
                and state.step == steps):
            raise AssertionError(f"{label}: step {state.step}, losses and "
                                 f"grad norms {values}")
        result = (f"loss {values[0]:.4f} -> {values[-2]:.4f}, peak memory "
                  f"{peak / 2 ** 30:.2f} GiB")
    else:
        top1, top5, valid = (float(outs[-1][key]) for key in
                             ("top1_count", "top5_count", "n"))
        if not (0 <= top1 <= top5 <= valid == n - 8):
            raise AssertionError(f"{label}: top1 {top1} top5 {top5} n "
                                 f"{valid}")
        result = (f"top1 {top1:.0f} top5 {top5:.0f} of {valid:.0f}, peak "
                  f"memory {peak / 2 ** 30:.2f} GiB")
    median = statistics.median(times)
    layers = sum(per_step for _, _, per_step in MODELS[model_name][1])
    log(f"bf16 {label} {size}x{size} bs{n}: {n / median:.1f} img/s "
        f"(median of {timed} steps, {median * 1e3:.1f} ms a step) on "
        f"{nvidia_smi()}; {result}; per step {layers} launches each of "
        f"{', '.join(PATH_KERNELS[kind])}, no other kernel of the op, 0 "
        f"plain calls")
    profile_step(run, f"bf16 {label} step")
    torch.cuda.empty_cache()


def switches_phase(la, paths: PathCounts, cotnet50_state):
    """Phase 4: the two switches on cotnet50, and cotnext50_2x48d with and
    without them."""
    switch_checks_f32(la, "cotnet50", cotnet50_state)
    switch_checks_f32(la, "cotnext50_2x48d")
    torch.cuda.empty_cache()
    for model_name, kinds in (
            ("cotnet50", ("train_fold", "eval_fused")),
            ("cotnext50_2x48d", ("eval", "train", "train_fold",
                                 "eval_fused"))):
        for kind in kinds:
            run_main_path(la, paths, model_name, kind,
                          timed=6 if kind.startswith("train") else 8)


def hybrid_phase(la, paths: PathCounts):
    """Phase 5: se_cotnetd_152.  f32 at bs4 and 256x256, TF32 off: logits
    through the kernels against the plain path, every backward launch
    inside the model against the plain backward, five steps that lower the
    loss; then its bf16 main paths, the eval step at 256 bs128 and the
    train step at 256 bs64 under its recipe."""
    from cotnet_tpu_torch.models import create_model

    name = "se_cotnetd_152"
    _, geometries, size = MODELS[name]
    layers = sum(per_step for _, _, per_step in geometries)
    x = images_f32(4, size)
    model = create_model(name, device="cuda", seed=0)
    calibrate_bn(model, x, seed=1)
    plain = create_model(name, device="cuda", block_args=dict(impl="torch"))
    plain.load_state_dict(model.state_dict())
    with tf32_off(), torch.no_grad():
        la.reset_counts()
        got = model(x)
        torch.cuda.synchronize()
        counts = (la.LAUNCHES, la.PLAIN_CALLS)
        ref = plain(x)
    del plain
    if counts != (layers, 0):
        raise AssertionError(f"{name} f32 forward: {counts[0]} kernel "
                             f"launches and {counts[1]} plain calls, want "
                             f"{layers} and 0")
    diff, scale = float((got - ref).abs().max()), float(ref.abs().max())
    if not (torch.isfinite(got).all() and got.shape == (4, 1000)
            and diff <= 1e-3 * scale):
        raise AssertionError(f"{name} f32 logits {tuple(got.shape)}: "
                             f"max|diff| {diff}, max|logit| {scale}")
    labels = torch.randint(0, 1000, (x.shape[0],), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(4))
    strict = backward_launches_match_plain(la, model, x, labels, layers)
    log(f"{name} f32, bs{x.shape[0]} {size}x{size}: logits through the "
        f"kernels against the plain path max|diff| {diff:.3g} of max|logit| "
        f"{scale:.3g} (limit 1e-3), {counts[0]} launches and no plain call "
        f"a forward; each of the {layers} dx and {layers} dw launches of a "
        f"backward against the plain backward on the model's own tensors: "
        f"worst max|err|/max|ref| {strict:.3g} (limit 1e-5)")
    loss_falls(la, model, x)
    del model
    torch.cuda.empty_cache()
    run_main_path(la, paths, name, "eval", timed=6)
    run_main_path(la, paths, name, "train", timed=4)


def mix_cases() -> list:
    """The mix kernels' cases: cotnet50's four CoT geometries in bf16 at
    bs128 (heads 1, Cw = C/8; ``main``, the mix path's), then a general f32
    case (heads 2, 13x11, Cw dividing C four times), the edges of the dx
    and dw tiles in bf16 (a map smaller than the 5x5 window, 57x57, 13x11
    with Cw=6, N=1 at 56x56) and a row too wide for one block (2x2049),
    which dx and dw must run on their pointwise route; each with the
    weights separate and packed."""
    cases = [dict(n=BATCH, c=c, h=hw, w=hw, heads=1, cw=c // 8,
                  dtype=torch.bfloat16, main=True)
             for c, hw, _ in COTNET50_GEOMETRIES]
    cases.append(dict(n=4, c=32, h=13, w=11, heads=2, cw=8,
                      dtype=torch.float32))
    for n, c, cw, h, w in ((2, 64, 8, 3, 3), (2, 64, 8, 57, 57),
                           (4, 48, 6, 13, 11), (1, 64, 8, 56, 56)):
        cases.append(dict(n=n, c=c, h=h, w=w, heads=1, cw=cw,
                          dtype=torch.bfloat16))
    cases.append(dict(n=1, c=16, h=2, w=2049, heads=1, cw=8,
                      dtype=torch.bfloat16, route="pointwise"))
    return [dict(cs, merged=merged) for cs in cases
            for merged in (False, True)]


def mix_tensors(cs, seed: int) -> tuple:
    """x, w1, w2 (w1 packed and w2 None when ``merged``) and dy of a case."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n, c, h, w, heads, cw, dt = (cs[key] for key in (
        "n", "c", "h", "w", "heads", "cw", "dtype"))

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dt)

    x = randn(n, c, h, w)
    w1, w2 = randn(n, heads, cw, 9, h, w), randn(n, heads, cw, 25, h, w)
    if cs["merged"]:
        w1, w2 = torch.cat([w1, w2], dim=3), None
    return x, w1, w2, randn(n, 2 * heads * c, h, w)


def mix_path(la, paths: PathCounts):
    """The mix kernels' main path, the op's own entry points (no model of
    the zoo calls them): one autograd call of ``local_aggregate_mix`` (or
    ``local_aggregate_mix_merge`` for the packed weight) at each bf16 case,
    each one launch of each mix kernel and no plain call or other
    aggregation kernel, the forward, dx and dw on their ``tiles`` route;
    the counts are set to 0 before and read after."""
    cases = [cs for cs in mix_cases() if cs.get("main")]
    la.reset_counts()
    for i, cs in enumerate(cases):
        x, w1, w2, dy = mix_tensors(cs, seed=20 + i)
        routes = {k: la.mix_route(k, x, w1, w2) for k in ("fwd", "dx", "dw")}
        if set(routes.values()) != {"tiles"}:
            raise AssertionError(f"mix op at {cs}: routes {routes}")
        leaves = [t.requires_grad_() for t in (x, w1, w2) if t is not None]
        before = dict(la.MIX_LAUNCHES)
        if cs["merged"]:
            out = la.local_aggregate_mix_merge(*leaves)
        else:
            out = la.local_aggregate_mix(*leaves)
        out.backward(dy)
        torch.cuda.synchronize()
        if ({k: la.MIX_LAUNCHES[k] - before[k] for k in before}
                != {"fwd": 1, "dx": 1, "dw": 1}
                or not all(t.grad.shape == t.shape for t in leaves)):
            raise AssertionError(f"mix op at {cs}: launches "
                                 f"{la.MIX_LAUNCHES} after {before}")
    snapshot = paths.record(la, "mix op", 1)
    others = {kernel for kernel, _ in snapshot["by_key"]
              if not kernel.startswith("mix_")}
    if snapshot["plain"] or others or la.MIX_LAUNCHES != {
            k: len(cases) for k in ("fwd", "dx", "dw")}:
        raise AssertionError(f"mix op: {snapshot['plain']} plain calls, "
                             f"other kernels {others}, launches "
                             f"{la.MIX_LAUNCHES}")
    log(f"mix op: one autograd call at each of {len(cases)} bf16 cases "
        f"(cotnet50's geometries at bs128, weights separate and packed): "
        f"launches {la.MIX_LAUNCHES}, 0 plain calls, the forward, dx and dw "
        "on the tiles route")


def mix_kernel_phase(la, hbm_rate: float, paths: PathCounts) -> list:
    """The three mix kernels against the plain mix on the card; returns
    their entries.  Each names its route (``variant``, from
    ``ops.local_agg.mix_route``: ``tiles``, or ``pointwise`` where the case
    says so), is launched twice for the same bits (``deterministic``), and
    is timed on the pointwise route too (``pointwise_ms``, the first
    kernels at the same inputs); the forward's and dw's
    ``same_bits_as_pointwise`` say whether the two routes' outputs are bit
    for bit the same, which the forward's must be."""
    entries = []
    for i, cs in enumerate(mix_cases()):
        x, w1, w2, dy = mix_tensors(cs, seed=40 + i)
        n, c, h, w, heads, dt = (cs[key] for key in (
            "n", "c", "h", "w", "heads", "dtype"))
        geometry = (f"N={n} C={c} {h}x{w} heads={heads} Cw={cs['cw']} "
                    f"{str(dt).replace('torch.', '')}"
                    f"{' packed' if cs['merged'] else ''}")
        # taps inside the image, 3x3 (pad 1) and 5x5 (pad 2)
        pairs = sum(valid_taps(h, h, k, k // 2, 1) * valid_taps(w, w, k,
                                                                k // 2, 1)
                    for k in (3, 5))
        flops = 2 * n * heads * c * pairs
        weights = w1.numel() + (0 if w2 is None else w2.numel())
        # each pass reads or writes x (or dx), the weights (or dw) and dy
        # (or out) once
        nbytes = (x.numel() + weights + dy.numel()) * x.element_size()
        bound, bound_by = bounds_ms(nbytes, flops)
        for kernel in ("fwd", "dx", "dw"):
            if kernel == "fwd":
                def run(pointwise=False):
                    return (la.local_aggregate_mix_hopper(
                        x, w1, w2, pointwise=pointwise),)

                def plain():
                    return (la.local_aggregate_mix_plain(x, w1, w2),)
            else:
                need = dict(need_dx=kernel == "dx", need_dw=kernel == "dw")
                pick = 0 if kernel == "dx" else 1

                def run(pointwise=False):
                    return la.local_aggregate_mix_bwd_hopper(
                        x, w1, w2, dy, pointwise=pointwise,
                        **need)[pick:pick + 2]

                def plain():
                    return la.local_aggregate_mix_bwd_plain(
                        x, w1, w2, dy, **need)[pick:pick + 2]
            before = dict(la.MIX_LAUNCHES_BY_SHAPE)
            with torch.no_grad():
                got = run()
                torch.cuda.synchronize()
                launches = paths.entry(
                    "mix_" + kernel, new_key(la.MIX_LAUNCHES_BY_SHAPE,
                                             before)[1])
                ref = plain()
                again = run()
                routed = {
                    "variant": la.mix_route(kernel, x, w1, w2),
                    "deterministic": all(
                        torch.equal(a, b) for a, b in zip(got, again)
                        if a is not None)}
                if routed["variant"] != cs.get("route", "tiles"):
                    raise AssertionError(
                        f"mix {kernel} at {geometry} took the "
                        f"{routed['variant']} route")
                if not routed["deterministic"]:
                    raise AssertionError(f"mix {kernel} at {geometry}: "
                                         "two launches differ")
                if kernel != "dx":
                    routed["same_bits_as_pointwise"] = all(
                        torch.equal(a, b)
                        for a, b in zip(got, run(pointwise=True))
                        if a is not None)
                # the forward's two accumulators take the taps in the
                # pointwise kernel's order, from the same zeros
                if kernel == "fwd" and not routed["same_bits_as_pointwise"]:
                    raise AssertionError(f"mix fwd at {geometry}: not the "
                                         "pointwise route's bits")
                errs = [check_close(f"{geometry} {kernel}", g, r, dt)
                        for g, r in zip(got, ref) if r is not None]
                ms = device_ms(run)
                plain_ms = device_ms(plain)
                routed["pointwise_ms"] = device_ms(
                    lambda: run(pointwise=True))
            max_err, rtol, atol = max(errs)
            entries.append({
                "name": f"local_agg_mix_{kernel}", "route": "cuda",
                "source": "cotnet_tpu_torch/ops/csrc/local_agg_mix.cu",
                "replaces": REPLACES_MIX[kernel], "geometry": geometry,
                **routed, **launches, "max_abs_err": max_err,
                "tol": {"rtol": rtol, "atol": atol},
                "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": bound_by,
                "bound_ms_at_copy_rate": nbytes / hbm_rate * 1e3,
                "library_ms": None})
            log_entry(entries[-1])
    return entries


def dilated_check(la):
    """``local_aggregate_dilated`` on the card at cotnet50's first geometry
    (56x56, C=64, Cw=8) in f32 at bs16 with dilations 1 and 2: forward and
    gradients against the plain path (rtol/atol 1e-5); one forward, one dx
    and one dw launch per distinct dilation, and no plain call."""
    gen = torch.Generator(device="cuda").manual_seed(30)
    x0 = torch.randn(16, 64, 56, 56, generator=gen, device="cuda")
    w0 = torch.randn(16, 1, 8, 9, 56, 56, generator=gen, device="cuda")
    dy = torch.randn(16, 64, 56, 56, generator=gen, device="cuda")
    dilations = (1, 2, 1, 1, 2, 2, 1, 2)
    results = {}
    for impl in ("hopper", "torch"):
        x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
        la.reset_counts()
        out = la.local_aggregate_dilated(x, w, dilations, impl=impl)
        out.backward(dy)
        torch.cuda.synchronize()
        results[impl] = (out.detach(), x.grad, w.grad)
        counts = (la.LAUNCHES, dict(la.BWD_LAUNCHES), la.PLAIN_CALLS,
                  la.PLAIN_BWD_CALLS)
        if impl == "hopper" and counts != (2, {"dx": 2, "dw": 2}, 0, 0):
            raise AssertionError(f"dilated op: (fwd, bwd launches, plain, "
                                 f"plain bwd) = {counts}")
    errs = [check_close(f"dilated op {name}", g, r, torch.float32)[0]
            for name, g, r in zip(("out", "dx", "dw"), *results.values())]
    log(f"dilated op (N=16 C=64 56x56 Cw=8 f32, dilations {dilations}): "
        f"2 forward, 2 dx and 2 dw launches, 0 plain calls; max|err| "
        f"against the plain path out {errs[0]:.3g}, dx {errs[1]:.3g}, dw "
        f"{errs[2]:.3g} (rtol/atol 1e-5)")


def profile_step(fn, label: str, top: int = 12):
    """One step under torch.profiler: the device time by kernel name and the
    device's busy share of the step's wall time (the profiler's own cost is
    in that wall time)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: the operators' own rows repeat their kernels
    rows = [(e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    if not rows:
        log(f"profile of one {label}: the profiler recorded no device time "
            "(not measured)")
        return
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    # a template's name ends at its "<", any other at its "("
    agg = {name: sum(r[0] for r in rows
                     if f"{name}<" in r[2] or f"{name}(" in r[2])
           for name in ("local_agg_fwd", "local_agg_bwd_dx",
                        "local_agg_bwd_dw", "local_agg_bwd_dw_affine",
                        "local_agg_bwd_dw_affine_sums",
                        *EMBED_GN_STATS, *EMBED_GN_AGG)}
    log(f"profile of one {label}: {sum(r[1] for r in rows)} device kernels "
        f"busy {busy_ms:.3f} ms of {wall_ms:.3f} ms wall "
        f"({100 * busy_ms / wall_ms:.1f}%); "
        + ", ".join(f"{name} {ms:.3f} ms ({100 * ms / busy_ms:.1f}%)"
                    for name, ms in agg.items() if ms)
        + f"; the aggregation kernels {100 * sum(agg.values()) / busy_ms:.1f}% "
        "of device time")
    for ms, count, name in rows[:top]:
        log(f"  {ms:9.3f} ms {100 * ms / busy_ms:5.1f}% x{count:<4d} "
            f"{name[:100]}")


def per_step_summary(entries, path: str):
    """Each case a main path launched, at its launches per step there; and
    by kernel, the ms a step it loses to its bound, launches x (ms - bound),
    which ranks the kernels for speed work."""
    per_step = [(e, by["launches"] / by["steps"]) for e in entries
                for label, by in e["launches_by_path"].items()
                if label == path]
    lost = {}
    for e, n in per_step:
        lost[e["name"]] = lost.get(e["name"], 0.0) + n * (
            e["ms"] - e["bound_ms"])
    log(f"aggregation kernels per step of {path} "
        f"({sum(n for _, n in per_step):.0f} launches): " + ", ".join(
            f"{key} {sum(e[key] * n for e, n in per_step):.4f} ms"
            for key in ("ms", "plain_ms", "bound_ms",
                        "bound_ms_at_copy_rate"))
        + "; lost to the bound: " + ", ".join(
            f"{name} {ms:.4f} ms" for name, ms in lost.items()))


def build_report(build):
    """Build every kernel source (``build`` is the port's ``ops._build``)
    and log, per kernel function, what ``nvcc -Xptxas=-v`` reported for it
    (registers, shared memory, spills; nothing for a library that was built
    already) and the number of SASS instructions in the built library
    (``cuobjdump -sass``)."""
    import re
    import shutil

    outputs = build.build_all()
    cuobjdump = (shutil.which("cuobjdump")
                 or "/usr/local/cuda/bin/cuobjdump")
    for source in build.sources():
        ptxas, fn = {}, None
        for line in outputs[source].splitlines():
            m = re.search(r"(?:entry function|properties for) '?(\w+)", line)
            if m:
                fn = m.group(1)
            elif fn and ("spill" in line or "Used" in line):
                ptxas.setdefault(fn, []).append(
                    line.replace("ptxas info    :", "").strip())
        sass = {}
        try:
            dump = subprocess.run(
                [cuobjdump, "-sass", str(build.library_path(source))],
                check=True, capture_output=True, text=True,
                timeout=120).stdout
        except (OSError, subprocess.CalledProcessError) as err:
            log(f"build {source}: SASS not measured ({err})")
            dump = ""
        for line in dump.splitlines():
            m = re.match(r"\s*Function : (\w+)", line)
            if m:
                fn = m.group(1)
                sass[fn] = 0
            elif fn in sass and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
                sass[fn] += 1
        names = sorted(set(ptxas) | set(sass))
        demangled = dict(zip(names, subprocess.run(
            ["c++filt"], input="\n".join(names), capture_output=True,
            text=True).stdout.splitlines())) if shutil.which("c++filt") \
            else {}
        for fn in names:
            short = demangled.get(fn, fn).replace(
                "(anonymous namespace)::", "").replace("void ", "").split(
                "(")[0]
            log(f"build {source}: {short}: "
                + "; ".join(ptxas.get(fn, []))
                + f"; {sass.get(fn, 'not measured')} SASS instructions")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    from cotnet_tpu_torch.ops import _build, local_agg as la

    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(f"device: {name}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    log(smi)
    build_report(_build)
    torch.zeros(1, device="cuda")
    log(f"set-up (kernel build included): {time.perf_counter() - t0:.1f} s")

    paths = PathCounts()
    state = model_phase(la, paths)
    switches_phase(la, paths, state)
    del state
    torch.cuda.empty_cache()
    hybrid_phase(la, paths)
    torch.cuda.empty_cache()
    mix_path(la, paths)
    dilated_check(la)
    log(f"model and op phases done at {time.perf_counter() - t0:.1f} s")

    hbm_rate = copy_rate()
    log(f"device copy rate: {hbm_rate / 1e12:.3f} TB/s (data sheet "
        f"{HBM_BYTES_PER_S / 1e12:.2f})")
    entries = (kernel_phase(la, hbm_rate, paths)
               + bwd_kernel_phase(la, hbm_rate, paths)
               + affine_bwd_kernel_phase(la, hbm_rate, paths)
               + embed_gn_kernel_phase(la, hbm_rate, paths)
               + mix_kernel_phase(la, hbm_rate, paths))
    # every shape a main path launched was held against its plain version
    launched = sum(c for by in paths.by_key.values() for c, _ in by.values())
    if sum(e["launches"] for e in entries) != launched:
        raise AssertionError(
            f"the main paths made {launched} launches, the kernel phase "
            f"accounts for {sum(e['launches'] for e in entries)}")
    # every main path runs the K = 3 route of the forward, dx and dw, the
    # mix path the tiles route of the mix's dx and dw
    off_route = sorted({f"{e['name']} ({e['variant']}) {e['geometry']}"
                        for e in entries
                        if e["launches"] and e.get("variant", MAIN_ROUTE.get(
                            e["name"], "k3")) != MAIN_ROUTE.get(e["name"],
                                                                "k3")})
    if off_route:
        raise AssertionError(f"main-path launches off the k3 route: "
                             f"{off_route}")
    path_labels = []
    for by_path in paths.by_key.values():
        path_labels += [label for label in by_path
                        if label not in path_labels]
    for label in path_labels:
        per_step_summary(entries, label)
    log(f"total {time.perf_counter() - t0:.1f} s")
    log(smi)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
