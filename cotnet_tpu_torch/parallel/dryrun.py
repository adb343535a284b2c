"""``dryrun_multiproc``: data-parallel training of two model families on
tiny shapes over ``world_size`` spawned ranks, the port's counterpart of
``__graft_entry__.dryrun_multichip`` (global-batch BN, gradient means,
optimizer, EMA and mixup over the global batch, then a padded eval)::

    python -m cotnet_tpu_torch.parallel.dryrun 2 cpu

On the CPU the ranks join a gloo group; on ``cuda`` an NCCL group, rank r
on card r, so ``world_size`` cards are needed.
"""

from __future__ import annotations

import os
import sys
import time
from typing import List

FAMILIES = ("cotnet50", "se_cotnetd_50")
# image size, global batch and steps of each family's run; the whole
# run's time limit
SIZE, BATCH, STEPS = 64, 16, 4
TIMEOUT_S = 600.0


def _rank_main(rank: int, world_size: int, init_method: str, device: str,
               queue) -> None:
    import torch

    from cotnet_tpu_torch.data.mixup import Mixup
    from cotnet_tpu_torch.models import create_model
    from cotnet_tpu_torch.parallel import mesh
    from cotnet_tpu_torch.train.loss import soft_target_cross_entropy
    from cotnet_tpu_torch.train.optim import create_optimizer
    from cotnet_tpu_torch.train.schedule import create_scheduler
    from cotnet_tpu_torch.train.state import TrainState
    from cotnet_tpu_torch.train.step import make_eval_step, make_train_step

    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)
    try:
        mesh.initialize_distributed(init_method, world_size, rank,
                                    device=dev)
        num_classes = 10
        rows = mesh.rank_rows(BATCH)
        results = []
        for fam_i, name in enumerate(FAMILIES):
            t0 = time.time()
            model = create_model(name, num_classes=num_classes, device=dev,
                                 seed=fam_i)
            schedule_fn, _ = create_scheduler(
                dict(sched="cosine", epochs=2, lr=0.1, warmup_epochs=1,
                     warmup_lr=1e-4, min_lr=1e-5), steps_per_epoch=10)
            optimizer = create_optimizer(
                dict(opt="sgd", momentum=0.9, weight_decay=4e-5,
                     clip_mode="norm", clip_grad=5.0), model.parameters())
            state = TrainState.create(model, optimizer, ema=True)
            mixup = Mixup(mixup_alpha=0.8, cutmix_alpha=1.0,
                          label_smoothing=0.1, num_classes=num_classes)
            train_step = make_train_step(model, optimizer, schedule_fn,
                                         soft_target_cross_entropy,
                                         ema_decay=0.9999, mixup_fn=mixup)
            # one fixed global batch, the rank keeps its rows: the step
            # must learn, not only run the collectives
            images = torch.randn((BATCH, 3, SIZE, SIZE), generator=torch.
                                 Generator().manual_seed(2)) * 0.3
            labels = torch.arange(BATCH) % num_classes
            data = {"image": images[rows].to(dev),
                    "label": labels[rows].to(dev)}
            generator = torch.Generator(dev)
            losses = []
            for i in range(STEPS):
                generator.manual_seed(1000003 + i)
                state, metrics = train_step(state, data, generator)
                losses.append(float(metrics["loss"]))
            assert all(map(lambda v: v == v and abs(v) < 1e9, losses)), \
                (name, losses)
            assert state.step == STEPS
            head, tail = sum(losses[:3]) / 3, sum(losses[-3:]) / 3
            assert tail < head, (f"{name}: data-parallel training does "
                                 f"not learn: {losses}")
            # a ragged final global batch: padded and masked
            n_valid = BATCH - world_size // 2 - 1
            valid = (torch.arange(BATCH) < n_valid).float()
            res = make_eval_step(model)(
                {"image": data["image"], "label": data["label"],
                 "valid": valid[rows].to(dev)})
            res = {k: float(v) for k, v in res.items()}
            assert res["n"] == n_valid, (name, res)
            assert 0.0 <= res["top1_count"] <= res["top5_count"] \
                <= res["n"], (name, res)
            bn = model.bn1
            results.append(dict(
                name=name, losses=losses, eval=res,
                param_sum=float(sum(p.detach().double().abs().sum()
                                    for p in model.parameters())),
                bn_mean_sum=float(bn.running_mean.double().abs().sum()),
                seconds=time.time() - t0))
        queue.put((rank, results))
    except BaseException as e:
        queue.put((rank, repr(e)))
        raise
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def dryrun_multiproc(world_size: int = 2, device: str = "cuda"
                     ) -> List[dict]:
    """Spawn ``world_size`` ranks that each train cotnet50 and
    se_cotnetd_50 at ``SIZE`` px on their rows of a global batch of
    ``BATCH`` (nesterov SGD with norm clipping, the EMA and mixup over the
    global batch) for ``STEPS`` steps, check that the loss falls, then run
    a padded eval pass.  Raises unless every rank succeeds within
    ``TIMEOUT_S`` and all ranks hold the same losses, eval counts and
    parameters; returns rank 0's results, one dict per family."""
    import torch.multiprocessing as mp

    from cotnet_tpu_torch.parallel import mesh

    ctx = mp.get_context("spawn")
    queue = ctx.SimpleQueue()
    init_method = f"tcp://127.0.0.1:{mesh.free_port()}"
    procs = [ctx.Process(target=_rank_main, args=(
        r, world_size, init_method, device, queue))
        for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.time() + TIMEOUT_S
    try:
        for p in procs:
            p.join(max(1.0, deadline - time.time()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    results = {}
    while not queue.empty():
        rank, res = queue.get()
        results[rank] = res
    failed = {r: v for r, v in results.items() if isinstance(v, str)}
    rcs = [p.exitcode for p in procs]
    if failed or any(rcs) or len(results) != world_size:
        raise RuntimeError(f"dryrun_multiproc({world_size}, {device!r}): "
                           f"exit codes {rcs}, errors {failed}")
    for r in range(1, world_size):
        for a, b in zip(results[0], results[r]):
            same = {k: a[k] for k in ("losses", "eval", "param_sum",
                                      "bn_mean_sum")} == \
                {k: b[k] for k in ("losses", "eval", "param_sum",
                                   "bn_mean_sum")}
            if not same:
                raise RuntimeError(f"rank {r} disagrees with rank 0 on "
                                   f"{a['name']}: {a} vs {b}")
    return results[0]


if __name__ == "__main__":
    world = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    dev = sys.argv[2] if len(sys.argv) > 2 else "cuda"
    for fam in dryrun_multiproc(world, dev):
        print(f"dryrun_multiproc({world}, {dev}) {fam['name']}: losses "
              f"{' '.join(f'{v:.4f}' for v in fam['losses'])}, eval "
              f"{fam['eval']}, {fam['seconds']:.0f}s", flush=True)
    os._exit(0)
