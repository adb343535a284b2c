"""Data parallelism of the port across the cards of one host, over NCCL.

    python tools/torch_dp_cards.py [--world 4]

Needs ``--world`` CUDA cards; each rank is a spawned process on card
``rank`` in one NCCL group.  Four parts:

1. ``dryrun_multiproc(world, "cuda")``: cotnet50 and se_cotnetd_50 at 64
   px, global batch 16; the loss must fall and the ranks agree.
2. ``chip_smoke.dp_against_one_process`` over NCCL: cotnet50 in f32 at
   224 (TF32 off, cuDNN deterministic) on a global batch of 128, 3 recipe
   steps with mixup over the global batch, held against one process on
   the whole batch at check (b)'s limits (loss 2e-5, sums 1e-4, or 3x
   that process's own noise).  The one process holds the whole global
   batch in f32 on one card, which keeps it at 128 (128 / world a rank).
3. cotnet50's bf16 train step under the CoTNet-50 recipe (mixup over the
   global batch, drop 0.25, drop path 0.1, nesterov, EMA) at 128 images a
   rank: 2 warm-up steps, 5 timed steps (host clock around synchronized
   steps), 3 steps under ``CollectiveTimer`` (CUDA events around each
   collective, nothing drained): its calls, MB and ms on the stream a
   step by helper.  The ranks must then hold the same bits and have made
   no plain call.  Then 5 timed steps with every BatchNorm given a
   one-rank group, so that its statistics are the rank's own: the step
   without global-batch BN's collectives.
4. The same step in one process on one card at 128, for comparison,
   spawned as the ranks are (a world-size-1 group): a step timed in the
   parent process, which built the kernels and ran part 2, took 225.6 ms
   where a spawned one took 163.5 on the same NVIDIA H100 80GB HBM3
   (700 W).

Prints one line per part and rank, with every card's name and power
limit.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import queue as queues
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

BATCH, WARM, TIMED, UNDER_TIMER = 128, 2, 5, 3


def steps(step, state, batch, n, first):
    """``n`` synchronized steps from step ``first``; their ms."""
    gen = torch.Generator(device="cuda")
    times = []
    for i in range(first, first + n):
        gen.manual_seed(6 + i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times, float(metrics["loss"])


def recipe_step(world: int, rows: slice):
    from cotnet_tpu_torch.models import create_model

    model = create_model("cotnet50", device="cuda", dtype=torch.bfloat16,
                         seed=0, **cs.RECIPE["model"])
    step, state = cs.recipe_train_step(model, cs.RECIPE, BATCH * world)
    full = cs.make_batch(BATCH * world)
    return model, step, state, {"image": full["image"][rows],
                                "label": full["label"][rows]}


def rank_main(rank: int, world: int, init: str, out):
    try:
        import torch.distributed as dist

        from cotnet_tpu_torch.nn import BatchNorm2d
        from cotnet_tpu_torch.ops import local_agg as la
        from cotnet_tpu_torch.parallel import mesh
        from cotnet_tpu_torch.parallel.collectives import CollectiveTimer

        torch.cuda.set_device(rank)
        mesh.initialize_distributed(init, world, rank, device="cuda")
        model, step, state, batch = recipe_step(world,
                                                mesh.rank_rows(BATCH * world))
        la.reset_counts()
        steps(step, state, batch, WARM, 0)
        times, loss = steps(step, state, batch, TIMED, WARM)
        with CollectiveTimer() as timer:
            timed, _ = steps(step, state, batch, UNDER_TIMER, WARM + TIMED)
        digest = hashlib.sha256()
        for _, v in sorted(model.state_dict().items()):
            digest.update(v.detach().cpu().numpy().tobytes())
        plain = cs.launch_snapshot(la)["plain"]
        fwd = la.LAUNCHES
        # every rank makes every group, then keeps its own
        own = [dist.new_group([r]) for r in range(world)][rank]
        for m in model.modules():
            if isinstance(m, BatchNorm2d):
                m.group = own
        local_bn, _ = steps(step, state, batch, TIMED,
                            WARM + TIMED + UNDER_TIMER)
        backend = dist.get_backend()
        dist.barrier()
        dist.destroy_process_group()
        out.put((rank, dict(times=times, timed=timed, loss=loss,
                            by=timer.by, digest=digest.hexdigest(),
                            fwd=fwd, plain=plain, backend=backend,
                            local_bn=local_bn)))
    except BaseException:
        import traceback
        out.put((rank, traceback.format_exc()))
        raise SystemExit(1)


def spawn_ranks(world: int) -> dict:
    """``rank_main`` on ``world`` spawned ranks; their results by rank."""
    import torch.multiprocessing as mp

    from cotnet_tpu_torch.parallel.mesh import free_port

    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    init = f"tcp://127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=rank_main, args=(r, world, init, out))
             for r in range(world)]
    for proc in procs:
        proc.start()
    results = {}
    try:
        while len(results) < world:
            r, res = out.get(timeout=400)
            results[r] = res
            if isinstance(res, str):
                break
        for proc in procs:
            proc.join(60)
    except queues.Empty:
        pass
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join()
    if len(results) != world or any(isinstance(v, str)
                                    for v in results.values()):
        raise SystemExit(f"ranks failed: {results}")
    return results


def summary(r: int, res: dict) -> str:
    per = {k: (round(c / UNDER_TIMER, 1), round(b / UNDER_TIMER / 1e6, 3),
               round(ms / UNDER_TIMER, 2))
           for k, (c, b, ms) in res["by"].items()}
    return (f"cotnet50 bf16 recipe, {BATCH} a rank: rank {r} step ms "
            f"{[round(t, 1) for t in res['times']]} median "
            f"{statistics.median(res['times']):.1f}; under the timer "
            f"{[round(t, 1) for t in res['timed']]}, collectives a step by "
            f"helper (calls, MB, ms on the stream) {per}; loss "
            f"{res['loss']:.4f}; fwd launches {res['fwd']}, plain calls "
            f"{res['plain']}; digest {res['digest'][:16]}; with per-rank BN "
            f"step ms {[round(t, 1) for t in res['local_bn']]} median "
            f"{statistics.median(res['local_bn']):.1f}")


def main():
    from cotnet_tpu_torch.ops import _build, local_agg as la
    from cotnet_tpu_torch.parallel.dryrun import dryrun_multiproc

    p = argparse.ArgumentParser()
    p.add_argument("--world", type=int, default=4)
    world = p.parse_args().world
    if torch.cuda.device_count() < world:
        raise SystemExit(f"needs {world} cards, has "
                         f"{torch.cuda.device_count()}")
    cs.log(f"{torch.cuda.device_count()} cards: " + os.popen(
        "nvidia-smi --query-gpu=name,power.limit --format=csv,noheader"
    ).read().strip().replace("\n", "; "))
    _build.build_all()

    t0 = time.perf_counter()
    for fam in dryrun_multiproc(world, "cuda"):
        cs.log(f"dryrun_multiproc({world}, cuda) {fam['name']}: losses "
               f"{[round(v, 4) for v in fam['losses']]}, eval {fam['eval']}")
    cs.log(f"dryrun: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    cs.dp_against_one_process(la, world, "nccl", label=f"dp ({world} cards)")
    torch.cuda.empty_cache()
    cs.log(f"f32 against one process: {time.perf_counter() - t0:.1f} s")

    results = spawn_ranks(world)
    for r, res in sorted(results.items()):
        cs.log(f"{world} {res['backend']} ranks, " + summary(r, res))
    if len({res["digest"] for res in results.values()}) != 1 or any(
            res["plain"] for res in results.values()):
        raise SystemExit("the ranks differ, or a plain version ran")
    # one process on one card, spawned as the ranks are: a world-size-1
    # group, whose collectives are the identity
    cs.log(f"one process, one card, bs{BATCH}: "
           + summary(0, spawn_ranks(1)[0]))


if __name__ == "__main__":
    main()
