"""Training driver, counterpart of ``cotnet_tpu/train_cli.py`` (reference
train.py).

    python -m cotnet_tpu_torch.train_cli --folder <exp_dir>

The folder holds a ``config.yaml`` in the reference recipe format (the
``cot_experiments/*/config.yaml`` recipes parse unchanged); the log,
``log.txt``, and the checkpoints land in it.  The flags and the flow are the
JAX CLI's: ``--synthetic`` runs on random data, ``--steps N`` caps the
iterations of an epoch, ``--epochs N`` the schedule's length, and
``--img-size``, ``--batch-size``, ``--model`` override the recipe (smoke
mode); ``--eval-only`` evaluates the resumed state, with ``--real-labels``
ImageNet ReaL too.  One flag is the port's own: ``--device`` (``cuda`` by
default, which raises without a card; ``cpu`` runs the plain versions).

Data parallel, one process per card (or per CPU rank under gloo)::

    python -m torch.distributed.run --nproc_per_node 2 \
        -m cotnet_tpu_torch.train_cli --folder <exp> [--device cpu]

``initialize_distributed()`` reads torchrun's environment (NCCL on the
cards, gloo with ``--device cpu``); each rank runs on ``cuda:LOCAL_RANK``
with its rows of the recipe's global batch, seeds numpy with ``seed +
rank`` as the JAX CLI's ``setup_env`` does, and keeps the step generator's
seed, the same on every rank.  Rank 0 alone writes the checkpoints and the
recovery file, and every rank waits for the write; every rank reads on
resume.

``model.kernel_impl``: ``auto`` takes the Hopper kernels on the card (the
plain versions on the CPU), ``pallas`` the kernels always (it raises on the
CPU), ``xla`` the plain versions (``block_args=dict(impl="torch")``).

The step's draws (mixup, dropout, drop path) come from a device generator
seeded from ``(seed + 777, step)`` before every step, as the JAX step folds
the step into its key, so a run resumed from a checkpoint draws what an
uninterrupted run draws.  The plateau schedule trains at its fixed rate:
the JAX CLI wires no ``PlateauController`` either.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

# the JAX package's model.dtype names
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# model.kernel_impl -> the port's impl
IMPLS = {"auto": "auto", "pallas": "hopper", "xla": "torch"}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="cotnet_tpu_torch training")
    p.add_argument("--folder", required=True,
                   help="experiment dir containing config.yaml")
    p.add_argument("--synthetic", action="store_true",
                   help="synthetic data (smoke mode)")
    p.add_argument("--steps", type=int, default=0,
                   help="cap steps per epoch (0 = full)")
    p.add_argument("--epochs", type=int, default=0,
                   help="override solver.epochs")
    p.add_argument("--eval-only", action="store_true")
    p.add_argument("--real-labels", default="",
                   help="path to ImageNet ReaL real.json (eval-only; "
                        "reference validate.py --real-labels)")
    p.add_argument("--img-size", type=int, default=0,
                   help="override input resolution (smoke mode)")
    p.add_argument("--batch-size", type=int, default=0,
                   help="override train/val batch size (smoke mode)")
    p.add_argument("--model", default="",
                   help="override model.name (smoke mode)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the Hopper kernels) or cpu (the plain "
                        "versions)")
    return p.parse_args(argv)


def step_seed(seed: int, step: int) -> int:
    """The seed of the step's generator: a function of the run's seed and
    the step alone."""
    return (seed * 1000003 + step) % (1 << 63)


def build_model(cfg, device):
    """(model, data config) of ``cfg.model``, weights from ``cfg.seed``."""
    from cotnet_tpu_torch.models import create_model, get_model_default_cfg

    m = cfg.model
    model = create_model(
        m.name, num_classes=m.num_classes, device=device,
        dtype=DTYPES[m.dtype], seed=int(cfg.seed), drop_rate=m.drop,
        drop_path_rate=m.drop_path, drop_block_rate=m.drop_block,
        global_pool=m.gp, block_args=dict(impl=IMPLS[m.kernel_impl]))
    return model, get_model_default_cfg(m.name)


def build_loaders(cfg, data_cfg, args, device):
    from cotnet_tpu_torch.data.loader import Loader, SyntheticLoader

    size = data_cfg["input_size"][-1]
    num_classes = cfg.model.num_classes
    aug = cfg.augmentation
    if args.synthetic or cfg.data_loader.get("dataset_type") == "synthetic":
        steps = args.steps or 100
        train = SyntheticLoader(cfg.data_loader.batch_size, size, num_classes,
                                steps=steps, device=device)
        val = SyntheticLoader(cfg.data_loader.vbatch_size, size, num_classes,
                              steps=max(1, steps // 10), device=device)
        return train, val
    from cotnet_tpu_torch.data.dataset import ImageFolderDataset, TarDataset

    root = cfg.data_loader.data_path
    mk = TarDataset if cfg.data_loader.get("dataset_type") == "tar" else \
        ImageFolderDataset
    train_ds = mk(os.path.join(root, "train") if os.path.isdir(
        os.path.join(root, "train")) else root)
    val_ds = mk(os.path.join(root, "val") if os.path.isdir(
        os.path.join(root, "val")) else root,
        class_to_idx=train_ds.class_to_idx)
    common = dict(mean=data_cfg["mean"], std=data_cfg["std"],
                  workers=cfg.data_loader.workers, device=device,
                  # decode on worker processes where the host has the cores
                  # for them (the JAX CLI's rule)
                  worker_procs=(cfg.data_loader.workers > 1
                                and (os.cpu_count() or 1) > 2))
    train = Loader(
        train_ds, cfg.data_loader.batch_size, train=True, image_size=size,
        interpolation=aug.train_interpolation or "random",
        scale=tuple(aug.scale), ratio=tuple(aug.ratio), hflip=aug.hflip,
        vflip=aug.vflip, auto_augment=aug.aa, reprob=aug.reprob,
        remode=aug.remode, recount=aug.recount,
        num_aug_splits=aug.aug_splits, seed=int(cfg.seed), **common)
    val = Loader(
        val_ds, cfg.data_loader.vbatch_size, train=False, image_size=size,
        crop_pct=data_cfg["crop_pct"],
        interpolation=data_cfg["interpolation"], **common)
    return train, val


def build_solver(cfg, model, steps_per_epoch: int):
    """``(schedule_fn, num_epochs, optimizer, train_loss, mixup_fn)`` of the
    recipe's solver, loss and augmentation sections."""
    from cotnet_tpu_torch.data.mixup import Mixup
    from cotnet_tpu_torch.train.loss import create_loss_fn
    from cotnet_tpu_torch.train.optim import create_optimizer
    from cotnet_tpu_torch.train.schedule import create_scheduler

    solver = dict(cfg.solver)
    solver["base_lr"] = solver.get("lr", 0.1)
    solver["seed"] = int(cfg.seed)
    schedule_fn, num_epochs = create_scheduler(solver, steps_per_epoch)
    optimizer = create_optimizer(solver, model.parameters())
    mixup_active = ((cfg.augmentation.mixup > 0 or cfg.augmentation.cutmix > 0)
                    and not cfg.loss.jsd)  # JSD trains on hard labels
    loss_cfg = dict(cfg.loss)
    loss_cfg["aug_splits"] = cfg.augmentation.aug_splits
    train_loss, _ = create_loss_fn(loss_cfg, mixup_active)
    mixup_fn = None
    if mixup_active:
        mixup_fn = Mixup(
            mixup_alpha=cfg.augmentation.mixup,
            cutmix_alpha=cfg.augmentation.cutmix,
            prob=cfg.augmentation.mixup_prob,
            switch_prob=cfg.augmentation.mixup_switch_prob,
            mode=cfg.augmentation.mixup_mode,
            label_smoothing=cfg.loss.smoothing,
            num_classes=cfg.model.num_classes)
    return schedule_fn, num_epochs, optimizer, train_loss, mixup_fn


def main(argv=None) -> dict:
    """Run the CLI; returns ``{"eval": the last eval's results, "best": the
    best metric (None with --eval-only), "state": the TrainState}``."""
    args = parse_args(argv)
    from cotnet_tpu_torch.parallel import mesh

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train_cli --device cuda needs a CUDA device; "
                           "pass --device cpu to run the plain versions")
    # torchrun's group where its environment is set, else one process
    joined = (not torch.distributed.is_initialized()
              and mesh.initialize_distributed(device=device))
    try:
        if device.type == "cuda":
            device = mesh.local_device()
        return _run(args, device)
    finally:
        if joined:
            torch.distributed.destroy_process_group()


def _run(args, device) -> dict:
    from cotnet_tpu_torch.config import load_experiment
    from cotnet_tpu_torch.evaler import Evaler
    from cotnet_tpu_torch.ops.flops import get_model_complexity
    from cotnet_tpu_torch.parallel import mesh
    from cotnet_tpu_torch.train.loss import label_smoothing_cross_entropy
    from cotnet_tpu_torch.train.optim import sync_lookahead
    from cotnet_tpu_torch.train.state import TrainState
    from cotnet_tpu_torch.train.step import make_train_step
    from cotnet_tpu_torch.utils.checkpoint import CheckpointSaver
    from cotnet_tpu_torch.utils.logger import logger_info, setup_default_logging
    from cotnet_tpu_torch.utils.meters import TrainMeter

    cfg = load_experiment(args.folder)
    if args.model:
        cfg["model"]["name"] = args.model
    if args.epochs:
        cfg["solver"]["epochs"] = args.epochs
    if args.batch_size:
        cfg["data_loader"]["batch_size"] = args.batch_size
        cfg["data_loader"]["vbatch_size"] = args.batch_size
    logger = setup_default_logging(args.folder)
    seed = int(cfg.seed)
    np.random.seed(seed + mesh.rank())

    model, data_cfg = build_model(cfg, device)
    if args.img_size:
        c = data_cfg["input_size"][0]
        data_cfg["input_size"] = (c, args.img_size, args.img_size)
    train_loader, val_loader = build_loaders(cfg, data_cfg, args, device)
    try:
        steps_per_epoch = (min(len(train_loader), args.steps) if args.steps
                           else len(train_loader))

        # complexity report (reference train.py:68-70), on the meta device
        gmacs, n_params = get_model_complexity(
            model, (1, *data_cfg["input_size"]))
        logger_info(logger, f"model {cfg.model.name}: {n_params / 1e6:.1f}M "
                            f"params, {gmacs:.2f} GMACs")

        schedule_fn, num_epochs, optimizer, train_loss, mixup_fn = \
            build_solver(cfg, model, steps_per_epoch)
        ema = bool(cfg.model.model_ema)
        state = TrainState.create(model, optimizer, ema=ema)

        saver = CheckpointSaver(
            os.path.join(args.folder, "checkpoints"), max_history=10,
            metric_mode="max",
            recovery_interval=cfg.solver.recovery_interval,
            arch=cfg.model.name)
        start_epoch = 0
        recovery = saver.find_recovery()
        if cfg.model.resume:
            saver.restore(state, cfg.model.resume)
            start_epoch = state.step // max(steps_per_epoch, 1)
            logger_info(logger, f"resumed at epoch {start_epoch}")
        elif recovery:
            saver.restore(state, recovery["path"])
            start_epoch = recovery["epoch"]
            logger_info(logger, f"recovered from epoch {start_epoch}")

        ema_decay = cfg.model.model_ema_decay if ema else 0.0
        train_step = make_train_step(model, optimizer, schedule_fn,
                                     train_loss, ema_decay=ema_decay,
                                     mixup_fn=mixup_fn)
        # mixup can switch off for the last epochs (cfg mixup_off_epoch)
        mixup_off_epoch = cfg.augmentation.mixup_off_epoch or 0
        train_step_nomix = None
        if mixup_fn is not None and mixup_off_epoch > 0:
            def hard_loss(logits, labels):
                return label_smoothing_cross_entropy(logits, labels,
                                                     cfg.loss.smoothing)
            train_step_nomix = make_train_step(
                model, optimizer, schedule_fn, hard_loss,
                ema_decay=ema_decay, mixup_fn=None)

        tta = bool(cfg.augmentation.tta)
        real_labels = None
        if args.real_labels:
            from cotnet_tpu_torch.data.real_labels import RealLabelsImagenet
            real_labels = RealLabelsImagenet(
                val_loader.dataset.filenames(basename=True),
                real_json=args.real_labels)
        evaler = Evaler(model, val_loader, logger, tta_hflip=tta,
                        real_labels=real_labels)
        evaler_ema = (Evaler(model, val_loader, logger, use_ema=True,
                             tta_hflip=tta) if ema else None)

        if args.eval_only:
            results = evaler(start_epoch, state)
            if "real_top1" in results:
                logger_info(logger, f"ReaL top1 {results['real_top1']:.3f} "
                                    f"top5 {results['real_top5']:.3f}")
            return {"eval": results, "best": None, "state": state}

        if cfg.solver.start_epoch is not None and not start_epoch:
            start_epoch = int(cfg.solver.start_epoch)

        generator = torch.Generator(device=device)
        best, results = -1.0, None
        try:
            for epoch in range(start_epoch, num_epochs):
                step_fn = train_step
                if (train_step_nomix is not None
                        and epoch >= num_epochs - mixup_off_epoch):
                    step_fn = train_step_nomix
                train_loader.set_epoch(epoch)
                meter = TrainMeter(steps_per_epoch, num_epochs,
                                   cfg.solver.log_interval, logger,
                                   cfg.data_loader.batch_size)
                for it, batch in enumerate(train_loader):
                    if args.steps and it >= args.steps:
                        break
                    generator.manual_seed(step_seed(seed + 777, state.step))
                    meter.iter_tic()
                    state, metrics = step_fn(state, batch, generator)
                    meter.iter_toc()
                    if (it + 1) % cfg.solver.log_interval == 0:
                        meter.update(float(metrics["loss"]),
                                     float(metrics["lr"]))
                    meter.log_iter_stats(epoch, it)

                # epoch-end lookahead sync (reference train.py:295-296):
                # eval and checkpoint on the slow-merged weights
                state = sync_lookahead(state)
                results = evaler(epoch, state)
                if evaler_ema is not None:
                    ema_results = evaler_ema(epoch, state)
                    if ema_results["top1"] > results["top1"]:
                        results = ema_results
                metric = results[cfg.eval.eval_metric]
                saver.save_recovery(state, epoch + 1)
                saver.save_checkpoint(state, epoch + 1, metric)
                best = max(best, metric)
        except KeyboardInterrupt:
            pass
        logger_info(logger, f"done; best {cfg.eval.eval_metric}: {best:.3f}")
        return {"eval": results, "best": best, "state": state}
    finally:
        for loader in (train_loader, val_loader):
            if hasattr(loader, "close"):
                loader.close()


if __name__ == "__main__":
    main()
