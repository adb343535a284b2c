"""Train and eval steps, counterparts of ``make_train_step`` and
``make_eval_step`` in ``cotnet_tpu/train/step.py`` (the reference's inner
loop, train.py:238-297)."""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch.func import functional_call

from cotnet_tpu_torch.models.cotnet import CotLayer
from cotnet_tpu_torch.models.lr_net import SelfAttLayer
from cotnet_tpu_torch.models.san import SAM, SAMLowRank
from cotnet_tpu_torch.nn.drop import set_generator
from cotnet_tpu_torch.parallel import mesh
from cotnet_tpu_torch.parallel.collectives import (average_gradients,
                                                    average_tensors,
                                                    sum_tensor)
from cotnet_tpu_torch.train.optim import global_norm
from cotnet_tpu_torch.train.state import TrainState, ema_update, float_state

# the modules that call local_aggregate
_AGGREGATING = (CotLayer, SAM, SAMLowRank, SelfAttLayer)


def make_train_step(model, optimizer, schedule_fn: Callable, loss_fn: Callable,
                    ema_decay: float = 0.0,
                    mixup_fn: Optional[Callable] = None,
                    second_order: bool = False) -> Callable:
    """Build the train step: mixup, forward, loss, backward, the optimizer's
    update and the EMA.

    The returned ``train_step(state, batch, generator)`` takes a
    ``TrainState`` made from this ``model`` and ``optimizer``, ``{"image":
    [N, C, H, W], "label": [N] int}`` on the model's device and the
    ``torch.Generator`` (on that device; None for its default one) that
    mixup and the drop layers draw from.  It updates the model, the
    optimizer and the EMA in place and returns ``(state, metrics)``:
    ``loss`` and ``grad_norm`` (the global L2 norm of the gradients) as f32
    device scalars, and ``lr`` = ``schedule_fn(step) * lr_scale``, the rate
    this update used, as a Python float.  Nothing in the step waits for the
    device: the schedule is host arithmetic on the state's step counter.

    The model computes in its own ``dtype`` with f32 parameters cast at use
    (as its eval forward does), so gradients and the update are f32;
    ``torch.autocast`` is not used.

    ``second_order`` adds AdaHessian's Hutchinson probe (the reference's
    ``create_graph=True`` backward, train.py:249): Rademacher vectors z
    drawn from ``generator``, ``Hz`` by a second backward through the
    gradients, and ``hessian_diag = z * Hz`` passed to ``optimizer.step``.
    It needs a twice-differentiable model: the CoT aggregation's backward
    is not (nor is the JAX package's, whose ``jax.jvp`` of ``jax.grad``
    raises through ``local_aggregate``), so a model holding the op (a
    ``CotLayer``, SAN's ``SAM`` or ``SAMLowRank``, LR-Net's
    ``SelfAttLayer``) raises ``ValueError`` here.  An optimizer with ``schedule_offset`` (1
    for AdaHessian) takes the schedule's rate that many steps ahead, as the
    JAX package's does; the ``lr`` metric stays ``schedule_fn(step)``.

    Data parallel (a default process group of W > 1 ranks, each with its
    rows of the global batch): the BatchNorms take global statistics, mixup
    mixes over the global batch (``data/mixup.py``), the loss is the rank's
    own mean, and before the norm and the update the gradients are averaged
    across ranks in one all-reduce of a flat f32 buffer
    (``parallel.collectives.average_gradients``), so clipping, the update,
    Lookahead and the EMA see the same gradients on every rank.  The
    ``loss`` metric is the global mean.  The model is not wrapped in
    ``DistributedDataParallel``, which would rename every state_dict key.
    AdaHessian's ``hessian_diag`` is averaged the same way (its probes are
    drawn alike on every rank).  Drop path and dropout draw per rank, from
    a generator seeded by the step generator's seed, the step and the
    rank: they are not the draws one process makes, as in any
    data-parallel run.
    """
    if second_order and any(isinstance(m, _AGGREGATING)
                            for m in model.modules()):
        raise ValueError(
            "make_train_step(second_order=True): the model holds the CoT "
            "aggregation op (local_aggregate, in CotLayer, SAM or "
            "SelfAttLayer), whose backward is not twice differentiable; the "
            "JAX package cannot take this step either")
    params = [p for g in optimizer.param_groups for p in g["params"]]
    live = list(float_state(model).items())
    offset = getattr(optimizer, "schedule_offset", 0)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None):
        model.train()
        images, labels = batch["image"], batch["label"]
        if mixup_fn is not None:
            images, labels = mixup_fn(images, labels, generator)
        world = mesh.world_size()
        drop_generator = generator
        if world > 1 and generator is not None:
            drop_generator = torch.Generator(generator.device).manual_seed(
                (generator.initial_seed() * 1000003 + state.step * world
                 + mesh.rank()) % (1 << 63))
        set_generator(model, drop_generator)

        lr = float(schedule_fn(state.step)) * state.lr_scale
        step_lr = lr if not offset else (
            float(schedule_fn(state.step + offset)) * state.lr_scale)
        for group in optimizer.param_groups:
            group["lr"] = step_lr
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model(images), labels)
        if second_order:
            extra = {"hessian_diag": hessian_diagonal(
                loss, params, rademacher_probes(params, generator))}
            # the probes are the same on every rank: the global estimate
            # is the mean of the ranks'
            average_tensors(extra["hessian_diag"])
        else:
            loss.backward()
            extra = {}
        # the identity on one rank: the loss stays the tensor it was
        loss = average_gradients(params, extra={"loss": loss})["loss"]
        grads = [p.grad for p in params if p.grad is not None]
        grad_norm = global_norm(grads)
        optimizer.step(**extra)

        if ema_decay and state.ema is not None:
            ema_update([state.ema[k] for k, _ in live],
                       [v.detach() for _, v in live], ema_decay)
        state.step += 1
        return state, {"loss": loss.detach(), "lr": lr,
                       "grad_norm": grad_norm}

    return train_step


def rademacher_probes(params, generator: Optional[torch.Generator] = None):
    """One Rademacher vector (+-1 with equal odds) per parameter, drawn from
    ``generator``."""
    return [torch.randint(0, 2, p.shape, generator=generator,
                          device=p.device).to(p.dtype) * 2 - 1
            for p in params]


def hessian_diagonal(loss, params, probes):
    """Hutchinson's estimate of the Hessian diagonal, ``z * Hz`` for each
    probe z: the gradients by a backward that records its own graph, then
    ``Hz`` by a backward of them against the probes.  Sets each
    parameter's ``.grad`` to its gradient."""
    grads = torch.autograd.grad(loss, params, create_graph=True)
    hz = torch.autograd.grad(grads, params, grad_outputs=probes)
    for p, g in zip(params, grads):
        p.grad = g.detach()
    return torch._foreach_mul(probes, hz)


def make_eval_step(model, tta_hflip: bool = False,
                   return_topk: bool = False) -> Callable:
    """Top-1/top-5 correct counts on one batch (reference
    utils/meters.py:12-19).

    The returned ``eval_step(batch, tensors=None)`` takes ``{"image": [N,
    C, H, W], "label": [N] int, optional "valid": [N] float mask}`` on the
    model's device and returns float32 scalars ``top1_count``,
    ``top5_count`` and ``n`` (plus ``topk`` indices with ``return_topk``).
    ``tta_hflip`` averages the logits with those of the horizontally
    flipped images.  ``tensors`` (state_dict name -> tensor, such as
    ``TrainState.ema``) stand in for the model's own for this call
    (``torch.func.functional_call``): the EMA is evaluated without touching
    the live weights (the JAX step's ``use_ema``).

    Data parallel: the counts are summed across ranks (one all-reduce), as
    GSPMD gives the JAX step global counts; ``topk`` stays the rank's rows
    (``Evaler`` gathers them)."""

    @torch.no_grad()
    def eval_step(batch: Dict[str, torch.Tensor],
                  tensors: Optional[Dict[str, torch.Tensor]] = None
                  ) -> Dict[str, torch.Tensor]:
        model.eval()
        images = batch["image"]

        def forward(x):
            if tensors is None:
                return model(x)
            return functional_call(model, tensors, (x,))

        logits = forward(images)
        if tta_hflip:
            logits = 0.5 * (logits + forward(images.flip(-1)))
        labels = batch["label"]
        valid = batch.get("valid")
        if valid is None:
            valid = torch.ones(labels.shape, dtype=torch.float32,
                               device=labels.device)
        k = min(5, logits.shape[-1])
        topk = logits.float().topk(k, dim=-1).indices
        correct1 = (topk[:, 0] == labels).float() * valid
        correct5 = (topk == labels[:, None]).any(dim=1).float() * valid
        out = {"top1_count": correct1.sum(), "top5_count": correct5.sum(),
               "n": valid.float().sum()}
        if mesh.world_size() > 1:
            counts = sum_tensor(torch.stack(list(out.values())))
            out = dict(zip(out, counts))
        if return_topk:  # for ReaL-labels scoring, this rank's rows
            out["topk"] = topk
        return out

    return eval_step
