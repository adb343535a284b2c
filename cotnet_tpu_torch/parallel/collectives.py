"""Collectives, counterpart of ``cotnet_tpu/parallel/collectives.py``
(reference utils/distributed.py:19-67), on ``torch.distributed``.

Each helper takes an optional ``group`` (the default group when None).  At
world size 1, or with no process group, each is the identity, as GSPMD
inserts no collective on one device.  ``all_reduce_sum`` carries a
gradient (its backward sums the incoming gradients across the group), for
the global-batch BatchNorm; the others run under ``no_grad``.
``CollectiveTimer`` records every collective run here, by the helper that
ran it.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist


class CollectiveTimer:
    """While entered, records each collective that this module runs: calls,
    bytes and ms by the helper that ran it, in ``by`` (helper -> [calls,
    bytes, ms]).  The helpers and their callers: ``all_reduce_sum``, the
    global-batch BatchNorm's sums (forward and backward);
    ``average_tensors``, the gradients and the loss; ``partner_rows``,
    mixup's partner rows; ``all_gather_rows``, the Evaler's rows;
    ``sum_tensor``, the eval counts and ``reduce_tensor``'s means.  Bytes
    are those a rank receives (an all-gather's whole result).

    A call on CUDA tensors is timed by CUDA events recorded on the current
    stream before and after it: its time on the stream, the wait for the
    slowest rank included.  Nothing is drained, so a step runs as it does
    untimed; ``__exit__`` synchronizes and adds the events' times.  A call
    on CPU tensors is timed on the host clock."""

    active: Optional["CollectiveTimer"] = None

    def __init__(self):
        self.by: Dict[str, List[float]] = {}
        self._events: list = []

    def __enter__(self):
        CollectiveTimer.active = self
        return self

    def __exit__(self, *exc):
        CollectiveTimer.active = None
        if self._events:
            torch.cuda.synchronize()
        for caller, start, end in self._events:
            self.by[caller][2] += start.elapsed_time(end)
        self._events.clear()

    def run(self, caller: str, t: torch.Tensor, nbytes: int, fn, *args,
            **kwargs):
        row = self.by.setdefault(caller, [0, 0, 0.0])
        row[0] += 1
        row[1] += nbytes
        if not t.is_cuda:
            t0 = time.perf_counter()
            fn(*args, **kwargs)
            row[2] += (time.perf_counter() - t0) * 1e3
            return
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        fn(*args, **kwargs)
        end.record()
        self._events.append((caller, start, end))


def _collective(caller: str, t: torch.Tensor, nbytes: int, fn, *args,
                **kwargs) -> None:
    """``fn(*args, **kwargs)``, recorded under ``caller`` while a
    ``CollectiveTimer`` is entered."""
    timer = CollectiveTimer.active
    if timer is None:
        fn(*args, **kwargs)
    else:
        timer.run(caller, t, nbytes, fn, *args, **kwargs)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def group_size(group=None) -> int:
    """The size of ``group`` (1 with no process group)."""
    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size(group)


class _AllReduceSum(torch.autograd.Function):
    """``y = sum over ranks of x`` on every rank; ``dx = sum over ranks of
    dy`` (each rank's loss depends on the same y)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        _collective("all_reduce_sum", y, _nbytes(y), dist.all_reduce, y,
                    group=group)
        return y

    @staticmethod
    def backward(ctx, dy):
        dx = dy.clone()
        _collective("all_reduce_sum", dx, _nbytes(dx), dist.all_reduce, dx,
                    group=ctx.group)
        return dx, None


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``group``, differentiable."""
    if group_size(group) == 1:
        return t
    return _AllReduceSum.apply(t, group)


@torch.no_grad()
def sum_tensor(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum across ranks (reference sum_tensor :44-49), a new tensor."""
    if group_size(group) == 1:
        return t
    out = t.clone()
    _collective("sum_tensor", out, _nbytes(out), dist.all_reduce, out,
                group=group)
    return out


@torch.no_grad()
def reduce_tensor(t: torch.Tensor, group=None) -> torch.Tensor:
    """Mean across ranks (reference reduce_tensor :51-55), a new tensor."""
    w = group_size(group)
    if w == 1:
        return t
    return sum_tensor(t, group) / w


@torch.no_grad()
def scaled_all_reduce(tensors: Sequence[torch.Tensor],
                      group=None) -> List[torch.Tensor]:
    """Sum-all-reduce then scale by 1/world (reference :19-42): the means
    across ranks, as new tensors."""
    return [reduce_tensor(t, group) for t in tensors]


@torch.no_grad()
def sync_batch_stats(model: torch.nn.Module, group=None) -> None:
    """Average the BN running statistics across ranks in place (the
    reference's per-epoch ``distribute_bn(..., 'reduce')``, :58-67).  The
    global-batch BN keeps them equal on every rank already; this serves
    loops whose BN is per rank."""
    if group_size(group) == 1:
        return
    for name, buf in model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            buf.copy_(reduce_tensor(buf, group))


def barrier(group=None) -> None:
    """Host-level sync (reference evaler.py:55's ``dist.barrier``)."""
    if group_size(group) > 1:
        dist.barrier(group=group)


def _gather_rows(t: torch.Tensor, group, caller: str) -> torch.Tensor:
    w = group_size(group)
    if w == 1:
        return t[None]
    parts = [torch.empty_like(t) for _ in range(w)]
    _collective(caller, t, w * _nbytes(t), dist.all_gather, parts,
                t.contiguous(), group=group)
    return torch.stack(parts)


@torch.no_grad()
def all_gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t`` stacked in rank order, ``[world, *t.shape]``."""
    return _gather_rows(t, group, "all_gather_rows")


@torch.no_grad()
def partner_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """Rank ``W-1-r``'s ``t`` on rank r: the rows that the flip of the
    global batch pairs with this rank's (mixup).  One all-gather."""
    w = group_size(group)
    if w == 1:
        return t
    rows = _gather_rows(t, group, "partner_rows")
    return rows[w - 1 - dist.get_rank(group)]


@torch.no_grad()
def average_tensors(tensors: Sequence[torch.Tensor], group=None) -> None:
    """The means across ranks of ``tensors``, in place: flattened into one
    float32 buffer (cotnet50's gradients and loss are 88.9 MB), one
    all-reduce, scaled by 1/world.  The identity at world size 1."""
    w = group_size(group)
    if w == 1:
        return
    tensors = list(tensors)
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    _collective("average_tensors", flat, _nbytes(flat), dist.all_reduce,
                flat, group=group)
    flat /= w
    off = 0
    for t in tensors:
        t.copy_(flat[off:off + t.numel()].view_as(t))
        off += t.numel()


@torch.no_grad()
def average_gradients(params: Sequence[torch.Tensor], group=None,
                      extra: Optional[Dict[str, torch.Tensor]] = None
                      ) -> Dict[str, torch.Tensor]:
    """Average the ``.grad`` of ``params`` across ranks in place
    (``average_tensors``); ``extra`` scalars (the loss) ride in the same
    buffer, and their means are returned.  The identity at world size 1."""
    extra = dict(extra or {})
    if group_size(group) == 1:
        return extra
    scalars = torch.stack([v.detach().float().reshape(())
                           for v in extra.values()]) if extra else None
    average_tensors(([scalars] if extra else [])
                    + [p.grad for p in params if p.grad is not None], group)
    return dict(zip(extra, scalars)) if extra else extra
