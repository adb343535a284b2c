"""Process group and rank helpers, counterpart of ``cotnet_tpu/parallel/mesh.py``.

The JAX package distributes by GSPMD: one mesh, sharding annotations, and
the compiler's all-reduces, so its BatchNorm and gradient means are over
the global batch by construction.  The port runs one process per card on
``torch.distributed`` (the reference's layout, train.py:96-115, 222-227):
each rank holds the whole model, computes on its own rows of the global
batch (``rank_rows``), and the collectives of ``parallel.collectives`` make
the batch statistics, the gradients and the eval counts global.

``make_mesh``, ``batch_sharding`` and ``replicated`` have no counterpart
here: there is no mesh to build and no sharding to annotate.  A rank's
device is ``local_device()`` (``cuda:LOCAL_RANK``).
"""

from __future__ import annotations

import logging
import os
import socket
from typing import Optional

import torch
import torch.distributed as dist

_log = logging.getLogger(__name__)

# torchrun's rendezvous variables
_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def default_backend(device=None) -> str:
    """``nccl`` for the card, ``gloo`` for the CPU.  ``device`` is the one
    the caller computes on; None means the card, the port's default."""
    device = torch.device("cuda" if device is None else device)
    return "nccl" if device.type == "cuda" else "gloo"


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           backend: Optional[str] = None,
                           device=None) -> bool:
    """Join the process group, the counterpart of the JAX package's
    ``initialize_distributed`` (reference init_process_group,
    train.py:224).  Returns whether the process is in a group (joined now
    or before).

    With no arguments it is best-effort: under torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) it joins
    with ``env://``; without it the run stays one process.  With explicit
    arguments (``init_method`` such as ``tcp://localhost:PORT``,
    ``world_size``, ``rank``) a failure is fatal: it is logged and raised,
    never degraded to independent single-process runs, which would train
    divergent models.  ``backend`` defaults to ``default_backend(device)``;
    with ``nccl`` the process's current card becomes ``local_device()``."""
    explicit = any(a is not None for a in (init_method, world_size, rank))
    if dist.is_initialized():
        return True
    if not explicit and not all(k in os.environ for k in _TORCHRUN_ENV):
        _log.debug("no torchrun environment: staying one process")
        return False
    backend = backend or default_backend(device)
    try:
        if explicit:
            if world_size is None or rank is None:
                raise ValueError("initialize_distributed: explicit "
                                 "arguments need world_size and rank")
            if not 0 <= rank < world_size:
                raise ValueError(f"rank {rank} outside world_size "
                                 f"{world_size}")
        dist.init_process_group(
            backend, init_method=init_method or "env://",
            world_size=-1 if world_size is None else world_size,
            rank=-1 if rank is None else rank)
    except (RuntimeError, ValueError) as e:
        _log.error("init_process_group(%s, init_method=%s, world_size=%s, "
                   "rank=%s) FAILED: %s; refusing to degrade to one process",
                   backend, init_method, world_size, rank, e)
        raise
    if backend == "nccl":  # before the first collective builds NCCL's
        torch.cuda.set_device(local_device())
    return True


def free_port() -> int:
    """A free TCP port on localhost, for a group's rendezvous
    (``tcp://127.0.0.1:PORT``)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank() -> int:
    """This process's rank in the default group (0 without one)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def world_size() -> int:
    """The default group's size (1 without one)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def local_rank() -> int:
    """The rank within this host: torchrun's ``LOCAL_RANK``, else the rank
    (one host)."""
    return int(os.environ.get("LOCAL_RANK", rank()))


def local_device() -> torch.device:
    """This rank's card, ``cuda:LOCAL_RANK``."""
    return torch.device("cuda", local_rank())


def rank_rows(global_n: int, rank_: Optional[int] = None,
              world_size_: Optional[int] = None) -> slice:
    """The rows of a global batch of ``global_n`` that ``rank_`` computes:
    the contiguous ``[rank * n, (rank + 1) * n)`` with ``n = global_n /
    world``, the rows GSPMD places on process ``rank`` (the JAX package's
    ``shard_batch``)."""
    r = rank() if rank_ is None else rank_
    w = world_size() if world_size_ is None else world_size_
    if global_n % w:
        raise ValueError(f"global batch {global_n} does not split into "
                         f"{w} ranks")
    n = global_n // w
    return slice(r * n, (r + 1) * n)
