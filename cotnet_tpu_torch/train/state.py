"""Train state: the model, its optimizer, the EMA copy and the step counter;
counterpart of ``cotnet_tpu/train/state.py``.

The JAX state is a pure pytree that each step replaces; here the model and
the optimizer are updated in place and the state holds them.  The EMA covers
the parameters *and* the BN running stats, like the reference's full
state_dict sweep (utils/model_ema.py:45-53).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch
from torch import nn


def float_state(model: nn.Module, unique: bool = False
                ) -> Dict[str, torch.Tensor]:
    """The model's own floating-point state tensors by state_dict name:
    parameters and BN running stats, not the integer batch counters.  A
    module shared under several names (CoaT's) gives its tensors under
    each; ``unique`` keeps the first name of each tensor only."""
    out, seen = {}, set()
    for k, v in model.state_dict(keep_vars=True).items():
        if v.is_floating_point() and not (unique and id(v) in seen):
            out[k] = v
            seen.add(id(v))
    return out


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    # state_dict name -> EMA tensor (parameters and BN running stats)
    ema: Optional[Dict[str, torch.Tensor]] = None
    # host-controlled LR multiplier (1.0 unless a plateau controller sets it)
    lr_scale: float = 1.0

    @classmethod
    def create(cls, model: nn.Module, optimizer: torch.optim.Optimizer,
               ema: bool = False) -> "TrainState":
        copy = None
        if ema:
            # one EMA tensor per model tensor, under each of its names
            clones = {id(v): v.detach().clone()
                      for v in float_state(model, unique=True).values()}
            copy = {k: clones[id(v)] for k, v in float_state(model).items()}
        return cls(model=model, optimizer=optimizer, ema=copy)


@torch.no_grad()
def ema_update(ema: List[torch.Tensor], new: List[torch.Tensor],
               decay: float):
    """``v_ema = decay * v_ema + (1 - decay) * v`` in place, over two
    matching lists of tensors (model_ema.py:45-53)."""
    torch._foreach_mul_(ema, decay)
    torch._foreach_add_(ema, new, alpha=1.0 - decay)
