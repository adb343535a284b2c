"""Recompute a module's forward in the backward (``remat``), the
counterpart of ``flax.linen.remat`` on the JAX chassis.

``remat_call(module, x)`` runs ``module(x)`` under
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``: only the input
is kept, and the forward runs again when the backward needs its
activations.  Two things a JAX recompute gets for free are done by hand so
that the result is bit for bit that of the plain call:

- the draws of the drop modules (drop path, dropout, DropBlock) come from
  the explicit generator the train step sets (``nn.drop``), which
  ``preserve_rng_state`` does not save: its state is recorded before the
  first pass, set again for the recompute, and put back after it, so the
  generator stands after the backward where it stands without ``remat``;
- a train-mode ``BatchNorm2d`` would move its running statistics a second
  time in the recompute, and under a process group all-reduce a second
  time: it takes the first pass's sums instead (``BatchStatsReplay``).
"""

from __future__ import annotations

from torch.utils.checkpoint import checkpoint

from cotnet_tpu_torch.nn.drop import _Drop
from cotnet_tpu_torch.nn.norm import BatchStatsReplay


class _FirstPass:
    def __init__(self, replay, generators):
        self.replay, self.generators = replay, generators

    def __enter__(self):
        self.replay.start = [g.get_state() for g in self.generators]
        BatchStatsReplay.stack.append(self.replay)

    def __exit__(self, *exc):
        BatchStatsReplay.stack.pop()


class _Recompute(_FirstPass):
    def __enter__(self):
        self.now = [g.get_state() for g in self.generators]
        for g, state in zip(self.generators, self.replay.start):
            g.set_state(state)
        self.replay.replaying, self.replay.pos = True, 0
        BatchStatsReplay.stack.append(self.replay)

    def __exit__(self, *exc):
        BatchStatsReplay.stack.pop()
        for g, state in zip(self.generators, self.now):
            g.set_state(state)


def remat_call(module, *args):
    """``module(*args)`` with its activations recomputed in the backward."""
    generators = []
    for m in module.modules():
        g = getattr(m, "generator", None) if isinstance(m, _Drop) else None
        if g is not None and all(g is not h for h in generators):
            generators.append(g)
    replay = BatchStatsReplay()

    def contexts():
        return _FirstPass(replay, generators), _Recompute(replay, generators)

    return checkpoint(module, *args, use_reentrant=False,
                      context_fn=contexts)
