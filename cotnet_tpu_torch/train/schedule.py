"""LR schedules, counterpart of ``cotnet_tpu/train/schedule.py`` (reference
scheduler/cosine_lr.py, tanh_lr.py, step_lr.py, plateau_lr.py,
scheduler_factory.py).

A schedule is a pure ``f(step) -> lr`` of the optimizer step, in Python
floats on the host: the train step evaluates it from its own step counter,
so it costs no device work and no synchronisation.  Epoch granularity comes
from ``steps_per_epoch``.  Cosine (SGDR) and tanh with warm-up, restarts
via ``t_mul``, ``decay_rate`` and ``cycle_limit``; step and multistep
decay; plateau, a constant rate with warm-up that ``PlateauController``
scales through ``TrainState.lr_scale``; and the LR noise.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch


def _warmup_wrap(fn, base_lr, warmup_t, warmup_lr_init, t_of_step):
    """Linear warm-up override for t < warmup_t; the main schedule sees the
    *raw* t (reference Scheduler semantics: warm-up replaces, not shifts,
    cosine_lr.py:86-95)."""
    def sched(step) -> float:
        t = t_of_step(step)
        if warmup_t > 0 and t < warmup_t:
            return warmup_lr_init + (base_lr - warmup_lr_init) * (
                t / max(warmup_t, 1e-8))
        return fn(t)
    return sched


def _cycle_index(t, t_initial, t_mul) -> Tuple[float, float, float]:
    """(cycle index i, time within the cycle, cycle length),
    cosine_lr.py:68-85."""
    if t_mul == 1.0:
        i = math.floor(t / t_initial)
        return i, t - i * t_initial, t_initial
    i = math.floor(math.log1p(t / t_initial * (t_mul - 1)) / math.log(t_mul))
    start = t_initial * (t_mul ** i - 1) / (t_mul - 1)
    return i, t - start, t_initial * t_mul ** i


def _cyclic(shape: Callable, base_lr, t_initial, lr_min, t_mul, decay_rate,
            warmup_t, warmup_lr_init, cycle_limit, steps_per_epoch):
    """A restarting schedule: ``lr_min + (base_lr * decay_rate^i - lr_min) *
    shape(t_curr / t_i)`` in cycle i, ``lr_min`` from ``cycle_limit`` on."""
    def main(t) -> float:
        i, t_curr, t_i = _cycle_index(t, t_initial, t_mul)
        if cycle_limit and i >= cycle_limit:
            return lr_min
        return lr_min + (base_lr * decay_rate ** i - lr_min) * shape(
            t_curr / t_i)
    return _warmup_wrap(main, base_lr, warmup_t, warmup_lr_init,
                        lambda s: s / steps_per_epoch)


def cosine_schedule(base_lr: float, t_initial: float, lr_min: float = 0.0,
                    t_mul: float = 1.0, decay_rate: float = 1.0,
                    warmup_t: float = 0.0, warmup_lr_init: float = 0.0,
                    cycle_limit: int = 0, steps_per_epoch: int = 1) -> Callable:
    """SGDR cosine with warm-up and restarts (reference cosine_lr.py:18-116)."""
    return _cyclic(lambda r: 0.5 * (1 + math.cos(math.pi * r)), base_lr,
                   t_initial, lr_min, t_mul, decay_rate, warmup_t,
                   warmup_lr_init, cycle_limit, steps_per_epoch)


def tanh_schedule(base_lr: float, t_initial: float, lb: float = -6.0,
                  ub: float = 4.0, lr_min: float = 0.0, t_mul: float = 1.0,
                  decay_rate: float = 1.0, warmup_t: float = 0.0,
                  warmup_lr_init: float = 0.0, cycle_limit: int = 0,
                  steps_per_epoch: int = 1) -> Callable:
    """Hyperbolic-tangent decay with warm-up and restarts (reference
    tanh_lr.py)."""
    return _cyclic(lambda r: 0.5 * (1 - math.tanh(lb * (1.0 - r) + ub * r)),
                   base_lr, t_initial, lr_min, t_mul, decay_rate, warmup_t,
                   warmup_lr_init, cycle_limit, steps_per_epoch)


def step_schedule(base_lr: float, decay_epochs: float, decay_rate: float = 1.0,
                  warmup_t: float = 0.0, warmup_lr_init: float = 0.0,
                  steps_per_epoch: int = 1) -> Callable:
    """Fixed-interval step decay (reference step_lr.py)."""
    return _warmup_wrap(
        lambda t: base_lr * decay_rate ** math.floor(t / decay_epochs),
        base_lr, warmup_t, warmup_lr_init, lambda s: s / steps_per_epoch)


def multistep_schedule(base_lr: float, milestones: Sequence[float],
                       decay_rate: float = 0.1, warmup_t: float = 0.0,
                       warmup_lr_init: float = 0.0,
                       steps_per_epoch: int = 1) -> Callable:
    """Decay by ``decay_rate`` at each milestone epoch passed."""
    milestones = sorted(milestones)
    return _warmup_wrap(
        lambda t: base_lr * decay_rate ** sum(t >= m for m in milestones),
        base_lr, warmup_t, warmup_lr_init, lambda s: s / steps_per_epoch)


def lr_noise_draw(seed: int, epoch: int, noise_pct: float = 0.67,
                  noise_std: float = 1.0) -> float:
    """The LR noise of one epoch: a normal draw times ``noise_std`` clipped
    to +-``noise_pct``, or with ``noise_std`` 0 a uniform one in
    +-``noise_pct``, from a CPU ``torch.Generator`` seeded by ``seed`` and
    ``epoch``.  (The JAX package draws with threefry from ``fold_in(
    PRNGKey(seed), epoch)``: the values differ, the law is the same.)"""
    # the CPU generator takes a 32-bit seed: mix the two into one
    gen = torch.Generator().manual_seed((seed * 0x9E3779B1 + epoch)
                                        & 0xFFFFFFFF)
    if noise_std > 0:
        n = float(torch.randn((), generator=gen)) * noise_std
        return min(max(n, -noise_pct), noise_pct)
    return 2 * (float(torch.rand((), generator=gen)) - 0.5) * noise_pct


def with_lr_noise(sched: Callable, t_initial: float, steps_per_epoch: int,
                  noise_range_pct, noise_pct: float = 0.67,
                  noise_std: float = 1.0, seed: int = 42,
                  draw: Optional[Callable[[int], float]] = None) -> Callable:
    """Multiplicative LR noise inside a window of epochs (reference
    scheduler.py:71-80): ``lr + lr * n`` with ``n`` the epoch's draw, the
    same at every step of that epoch.  ``noise_range_pct`` is a fraction of
    ``t_initial`` (the window's start, open-ended) or a pair of fractions.
    ``draw(epoch) -> n`` replaces ``lr_noise_draw`` (for tests)."""
    if noise_range_pct is None:
        return sched
    if isinstance(noise_range_pct, (list, tuple)):
        lo, hi = (noise_range_pct[0] * t_initial,
                  noise_range_pct[1] * t_initial)
    else:
        lo, hi = noise_range_pct * t_initial, float("inf")
    if draw is None:
        def draw(epoch):
            return lr_noise_draw(seed, epoch, noise_pct, noise_std)

    def noisy(step) -> float:
        lr = sched(step)
        t = step / steps_per_epoch
        if not lo <= t < hi:
            return lr
        return lr + lr * draw(math.floor(t))
    return noisy


class PlateauController:
    """Host-side reduce-on-plateau (reference plateau_lr.py): call
    ``update(metric)`` once an epoch and set ``TrainState.lr_scale`` to
    what it returns; the ``plateau`` schedule's rate is multiplied by it."""

    def __init__(self, decay_rate=0.1, patience=10, threshold=1e-4,
                 mode="max", cooldown=10, min_scale=0.0):
        self.decay_rate, self.patience = decay_rate, patience
        self.threshold, self.mode = threshold, mode
        self.cooldown_t, self.min_scale = cooldown, min_scale
        self.scale = 1.0
        self.best = None
        self.num_bad = 0
        self.cooldown = 0

    def _better(self, m):
        if self.best is None:
            return True
        if self.mode == "max":
            return m > self.best * (1 + self.threshold)
        return m < self.best * (1 - self.threshold)

    def update(self, metric: float) -> float:
        if self._better(metric):
            self.best, self.num_bad = metric, 0
        elif self.cooldown > 0:
            self.cooldown -= 1
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.scale = max(self.scale * self.decay_rate, self.min_scale)
                self.cooldown = self.cooldown_t
                self.num_bad = 0
        return self.scale


def create_scheduler(cfg: dict, steps_per_epoch: int):
    """Config -> (schedule fn, total epochs incl. cooldown), mirroring
    scheduler_factory.py:10-87 including the cycle-aware epoch count of the
    cosine and tanh schedules."""
    num_epochs = cfg.get("epochs", 200)
    sched_name = cfg.get("sched", "cosine")
    base_lr = cfg.get("base_lr", cfg.get("lr", 0.1))
    warmup = dict(warmup_t=cfg.get("warmup_epochs", 0),
                  warmup_lr_init=cfg.get("warmup_lr", 1e-4),
                  steps_per_epoch=steps_per_epoch)
    cycle_mul = cfg.get("lr_cycle_mul", 1.0)
    cycle_limit = cfg.get("lr_cycle_limit", 1)
    decay_rate = cfg.get("decay_rate", 0.1)

    if sched_name in ("cosine", "tanh") and cycle_limit > 1:
        if cycle_mul == 1.0:
            total = num_epochs * cycle_limit
        else:
            total = int(math.floor(
                -num_epochs * (cycle_mul ** cycle_limit - 1) / (1 - cycle_mul)))
    else:
        total = num_epochs

    if sched_name in ("cosine", "tanh"):
        make = cosine_schedule if sched_name == "cosine" else tanh_schedule
        fn = make(base_lr, num_epochs, lr_min=cfg.get("min_lr", 0.0),
                  t_mul=cycle_mul, decay_rate=decay_rate,
                  cycle_limit=cycle_limit, **warmup)
    elif sched_name == "step":
        fn = step_schedule(base_lr, cfg.get("decay_epochs", 30), decay_rate,
                           **warmup)
    elif sched_name == "multistep":
        fn = multistep_schedule(base_lr, cfg.get("decay_milestones", [30, 60]),
                                decay_rate, **warmup)
    elif sched_name == "plateau":
        # constant; the host scales it by a PlateauController's lr_scale
        fn = _warmup_wrap(lambda t: base_lr, base_lr, warmup["warmup_t"],
                          warmup["warmup_lr_init"],
                          lambda s: s / steps_per_epoch)
    else:
        raise ValueError(f"unknown sched {sched_name!r}")

    fn = with_lr_noise(fn, num_epochs, steps_per_epoch, cfg.get("lr_noise"),
                       cfg.get("lr_noise_pct", 0.67),
                       cfg.get("lr_noise_std", 1.0), cfg.get("seed", 42))
    return fn, total + cfg.get("cooldown_epochs", 0)
