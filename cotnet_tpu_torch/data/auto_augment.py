"""AutoAugment policies and AugMix on the device, in torch; counterpart of
``cotnet_tpu/data/auto_augment.py`` (reference datasets/auto_augment.py).

The op primitives are ``rand_augment.py``'s, so the policies are data
(``policies.py``, shared with the host backend).
- ``auto_augment_transform('v0'|'v0r'|'original'|'originalr')``: per image
  one of 25 sub-policies, each applying two (op, prob, magnitude) entries.
- ``augment_and_mix_transform('augmix-m..-w..-d..')``: AugMix, ``width``
  random op chains mixed with Dirichlet weights, then a Beta blend with the
  clean image; pairs with AugMixDataset and the JSD loss.

As in ``rand_augment.py``, ``draw(generator, n, h, w)`` makes every random
value of a batch and ``apply(x, draws)`` is deterministic.  AugMix's
Dirichlet and Beta weights are normalised Gamma draws from the same
generator (``torch._standard_gamma`` takes one; ``torch.distributions``
would draw from the global RNG).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from cotnet_tpu_torch.data.policies import (AUGMIX_OPS, OP_IDX, POLICIES,
                                            parse_augmix, parse_auto)
from cotnet_tpu_torch.data.rand_augment import (_cutout_xy, _signs,
                                                apply_ops,
                                                rand_augment_transform)


def _device(generator, device):
    return generator.device if generator is not None else device


class AutoAugment:
    """Callable (float NCHW batch in 0..255, generator) -> augmented batch."""

    def __init__(self, policy: str = "v0", magnitude_std: float = 0.0):
        table = POLICIES[policy]
        self.magnitude_std = float(magnitude_std)
        self.n_sub = len(table)
        self.op_idx = torch.tensor(
            [[OP_IDX[e[0]] for e in sub] for sub in table], dtype=torch.int64)
        self.prob = torch.tensor([[e[1] for e in sub] for sub in table],
                                 dtype=torch.float32)
        self.mag = torch.tensor([[e[2] for e in sub] for sub in table],
                                dtype=torch.float32)

    def draw(self, generator: Optional[torch.Generator], n: int, h: int,
             w: int, device=None) -> Dict[str, torch.Tensor]:
        """``sub`` (``[n]``, the sub-policy) and per slot ``[2, n]``:
        ``apply`` (``U < prob``), ``sign``, ``mag`` (the table's, noised
        and clipped to [0, 10] where ``magnitude_std`` > 0) and ``xy``
        (``[2, n, 2]``, a cutout's centre)."""
        device = _device(generator, device)
        sub = torch.randint(0, self.n_sub, (n,), generator=generator,
                            device=device)
        prob = self.prob.to(device)[sub].T
        mag = self.mag.to(device)[sub].T
        apply = torch.rand((2, n), generator=generator, device=device) < prob
        sign = _signs((2, n), generator, device)
        if self.magnitude_std > 0:
            mag = torch.clamp(mag + self.magnitude_std * torch.randn(
                (2, n), generator=generator, device=device), 0.0, 10.0)
        return {"sub": sub, "apply": apply, "sign": sign, "mag": mag,
                "xy": _cutout_xy((2, n), h, w, generator, device)}

    def apply(self, x, draws: Dict[str, torch.Tensor]):
        draws = {k: v.to(x.device) for k, v in draws.items()}
        op = self.op_idx.to(x.device)[draws["sub"]].T
        ops = torch.where(draws["apply"], op, -1).tolist()
        for slot in range(2):
            x = apply_ops(x, ops[slot], draws["mag"][slot],
                          draws["sign"][slot], draws["xy"][slot])
        return x

    def __call__(self, x, generator: Optional[torch.Generator] = None):
        n, _, h, w = x.shape
        return self.apply(x.to(torch.float32),
                          self.draw(generator, n, h, w, x.device))


_AUGMIX_IDX = torch.tensor([OP_IDX[n] for n in AUGMIX_OPS], dtype=torch.int64)


class AugMix:
    """AugMix (arXiv 1912.02781): out = m*x + (1-m)*sum_i w_i chain_i(x)."""

    def __init__(self, magnitude: float = 3, width: int = 3, depth: int = -1,
                 alpha: float = 1.0):
        self.magnitude = float(magnitude)
        self.width = width
        self.depth = depth
        self.alpha = alpha

    @property
    def max_depth(self) -> int:
        return self.depth if self.depth > 0 else 3

    def draw(self, generator: Optional[torch.Generator], n: int, h: int,
             w: int, device=None) -> Dict[str, torch.Tensor]:
        """``ws`` (``[n, width]``, Dirichlet(alpha)), ``m`` (``[n]``,
        Beta(alpha, alpha)) and per chain and step ``[width, max_depth,
        n]``: ``op``, ``sign``, ``keep`` (with a random depth, the JAX
        package's ``d < U{1, 3}`` drawn afresh at each step) and ``xy``
        (a cutout's centre, ``[..., 2]``)."""
        device = _device(generator, device)

        def gamma(shape):
            return torch._standard_gamma(
                torch.full(shape, float(self.alpha), device=device),
                generator=generator)

        g = gamma((n, self.width))
        ws = g / g.sum(1, keepdim=True)
        ga, gb = gamma((n,)), gamma((n,))
        shape = (self.width, self.max_depth, n)
        op = _AUGMIX_IDX.to(device)[torch.randint(
            0, len(AUGMIX_OPS), shape, generator=generator, device=device)]
        if self.depth > 0:
            keep = torch.ones(shape, dtype=torch.bool, device=device)
        else:
            steps = torch.arange(self.max_depth, device=device)[None, :, None]
            keep = steps < torch.randint(1, 4, shape, generator=generator,
                                         device=device)
        return {"ws": ws, "m": ga / (ga + gb), "op": op,
                "sign": _signs(shape, generator, device), "keep": keep,
                "xy": _cutout_xy(shape, h, w, generator, device)}

    def apply(self, x, draws: Dict[str, torch.Tensor]):
        draws = {k: v.to(x.device) for k, v in draws.items()}
        ops = torch.where(draws["keep"], draws["op"], -1).tolist()
        level = torch.full((x.shape[0],), self.magnitude, device=x.device)
        mixed = torch.zeros_like(x)
        for i in range(self.width):
            cur = x
            for d in range(self.max_depth):
                cur = apply_ops(cur, ops[i][d], level, draws["sign"][i, d],
                                draws["xy"][i, d])
            mixed = mixed + draws["ws"][:, i, None, None, None] * cur
        m = draws["m"][:, None, None, None]
        return m * x + (1.0 - m) * mixed

    def __call__(self, x, generator: Optional[torch.Generator] = None):
        n, _, h, w = x.shape
        return self.apply(x.to(torch.float32),
                          self.draw(generator, n, h, w, x.device))


def auto_augment_transform(config_str: str):
    """'v0' / 'v0r' / 'original' / 'originalr' / '<name>-mstd0.5' ->
    AutoAugment (parser parity with reference auto_augment.py:495-530)."""
    return AutoAugment(**parse_auto(config_str))


def augment_and_mix_transform(config_str: str):
    """'augmix-m5-w4-d2' -> AugMix (parser parity with
    auto_augment.py's augment_and_mix_transform)."""
    return AugMix(**parse_augmix(config_str))


def create_batch_augment(config_str):
    """Dispatch on the reference 'aa' config string
    (transforms_factory.py:86-98): rand-* -> RandAugment, augmix-* -> AugMix,
    else AutoAugment policy name."""
    if not config_str:
        return None
    if config_str.startswith("rand"):
        return rand_augment_transform(config_str)
    if config_str.startswith("augmix"):
        return augment_and_mix_transform(config_str)
    return auto_augment_transform(config_str)
