"""Optimizer factory, counterpart of ``cotnet_tpu/train/optim.py`` (reference
optim/optim_factory.py:35-127 and the optimizer zoo optim/*.py).

Every name the JAX package accepts: sgd, nesterov, momentum, adam, adamw,
nadam, radam, adamp, sgdp, adadelta, rmsprop, rmsproptf / rmsprop_tf,
novograd / nvnovograd, adafactor, lamb, lars and adahessian; the apex fused
names as their plain equivalents; ``lookahead_<name>`` and
``<name>_lookahead``; and gradient clipping (``clip_mode`` norm, value or
agc with ``clip_grad``), applied first, as the JAX chain does.

The weight-decay mask is the port's two parameter groups: parameters of more
than one dimension decay, the others do not (optim_factory.py:19-32).
Where the JAX chain adds the decay to the gradient before the optimizer
(sgd, adam, nadam, radam, adadelta, rmsprop, novograd), so does the port.

SGD and Adadelta are ``torch.optim``'s own classes, whose arithmetic is the
optax chain's.  The others are written here, each in the order of the optax
transformations the JAX package chains, in f32, with ``torch._foreach_*``
over a group's tensors where the shapes allow and a loop over the tensors
where a transformation works tensor by tensor (trust ratios, the AdamP /
SGDP projection, Adafactor's moments and block clipping, AGC).  Step counts
are host integers in the parameter groups, so bias corrections are host
arithmetic; the conditions that depend on values (the clipping, the
projection, the trust ratios) stay device tensors under ``torch.where``, so
no step reads a device value back.  The learning rate is written into the
groups by the train step from its schedule.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, List, Optional, Sequence

import numpy as np
import torch

# apex fused names -> the plain equivalents
_FUSED = {"fusedsgd": "sgd", "fusedmomentum": "momentum", "fusedadam": "adam",
          "fusedadamw": "adamw", "fusedlamb": "lamb",
          "fusednovograd": "novograd"}
# AGC's floor on a parameter's unit norm (optax.adaptive_grad_clip's eps)
_AGC_EPS = 1e-3


def wd_mask(params: Iterable[torch.Tensor]) -> List[bool]:
    """True where weight decay applies: ndim > 1 (optim_factory.py:19-32;
    1-d parameters and biases get no decay)."""
    return [p.dim() > 1 for p in params]


def norms(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Each tensor's L2 norm, as a 0-d tensor on its device: one
    ``torch._foreach_norm`` on the card; on the CPU, whose norm kernel sums
    in order (4e-5 relative error at 2M f32 elements), a cascade sum of
    squares each, as accurate as the JAX package's."""
    if tensors and tensors[0].device.type != "cpu":
        return list(torch._foreach_norm(tensors))
    return [t.square().sum().sqrt() for t in tensors]


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """``optax.global_norm``: the L2 norm of all the tensors together."""
    return torch.linalg.vector_norm(torch.stack(norms(tensors)))


# ---- gradient clipping ----------------------------------------------------

def unitwise_norm(x: torch.Tensor) -> torch.Tensor:
    """The L2 norm of each output unit, broadcast to ``x``'s shape
    (``optax.unitwise_norm`` in the port's layout): the whole tensor where
    it has at most one non-unit dimension, else each output channel of a
    ``[out, in]`` Linear or ``[O, I, kh, kw]`` conv weight (flax's Dense
    ``[in, out]`` over axis 0, HWIO over axes 0-2)."""
    if x.squeeze().dim() <= 1:
        return x.square().sum().sqrt().expand(x.shape)
    if x.dim() not in (2, 4):
        raise ValueError(f"no unit norm for a parameter of shape "
                         f"{tuple(x.shape)}")
    return x.square().sum(tuple(range(1, x.dim())), keepdim=True).sqrt(
    ).expand(x.shape)


@torch.no_grad()
def clip_gradients(params: Sequence[torch.Tensor], mode: str, value: float):
    """Clip the ``.grad`` of ``params`` in place (``clip_transform``,
    reference utils/clip_grad.py:26-40):

    - ``norm``: ``optax.clip_by_global_norm``, ``g * value / norm`` where
      the global norm exceeds ``value`` (``clip_grad_norm_`` would divide
      by ``norm + 1e-6``);
    - ``value``: each element clamped to ``[-value, value]``;
    - ``agc``: ``optax.adaptive_grad_clip(value)``, each output unit's
      gradient to at most ``value * max(|p|_unit, 1e-3)``."""
    params = [p for p in params if p.grad is not None]
    grads = [p.grad for p in params]
    if not grads:
        return
    if mode == "norm":
        norm = global_norm(grads)
        scale = torch.where(norm < value, 1.0, value / norm)
        torch._foreach_mul_(grads, scale)
    elif mode == "value":
        torch._foreach_clamp_min_(grads, -value)
        torch._foreach_clamp_max_(grads, value)
    elif mode == "agc":
        for p, g in zip(params, grads):
            g_norm = unitwise_norm(g)
            max_norm = value * unitwise_norm(p).clamp_min(_AGC_EPS)
            clipped = g * (max_norm / g_norm.clamp_min(1e-6))
            g.copy_(torch.where(g_norm < max_norm, g, clipped))
    else:
        raise ValueError(f"unknown clip mode {mode!r}")


# ---- the hand-written optimizers -----------------------------------------

def _trust_ratio(params, updates, coefficient: float = 1.0, eps: float = 0.0):
    """``optax.scale_by_trust_ratio`` in place: each update times
    ``coefficient * |p| / (|u| + eps)``, or 1 where either norm is 0."""
    pn = torch.stack(norms(params))
    un = torch.stack(norms(updates))
    ratio = torch.where((pn == 0) | (un == 0), 1.0,
                        coefficient * pn / (un + eps))
    torch._foreach_mul_(updates, list(ratio.unbind()))


def _f32_correction(decay: float, t: int) -> float:
    """``1 - decay^t`` in f32, as the optax chains compute a bias
    correction (``decay`` rounds to f32 first: ``1 - 0.999`` is 1.3e-5
    larger there than in f64)."""
    return float(np.float32(1) - np.float32(decay) ** np.float32(t))


def _zeros(params) -> List[torch.Tensor]:
    return [torch.zeros_like(p, memory_format=torch.preserve_format)
            for p in params]


class _Chain(torch.optim.Optimizer):
    """An optax chain as a ``torch.optim.Optimizer``: ``step`` counts each
    group's updates in ``group["count"]`` (a host int), adds the chain's L2
    decay to the gradients where ``l2`` is set (``g + wd * p``, not in
    place) and hands the group to the subclass's ``_update(group, params,
    grads, **extra)``, which moves the parameters in place.  Bias
    corrections are f32, as the chains' are."""

    l2 = False

    def __init__(self, params, lr: float = 0.0, weight_decay: float = 0.0,
                 **defaults):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay,
                                      count=0, **defaults))

    def _state(self, params, *names, init=_zeros) -> List[List[torch.Tensor]]:
        """Per-parameter state tensors, created as ``init(params)`` on first
        use; one list per name."""
        new = [p for p in params if names[0] not in self.state[p]]
        if new:
            for name in names:
                for p, t in zip(new, init(new)):
                    self.state[p][name] = t
        return [[self.state[p][name] for p in params] for name in names]

    @torch.no_grad()
    def step(self, closure=None, **extra):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            group["count"] += 1
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            if self.l2 and group["weight_decay"]:
                # wd * p rounded before the sum, as XLA does (an add with
                # alpha may fuse into one FMA), since g + wd * p may cancel
                grads = torch._foreach_add(
                    grads, torch._foreach_mul(params, group["weight_decay"]))
            self._update(group, params, grads, **extra)
        return loss


class AdamFamily(_Chain):
    """``optax.scale_by_adam`` and what each name chains around it:

    - ``adam``: L2 decay before, ``-lr * m_hat / (sqrt(v_hat) + eps)``;
    - ``adamw``: decoupled decay after, ``u + wd * p`` (``optax.adamw``);
    - ``nadam``: L2 decay, optax's Nesterov form (``optax.nadam``,
      ``m_hat = b1 m / (1 - b1^(t+1)) + (1 - b1) g / (1 - b1^t)``; not
      ``torch.optim.NAdam``'s momentum-decay schedule);
    - ``radam``: L2 decay, ``optax.radam``'s rectification where the
      length of the approximated SMA reaches ``threshold``, else ``m_hat``;
    - ``lamb``: decoupled decay after, then the trust ratio
      (``optax.lamb``)."""

    def __init__(self, params, kind: str, betas=(0.9, 0.999),
                 eps: float = 1e-8, threshold: float = 5.0, **kw):
        if kind not in ("adam", "adamw", "nadam", "radam", "lamb"):
            raise ValueError(f"unknown Adam form {kind!r}")
        self.kind = kind
        self.l2 = kind in ("adam", "nadam", "radam")
        super().__init__(params, betas=tuple(betas), eps=eps,
                         threshold=threshold, **kw)

    def _update(self, group, params, grads):
        b1, b2 = group["betas"]
        t = group["count"]
        mu, nu = self._state(params, "mu", "nu")
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, grads, alpha=1 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, torch._foreach_mul(grads, grads),
                            alpha=1 - b2)
        if self.kind == "nadam":
            u = torch._foreach_div(mu, _f32_correction(b1, t + 1))
            torch._foreach_mul_(u, b1)
            torch._foreach_add_(
                u, torch._foreach_div(grads, _f32_correction(b1, t)),
                alpha=1 - b1)
        else:
            u = torch._foreach_div(mu, _f32_correction(b1, t))
        rectify = 1.0
        if self.kind == "radam":
            # the length of the approximated SMA, in f32 as optax's
            f32 = np.float32
            ro_inf = f32(2.0 / (1.0 - b2) - 1.0)
            b2t = f32(b2) ** f32(t)
            ro = ro_inf - f32(2) * f32(t) * b2t / (f32(1) - b2t)
            if ro < group["threshold"]:
                rectify = None
            else:
                rectify = float(np.sqrt(
                    (ro - f32(4)) * (ro - f32(2)) * ro_inf
                    / ((ro_inf - f32(4)) * (ro_inf - f32(2)) * ro)))
        if rectify is not None:
            denom = torch._foreach_div(nu, _f32_correction(b2, t))
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, group["eps"])
            if rectify != 1.0:
                torch._foreach_mul_(u, rectify)
            torch._foreach_div_(u, denom)
        wd = group["weight_decay"]
        if self.kind in ("adamw", "lamb") and wd:
            torch._foreach_add_(u, params, alpha=wd)
        if self.kind == "lamb":
            _trust_ratio(params, u)
        torch._foreach_add_(params, u, alpha=-group["lr"])


class RMSprop(_Chain):
    """``optax.rmsprop`` with momentum, after the L2 decay: ``nu`` from 0
    (optax's ``initial_scale``), ``g / (sqrt(nu) + eps)``, or ``g *
    rsqrt(nu + eps)`` with ``eps_in_sqrt`` (rmsproptf); then ``-lr``, then
    the momentum trace, so the rate scales each step's update before it
    enters the trace (``torch.optim.RMSprop`` scales the trace)."""

    l2 = True

    def __init__(self, params, alpha: float = 0.9, eps: float = 1e-8,
                 momentum: float = 0.9, eps_in_sqrt: bool = False, **kw):
        super().__init__(params, alpha=alpha, eps=eps, momentum=momentum,
                         eps_in_sqrt=eps_in_sqrt, **kw)

    def _update(self, group, params, grads):
        d = group["alpha"]
        nu, trace = self._state(params, "nu", "trace")
        torch._foreach_mul_(nu, d)
        torch._foreach_add_(nu, torch._foreach_mul(grads, grads), alpha=1 - d)
        if group["eps_in_sqrt"]:
            scale = torch._foreach_add(nu, group["eps"])
            torch._foreach_rsqrt_(scale)
        else:
            scale = torch._foreach_sqrt(nu)
            torch._foreach_add_(scale, group["eps"])
            torch._foreach_reciprocal_(scale)
        torch._foreach_mul_(scale, grads)
        torch._foreach_mul_(scale, -group["lr"])
        torch._foreach_mul_(trace, group["momentum"])
        torch._foreach_add_(trace, scale)
        torch._foreach_add_(params, trace)


class Novograd(_Chain):
    """``optax.novograd`` after the L2 decay: a per-tensor second moment
    ``nu`` of ``|g|^2``, ``mu = b1 mu + g / (sqrt(nu) + eps)``, both
    started from the first gradient."""

    l2 = True

    def __init__(self, params, betas=(0.9, 0.999), eps: float = 1e-8, **kw):
        super().__init__(params, betas=tuple(betas), eps=eps, **kw)

    def _update(self, group, params, grads):
        b1, b2 = group["betas"]
        sq = norms(grads)
        torch._foreach_mul_(sq, sq)
        (nu,) = self._state(params, "nu", init=lambda ps: [
            torch.zeros((), dtype=p.dtype, device=p.device) for p in ps])
        if group["count"] == 1:
            torch._foreach_copy_(nu, sq)
        else:
            torch._foreach_mul_(nu, b2)
            torch._foreach_add_(nu, sq, alpha=1 - b2)
        denom = torch._foreach_sqrt(nu)
        torch._foreach_add_(denom, group["eps"])
        step = torch._foreach_div(grads, denom)
        if group["count"] == 1:
            for p, s in zip(params, step):
                self.state[p]["mu"] = s
        else:
            mu = [self.state[p]["mu"] for p in params]
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, step)
        torch._foreach_add_(params, [self.state[p]["mu"] for p in params],
                            alpha=-group["lr"])


class Lars(_Chain):
    """``optax.lars``: masked decay ``g + wd * p``, the trust ratio on every
    parameter (coefficient 0.001, eps 0), ``-lr``, then the momentum trace
    (no Nesterov)."""

    l2 = True

    def __init__(self, params, momentum: float = 0.9,
                 trust_coefficient: float = 0.001, **kw):
        super().__init__(params, momentum=momentum,
                         trust_coefficient=trust_coefficient, **kw)

    def _update(self, group, params, grads):
        (trace,) = self._state(params, "trace")
        u = list(grads) if group["weight_decay"] else [
            g.clone() for g in grads]
        _trust_ratio(params, u, group["trust_coefficient"])
        torch._foreach_mul_(u, -group["lr"])
        torch._foreach_mul_(trace, group["momentum"])
        torch._foreach_add_(trace, u)
        torch._foreach_add_(params, trace)


def _factored_dims(shape, min_dim_size_to_factor: int):
    """The two largest dimensions by size, (second, largest), or None where
    the second is below ``min_dim_size_to_factor`` (optax's
    ``_factored_dims``; by size, so the layout does not matter)."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape, kind="stable")
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


class Adafactor(_Chain):
    """``optax.adafactor`` with its defaults: the factored second moment
    (rows and columns of the two largest dimensions, where the second is at
    least ``min_dim_size_to_factor``; decay ``1 - t^-0.8``; eps 1e-30), the
    block RMS clipped to 1, ``lr``, times the parameter's RMS (at least
    1e-3), plus the masked decay ``wd * p`` (not scaled by the rate), and
    the sign flipped."""

    def __init__(self, params, decay_rate: float = 0.8,
                 min_dim_size_to_factor: int = 128, eps: float = 1e-30,
                 clipping_threshold: float = 1.0, **kw):
        super().__init__(params, decay_rate=decay_rate,
                         min_dim_size_to_factor=min_dim_size_to_factor,
                         eps=eps, clipping_threshold=clipping_threshold, **kw)

    def _update(self, group, params, grads):
        rate = float(np.float32(1) - np.float32(group["count"])
                     ** np.float32(-group["decay_rate"]))
        eps = group["eps"]
        for p, g in zip(params, grads):
            state = self.state[p]
            dims = _factored_dims(p.shape, group["min_dim_size_to_factor"])
            g_sq = g * g + eps
            if dims is None:
                if "v" not in state:
                    state["v"] = torch.zeros_like(p)
                v = state["v"]
                v.mul_(rate).add_(g_sq, alpha=1 - rate)
                u = g * v.rsqrt()
            else:
                d1, d0 = dims
                if "v_row" not in state:
                    state["v_row"] = torch.zeros_like(g_sq.mean(d0))
                    state["v_col"] = torch.zeros_like(g_sq.mean(d1))
                v_row, v_col = state["v_row"], state["v_col"]
                v_row.mul_(rate).add_(g_sq.mean(d0), alpha=1 - rate)
                v_col.mul_(rate).add_(g_sq.mean(d1), alpha=1 - rate)
                row_col_mean = v_row.mean(d1 - 1 if d1 > d0 else d1,
                                          keepdim=True)
                row_factor = (v_row / row_col_mean).rsqrt()
                u = (g * row_factor.unsqueeze(d0)
                     * v_col.rsqrt().unsqueeze(d1))
            u = u / torch.clamp_min(
                u.square().mean().sqrt() / group["clipping_threshold"], 1.0)
            u = u * group["lr"]
            rms = p.square().mean().sqrt()
            u = u * torch.where(rms <= 1e-3, 1e-3, rms)
            if group["weight_decay"]:
                u = u + group["weight_decay"] * p
            p.sub_(u)


def _projection(p, update, delta: float, wd_ratio: float, eps: float):
    """AdamP / SGDP's projection (reference adamp.py, sgdp.py): where the
    update is nearly parallel to a weight's output-channel directions, take
    its part orthogonal to them and shrink the decay by ``wd_ratio``.
    Returns (update, decay ratio) with the condition on the device; the
    output channel is dim 0 in the port's layout."""
    if p.dim() < 2:
        return update, 1.0
    pv = p.reshape(p.shape[0], -1)
    uv = update.reshape(p.shape[0], -1)
    pn = pv / (pv.square().sum(1, keepdim=True).sqrt() + eps)
    dot = (pn * uv).sum(1)
    cos = dot.abs() / (uv.square().sum(1).sqrt() + eps)
    cond = cos.max() < delta / math.sqrt(pv.shape[1])
    proj = (uv - pn * dot[:, None]).view_as(p)
    return (torch.where(cond, proj, update),
            torch.where(cond, wd_ratio, 1.0))


class AdamP(_Chain):
    """AdamP (reference optim/adamp.py; ``_scale_by_adamp``): Adam's
    direction, Nesterov as the JAX package writes it, projected per tensor,
    plus ``p * wd * ratio``, then ``-lr``."""

    def __init__(self, params, betas=(0.9, 0.999), eps: float = 1e-8,
                 delta: float = 0.1, wd_ratio: float = 0.01,
                 nesterov: bool = True, **kw):
        super().__init__(params, betas=tuple(betas), eps=eps, delta=delta,
                         wd_ratio=wd_ratio, nesterov=nesterov, **kw)

    def _update(self, group, params, grads):
        b1, b2 = group["betas"]
        t = group["count"]
        b1c, b2c = _f32_correction(b1, t), _f32_correction(b2, t)
        exp_avg, exp_avg_sq = self._state(params, "exp_avg", "exp_avg_sq")
        torch._foreach_mul_(exp_avg, b1)
        torch._foreach_add_(exp_avg, grads, alpha=1 - b1)
        torch._foreach_mul_(exp_avg_sq, b2)
        torch._foreach_addcmul_(exp_avg_sq, grads, grads, value=1 - b2)
        denom = torch._foreach_div(exp_avg_sq, b2c)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, group["eps"])
        if group["nesterov"]:
            d = torch._foreach_mul(exp_avg, b1)
            torch._foreach_div_(d, b1c)
            torch._foreach_add_(d, grads, alpha=1 - b1)
        else:
            d = torch._foreach_div(exp_avg, b1c)
        torch._foreach_div_(d, denom)
        _project_and_step(group, params, d)


class SGDP(_Chain):
    """SGDP (reference optim/sgdp.py; ``_scale_by_sgdp``): momentum with
    Nesterov, projected per tensor, plus ``p * wd * ratio``, then
    ``-lr``."""

    def __init__(self, params, momentum: float = 0.9, dampening: float = 0.0,
                 eps: float = 1e-8, delta: float = 0.1, wd_ratio: float = 0.1,
                 nesterov: bool = True, **kw):
        super().__init__(params, momentum=momentum, dampening=dampening,
                         eps=eps, delta=delta, wd_ratio=wd_ratio,
                         nesterov=nesterov, **kw)

    def _update(self, group, params, grads):
        m = group["momentum"]
        (buf,) = self._state(params, "buf")
        torch._foreach_mul_(buf, m)
        torch._foreach_add_(buf, grads, alpha=1 - group["dampening"])
        if group["nesterov"]:
            d = torch._foreach_add(grads, buf, alpha=m)
        else:
            d = [b.clone() for b in buf]
        _project_and_step(group, params, d)


def _project_and_step(group, params, directions):
    """AdamP / SGDP's tail: the projection, ``p * wd * ratio`` and the step
    by ``-lr``, tensor by tensor."""
    wd = group["weight_decay"]
    for p, d in zip(params, directions):
        d, ratio = _projection(p, d, group["delta"], group["wd_ratio"],
                               group["eps"])
        if wd:
            d = d + p * wd * ratio
        p.add_(d, alpha=-group["lr"])


class AdaHessian(_Chain):
    """AdaHessian (reference optim/adahessian.py; the JAX package's
    ``adahessian``): Adam's first moment, a second moment of the Hutchinson
    Hessian diagonal (``hessian_diag``, which ``step`` takes from
    ``make_train_step(second_order=True)``) averaged over a conv kernel's
    taps, decay ``wd * p`` on every parameter (no mask, as in the JAX
    package).  The JAX package reads the schedule at ``count + 1`` here,
    where every optax optimizer reads it at ``count``: ``schedule_offset``
    tells the train step to set the rate of the next step."""

    schedule_offset = 1

    def __init__(self, params, betas=(0.9, 0.999), eps: float = 1e-8,
                 hessian_power: float = 1.0, **kw):
        super().__init__(params, betas=tuple(betas), eps=eps,
                         hessian_power=hessian_power, **kw)

    def step(self, closure=None, hessian_diag=None):
        """``hessian_diag``: one tensor per parameter of the groups, in
        their order (``make_train_step(second_order=True)`` passes it)."""
        if hessian_diag is None:
            raise ValueError("adahessian needs hessian_diag from "
                             "make_train_step(second_order=True)")
        order = [p for g in self.param_groups for p in g["params"]]
        return super().step(closure, hessian_diag=dict(zip(order,
                                                           hessian_diag)))

    def _update(self, group, params, grads, hessian_diag):
        b1, b2 = group["betas"]
        t = group["count"]
        m, v = self._state(params, "exp_avg", "exp_hessian_sq")
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, grads, alpha=1 - b1)
        hd = []
        for p in params:
            h = hessian_diag[p].abs()
            hd.append(h.mean((2, 3), keepdim=True).expand(h.shape)
                      if h.dim() == 4 else h)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, hd, hd, value=1 - b2)
        denom = torch._foreach_div(v, _f32_correction(b2, t))
        torch._foreach_sqrt_(denom)
        if group["hessian_power"] != 1.0:
            torch._foreach_pow_(denom, group["hessian_power"])
        torch._foreach_add_(denom, group["eps"])
        step = torch._foreach_div(m, _f32_correction(b1, t))
        torch._foreach_div_(step, denom)
        if group["weight_decay"]:
            torch._foreach_add_(step, params, alpha=group["weight_decay"])
        torch._foreach_add_(params, step, alpha=-group["lr"])


# ---- Lookahead ------------------------------------------------------------

class Lookahead:
    """Lookahead (reference optim/lookahead.py; the JAX package's
    ``lookahead``) around an optimizer: slow weights, and every
    ``sync_period`` steps ``slow += alpha * (fast - slow)`` and the fast
    weights set to them.  ``param_groups`` is the inner optimizer's, so the
    train step's rate reaches it; ``state_dict`` holds the inner state, the
    slow weights and the count."""

    def __init__(self, inner, sync_period: int = 6, alpha: float = 0.5):
        self.inner, self.sync_period, self.alpha = inner, sync_period, alpha
        self.count = 0
        self.params = [p for g in inner.param_groups for p in g["params"]]
        self.slow = [p.detach().clone() for p in self.params]

    @property
    def param_groups(self):
        return self.inner.param_groups

    def zero_grad(self, set_to_none: bool = True):
        self.inner.zero_grad(set_to_none=set_to_none)

    def _pull_slow(self, alpha: float) -> List[torch.Tensor]:
        """``slow += alpha * (fast - slow)``; returns the fast weights."""
        fast = [p.detach() for p in self.params]
        diff = torch._foreach_sub(fast, self.slow)
        torch._foreach_mul_(diff, alpha)
        torch._foreach_add_(self.slow, diff)
        return fast

    @torch.no_grad()
    def step(self, closure=None, **extra):
        loss = self.inner.step(closure, **extra)
        self.count += 1
        if self.count % self.sync_period == 0:
            # as the JAX chain: the update slow - fast added to the fast
            # weights (one rounding from the slow weights themselves)
            fast = self._pull_slow(self.alpha)
            torch._foreach_add_(fast, torch._foreach_sub(self.slow, fast))
        return loss

    @torch.no_grad()
    def sync(self, alpha: Optional[float] = None):
        """``slow += alpha * (fast - slow)``; ``fast = slow``."""
        fast = self._pull_slow(self.alpha if alpha is None else alpha)
        torch._foreach_copy_(fast, self.slow)

    def state_dict(self) -> dict:
        return {"inner": self.inner.state_dict(), "slow": list(self.slow),
                "count": self.count}

    def load_state_dict(self, state: dict):
        self.inner.load_state_dict(state["inner"])
        with torch.no_grad():
            torch._foreach_copy_(self.slow, list(state["slow"]))
        self.count = int(state["count"])


def sync_lookahead(state, alpha: float = 0.5):
    """Epoch-end lookahead sync (reference train.py:295-296): the slow
    weights merge the fast ones by ``alpha`` and the model takes them, so
    an epoch-end eval or checkpoint sees the merged weights wherever the
    step count sits in the sync period.  Takes and returns a
    ``TrainState``; a no-op without the Lookahead wrapper."""
    if isinstance(state.optimizer, Lookahead):
        state.optimizer.sync(alpha)
    return state


# ---- the factory ----------------------------------------------------------

def _groups(params, wd: float, mask: bool = True) -> list:
    """The decay mask as parameter groups: ndim > 1 with ``wd``, the rest
    with 0 (or one group of all with ``wd`` where ``mask`` is False)."""
    if not mask:
        return [{"params": params, "weight_decay": wd}]
    keep = wd_mask(params)
    return [{"params": [p for p, m in zip(params, keep) if m],
             "weight_decay": wd},
            {"params": [p for p, m in zip(params, keep) if not m],
             "weight_decay": 0.0}]


def _clip_hook(mode: str, value: float) -> Callable:
    def hook(optimizer, args, kwargs):
        clip_gradients([p for g in optimizer.param_groups
                        for p in g["params"]], mode, value)
    return hook


def create_optimizer(cfg: dict, params: Iterable[torch.Tensor],
                     lr: float = 0.0):
    """Config -> an optimizer over ``params`` (``torch.optim.Optimizer``,
    or ``Lookahead`` around one).

    cfg keys (the reference's solver section): ``opt``, ``weight_decay``,
    ``momentum``, ``opt_eps``, ``opt_betas``, ``alpha`` (rmsprop),
    ``clip_mode`` (default norm) and ``clip_grad``.  ``lr`` is the rate
    until the train step sets the schedule's.  As in the JAX package,
    adahessian takes neither the clipping nor Lookahead, and decays every
    parameter."""
    opt = cfg.get("opt", "sgd").lower()
    wd = cfg.get("weight_decay", 0.0)
    momentum = cfg.get("momentum", 0.9)
    eps = cfg.get("opt_eps", 1e-8)
    betas = tuple(cfg.get("opt_betas") or (0.9, 0.999))
    use_lookahead = False
    if opt.startswith("lookahead_"):
        use_lookahead, opt = True, opt[len("lookahead_"):]
    if opt.endswith("_lookahead"):
        use_lookahead, opt = True, opt[:-len("_lookahead")]
    opt = _FUSED.get(opt, opt)
    params = [p for p in params if p.requires_grad]

    if opt in ("sgd", "momentum", "nesterov"):
        # the reference's 'sgd' is Nesterov SGD
        optimizer = torch.optim.SGD(_groups(params, wd), lr=lr,
                                    momentum=momentum,
                                    nesterov=opt in ("sgd", "nesterov"))
    elif opt in ("adam", "adamw", "nadam", "radam", "lamb"):
        optimizer = AdamFamily(_groups(params, wd), opt, betas, eps, lr=lr)
    elif opt == "adamp":
        optimizer = AdamP(_groups(params, wd), betas, eps, lr=lr)
    elif opt == "sgdp":
        optimizer = SGDP(_groups(params, wd), momentum, eps=eps, lr=lr)
    elif opt == "adadelta":
        optimizer = torch.optim.Adadelta(_groups(params, wd), lr=lr, rho=0.9,
                                         eps=eps)
    elif opt in ("rmsprop", "rmsproptf", "rmsprop_tf"):
        # rmsproptf: eps inside the sqrt (reference rmsprop_tf.py)
        optimizer = RMSprop(_groups(params, wd), cfg.get("alpha", 0.9), eps,
                            momentum, eps_in_sqrt=opt != "rmsprop", lr=lr)
    elif opt in ("novograd", "nvnovograd"):
        optimizer = Novograd(_groups(params, wd), betas, eps, lr=lr)
    elif opt == "adafactor":
        optimizer = Adafactor(_groups(params, wd), lr=lr)
    elif opt == "lars":
        optimizer = Lars(_groups(params, wd), momentum, lr=lr)
    elif opt == "adahessian":
        # pair with make_train_step(second_order=True)
        return AdaHessian(_groups(params, wd, mask=False), betas, eps, lr=lr)
    else:
        raise ValueError(f"Invalid optimizer {opt!r}")

    mode, value = cfg.get("clip_mode", "norm"), cfg.get("clip_grad")
    if mode and value is not None and value > 0:
        if mode not in ("norm", "value", "agc"):
            raise ValueError(f"unknown clip mode {mode!r}")
        optimizer.register_step_pre_hook(_clip_hook(mode, value))
    if use_lookahead:
        optimizer = Lookahead(optimizer, sync_period=6, alpha=0.5)
    return optimizer
