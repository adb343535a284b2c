"""Activations, counterpart of ``cotnet_tpu/nn/activations.py`` (reference
models/layers/activations.py, create_act.py): one function per name."""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F


def relu(x):
    return F.relu(x)


def swish(x):
    """x * sigmoid(x) (a.k.a. SiLU) — the CoT block's post-BN activation."""
    return F.silu(x)


def mish(x):
    return x * torch.tanh(F.softplus(x))


def hard_swish(x):
    return x * F.relu6(x + 3.0) / 6.0


def hard_sigmoid(x):
    return F.relu6(x + 3.0) / 6.0


def hard_mish(x):
    return 0.5 * x * torch.clamp(x + 2.0, 0.0, 2.0)


_ACT_FNS = {
    "relu": relu,
    "relu6": F.relu6,
    "leaky_relu": F.leaky_relu,      # slope 0.01, as jax.nn.leaky_relu
    "elu": F.elu,
    "celu": F.celu,
    "selu": F.selu,
    # the exact erf form, torch nn.GELU's default; gelu_tanh is the tanh
    # approximation (jax.nn.gelu's default)
    "gelu": F.gelu,
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "swish": swish,
    "silu": swish,
    "mish": mish,
    "hard_swish": hard_swish,
    "hard_sigmoid": hard_sigmoid,
    "hard_mish": hard_mish,
    "identity": lambda x: x,
}


def get_act_fn(name: Optional[str]) -> Callable:
    """String -> activation function (reference get_act_fn/get_act_layer)."""
    if name is None or name == "":
        return lambda x: x
    if callable(name):
        return name
    try:
        return _ACT_FNS[name]
    except KeyError:
        raise ValueError(f"unknown activation {name!r}; have {sorted(_ACT_FNS)}")


def list_act_fns():
    return sorted(_ACT_FNS)
