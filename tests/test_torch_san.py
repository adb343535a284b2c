"""Parity of the port's SAN (``cotnet_tpu_torch/models/san.py``) with the
JAX package's, in f32 on the CPU: a reduced san19 (one block a stage, 64
px, batch 2) in training and, after calibrating BN on the images, in eval;
each stage's bottleneck (K = 3 at 32x32, then K = 7 down to the 2x2 map of
stage 4, whose key patches take a reflect pad of 3, larger than the map)
with its output, its input and parameter gradients and its running
statistics; and the low-rank SAM.  Weights go across through
``jax_to_torch_state_dict(family="san")``, which permutes SAM's K^2 weight
producer back to the reference's cw-major layout.  The JAX side runs the
aggregation's XLA form, the port its plain versions.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from cotnet_tpu.models import san as jax_san  # noqa: E402
from cotnet_tpu_torch.models import san  # noqa: E402
from torch_family_parity import (check_logits, check_train_grads,  # noqa: E402
                                 images, random_variables)

LAYERS = (1, 1, 1, 1, 1)
KERNELS = (3, 7, 7, 7, 7)


def test_san_logits_match_jax():
    """Reduced san19 at 64 px: train-mode logits and running statistics,
    and eval logits after calibration, at 5e-4 of the largest logit."""
    x = images(2, 64)
    model = jax_san.SAN(layers=LAYERS, kernels=KERNELS, num_classes=10,
                        impl="xla")
    flat = random_variables(model, jnp.asarray(x), seed=1)
    port = san.SAN(layers=LAYERS, kernels=KERNELS, num_classes=10,
                   impl="torch")
    check_logits(model, port, flat, x, family="san")


# (stage, map side at 64 px)
STAGES = [(0, 32), (1, 16), (2, 8), (3, 4), (4, 2)]


@pytest.mark.parametrize("stage,side", STAGES)
def test_san_bottleneck_matches_jax(stage, side):
    """One SanBottleneck at the stage's width and kernel on its 64 px map,
    in training: output, gradients at 1e-5 of the largest, running
    statistics."""
    c, ks = san.WIDTHS[stage], KERNELS[stage]
    rng = np.random.RandomState(stage)
    x = (rng.randn(2, side, side, c)
         * np.linspace(0.5, 2.0, 2)[:, None, None, None]).astype(np.float32)
    r = rng.randn(2, side, side, c).astype(np.float32)
    block = jax_san.SanBottleneck(rel_planes=c // 16, mid_planes=c // 4,
                                  out_planes=c, kernel_size=ks, impl="xla",
                                  name=f"layer{stage}_0")
    flat = random_variables(block, jnp.asarray(x), seed=10 + stage)
    port = san.SanBottleneck(c // 16, c // 4, c, kernel_size=ks,
                             impl="torch")
    # the converter reads SAM's weight channels by stage from the name
    flat = {k.replace("params/", f"params/layer{stage}_0/", 1)
            .replace("batch_stats/", f"batch_stats/layer{stage}_0/", 1): v
            for k, v in flat.items()}
    wrapped = torch.nn.Module()
    wrapped.add_module(f"layer{stage}", torch.nn.Sequential(port))
    wrapped.forward = port.forward
    check_train_grads(wrapped, _Named(block, f"layer{stage}_0"), flat, x, r,
                      family="san")


class _Named:
    """A JAX module applied under a parent name, so that its variables sit
    under ``layer{S}_0`` as in the chassis."""

    def __init__(self, module, name):
        self.module, self.name = module, name

    def apply(self, variables, x, **kw):
        inner = {col: tree[self.name] for col, tree in variables.items()}
        out = self.module.apply(inner, x, **kw)
        if kw.get("mutable"):
            out, mutated = out
            return out, {col: {self.name: t} for col, t in mutated.items()}
        return out


def test_san_low_rank_module_matches_jax():
    """The low-rank SAM (not reached from san19) at 64 weight channels on a
    12x12 map, K = 7, in training: its K x 1 and 1 x K factors come at a
    map pooled by 4 (``min(512 / 64, 4)``) and are repeated back up."""
    rng = np.random.RandomState(7)
    x = (rng.randn(2, 12, 12, 32)
         * np.linspace(0.5, 2.0, 2)[:, None, None, None]).astype(np.float32)
    r = rng.randn(2, 12, 12, 64).astype(np.float32)
    module = jax_san.SAMLowRank(rel_planes=16, out_planes=64, kernel_size=7,
                                impl="xla")
    flat = random_variables(module, jnp.asarray(x), seed=8)
    port = san.SAMLowRank(32, 16, 64, kernel_size=7, impl="torch")
    assert port.pool_size == 4
    # under a parent's ``sam``, whose ``conv`` the converter maps to
    # ``sam.conv.0``
    flat = {k.replace("/", "/sam/", 1): v for k, v in flat.items()}
    holder = torch.nn.Module()
    holder.sam = port
    holder.forward = port.forward
    check_train_grads(holder, _Named(module, "sam"), flat, x, r,
                      family="san")
