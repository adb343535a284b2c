"""Parity of the port's LR-Net (``cotnet_tpu_torch/models/lr_net.py``)
with the JAX package's, in f32 on the CPU: reduced ``lrnet50`` and
``lrnet50_ks3`` (one block a stage, 64 px, batch 2) in training and in
eval after calibrating BN on the images, and one ``LrBottleneck`` at each
key size, strided (its avg-pool after the attention) with a projection
shortcut: output, input and parameter gradients, running statistics.
Weights go across through ``jax_to_torch_state_dict`` (the default
mapping; ``pos_h``/``pos_w`` as they are).  The JAX side runs the
aggregation's XLA form, the port its plain versions.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from cotnet_tpu.models import lr_net as jax_lr  # noqa: E402
from cotnet_tpu.models.resnet import ResNet as JaxResNet  # noqa: E402
from cotnet_tpu_torch.models import lr_net, model_entrypoint  # noqa: E402
from cotnet_tpu_torch.models.resnet import Downsample  # noqa: E402
from cotnet_tpu_torch.ops import local_agg as la  # noqa: E402
from torch_family_parity import (check_logits, check_train_grads,  # noqa: E402
                                 images, random_variables)


@pytest.mark.parametrize("name,key_ks", [("lrnet50", 1), ("lrnet50_ks3", 3)])
def test_lrnet_logits_match_jax(name, key_ks):
    """Train-mode logits and running statistics, and eval logits after
    calibration, at 5e-4 of the largest logit; every forward aggregates
    through the plain version once a block."""
    x = images(2, 64)
    model = JaxResNet(block=jax_lr.LrBottleneck, layers=(1, 1, 1, 1),
                      num_classes=10,
                      block_args=dict(key_ks=key_ks, impl="xla"))
    flat = random_variables(model, jnp.asarray(x), seed=1)
    port = model_entrypoint(name)(layers=(1, 1, 1, 1), num_classes=10,
                                  block_args=dict(impl="torch"))
    la.reset_counts()
    check_logits(model, port, flat, x)
    # train, calibration and eval forwards, four blocks each
    assert (la.PLAIN_CALLS, la.LAUNCHES) == (3 * 4, 0)


@pytest.mark.parametrize("key_ks", [1, 3])
def test_lr_bottleneck_matches_jax(key_ks):
    """A stride-2 LrBottleneck at 64 planes (width 64, 8 heads) on a 12x12
    map with a projection shortcut, in training: output, gradients at 1e-5
    of the largest, running statistics."""
    rng = np.random.RandomState(key_ks)
    x = (rng.randn(4, 12, 12, 32)
         * np.linspace(0.5, 2.0, 4)[:, None, None, None]).astype(np.float32)
    r = rng.randn(4, 6, 6, 256).astype(np.float32)
    block = jax_lr.LrBottleneck(planes=64, stride=2, key_ks=key_ks,
                                impl="xla", downsample=dict(stride=2))
    flat = random_variables(block, jnp.asarray(x), seed=20 + key_ks)
    port = lr_net.LrBottleneck(32, 64, stride=2, key_ks=key_ks,
                               impl="torch",
                               downsample=Downsample(32, 256, 2))
    check_train_grads(port, block, flat, x, r)
