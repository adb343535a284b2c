"""Parity of the port's PiT (``models/pit.py``) with the JAX package, in
f32 on the CPU.

The same seeded numpy variables go into both sides (carried into the port
by ``jax_to_torch_state_dict(family="pit")``, which turns the JAX model's
NHWC position embedding into timm's NCHW one), and the output and the
gradients of ``sum(out * r)`` in the input and in every parameter are held
against ``jax.value_and_grad`` of the JAX module, jitted once
(``torch_family_parity.check_parity``): a reduced PiT (patch 8 at stride
4 on 32 px, a 7x7 map; two stages of widths 2x16 and 4x16, the pooling
between them) plain, distilled (two tokens, the heads averaged) and
``features_only``, at ``1e-5 * max|ref|`` (f32 matmuls and convs with
their sums in another order).  PiT and CaiT are built for one input size
and refuse another by name.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from cotnet_tpu.models import pit as jpit  # noqa: E402
from cotnet_tpu_torch.models import cait as pcait  # noqa: E402
from cotnet_tpu_torch.models import pit as ppit  # noqa: E402
from torch_family_parity import check_parity, images  # noqa: E402

PIT = dict(patch_size=8, stride=4, base_dims=(16, 16), depths=(1, 2),
           heads=(2, 4), num_classes=10)
NETS = {"plain": {}, "distilled": dict(distilled=True),
        "features_only": dict(features_only=True),
        "distilled_features_only": dict(distilled=True, features_only=True)}


@pytest.mark.parametrize("variant", list(NETS))
def test_reduced_pit_matches_jax(variant):
    """Logits (each stage's patch-token map for ``features_only``) and
    every gradient at 1e-5 of the largest."""
    kw = dict(PIT, **NETS[variant])
    port = ppit.PoolingTransformer(img_size=32, **kw)
    check_parity(port, jpit.PoolingTransformer(**kw), images(2, 32), 5,
                 "pit", image=True)


def test_pit_shapes():
    port = ppit.PoolingTransformer(img_size=32, distilled=True, **PIT)
    assert port.pos_embed.shape == (1, 32, 7, 7)
    assert port.cls_token.shape == (1, 2, 32)
    pool = port.transformers[0].pool
    assert pool.conv.weight.shape == (64, 1, 3, 3) and pool.conv.groups == 32
    port.features_only = True
    with torch.no_grad():
        feats = port(torch.zeros(2, 3, 32, 32))
    assert [tuple(f.shape) for f in feats] == [(2, 32, 7, 7), (2, 64, 4, 4)]


@pytest.mark.parametrize("build", [
    lambda: ppit.PoolingTransformer(img_size=32, **PIT),
    lambda: pcait.Cait(img_size=32, patch_size=8, embed_dim=64, depth=1,
                       num_heads=4, num_classes=10)])
def test_pit_and_cait_are_built_for_one_input_size(build):
    port = build()
    with torch.no_grad():
        assert port(torch.zeros(1, 3, 32, 32)).shape == (1, 10)
    with pytest.raises(ValueError, match="img_size"):
        port(torch.zeros(1, 3, 64, 64))


def test_pit_b_grid_at_224():
    """PiT-B's patch 14 at stride 7 gives a 31x31 map at 224 px, the others'
    patch 16 at stride 8 a 27x27 one."""
    from cotnet_tpu_torch.models import model_entrypoint

    with torch.device("meta"):
        b = model_entrypoint("pit_b_224")()
        ti = model_entrypoint("pit_ti_224")()
    assert b.pos_embed.shape == (1, 256, 31, 31)
    assert ti.pos_embed.shape == (1, 64, 27, 27)
    assert np.prod(b.cls_token.shape) == 256
