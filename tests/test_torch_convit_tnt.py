"""Parity of the port's ConViT (``models/convit.py``) and TNT
(``models/tnt.py``) with the JAX package, in f32 on the CPU.

The same seeded numpy variables go into both sides (carried into the port
by ``jax_to_torch_state_dict``: ConViT by the ``vit`` rules, TNT's by the
``tnt`` ones, which split the JAX model's fused ``qkv`` rows into timm's
``qk`` and ``v`` and turn its token-major ``pixel_pos`` into timm's
``[1, C, 4, 4]``), and the output and the gradients of ``sum(out * r)`` in
the input and in every parameter are held against ``jax.value_and_grad``
of the JAX module, jitted once (``torch_family_parity.check_parity``), at
``1e-5 * max|ref|``: GPSA and its block on 16 tokens, TNT's block on a
2x2 grid of 4x4-pixel patches, and reduced nets: ConViT at 32 px (patch
8, three blocks of width 32, the class token entering at the third), plain
and ``features_only``; TNT at 32 px (patch 16 at inner stride 4, two
blocks of widths 32 and 8), plain and ``features_only``.  Both are built
for one input size and refuse another by name.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from cotnet_tpu.models import convit as jconvit  # noqa: E402
from cotnet_tpu.models import tnt as jtnt  # noqa: E402
from cotnet_tpu_torch.models import convit as pconvit  # noqa: E402
from cotnet_tpu_torch.models import tnt as ptnt  # noqa: E402
from torch_family_parity import check_parity, images  # noqa: E402

CONVIT = dict(patch_size=8, embed_dim=32, depth=3, num_heads=4,
              local_layers=2, num_classes=10)
TNT = dict(patch_size=16, embed_dim=32, inner_dim=8, depth=2,
           outer_heads=4, inner_heads=2, num_classes=10)


def tokens(shape, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape) * np.linspace(0.5, 2.0, shape[0]).reshape(
        -1, *(1,) * (len(shape) - 1))).astype(np.float32)


def test_gpsa_matches_jax():
    check_parity(pconvit.GPSA(32, 4), jconvit.GPSA(4),
                 tokens((2, 16, 32), 0), 1, "vit")


def test_gpsa_block_matches_jax():
    check_parity(pconvit.GPSABlock(32, 4), jconvit.GPSABlock(4),
                 tokens((2, 16, 32), 2), 3, "vit")


def test_rel_indices_are_the_jax_table():
    np.testing.assert_array_equal(pconvit.rel_indices(16),
                                  jconvit._rel_indices(16))


class _TNTBlockPatchFirst(ptnt.TNTBlock):
    """The port's block called as the JAX one is: ``(patch, pixel)`` in
    and out."""

    def forward(self, patch_embed, pixel_embed):
        pixel_embed, patch_embed = super().forward(pixel_embed, patch_embed)
        return patch_embed, pixel_embed


def test_tnt_block_matches_jax():
    """Two images of a 2x2 grid of patches, 16 pixel tokens each: the
    patch tokens (with the class token) and the pixel tokens out, every
    gradient."""
    check_parity(_TNTBlockPatchFirst(32, 8, 16, 4, 2),
                 jtnt.TNTBlock(4, 2), tokens((2, 5, 32), 4), 5, "tnt",
                 args=(tokens((8, 16, 8), 6),))


@pytest.mark.parametrize("features_only", [False, True])
def test_reduced_convit_matches_jax(features_only):
    kw = dict(CONVIT, features_only=features_only)
    check_parity(pconvit.ConViT(img_size=32, **kw), jconvit.ConViT(**kw),
                 images(2, 32), 7, "vit", image=True)


@pytest.mark.parametrize("features_only", [False, True])
def test_reduced_tnt_matches_jax(features_only):
    kw = dict(TNT, features_only=features_only)
    check_parity(ptnt.TNT(img_size=32, **kw), jtnt.TNT(**kw),
                 images(2, 32), 8, "tnt", image=True)


def test_tnt_layouts():
    port = ptnt.TNT(img_size=32, **TNT)
    assert port.pixel_pos.shape == (1, 8, 4, 4)
    assert port.patch_pos.shape == (1, 5, 32)
    attn = port.blocks[0].attn_in
    assert attn.qk.weight.shape == (16, 8) and attn.v.weight.shape == (8, 8)
    assert attn.qk.bias is None and attn.v.bias is None


@pytest.mark.parametrize("build", [
    lambda: pconvit.ConViT(img_size=32, **CONVIT),
    lambda: ptnt.TNT(img_size=32, **TNT)])
def test_convit_and_tnt_are_built_for_one_input_size(build):
    port = build()
    with torch.no_grad():
        assert port(torch.zeros(1, 3, 32, 32)).shape == (1, 10)
    with pytest.raises(ValueError, match="img_size"):
        port(torch.zeros(1, 3, 64, 64))
