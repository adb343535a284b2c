"""Parity of the port's Twins (``models/twins.py``) with the JAX package,
in f32 on the CPU.

The same seeded numpy variables go into both sides (carried into the port
by ``jax_to_torch_state_dict(family="twins")``), and the output and the
gradients of ``sum(out * r)`` in the input and in every parameter are held
against ``jax.value_and_grad`` of the JAX module, jitted once
(``torch_family_parity.check_parity``), at ``1e-5 * max|ref|``: the
windowed attention on a 14x14 map (four 7x7 windows), the global
sub-sampled attention at ratios 4 and 1, the PEG, and reduced nets: SVT at
56 px (maps 14, 7, 3 and 1: windows of 7, 7, 3 and 1) and PCPVT at 64 px
(maps 16 to 2), plain and ``features_only``.  The windows are not padded,
as in the JAX package: SVT at 64 px (a 16x16 map under 7x7 windows) is
refused by name.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from flax import linen as fnn  # noqa: E402
from torch import nn  # noqa: E402

from cotnet_tpu.models import twins as jtwins  # noqa: E402
from cotnet_tpu.nn import Conv2d as JConv2d  # noqa: E402
from cotnet_tpu_torch.models import twins as ptwins  # noqa: E402
from torch_family_parity import check_parity, images  # noqa: E402

SVT = dict(embed_dims=(16, 32, 32, 32), num_heads=(2, 2, 4, 4),
           depths=(2, 2, 2, 1), num_classes=10)
PCPVT = dict(embed_dims=(16, 32, 32, 32), num_heads=(1, 2, 2, 4),
             mlp_ratios=(8, 8, 4, 4), depths=(2, 1, 1, 1),
             block_style="pcpvt", num_classes=10)


def maps(shape, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape) * np.linspace(0.5, 2.0, shape[0]).reshape(
        -1, 1, 1, 1)).astype(np.float32)


def test_locally_grouped_attention_matches_jax():
    check_parity(ptwins.LocallyGroupedAttn(16, 2, 7),
                 jtwins.LocallyGroupedAttn(2, 7), maps((2, 14, 14, 16), 0),
                 1, "twins")


@pytest.mark.parametrize("sr", [4, 1])
def test_global_subsample_attention_matches_jax(sr):
    check_parity(ptwins.GlobalSubSampleAttn(16, 2, sr),
                 jtwins.GlobalSubSampleAttn(2, sr), maps((2, 8, 8, 16), 2),
                 3, "twins")


class _JaxPeg(fnn.Module):
    """The JAX model's PEG as it sits in stage 0."""

    @fnn.compact
    def __call__(self, x, training: bool = False):
        d = x.shape[-1]
        return x + JConv2d(d, 3, 1, 1, groups=d, use_bias=True,
                           name="pos_block0")(x)


class _PortPeg(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.pos_block = nn.ModuleList([ptwins.PosConv(dim)])

    def forward(self, x):
        return self.pos_block[0](x)


def test_peg_matches_jax():
    check_parity(_PortPeg(16), _JaxPeg(), maps((2, 7, 7, 16), 4), 5,
                 "twins")


@pytest.mark.parametrize("style,size", [("svt", 56), ("pcpvt", 64)])
@pytest.mark.parametrize("features_only", [False, True])
def test_reduced_twins_matches_jax(style, size, features_only):
    kw = dict(SVT if style == "svt" else PCPVT, features_only=features_only)
    check_parity(ptwins.Twins(**kw), jtwins.Twins(**kw), images(2, size), 6,
                 "twins", image=True)


def test_twins_shapes():
    port = ptwins.Twins(**SVT)
    assert isinstance(port.blocks[0][0].attn, ptwins.LocallyGroupedAttn)
    assert isinstance(port.blocks[0][1].attn, ptwins.GlobalSubSampleAttn)
    assert port.blocks[0][1].attn.sr.weight.shape == (16, 16, 8, 8)
    assert port.blocks[2][1].attn.sr.weight.shape == (32, 32, 2, 2)
    assert ptwins.Twins(**PCPVT).blocks[3][0].attn.sr is None
    assert port.pos_block[1].proj[0].weight.shape == (32, 1, 3, 3)
    port.features_only = True
    with torch.no_grad():
        feats = port(torch.zeros(1, 3, 56, 56))
    assert [tuple(f.shape) for f in feats] == [
        (1, 16, 14, 14), (1, 32, 7, 7), (1, 32, 3, 3), (1, 32, 1, 1)]


def test_svt_refuses_a_map_the_window_does_not_divide():
    port = ptwins.Twins(**SVT)
    with pytest.raises(ValueError, match="16x16 map does not divide"):
        port(torch.zeros(1, 3, 64, 64))
