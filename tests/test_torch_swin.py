"""Parity of the port's Swin Transformer (``models/swin_transformer.py``)
with the JAX package, in f32 on the CPU.

The same seeded numpy variables go into both sides (carried into the port
by ``jax_to_torch_state_dict(family="swin")``), and the output and the
gradients of ``sum(out * r)`` in the input and in every parameter are held
against ``jax.value_and_grad`` of the JAX module, each function jitted
once (``torch_family_parity.check_parity``): ``WindowAttention`` on eight
4x4 windows with and without the shift mask, ``SwinBlock`` on an 8x8 map
with window 4, shifted by 2 and unshifted, and on a 4x4 map where the
window covers the map and the shift is turned off; a reduced Swin (patch
4, 32 px, dim 32, depths (2, 2), heads (2, 4), window 4, no drop path)
plain and ``features_only``, whose patch merge carries the two packages'
channel orders through the conversion.  Each tensor is held at ``1e-5 *
max|ref|`` (f32 matmuls with their sums in another order).  The window
partition and the relative position index are held exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from cotnet_tpu.models import swin_transformer as jswin  # noqa: E402
from cotnet_tpu_torch.models import swin_transformer as pswin  # noqa: E402
from torch_family_parity import check_parity, images  # noqa: E402


def maps(seed, n=2, size=8, c=32):
    """``[n, size, size, c]`` tokens with a per-token offset and unit
    spread."""
    rng = np.random.RandomState(seed)
    return (rng.randn(n, size, size, c)
            + rng.randn(n, size, size, 1)).astype(np.float32)


def test_window_partition_round_trip():
    x = maps(0, size=8, c=5)
    got = pswin.window_partition(torch.from_numpy(x), 4)
    want = np.asarray(jswin.window_partition(jnp.asarray(x), 4))
    assert got.shape == (8, 16, 5)
    np.testing.assert_array_equal(got.numpy(), want)
    back = pswin.window_reverse(got, 4, 8, 8)
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("ws", [4, 7, 12])
def test_rel_pos_index_equals_the_jax_one(ws):
    np.testing.assert_array_equal(pswin._rel_pos_index(ws),
                                  jswin._rel_pos_index(ws))


@pytest.mark.parametrize("masked", [False, True])
def test_window_attention_matches_jax(masked):
    """Eight windows of 16 tokens (two images of four windows), the mask
    that a shift of 2 on an 8x8 map gives: output and gradients at 1e-5 of
    the largest."""
    x = maps(1).reshape(2, 2, 4, 2, 4, 32).transpose(
        0, 1, 3, 2, 4, 5).reshape(8, 16, 32)
    args = (pswin.shift_mask(8, 8, 4, 2),) if masked else ()
    check_parity(pswin.WindowAttention(32, 2, 4),
                 jswin.WindowAttention(2, 4), x, 3, "swin", args=args)


@pytest.mark.parametrize("size,shift", [(8, 2), (8, 0), (4, 2)])
def test_swin_block_matches_jax(size, shift):
    """An 8x8 map with window 4, shifted by 2 (the mask and both rolls) and
    not; a 4x4 map, where the window covers the map and the shift is off."""
    check_parity(pswin.SwinBlock(32, 2, 4, shift=shift),
                 jswin.SwinBlock(2, 4, shift=shift), maps(2, size=size), 5,
                 "swin")


def test_the_shift_is_off_where_the_window_covers_the_map():
    block = pswin.SwinBlock(32, 2, 4, shift=2).eval()
    with torch.no_grad():
        block(torch.from_numpy(maps(3, size=4)))
        assert not block._masks
        block(torch.from_numpy(maps(3, size=8)))
    assert [k[:4] for k in block._masks] == [(8, 8, 4, 2)]


SWIN = dict(patch_size=4, embed_dim=32, depths=(2, 2), num_heads=(2, 4),
            window_size=4, drop_path_rate=0.0, num_classes=10)


@pytest.mark.parametrize("features_only", [False, True])
def test_reduced_swin_matches_jax(features_only):
    """A reduced Swin on 32 px images: an 8x8 map in stage 1 (a shifted
    block), the patch merge, a 4x4 map in stage 2 (the shift off); logits
    (each stage's map for ``features_only``) and every gradient at 1e-5 of
    the largest."""
    kw = dict(SWIN, features_only=features_only)
    check_parity(pswin.SwinTransformer(**kw), jswin.SwinTransformer(**kw),
                 images(2, 32), 7, "swin", image=True)


def test_swin_refuses_a_map_that_does_not_divide_by_the_window():
    port = pswin.SwinTransformer(**SWIN)
    with pytest.raises(ValueError, match="window"):
        port(torch.zeros(1, 3, 24, 24))
    with torch.no_grad():
        assert port(torch.zeros(1, 3, 64, 64)).shape == (1, 10)
