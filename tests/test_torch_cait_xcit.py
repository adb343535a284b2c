"""Parity of the port's CaiT (``models/cait.py``) and XCiT
(``models/xcit.py``) with the JAX package, in f32 on the CPU.

The same seeded numpy variables go into both sides (carried into the port
by ``jax_to_torch_state_dict(family=...)``), and the output and the
gradients of ``sum(out * r)`` in the input and in every parameter are held
against ``jax.value_and_grad`` of the JAX module, each function jitted
once (``torch_family_parity.check_parity``): CaiT's ``TalkingHeadAttn``,
``ClassAttn`` and both kinds of ``LayerScaleBlock``, XCiT's ``XCA``,
``LPI`` and ``XCABlock`` (in training, with the BN's batch statistics, and
in eval) on ``[2, 16, 64]`` tokens of a 4x4 grid; a reduced CaiT (patch 8,
32 px, dim 64, depth 2, two token-only blocks) plain and
``features_only``; reduced XCiTs at patch 8 and 16 (64 px, dim 64, one
XCA block, two class-attention blocks) with ``tokens_norm`` on and off, in training and in eval.  Each tensor
is held at ``1e-5 * max|ref|`` (f32 matmuls and convs with their sums in
another order); where a train-mode BN's gradient cancels, at 3x the JAX
gradient's own move under a 1e-7 input perturbation.  The Fourier
position encoding's values at a 3x5 grid are held against the JAX model's
at 1e-6 (sin and cos of the same f32 arguments).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cotnet_tpu.models import cait as jcait  # noqa: E402
from cotnet_tpu.models import xcit as jxcit  # noqa: E402
from cotnet_tpu_torch.models import cait as pcait  # noqa: E402
from cotnet_tpu_torch.models import xcit as pxcit  # noqa: E402
from torch_family_parity import (check_parity, images,  # noqa: E402
                                 random_variables, unflatten)


def tokens(seed, n=2, length=16, d=64):
    """Tokens with a per-token offset (as after a residual add) and unit
    spread."""
    rng = np.random.RandomState(seed)
    return (rng.randn(n, length, d)
            + rng.randn(n, length, 1)).astype(np.float32)


HW = (4, 4)
MODULES = {
    "talking_head_attn": ("cait", lambda: jcait.TalkingHeadAttn(4),
                          lambda: pcait.TalkingHeadAttn(64, 4), ()),
    "class_attn": ("cait", lambda: jcait.ClassAttn(4),
                   lambda: pcait.ClassAttn(64, 4), ()),
    "layer_scale_block": ("cait", lambda: jcait.LayerScaleBlock(4),
                          lambda: pcait.LayerScaleBlock(64, 4), ()),
    "layer_scale_block_class_attn": (
        "cait", lambda: jcait.LayerScaleBlock(4, class_attn=True),
        lambda: pcait.LayerScaleBlock(64, 4, class_attn=True), ()),
    "xca": ("xcit", lambda: jxcit.XCA(4), lambda: pxcit.XCA(64, 4), ()),
    "lpi": ("xcit", lambda: jxcit.LPI(), lambda: pxcit.LPI(64), (HW,)),
    "xca_block": ("xcit", lambda: jxcit.XCABlock(4),
                  lambda: pxcit.XCABlock(64, 4), (HW,)),
}
CASES = [(name, False) for name in MODULES] + [("lpi", True),
                                                ("xca_block", True)]


@pytest.mark.parametrize("name,training", CASES)
def test_module_matches_jax(name, training):
    """Output and gradients at 1e-5 of the largest (the BN modules in
    training mode too, with the running statistics)."""
    family, jax_module, port, args = MODULES[name]
    check_parity(port(), jax_module(), tokens(1), 3, family, args=args,
                 training=training)


def test_fourier_encoding_at_a_non_square_grid():
    """The encoding of a 3x5 grid (a 48x80 input at patch 16): the JAX
    model's ``pos_proj`` given the identity kernel and no bias returns it
    as it is."""
    module = jxcit.XCiT(patch_size=16, embed_dim=64, depth=1, num_heads=4,
                        features_only=True)
    x = images(1, 48)
    x = np.concatenate([x, x[:, :, :32]], axis=2)           # 48 x 80
    flat = random_variables(module, x, 0)
    flat["params/pos_proj/kernel"] = np.eye(64, dtype=np.float32)[None,
                                                                   None]
    flat["params/pos_proj/bias"] = np.zeros(64, np.float32)
    _, inter = jax.jit(lambda v, x_: module.apply(
        v, x_, training=False,
        capture_intermediates=lambda mdl, _: mdl.name == "pos_proj",
        mutable=["intermediates"]))(unflatten(flat), jnp.asarray(x))
    want = np.asarray(inter["intermediates"]["pos_proj"]["__call__"][0])
    got = pxcit.fourier_features(3, 5).numpy().transpose(0, 2, 3, 1)
    assert want.shape == got.shape == (1, 3, 5, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


CAIT = dict(patch_size=8, embed_dim=64, depth=2, num_heads=4,
            depth_token_only=2, num_classes=10)


@pytest.mark.parametrize("features_only", [False, True])
def test_reduced_cait_matches_jax(features_only):
    """A reduced CaiT on 32 px images, 16 patches: logits (the patch tokens'
    map for ``features_only``) and every gradient at 1e-5 of the
    largest."""
    kw = dict(CAIT, features_only=features_only)
    port = pcait.Cait(img_size=32, **kw)
    check_parity(port, jcait.Cait(**kw), images(2, 32), 5, "cait",
                 image=True)


XCIT = dict(embed_dim=64, depth=1, num_heads=4, num_classes=10)
XCIT_CASES = [(patch, tokens_norm, training) for patch in (8, 16)
              for tokens_norm in (True, False) for training in (True, False)]


@pytest.mark.parametrize("patch,tokens_norm,training", XCIT_CASES)
def test_reduced_xcit_matches_jax(patch, tokens_norm, training):
    """A reduced XCiT on 64 px images (an 8x8 grid at patch 8, 4x4 at 16):
    logits, the BNs' running statistics in training, and every gradient at
    1e-5 of the largest (or 3x the JAX gradient's move, see the module
    docstring)."""
    kw = dict(XCIT, patch_size=patch, tokens_norm=tokens_norm)
    check_parity(pxcit.XCiT(**kw), jxcit.XCiT(**kw), images(2, 64), 7,
                 "xcit", image=True, training=training)


def test_reduced_xcit_features_only():
    kw = dict(XCIT, patch_size=8, features_only=True)
    port = pxcit.XCiT(**kw)
    assert port.cls_token is None and port.head is None
    check_parity(port, jxcit.XCiT(**kw), images(2, 64), 7, "xcit",
                 image=True)


def test_xcit_takes_any_size_that_divides_by_the_patch():
    port = pxcit.XCiT(patch_size=16, **XCIT)
    with torch.no_grad():
        assert port(torch.zeros(1, 3, 48, 80)).shape == (1, 10)
    assert set(port.pos_embed._features) == {(3, 5, torch.device("cpu"))}
