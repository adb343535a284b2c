"""Parity of the port's CNNs off the ResNet chassis (``models/regnet.py``,
``densenet.py``, ``rexnet.py``, ``xception.py``) with the JAX package, in
f32 on the CPU.

The same seeded numpy variables go into both sides (carried into the port
by ``jax_to_torch_state_dict(family=...)``), and the output and the
gradients of ``sum(out * r)`` in the input and in every parameter are
held against ``jax.value_and_grad`` of the JAX module, jitted once
(``torch_family_parity.check_parity``).  The tolerance is ``1e-5 *
max|ref|``: both sides compute in f32 and differ by the order of their
sums; in train mode, where a BN's gradients are cancelling sums (the
one-pass variance, ROADMAP's "look like faults"), a tensor is held at 3x
the JAX gradient's own move under a 1e-7 relative perturbation of the
input where that is larger.  A block runs at its place in the net's
names (``features.denseblock1.denselayer1``, ``block1`` / ``block2`` of
Xception, whose ``rep`` indices follow the leading ReLU); a reduced net
is the class built directly (the entrypoints fix the widths and depths),
but Xception's, which has no knob: the whole net at 64 px.
"""

import functools

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from cotnet_tpu.models import densenet as jdense  # noqa: E402
from cotnet_tpu.models import regnet as jreg  # noqa: E402
from cotnet_tpu.models import rexnet as jrex  # noqa: E402
from cotnet_tpu.models import xception as jxc  # noqa: E402
from cotnet_tpu_torch.models import densenet as pdense  # noqa: E402
from cotnet_tpu_torch.models import regnet as preg  # noqa: E402
from cotnet_tpu_torch.models import rexnet as prex  # noqa: E402
from cotnet_tpu_torch.models import xception as pxc  # noqa: E402
from torch_family_parity import (At, JaxPath, check_logits,  # noqa: E402
                                 check_parity, images, maps,
                                 random_variables)


def test_stage_cfg_matches_jax_on_every_key():
    """The quantized stage widths, depths and group widths of the 24
    keys, from the port's copy of the table and the rule."""
    assert preg._PARAMS == jreg._PARAMS
    for name, (w0, wa, wm, gw, depth, _) in jreg._PARAMS.items():
        assert preg._stage_cfg(w0, wa, wm, gw, depth) == \
            jreg._stage_cfg(w0, wa, wm, gw, depth), name


# --- the blocks -----------------------------------------------------------------

BLOCKS = {
    # RegNet: strided with the shortcut conv, with and without SE; a
    # stride-1 block of the same width (identity shortcut)
    "reg_x": ("", lambda: preg.RegBottleneck(16, 24, 2, 8),
              functools.partial(jreg.RegBottleneck, 24, 2, 8), "regnet", 16),
    "reg_y": ("", lambda: preg.RegBottleneck(16, 24, 2, 8, 0.25),
              functools.partial(jreg.RegBottleneck, 24, 2, 8, 0.25),
              "regnet", 16),
    "reg_y_s1": ("", lambda: preg.RegBottleneck(24, 24, 1, 8, 0.25),
                 functools.partial(jreg.RegBottleneck, 24, 1, 8, 0.25),
                 "regnet", 24),
    # DenseNet's layer, relu and the Inplace-ABN stand-in
    "dense": ("features.denseblock1.denselayer1|denseblock1_layer1",
              lambda: pdense.DenseLayer(12, 8),
              functools.partial(jdense.DenseLayer, 8), "densenet", 12),
    "dense_iabn": ("features.denseblock1.denselayer1|denseblock1_layer1",
                   lambda: pdense.DenseLayer(12, 8, act="leaky_relu"),
                   functools.partial(jdense.DenseLayer, 8,
                                     act="leaky_relu"), "densenet", 12),
    # ReXNet: the input added onto the first channels (stride 1, widening),
    # the expansion-free first block, and no residual (stride 2)
    "rex_partial": ("", lambda: prex.LinearBottleneck(12, 20),
                    functools.partial(jrex.LinearBottleneck, 20), "rexnet",
                    12),
    "rex_no_expand": ("", lambda: prex.LinearBottleneck(
        12, 16, expand=1.0, use_se=False), functools.partial(
        jrex.LinearBottleneck, 16, expand=1.0, use_se=False), "rexnet", 12),
    "rex_s2": ("", lambda: prex.LinearBottleneck(12, 20, 2),
               functools.partial(jrex.LinearBottleneck, 20, 2), "rexnet",
               12),
    # Xception: without the leading ReLU, growing first (block1's), and
    # with it, growing last and pooling (block12's), and the middle flow's
    "xc_plain_start": ("block1", lambda: pxc.XceptionBlock(
        8, 16, 2, 2, start_with_relu=False), functools.partial(
        jxc.XceptionBlock, 16, 2, 2, start_with_relu=False), "xception", 8),
    "xc_grow_last": ("block2", lambda: pxc.XceptionBlock(
        8, 16, 2, 2, grow_first=False), functools.partial(
        jxc.XceptionBlock, 16, 2, 2, grow_first=False), "xception", 8),
    "xc_middle": ("block4", lambda: pxc.XceptionBlock(8, 8, 3),
                  functools.partial(jxc.XceptionBlock, 8, 3), "xception", 8),
}


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_block_matches_jax(kind, training):
    """At the block's path in the port's names and in JAX's (``port|jax``;
    one path for both, ``inner`` where the family's rules rename each name
    wherever it is)."""
    paths, port_fn, jax_fn, family, cin = BLOCKS[kind]
    port_path, _, jax_path = (paths or "inner").partition("|")
    block = port_fn()
    if kind.startswith("rex"):
        assert block.use_shortcut == (kind != "rex_s2")
    port = At(port_path, block)
    jax_mod = JaxPath(jax_fn, (jax_path or port_path,))
    check_parity(port, jax_mod, maps((4, 9, 9, cin), 4), 5, family,
                 image=True, training=training)


def test_xception_rep_indices_follow_the_leading_relu():
    plain = pxc.XceptionBlock(8, 16, 2, 2, start_with_relu=False)
    relu = pxc.XceptionBlock(8, 16, 2, 2)
    assert [k for k in plain.state_dict() if k.endswith("conv1.weight")] \
        == ["rep.0.conv1.weight", "rep.3.conv1.weight"]
    assert [k for k in relu.state_dict() if k.endswith("conv1.weight")] \
        == ["rep.1.conv1.weight", "rep.4.conv1.weight"]


# --- reduced nets ---------------------------------------------------------------

NETS = {
    "regnet_y": (preg.RegNet, jreg.RegNet, "regnet",
                 dict(widths=(8, 16, 24, 32), depths=(1, 2, 1, 1),
                      group_widths=(8, 8, 8, 8), se_ratio=0.25,
                      stem_width=8)),
    "densenet_blur_deep": (pdense.DenseNet, jdense.DenseNet, "densenet",
                           dict(growth_rate=4, block_config=(2, 1, 1, 1),
                                stem_width=8, stem_type="deep",
                                aa_layer="blur")),
    "densenet_iabn": (pdense.DenseNet, jdense.DenseNet, "densenet",
                      dict(growth_rate=4, block_config=(1, 1, 2, 1),
                           stem_width=8, act="leaky_relu")),
    "rexnet": (prex.ReXNet, jrex.ReXNet, "rexnet",
               dict(width_mult=0.5, depth_mult=0.1, drop_rate=0.0)),
    "rexnetr": (prex.ReXNet, jrex.ReXNet, "rexnet",
                dict(width_mult=0.5, depth_mult=0.1, ch_div=8,
                     drop_rate=0.0)),
    "xception": (pxc.Xception, jxc.Xception, "xception", {}),
}


@pytest.mark.parametrize("kind", sorted(NETS))
def test_reduced_net_matches_jax(kind):
    """5 classes at 64 px.  In eval mode the logits and every gradient
    (``check_parity``); in train mode the logits, the updated BN
    statistics and the eval logits after calibration (``check_logits``)
    on 4 images, the logits at 5e-5 of the largest (the last stage's
    train-mode BNs normalize 16 values and amplify f32 rounding: 1.03e-5
    the worst measured, the reduced DenseNet's), the train-mode gradients
    held block by block: across a
    whole net some ReLU input lies within f32 rounding of its kink, whose
    side moves the input gradient by up to 2e-2 of its largest between
    f32 and f64 in either package (measured on the chassis' reduced
    nets)."""
    port_cls, jax_cls, family, kw = NETS[kind]
    port = port_cls(num_classes=5, **kw)
    jax_mod = jax_cls(num_classes=5, **kw)
    check_parity(port, jax_mod, images(2, 64, seed=6), 7, family,
                 image=True)
    port = port_cls(num_classes=5, **kw)
    x = images(4, 64, seed=8)
    check_logits(jax_mod, port, random_variables(jax_mod, x, 9), x, family,
                 rel=5e-5)


@pytest.mark.parametrize("kind", ["regnet_y", "densenet_blur_deep",
                                  "rexnet"])
def test_features_only_matches_jax(kind):
    """Each stage's output, no head built."""
    port_cls, jax_cls, family, kw = NETS[kind]
    port = port_cls(features_only=True, **kw)
    assert not [k for k in port.state_dict()
                if k.startswith(("head.", "classifier.", "features.norm5"))]
    check_parity(port, jax_cls(features_only=True, **kw),
                 images(2, 64, seed=10), 11, family, image=True)
