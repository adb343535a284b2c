"""Parity of the port's EfficientNet superfamily (``models/efficientnet.py``)
and its two conv layers (``nn/extra.py``) with the JAX package, in f32 on
the CPU.

The arch-string decoder and every generator are held against the JAX
module's: each of the 91 keys' build arguments (the decoded stages, the
widths, the flags) and ``decode_arch_def`` on every generator's table at
a grid of multipliers, ceil and round, ``fix_first_last`` and
``experts_multiplier``.  The same seeded numpy variables go into both
sides (carried into the port by ``jax_to_torch_state_dict(family=
"efficientnet")``), and the output and the gradients of ``sum(out * r)``
in the input and in every parameter are held against
``jax.value_and_grad`` of the JAX module, jitted once
(``torch_family_parity.check_parity``), at ``1e-5 * max|ref|``, or, for a
train-mode BN's cancelling sums, at 3x the JAX gradient's own move under
a 1e-7 perturbation of the input: ``MixedConv2d`` (depthwise and grouped
pointwise, torch padding and TF-SAME at an odd and an even size),
``CondConv2d`` (one routing vector shared by a depthwise and a dense
conv with a bias), each block kind, six reduced nets in train and eval,
``features_only``, and the ``bn_tf`` resolution (torch momentum 0.01,
eps 1e-3, the running statistics moving as flax's 0.99 moves them).
"""

import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import linen as fnn  # noqa: E402
from torch import nn  # noqa: E402

from cotnet_tpu.models import efficientnet as jeff  # noqa: E402
from cotnet_tpu.nn import extra as jextra  # noqa: E402
from cotnet_tpu_torch.models import create_model  # noqa: E402
from cotnet_tpu_torch.models import efficientnet as peff  # noqa: E402
from cotnet_tpu_torch.models.features import (FeatureDictNet,  # noqa: E402
                                              FeatureListNet)
from cotnet_tpu_torch.nn import (CondConv2d, Linear,  # noqa: E402
                                 MixedConv2d)
from cotnet_tpu_torch.nn.extra import _split_channels  # noqa: E402
from torch_family_parity import check_parity, images  # noqa: E402

FAMILY = "efficientnet"


def maps(shape, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape) * np.linspace(0.5, 2.0, shape[0]).reshape(
        -1, 1, 1, 1)).astype(np.float32)


# --- the decoder and the generators ------------------------------------------

def _captured(module, name, row):
    """The keyword arguments the module's generator hands its model class
    for the table row ``row`` of key ``name`` (the model is not built)."""
    got = {}
    orig = module.build_model_with_cfg

    def capture(cls, variant, cfg, **kwargs):
        got.update(kwargs, variant=variant, cfg=cfg)
    module.build_model_with_cfg = capture
    try:
        module._effnet_entry(name, **row)
    finally:
        module.build_model_with_cfg = orig
    return got


@pytest.mark.parametrize("name", sorted(jeff.EFFICIENTNET_VARIANTS))
def test_every_key_builds_the_jax_arguments(name):
    """The decoded stages, widths, flags and data config of each key,
    against the JAX generator's; the BN momentum in each package's
    convention (torch ``m`` is flax ``1 - m``)."""
    want = _captured(jeff, name, jeff.EFFICIENTNET_VARIANTS[name])
    got = _captured(peff, name, peff.EFFICIENTNET_VARIANTS[name])
    got.pop("in_chans", None)
    if "bn_momentum" in got:
        got["bn_momentum"] = 1 - got["bn_momentum"]
    assert got == want


def _jax_tables():
    """Each JAX generator's arch table, read from the arguments it passes
    to ``decode_arch_def`` while one key of the generator is built."""
    tables = {}
    orig = jeff.decode_arch_def

    def capture(arch, *args, **kwargs):
        tables[gen] = arch
        return orig(arch, *args, **kwargs)
    jeff.decode_arch_def = capture
    try:
        for name, row in jeff.EFFICIENTNET_VARIANTS.items():
            gen = row["gen"]
            if gen not in tables:
                _captured(jeff, name, row)
    finally:
        jeff.decode_arch_def = orig
    return tables


TABLES = _jax_tables()


def test_every_generator_has_a_table():
    assert sorted(TABLES) == sorted(jeff._GEN_FNS)


@pytest.mark.parametrize("gen", sorted(TABLES))
def test_decode_arch_def_matches_jax_on_every_table(gen):
    arch = TABLES[gen]
    for dm in (0.5, 1.0, 1.1, 1.2, 1.4, 1.8, 2.2, 3.1, 5.3):
        for trunc in ("ceil", "round"):
            for em in (1, 2):
                for ffl in (False, True):
                    args = (arch, dm, trunc, em, ffl)
                    assert peff.decode_arch_def(*args) == \
                        jeff.decode_arch_def(*args), args


def test_make_divisible_and_round_channels_match_jax():
    for v in np.linspace(0.1, 700.0, 397):
        for divisor in (1, 4, 8, 16):
            assert peff.make_divisible(v, divisor) == \
                jeff.make_divisible(v, divisor)
            assert peff.make_divisible(v, divisor, 24) == \
                jeff.make_divisible(v, divisor, 24)
    for chs in (8, 16, 24, 32, 40, 80, 112, 192, 320, 1280):
        for m in (0, 0.5, 0.75, 1.0, 1.1, 1.3, 1.4, 1.6, 2.4, 4.3):
            assert peff.round_channels(chs, m) == jeff.round_channels(chs, m)


def test_split_channels_gives_the_first_group_the_remainder():
    assert _split_channels(10, 3) == [4, 3, 3]
    assert _split_channels(200, 5) == [40] * 5
    assert _split_channels(120, 4) == jextra._split_channels(120, 4)


def nhwc_out(module):
    """``module`` with its map output permuted to NHWC, the layout
    ``check_parity`` compares a single map in."""
    forward = module.forward
    module.forward = lambda *a: forward(*a).permute(0, 2, 3, 1)
    return module


# --- MixedConv2d and CondConv2d ------------------------------------------------

class _JaxWrap(fnn.Module):
    """A JAX layer (named ``layer``) that takes ``training``."""

    layer: fnn.Module

    def __call__(self, x, training: bool = False):
        return self.layer(x)


class _Wrap(nn.Module):
    def __init__(self, layer):
        super().__init__()
        self.layer = layer

    def forward(self, x):
        return self.layer(x)


@pytest.mark.parametrize("depthwise,kernels,stride,pad,size", [
    (True, (3, 5, 7), 1, "", 9),
    (True, (3, 5, 7), 2, "", 10),
    (True, (3, 5, 7, 9), 2, "same", 10),
    (True, (3, 5), 2, "same", 9),
    (False, (1, 1), 1, "", 8),
    (False, (1, 1), 1, "same", 7),
])
def test_mixed_conv_matches_jax(depthwise, kernels, stride, pad, size):
    cin = 10 if depthwise else 11
    cout = cin if depthwise else 13
    port = _Wrap(MixedConv2d(cin, cout, kernels, stride, depthwise=depthwise,
                             pad_type=pad))
    assert [k for k in port.state_dict()] == [
        f"layer.{i}.weight" for i in range(len(kernels))]
    jax_mod = _JaxWrap(jextra.MixedConv2d(cout, kernels, stride,
                                          depthwise=depthwise, pad_type=pad))
    check_parity(nhwc_out(port), jax_mod, maps((2, size, size, cin), 0), 1,
                 FAMILY, image=True)


class _JaxCondPair(fnn.Module):
    """One routing vector from a Dense on the pooled input feeding a
    depthwise CondConv and a dense one with a bias."""

    experts: int
    stride: int
    pad: object

    @fnn.compact
    def __call__(self, x, training: bool = False):
        c = x.shape[-1]
        routing = jax.nn.sigmoid(fnn.Dense(self.experts, name="routing_fn")(
            jnp.mean(x, axis=(1, 2))))
        y = jextra.CondConv2d(c, 5, self.stride, padding=self.pad, groups=c,
                              num_experts=self.experts, name="conv_dw")(
            x, routing=routing)
        return jextra.CondConv2d(7, 3, padding=self.pad,
                                 num_experts=self.experts, use_bias=True,
                                 name="conv_pw")(y, routing=routing)


class _CondPair(nn.Module):
    def __init__(self, c, experts, stride, pad):
        super().__init__()
        self.routing_fn = Linear(c, experts)
        self.conv_dw = CondConv2d(c, c, 5, stride, pad, groups=c,
                                  num_experts=experts)
        self.conv_pw = CondConv2d(c, 7, 3, 1, pad, num_experts=experts,
                                  bias=True)

    def forward(self, x):
        routing = torch.sigmoid(self.routing_fn(x.mean((2, 3))))
        return self.conv_pw(self.conv_dw(x, routing), routing)


@pytest.mark.parametrize("stride,pad,size", [(1, None, 9), (2, None, 10),
                                             (2, "same", 10),
                                             (2, "same", 9)])
def test_cond_conv_shares_one_routing_vector(stride, pad, size):
    port = _CondPair(6, 4, stride, pad)
    assert port.conv_dw.weight.shape == (4, 6 * 1 * 5 * 5)
    assert port.conv_pw.weight.shape == (4, 7 * 6 * 3 * 3)
    assert port.conv_pw.bias.shape == (4, 7)
    check_parity(nhwc_out(port), _JaxCondPair(4, stride, pad),
                 maps((3, size, size, 6), 2), 3, FAMILY, image=True)


# --- the blocks ----------------------------------------------------------------

BLOCKS = {
    "ds": ("ds_r1_k3_s1_e1_c12_se0.25", 12, {}),
    "dsa": ("dsa_r1_k3_s2_c16", 12, {}),
    "ir_se": ("ir_r1_k5_s1_e4_c12_se0.25_nsw", 12, {}),
    "ir_mixed": ("ir_r1_k3.5.7_a1.1_p1.1_s2_e3_c16_se0.5", 12,
                 dict(pad_type="same")),
    "ir_experts": ("ir_r1_k3_s1_e3_c12_se0.25_cc4", 12, {}),
    "ir_mnv3": ("ir_r1_k3_s1_e6_c12_se0.25", 12,
                dict(se_act="relu", se_reduce_mid=True, se_divisor=8,
                     se_gate="hard_sigmoid")),
    "er_fc": ("er_r1_k3_s2_e4_c16_fc8_se0.25", 12, {}),
    "cn": ("cn_r1_k3_s2_c16", 12, {}),
}


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_block_matches_jax(kind, training):
    block_str, cin, kw = BLOCKS[kind]
    ba, _ = peff._decode_block_str(block_str)
    jba, _ = jeff._decode_block_str(block_str)
    act = ba.act or "swish"
    extra = dict(kw)
    if ba.fake_in_chs:
        extra["fake_in_chs"] = ba.fake_in_chs
    port = peff._BLOCK_CLS[ba.block_type](ba, cin, ba.out_chs, ba.stride,
                                          act, **extra)
    jax_mod = jeff._BLOCK_CLS[jba.block_type](
        ba=jba, out_chs=jba.out_chs, stride=jba.stride, act=act, **extra)
    if kind in ("ds", "ir_se", "ir_experts", "ir_mnv3"):
        assert port.has_residual
    check_parity(nhwc_out(port), jax_mod, maps((4, 11, 11, cin), 4), 5,
                 FAMILY, image=True, training=training)


# --- reduced nets --------------------------------------------------------------

_NETS = {
    "efficientnet": dict(
        arch=(("ds_r1_k3_s1_e1_c8_se0.25",), ("ir_r2_k3_s2_e4_c16_se0.25",),
              ("ir_r1_k5_s2_e3_c24_se0.25",)), act="swish"),
    "tf_efficientnet": dict(
        arch=(("ds_r1_k3_s1_e1_c8_se0.25",), ("ir_r2_k3_s2_e4_c16_se0.25",),
              ("ir_r1_k5_s2_e3_c24_se0.25",)), act="swish",
        pad_type="same", bn_eps=1e-3),
    "mixnet": dict(
        arch=(("ds_r1_k3_s1_e1_c8",),
              ("ir_r1_k3_a1.1_p1.1_s2_e3_c16",
               "ir_r1_k3.5_a1.1_p1.1_s1_e3_c16_se0.5_nsw"),
              ("ir_r1_k3.5.7_s2_e6_c24_se0.25_nsw",)), act="relu"),
    "condconv": dict(
        arch=(("ds_r1_k3_s1_e1_c8_se0.25",), ("ir_r1_k3_s2_e4_c16_se0.25",),
              ("ir_r2_k5_s1_e3_c16_se0.25_cc4",)), act="swish"),
    "mobilenetv3": dict(
        arch=(("ds_r1_k3_s1_c8_nre",), ("ir_r1_k3_s2_e4_c16_nre",),
              ("ir_r1_k5_s2_e3_c24_se0.25", "ir_r1_k5_s1_e3_c24_se0.25")),
        act="hard_swish", head_hidden=40, fix_stem=True, se_act="relu",
        se_reduce_mid=True, se_divisor=8, se_gate="hard_sigmoid"),
    "edgetpu": dict(
        arch=(("er_r1_k3_s1_e4_c8_fc8_noskip",), ("er_r2_k3_s2_e4_c16",),
              ("ir_r1_k5_s2_e4_c24",)), act="relu"),
}


def _nets(kind, features_only=False, **over):
    cfg = dict(_NETS[kind], **over)
    arch = cfg.pop("arch")
    common = dict(stem_size=8, num_features=32, num_classes=5,
                  features_only=features_only, **cfg)
    port = peff.EfficientNet(peff.decode_arch_def(arch), **common)
    if "bn_momentum" in common:   # each package's convention
        common["bn_momentum"] = 1 - common["bn_momentum"]
    jax_mod = jeff.EfficientNet(jeff.decode_arch_def(arch), **common)
    return port, jax_mod


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("kind", sorted(_NETS))
def test_reduced_net_matches_jax(kind, training):
    port, jax_mod = _nets(kind)
    size = 33 if kind == "tf_efficientnet" and training else 32
    check_parity(port, jax_mod, images(2, size, seed=6), 7, FAMILY,
                 image=True, training=training)


def test_features_only_matches_jax():
    port, jax_mod = _nets("efficientnet", features_only=True)
    assert port.conv_head is None and port.classifier is None
    check_parity(port, jax_mod, images(2, 32, seed=8), 9, FAMILY,
                 image=True)


def test_feature_wrappers_on_efficientnet_b0():
    """``tests/test_features.py``'s channels and reductions, and the maps
    of a 64 px forward."""
    model = create_model("efficientnet_b0", device="cpu")
    net = FeatureListNet(model, out_indices=(0, 1, 2, 3, 4))
    assert net.feature_info.channels() == [16, 24, 40, 112, 320]
    assert net.feature_info.reduction() == [2, 4, 8, 16, 32]
    x = torch.from_numpy(images(1, 64, seed=1).transpose(0, 3, 1, 2).copy())
    with torch.no_grad():
        outs = net(x)
        picked = FeatureDictNet(model, out_indices=(2, 4))(x)
    assert [o.shape[1] for o in outs] == [16, 24, 40, 112, 320]
    assert [64 // o.shape[2] for o in outs] == [2, 4, 8, 16, 32]
    assert list(picked) == ["stage2", "stage4"]
    assert torch.equal(picked["stage4"], outs[4])


# --- the BN arguments ----------------------------------------------------------

def _bns(model):
    return [m for m in model.modules() if isinstance(m, peff.BatchNorm2d)]


@pytest.mark.parametrize("kwargs,eps,momentum", [
    (dict(bn_tf=True), 1e-3, 0.01),
    (dict(bn_momentum=0.05), 1e-5, 0.05),
    (dict(bn_eps=1e-4), 1e-4, 0.1),
    (dict(bn_tf=True, bn_momentum=0.02), 1e-3, 0.02),
])
def test_bn_arguments_are_torch_momenta(kwargs, eps, momentum):
    model = create_model("efficientnet_b0", device="cpu", **kwargs)
    bns = _bns(model)
    assert len(bns) == 49
    assert {(b.eps, b.momentum) for b in bns} == {(eps, momentum)}
    # the JAX package's resolution of the same arguments, in flax's
    # convention
    jax_args = jeff._resolve_bn_args(dict(kwargs))
    assert jax_args.get("bn_eps", 1e-5) == eps
    assert abs(jax_args.get("bn_momentum", 0.9) - (1 - momentum)) < 1e-12


def test_tf_rows_set_eps_on_every_bn_and_same_on_every_conv():
    model = create_model("tf_efficientnet_b0", device="cpu")
    assert {b.eps for b in _bns(model)} == {1e-3}
    assert {b.momentum for b in _bns(model)} == {0.1}
    # the SE's 1x1 convs act on the pooled 1x1 map, as Dense layers do
    se = {id(m) for s in model.modules()
          if isinstance(s, peff.SqueezeExcite) for m in s.modules()}
    convs = [m for m in model.modules()
             if isinstance(m, peff.Conv2d) and id(m) not in se]
    assert len(convs) == 2 + 2 + 3 * 15 and all(c.same for c in convs)


def test_bn_tf_running_statistics_move_as_flax_099():
    """A reduced net built with the port's ``bn_tf`` resolution against
    the JAX net built with JAX's, in training: the running statistics
    compared at rtol 1e-5 move by 0.01 of the batch's."""
    p_args = peff._resolve_bn_args({"bn_tf": True})
    j_args = jeff._resolve_bn_args({"bn_tf": True})
    assert p_args == {"bn_eps": 1e-3, "bn_momentum": 0.01}
    assert j_args == {"bn_eps": 1e-3, "bn_momentum": 0.99}
    arch = _NETS["efficientnet"]["arch"]
    common = dict(stem_size=8, num_features=32, num_classes=5, act="swish")
    port = peff.EfficientNet(peff.decode_arch_def(arch), **common, **p_args)
    jax_mod = jeff.EfficientNet(jeff.decode_arch_def(arch), **common,
                                **j_args)
    check_parity(port, jax_mod, images(2, 32, seed=10), 11, FAMILY,
                 image=True, training=True)


def test_drop_path_grows_by_block_index_where_a_residual_is():
    model = create_model("efficientnet_b0", device="cpu", drop_path_rate=0.2)
    blocks = [b for stage in model.blocks for b in stage]
    assert len(blocks) == 16
    for idx, b in enumerate(blocks):
        want = 0.2 * idx / 16
        if b.has_residual and want > 0:
            assert b.drop_path.rate == pytest.approx(want)
        else:
            assert b.drop_path is None


def test_in_chans_reaches_the_stem():
    model = create_model("mixnet_s", in_chans=1, num_classes=7, device="cpu")
    assert model.conv_stem.weight.shape == (16, 1, 3, 3)
    with torch.no_grad():
        assert model(torch.randn(2, 1, 32, 32)).shape == (2, 7)


def test_pruned_keys_build_the_unpruned_net_with_a_warning(caplog):
    with caplog.at_level(logging.WARNING):
        with torch.device("meta"):
            pruned = peff.efficientnet_b1_pruned()
    assert "efficientnet_b1_pruned" in caplog.text
    assert "unpruned" in caplog.text
    with torch.device("meta"):
        base = peff.tf_efficientnet_b1()
    assert {k: v.shape for k, v in pruned.state_dict().items()} == {
        k: v.shape for k, v in base.state_dict().items()}
