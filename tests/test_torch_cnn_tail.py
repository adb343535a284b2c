"""Parity of the port's ``ConvBnAct`` and ``SelectiveKernelConv``
(``nn/conv.py``, ``nn/extra.py``) and of the families on the ResNet
chassis (``models/resnest.py``, ``res2net.py``, ``sknet.py``,
``psresnet.py``, ``resnet_rs.py``) with the JAX package, in f32 on the
CPU.

The same seeded numpy variables go into both sides (carried into the port
by ``jax_to_torch_state_dict(family=...)``), and the output and the
gradients of ``sum(out * r)`` in the input and in every parameter are
held against ``jax.value_and_grad`` of the JAX module, jitted once
(``torch_family_parity.check_parity``), in eval and in train mode.  The
tolerance is ``1e-5 * max|ref|``: both sides compute in f32 and differ by
the order of their sums.  In train mode a BN's gradients are sums that
cancel (the one-pass variance, ROADMAP's "look like faults"), and there
each tensor is held at 3x the JAX gradient's own move under a 1e-7
relative perturbation of the input where that is larger.  A block runs
as the chassis' ``layer1.0`` (the SK family's names are placed by that
path); a reduced net is the chassis with one block a stage, built
directly (the entrypoints fix the depth).
"""

import functools

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch import nn  # noqa: E402

from cotnet_tpu.models import psresnet as jps  # noqa: E402
from cotnet_tpu.models import res2net as jr2  # noqa: E402
from cotnet_tpu.models import resnest as jnest  # noqa: E402
from cotnet_tpu.models import resnet as jresnet  # noqa: E402
from cotnet_tpu.models import sknet as jsk  # noqa: E402
from cotnet_tpu.nn import conv as jconv  # noqa: E402
from cotnet_tpu.nn import extra as jextra  # noqa: E402
from cotnet_tpu_torch.models import model_entrypoint  # noqa: E402
from cotnet_tpu_torch.models import psresnet as pps  # noqa: E402
from cotnet_tpu_torch.models import res2net as pr2  # noqa: E402
from cotnet_tpu_torch.models import resnest as pnest  # noqa: E402
from cotnet_tpu_torch.models import sknet as psk  # noqa: E402
from cotnet_tpu_torch.models.resnet import (Bottleneck,  # noqa: E402
                                             Downsample, ResNet)
from cotnet_tpu_torch.nn import ConvBnAct, SelectiveKernelConv  # noqa: E402
from torch_family_parity import (At, JaxPath, check_logits,  # noqa: E402
                                 check_parity, images, maps,
                                 random_variables)


# --- ConvBnAct and SelectiveKernelConv ---------------------------------------

@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("kw", [
    dict(kernel_size=3, stride=2, dilation=1, groups=1, act="relu"),
    dict(kernel_size=3, stride=1, dilation=2, groups=4, act="swish"),
    dict(kernel_size=1, stride=1, dilation=1, groups=1, act=None),
], ids=["k3s2", "k3d2g4", "k1_no_act"])
def test_conv_bn_act_matches_jax(kw, training):
    kw = dict(kw)
    k, s, d = kw.pop("kernel_size"), kw.pop("stride"), kw.pop("dilation")
    port = At("inner", ConvBnAct(8, 12, k, s, None, d, **kw))
    assert sorted(port.state_dict())[:2] == ["inner.bn.bias",
                                             "inner.bn.num_batches_tracked"]
    jax_mod = JaxPath(functools.partial(jconv.ConvBnAct, 12, k, s, None, d,
                                        **kw), ("inner",))
    check_parity(port, jax_mod, maps((3, 9, 9, 8), 0), 1, None, image=True,
                 training=training)


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("kw", [
    dict(stride=1, groups=1, split_input=True, attn_reduction=8,
         min_attn_channels=16),
    dict(stride=2, groups=4, split_input=False),
    dict(stride=2, groups=1, kernel_size=[3, 5, 7], keep_3x3=False,
         split_input=False, dilation=1),
], ids=["split", "grouped_s2", "three_paths_5x5_7x7"])
def test_selective_kernel_conv_matches_jax(kw, training):
    """As a SK block's ``conv2``, whose path the names follow."""
    sk = SelectiveKernelConv(12, 16, **kw)
    port = At("layer1.0.conv2", sk)
    keys = port.state_dict()
    assert "layer1.0.conv2.attn.fc_reduce.weight" in keys
    assert keys["layer1.0.conv2.attn.fc_select.weight"].shape == (
        16 * sk.num_paths, keys["layer1.0.conv2.attn.bn.weight"].shape[0],
        1, 1)
    jax_mod = JaxPath(functools.partial(jextra.SelectiveKernelConv, 16, **kw),
                      ("layer1_0", "conv2"))
    check_parity(port, jax_mod, maps((4, 10, 10, 12), 2), 3, "sknet",
                 image=True, training=training)


# --- the chassis blocks ---------------------------------------------------------

def _block(port_cls, jax_cls, inplanes, planes, stride, down, **kw):
    out = planes * port_cls.expansion
    ds = Downsample(inplanes, out, stride) if down else None
    port = At("layer1.0", port_cls(inplanes, planes, stride, ds, **kw))
    jax_mod = JaxPath(functools.partial(
        jax_cls, planes=planes, stride=stride,
        downsample=dict(stride=stride) if down else None, **kw),
        ("layer1_0",))
    return port, jax_mod


BLOCKS = {
    # ResNeSt: radix 2 with avd after the split attention, radix 4 grouped
    # with avd_first, radix 1 (the sigmoid gate), a stride-1 block
    "resnest_r2": (pnest.ResNestBottleneck, jnest.ResNestBottleneck,
                   16, 8, 2, True, dict(radix=2)),
    "resnest_r4_avd_first": (pnest.ResNestBottleneck,
                             jnest.ResNestBottleneck, 32, 32, 2, True,
                             dict(radix=4, cardinality=2, base_width=40,
                                  avd_first=True)),
    "resnest_r1": (pnest.ResNestBottleneck, jnest.ResNestBottleneck,
                   16, 8, 2, True, dict(radix=1, cardinality=4,
                                        base_width=24, avd_first=True)),
    "resnest_s1": (pnest.ResNestBottleneck, jnest.ResNestBottleneck,
                   32, 8, 1, False, dict(radix=2)),
    # Res2Net: a stage's first block (the parts alone, the last pooled)
    # and a later one (each part gets the previous one's output); SE
    "res2net_first": (pr2.Bottle2neck, jr2.Bottle2neck, 16, 8, 2, True,
                      dict(base_width=26, scale=4)),
    "res2net_later": (pr2.Bottle2neck, jr2.Bottle2neck, 32, 8, 1, False,
                      dict(base_width=26, scale=4, attn_layer="se")),
    "res2next": (pr2.Bottle2neck, jr2.Bottle2neck, 16, 16, 1, True,
                 dict(base_width=4, cardinality=8, scale=4)),
    # SK: the basic block (split input, small attention) and the
    # bottleneck (grouped), with the last BN not zero
    "sk_basic": (psk.SelectiveKernelBasic, jsk.SelectiveKernelBasic,
                 8, 16, 2, True,
                 dict(zero_init_last_bn=False,
                      sk_kwargs=dict(min_attn_channels=16, attn_reduction=8,
                                     split_input=True))),
    "sk_bottleneck": (psk.SelectiveKernelBottleneck,
                      jsk.SelectiveKernelBottleneck, 16, 8, 2, True,
                      dict(cardinality=4, base_width=16,
                           zero_init_last_bn=False)),
    # PS-ResNet: the poly-scale 3x3, strided and not
    "psresnet_s2": (pps.PSBottleneck, jps.PSBottleneck, 16, 8, 2, True, {}),
    "psresnet_s1": (pps.PSBottleneck, jps.PSBottleneck, 32, 8, 1, False,
                    dict(attn_layer="se")),
}
FAMILY = {"resnest": None, "res2net": "res2net", "res2next": "res2net",
          "sk": "sknet", "psresnet": "psresnet"}


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_block_matches_jax(kind, training):
    port_cls, jax_cls, inplanes, planes, stride, down, kw = BLOCKS[kind]
    port, jax_mod = _block(port_cls, jax_cls, inplanes, planes, stride,
                           down, **kw)
    check_parity(port, jax_mod, maps((4, 9, 9, inplanes), 4), 5,
                 FAMILY[kind.split("_")[0]], image=True, training=training)


def test_psconv_masked_weights_get_no_gradient():
    """The dense conv's masked places: zero at the start, no gradient, so
    an SGD step with weight decay keeps them zero."""
    conv = pps.PSConv2d(8, 8, 3, 1, 1, 1)
    gen = torch.Generator().manual_seed(0)
    for m in conv.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(gen)
    masked = conv.conv.mask.expand_as(conv.conv.weight) == 0
    assert not conv.conv.weight[masked].any()
    x = torch.randn(2, 8, 6, 6, generator=gen)
    conv(x).square().sum().backward()
    g = conv.conv.weight.grad
    assert not g[masked].any() and g[~masked].abs().min() > 0
    opt = torch.optim.SGD(conv.parameters(), lr=0.1, momentum=0.9,
                          weight_decay=1e-4)
    opt.step()
    assert not conv.conv.weight[masked].any()


# --- reduced nets on the chassis ------------------------------------------------

NETS = {
    "resnest": (pnest.ResNestBottleneck, jnest.ResNestBottleneck, None,
                dict(stem_type="deep", stem_width=8, avg_down=True,
                     block_args=dict(radix=2, avd=True))),
    "res2net": (pr2.Bottle2neck, jr2.Bottle2neck, "res2net",
                dict(base_width=26, block_args=dict(scale=4))),
    "sknet": (psk.SelectiveKernelBasic, jsk.SelectiveKernelBasic, "sknet",
              dict(zero_init_last_bn=False, block_args=dict(
                  sk_kwargs=dict(min_attn_channels=16, attn_reduction=8,
                                 split_input=True)))),
    "skresnext": (psk.SelectiveKernelBottleneck,
                  jsk.SelectiveKernelBottleneck, "sknet",
                  dict(cardinality=8, base_width=4, stem_type="deep",
                       stem_width=8, avg_down=True,
                       zero_init_last_bn=False)),
    "psresnet": (pps.PSBottleneck, jps.PSBottleneck, "psresnet", {}),
    "resnet_rs": (Bottleneck, jresnet.Bottleneck, None,
                  dict(stem_type="deep", stem_width=8,
                       replace_stem_pool=True,
                       block_args=dict(attn_layer="se",
                                       attn_kwargs=dict(reduction=4)))),
}


@pytest.mark.parametrize("kind", sorted(NETS))
def test_reduced_net_matches_jax(kind):
    """One block a stage, 5 classes, at 64 px.  In eval mode the logits and
    every gradient (``check_parity``).  In train mode the logits, the
    updated BN statistics and the eval logits after calibration
    (``check_logits``) on 4 images, at 5e-5 of the largest logit (the
    last stage's train-mode BNs normalize 16 values and amplify f32
    rounding; on 2 images the split attention's BN normalizes 2 pooled
    values, and the logits move by 4e-5).  The train-mode gradients are held block by block
    (``test_block_matches_jax``): across a whole net some ReLU input lies
    within f32 rounding of its kink, and which side it takes moves the
    input gradient by 1e-3 to 2e-2 of its largest between f32 and f64, in
    either package (measured on these nets against both packages' f64
    runs)."""
    port_cls, jax_cls, family, kw = NETS[kind]
    avg_down = kw.get("avg_down", False)

    def nets():
        return (ResNet(port_cls, (1, 1, 1, 1), num_classes=5, **kw),
                jresnet.ResNet(block=jax_cls, layers=(1, 1, 1, 1),
                               num_classes=5, **kw))
    port, jax_mod = nets()
    check_parity(port, jax_mod, images(2, 64, seed=6), 7, family,
                 image=True, avg_down=avg_down)
    port, jax_mod = nets()
    x = images(4, 64, seed=8)
    check_logits(jax_mod, port, random_variables(jax_mod, x, 9), x, family,
                 rel=5e-5, avg_down=avg_down)


def test_resnest_entrypoints_take_their_table_rows():
    """Each ResNeSt key's blocks as its JAX row builds them: radix,
    cardinality, width, where the stride goes, the stem's width."""
    for name, row in jnest.RESNEST_VARIANTS.items():
        with torch.device("meta"):
            model = model_entrypoint(name)()
        block = model.layer2[0]
        ba = row["block_args"]
        assert block.avd_first == ba["avd_first"] and block.avd_stride == 2
        width = int(128 * row["base_width"] / 64) * row["cardinality"]
        assert block.conv3.weight.shape[1] == width
        assert block.conv2.radix == ba["radix"]
        assert block.conv2.groups == row["cardinality"]
        assert model.conv1[0].weight.shape[0] == row["stem_width"]
        assert isinstance(block.downsample[0], nn.AvgPool2d)
