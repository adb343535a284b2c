"""Parity of the PyTorch port's plain ResNet chassis with the JAX package:
every activation and global pool, each attention module (SE, eSE, ECA,
circular ECA, CBAM, light CBAM), ``BasicBlock`` and ``Bottleneck`` with
each attention, the logits of one key per row shape of the variant table
in eval and in training, and the ``PARAM_EXACT`` parameter counts.

Variables come from a numpy seed into the JAX structure
(``test_torch_cotnet.random_variables``) and reach the port through
``jax_to_torch_state_dict``, loaded with ``strict=True``; both sides run
the same f32 input on the CPU.  The training forwards (batch statistics)
take 4 images of differing contrast at 64 px, so that no BN of the last
stage sees only a few near-equal values.  Whole-net logits are held at
``5e-4 * max|logit|`` (the converted whole-net tolerance, ROADMAP queue 3),
modules and blocks at 2e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import linen as fnn  # noqa: E402
from flax.traverse_util import flatten_dict  # noqa: E402

from cotnet_tpu.models import create_model as jax_create_model  # noqa: E402
from cotnet_tpu.models import resnet as jax_resnet  # noqa: E402
from cotnet_tpu.nn import activations as jax_act  # noqa: E402
from cotnet_tpu.nn import attn as jax_attn  # noqa: E402
from cotnet_tpu.nn import pool as jax_pool  # noqa: E402
from cotnet_tpu_torch.models import (  # noqa: E402
    get_model_default_cfg,
    is_model,
    model_entrypoint,
)
from cotnet_tpu_torch.models import resnet  # noqa: E402
from cotnet_tpu_torch.nn import ClassifierHead  # noqa: E402
from cotnet_tpu_torch.nn import activations as act  # noqa: E402
from cotnet_tpu_torch.nn import attn  # noqa: E402
from cotnet_tpu_torch.nn import pool  # noqa: E402
from cotnet_tpu_torch.utils.convert import jax_to_torch_state_dict  # noqa: E402
from test_models import PARAM_EXACT  # noqa: E402
from test_torch_cotnet import nchw, random_variables, unflatten  # noqa: E402

ATTN_KEYS = ("se", "ese", "eca", "ceca", "cbam", "lcbam")


def images(n=4, size=64, c=3, seed=0):
    """NHWC f32 images of differing contrast."""
    rng = np.random.RandomState(seed)
    return (rng.randn(n, size, size, c)
            * np.linspace(0.5, 2.0, n)[:, None, None, None]).astype(
                np.float32)


def to_nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def flat_np(tree, collection):
    return {f"{collection}/{k}": np.asarray(v)
            for k, v in flatten_dict(tree, sep="/").items()}


@pytest.mark.parametrize("name", jax_act.list_act_fns())
def test_activation_matches_jax(name):
    assert act.list_act_fns() == jax_act.list_act_fns()
    x = np.linspace(-6.0, 6.0, 241, dtype=np.float32)
    got = act.get_act_fn(name)(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_act.get_act_fn(name)(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("pool_type", ["avg", "max", "avgmax",
                                       "catavgmax", "identity"])
def test_global_pool_matches_jax(pool_type):
    x = images(2, 5, 6)
    got = pool.global_pool2d(nchw(x), pool_type)
    want = np.asarray(jax_pool.global_pool2d(jnp.asarray(x), pool_type))
    if got.dim() == 4:  # identity
        got = got.permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


class _InSe(fnn.Module):
    """A JAX attention module under the name ``se``, as a block holds it
    (the converter's 1x1-conv rule follows that name)."""

    key: str
    channels: int

    @fnn.compact
    def __call__(self, x, training=False):
        return jax_attn.create_attn(self.key, self.channels, name="se")(
            x, training=training)


@pytest.mark.parametrize("key", ATTN_KEYS)
def test_attention_module_matches_jax(key):
    """Each ``create_attn`` key at 64 channels (ECA takes a 3-tap kernel
    there, CBAM a 4-wide MLP) in eval and in training (CBAM's spatial BN
    takes batch statistics), with the weights carried by the converter."""
    c = 64
    x = images(4, 6, c, seed=1)
    jax_mod = _InSe(key, c)
    _, flat = random_variables(jax_mod, jnp.asarray(x), seed=2)
    variables = unflatten(flat)
    port = attn.create_attn(key, c)
    sd = {k[len("se."):]: v for k, v in jax_to_torch_state_dict(flat).items()}
    port.load_state_dict(sd, strict=True)
    for training in (False, True):
        want = jax_mod.apply(variables, jnp.asarray(x), training=training,
                             mutable=["batch_stats"])[0]
        with torch.no_grad():
            got = port.train(training)(nchw(x))
        np.testing.assert_allclose(to_nhwc(got), np.asarray(want),
                                   rtol=2e-5, atol=2e-5, err_msg=str(training))


def test_create_attn_factory():
    assert attn.create_attn(None, 8) is None
    assert attn.create_attn(False, 8) is None
    assert isinstance(attn.create_attn(True, 64), attn.SEModule)
    assert attn.create_attn("ceca", 64).circular
    assert attn.create_attn("lcbam", 64).light
    assert attn.create_attn("SE", 64).fc1.weight.shape == (8, 64, 1, 1)
    with pytest.raises(ValueError, match="invalid attn"):
        attn.create_attn("nope", 8)


BLOCK_CASES = [(block, key) for block in ("basic", "bottleneck")
               for key in (None, "se", "eca", "cbam")] + [
    ("bottleneck_aa", "ese"), ("basic_reduce_first", "lcbam"),
    ("bottleneck_reduce_first", "ceca")]


@pytest.mark.parametrize("block,key", BLOCK_CASES)
def test_block_matches_jax(block, key):
    """One block at stride 2 with a projection shortcut (a 3x3 one where
    ``reduce_first`` is set, as senet154's), in eval and training:
    outputs and the updated running statistics."""
    kind = block.split("_")[0]
    aa = block.endswith("_aa")
    reduce_first = 2 if "reduce_first" in block else 1
    down_ks = 3 if reduce_first == 2 else 1
    x = images(4, 9, 32, seed=3)
    planes = 32 if kind == "basic" else 16
    jax_cls = jax_resnet.BasicBlock if kind == "basic" else \
        jax_resnet.Bottleneck
    port_cls = resnet.BasicBlock if kind == "basic" else resnet.Bottleneck
    outplanes = planes * port_cls.expansion
    jax_block = jax_cls(planes=planes, stride=2, attn_layer=key, aa=aa,
                        reduce_first=reduce_first,
                        downsample=dict(stride=2, kernel_size=down_ks))
    _, flat = random_variables(jax_block, jnp.asarray(x), seed=4)
    variables = unflatten(flat)
    port = port_cls(32, planes, stride=2, attn_layer=key, aa=aa,
                    reduce_first=reduce_first,
                    downsample=resnet.Downsample(32, outplanes, 2,
                                                 kernel_size=down_ks))
    port.load_state_dict(jax_to_torch_state_dict(flat), strict=True)
    for training in (False, True):
        want, stats = jax_block.apply(variables, jnp.asarray(x),
                                      training=training,
                                      mutable=["batch_stats"])
        with torch.no_grad():
            got = port.train(training)(nchw(x))
        np.testing.assert_allclose(to_nhwc(got), np.asarray(want),
                                   rtol=2e-5, atol=2e-5 * float(
                                       np.abs(want).max()))
    want_sd = jax_to_torch_state_dict(flat_np(stats["batch_stats"],
                                              "batch_stats"))
    sd = port.state_dict()
    for k, v in want_sd.items():
        if "running_" in k:
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=k)


# one key per row shape: basic / deep stem + avg-down / grouped / tiered
# stem + SE / tiered-narrow stem + ECA / 3x3 shortcut + reduce_first, and a
# catavgmax head
LOGIT_CASES = {
    "resnet18": {},
    "resnet50d": {},
    "resnext50_32x4d": {},
    "seresnext26t_32x4d": {},
    "ecaresnext26tn_32x4d": {},
    "senet154": dict(layers=(1, 1, 1, 1)),
    "resnet26": dict(global_pool="catavgmax"),
}


@pytest.mark.parametrize("name", sorted(LOGIT_CASES))
def test_logits_match_jax(name):
    """Eval and training logits of the whole net at 64 px, 4 images."""
    kw = dict(LOGIT_CASES[name], num_classes=10)
    x = images()
    model = jax_create_model(name, **kw)
    _, flat = random_variables(model, jnp.asarray(x), seed=5)
    variables = unflatten(flat)
    port = model_entrypoint(name)(**kw)
    avg_down = jax_resnet.RESNET_VARIANTS[name].get("avg_down", False)
    port.load_state_dict(jax_to_torch_state_dict(flat, avg_down=avg_down),
                         strict=True)
    for training in (False, True):
        want = np.asarray(model.apply(variables, jnp.asarray(x),
                                      training=training,
                                      mutable=["batch_stats"])[0])
        with torch.no_grad():
            got = port.train(training)(nchw(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=5e-4 * float(np.abs(want).max()),
                                   err_msg=str(training))


@pytest.mark.parametrize("name", ["resnet50", "wide_resnet50_2",
                                  "resnext50_32x4d", "seresnet50",
                                  "ecaresnet50d"])
def test_param_exact(name):
    """``tests/test_models.py``'s exact counts, the reference's torch
    modules summed; the port builds on the meta device."""
    with torch.device("meta"):
        model = model_entrypoint(name)()
    assert sum(p.numel() for p in model.parameters()) == PARAM_EXACT[name]


def test_every_variant_is_registered_with_its_cfg():
    """The 68 keys of ``RESNET_VARIANTS``, each with the JAX package's
    interpolation and first conv."""
    from cotnet_tpu.models import get_model_default_cfg as jax_cfg

    keys = sorted(jax_resnet.RESNET_VARIANTS)
    assert len(keys) == 68
    assert keys == sorted(resnet.RESNET_VARIANTS)
    for name in keys:
        assert is_model(name), name
        with torch.device("meta"):
            model_entrypoint(name)(layers=(1, 1, 1, 1))
        jax_create_model(name, layers=(1, 1, 1, 1))
        got, want = get_model_default_cfg(name), jax_cfg(name)
        for k in ("interpolation", "first_conv", "input_size", "crop_pct"):
            assert got[k] == want[k], (name, k)


def test_catavgmax_head_doubles_features():
    head = ClassifierHead(8, 3, pool_type="catavgmax")
    assert head.weight.shape == (3, 16)
    assert head(torch.randn(2, 8, 4, 4)).shape == (2, 3)
    flat = ClassifierHead(8, 3, pool_type="identity")
    assert flat(torch.randn(2, 8, 4, 5)).shape == (2, 4, 5, 3)
