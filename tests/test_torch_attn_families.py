"""Parity of the port's BoTNet-S1, LambdaNet and ResNet-DW
(``cotnet_tpu_torch/models/{botnet,lambda_net,resnet_dw}.py``) with the
JAX package's, in f32 on the CPU, and what all seven comparison-family
keys share: the registry, the converter's round trip and the checkpoint
loader.

- Reduced nets (one block a stage, 64 px, batch 2; BoTNet built for its
  4x4 stage-4 map at 64 px): train-mode logits and running statistics,
  and eval logits after calibrating BN on the images, at 5e-4 of the
  largest logit.
- One strided block of each (BoTNet's MHSA form, which keeps its map and
  takes a 1x1 shortcut): output, input and parameter gradients, running
  statistics.
- ``rel_to_abs`` against the JAX package's, and BoTNet refusing an input
  of another size.
- For each of the seven keys at reduced depth: the port's state_dict
  through the JAX converter (``convert_torch_state_dict(strict=True)``)
  and back through ``jax_to_torch_state_dict`` gives the same tensors,
  and ``load_checkpoint_into`` loads it from a reference-layout file.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax.traverse_util import flatten_dict  # noqa: E402

from cotnet_tpu.models import botnet as jax_bot  # noqa: E402
from cotnet_tpu.models import create_model as jax_create_model  # noqa: E402
from cotnet_tpu.models import lambda_net as jax_lambda  # noqa: E402
from cotnet_tpu.models import resnet_dw as jax_dw  # noqa: E402
from cotnet_tpu.models.resnet import ResNet as JaxResNet  # noqa: E402
from cotnet_tpu.utils.convert import (convert_torch_state_dict,  # noqa: E402
                                      model_adapter)
from cotnet_tpu_torch.models import (botnet, create_model,  # noqa: E402
                                     lambda_net, model_entrypoint, resnet_dw)
from cotnet_tpu_torch.models.resnet import Downsample  # noqa: E402
from cotnet_tpu_torch.utils.convert import (  # noqa: E402
    jax_to_torch_state_dict, load_checkpoint_into, model_family)
from torch_family_parity import (check_logits, check_train_grads,  # noqa: E402
                                 images, random_variables)

REDUCED = dict(layers=(1, 1, 1, 1), num_classes=10)
NETS = {
    "BoTNetS1_59": (jax_bot.BotBottleneck, dict(attn_layer="se"),
                    dict(img_size=64)),
    "lambdanet50": (jax_lambda.LambdaBottleneck, {}, {}),
    "resnet50_dw": (jax_dw.DwBottleneck, {}, {}),
}


@pytest.mark.parametrize("name", sorted(NETS))
def test_logits_match_jax(name):
    block, block_args, port_kw = NETS[name]
    x = images(2, 64)
    model = JaxResNet(block=block, block_args=block_args, **REDUCED)
    flat = random_variables(model, jnp.asarray(x), seed=1)
    port = model_entrypoint(name)(**REDUCED, **port_kw)
    check_logits(model, port, flat, x, family=model_family(name))


def _inputs(seed, n, side, c_in, c_out, side_out):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, side, side, c_in)
         * np.linspace(0.5, 2.0, n)[:, None, None, None]).astype(np.float32)
    return x, rng.randn(n, side_out, side_out, c_out).astype(np.float32)


def test_mhsa_bottleneck_matches_jax():
    """BoTNet's stage-4 block asked to stride 2 on a 4x4 map (width 64
    through ``base_width``, 4 heads of 16): it keeps the map and projects
    the shortcut 1x1."""
    x, r = _inputs(0, 4, 4, 64, 2048, 4)
    block = jax_bot.BotBottleneck(planes=512, stride=2, base_width=8,
                                  downsample=dict(stride=2))
    flat = random_variables(block, jnp.asarray(x), seed=2)
    port = botnet.BotBottleneck(64, 512, stride=2, base_width=8, fmap=4,
                                downsample=Downsample(64, 2048, 2))
    check_train_grads(port, block, flat, x, r, family="botnet")


def test_lambda_bottleneck_matches_jax():
    """A stride-2 LambdaBottleneck (width 32: 4 heads of 8 values, dim_k
    16, r 15) on an 8x8 map with a projection shortcut."""
    x, r = _inputs(3, 4, 8, 32, 128, 4)
    block = jax_lambda.LambdaBottleneck(planes=32, stride=2,
                                        downsample=dict(stride=2))
    flat = random_variables(block, jnp.asarray(x), seed=4)
    port = lambda_net.LambdaBottleneck(32, 32, stride=2,
                                       downsample=Downsample(32, 128, 2))
    check_train_grads(port, block, flat, x, r, family="lambdanet")


def test_dw_bottleneck_matches_jax():
    """A stride-2 DwBottleneck on a 9x9 map with a projection shortcut."""
    x, r = _inputs(5, 4, 9, 32, 128, 5)
    block = jax_dw.DwBottleneck(planes=32, stride=2,
                                downsample=dict(stride=2))
    flat = random_variables(block, jnp.asarray(x), seed=6)
    port = resnet_dw.DwBottleneck(32, 32, stride=2,
                                  downsample=Downsample(32, 128, 2))
    check_train_grads(port, block, flat, x, r, family="resnet_dw")


def test_rel_to_abs_matches_jax():
    x = np.random.RandomState(7).randn(2, 3, 5, 9).astype(np.float32)
    want = np.asarray(jax_bot._rel_to_abs(jnp.asarray(x)))
    np.testing.assert_array_equal(
        botnet.rel_to_abs(torch.from_numpy(x)).numpy(), want)
    assert want.shape == (2, 3, 5, 5)


def test_botnet_refuses_another_input_size():
    model = create_model("BoTNetS1_59", device="cpu", img_size=64,
                         **REDUCED)
    assert botnet.stage4_map(256) == 16 and botnet.stage4_map(224) == 14
    assert model(torch.zeros(1, 3, 64, 64)).shape == (1, 10)
    with pytest.raises(ValueError, match="built for a 4x4 stage-4 map"):
        model(torch.zeros(1, 3, 96, 96))


FAMILY_KEYS = ("san19", "lrnet50", "lrnet50_ks3", "BoTNetS1_59",
               "BoTNetS1_128", "lambdanet50", "resnet50_dw")


def _reduced(name):
    kw = dict(num_classes=10,
              layers=(1, 1, 1, 1, 1) if name == "san19" else (1, 1, 1, 1))
    return kw, dict(img_size=64) if name.startswith("BoTNet") else {}


@pytest.mark.parametrize("name", FAMILY_KEYS)
def test_state_dict_round_trip(name, tmp_path):
    """The port's seeded state_dict through the JAX converter and back
    gives the same tensors, and ``load_checkpoint_into`` loads it from a
    reference-layout file (``module.`` prefixed, under ``state_dict``)."""
    kw, port_kw = _reduced(name)
    port = create_model(name, device="cpu", seed=3, **kw, **port_kw)
    sd = {k: v.clone() for k, v in port.state_dict().items()}
    jax_model = _jax_reduced(name, kw)
    shapes = jax.eval_shape(
        lambda r, x: jax_model.init({"params": r}, x, training=False),
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    variables = convert_torch_state_dict(
        {k: v.numpy() for k, v in sd.items()}, shapes, strict=True,
        adapter=model_adapter(name))
    flat = {f"{col}/{k}": np.asarray(v) for col in variables
            for k, v in flatten_dict(variables[col], sep="/").items()}
    back = jax_to_torch_state_dict(flat, family=model_family(name))
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        torch.testing.assert_close(back[k], v.to(back[k].dtype), rtol=0,
                                   atol=0, msg=k)
    path = tmp_path / "ckpt.pth.tar"
    torch.save({"state_dict": {"module." + k: v.clone() * 2
                               for k, v in sd.items()}}, path)
    load_checkpoint_into(port, str(path))
    for k, v in port.state_dict().items():
        assert torch.equal(v, sd[k] * 2), k


def _jax_reduced(name, kw):
    """The JAX entrypoints fix ``layers``: a reduced net is built on its
    chassis."""
    from cotnet_tpu.models import lr_net as jax_lr
    from cotnet_tpu.models import san as jax_san

    if name == "san19":
        return jax_san.SAN(**kw)
    if name.startswith("lrnet50"):
        return JaxResNet(block=jax_lr.LrBottleneck, block_args=dict(
            key_ks=3 if name.endswith("ks3") else 1), **kw)
    block, block_args, _ = NETS[name if name in NETS else "BoTNetS1_59"]
    return JaxResNet(block=block, block_args=block_args, **kw)


@pytest.mark.parametrize("name", FAMILY_KEYS)
def test_param_count_at_full_width(name):
    """The port's parameter count (built on the meta device) equals the
    JAX package's from ``jax.eval_shape`` of ``init``."""
    size = 256 if name.startswith("BoTNet") else 224
    with torch.device("meta"):
        port = model_entrypoint(name)()
    jax_model = jax_create_model(name)
    shapes = jax.eval_shape(
        lambda r, x: jax_model.init({"params": r}, x, training=False),
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)))
    want = sum(int(np.prod(v.shape))
               for v in flatten_dict(shapes["params"]).values())
    assert sum(p.numel() for p in port.parameters()) == want
    if name == "lambdanet50":
        assert want == 14_917_768
