"""Every key of the JAX package's ResNeSt (10), SKNet (8), Res2Net (7),
ResNet-RS (4), PS-ResNet (2), RegNet (24), DenseNet (9), ReXNet (8) and
Xception (1) modules in the PyTorch port: the port's state_dict, built on
the meta device, carries strictly onto the JAX model's variables
(``convert_torch_state_dict(strict=True)`` with ``model_adapter(name)``,
against ``jax.eval_shape`` of its init at 64 px), which checks every key
and every shape, and every tensor of the port's state_dict is used; the
JAX variables carry back through the port's ``jax_to_torch_state_dict(
family=model_family(name))`` onto the port's own keys and shapes.  The
ResNet-D shortcut's ``avg_down`` comes from the variant tables, not from
the name (``model_avg_down`` answers False for seven ResNeSt keys built
with it).  The ``PARAM_EXACT`` counts of ``tests/test_models.py``; one
seeded key of each module there and back with the same bits;
``load_checkpoint_into``; the port's registry equal to the JAX package's
418 keys.

The port's tensors are zero-stride arrays of their shapes: nothing of the
weights is made or run.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax.traverse_util import flatten_dict  # noqa: E402

from cotnet_tpu.models import create_model as jax_create_model  # noqa: E402
from cotnet_tpu.models import registry as jax_registry  # noqa: E402
from cotnet_tpu.models.resnest import RESNEST_VARIANTS  # noqa: E402
from cotnet_tpu.models.sknet import SKNET_VARIANTS  # noqa: E402
from cotnet_tpu.utils.convert import (convert_torch_state_dict,  # noqa: E402
                                      model_adapter, model_avg_down)
from cotnet_tpu_torch.models import (create_model, list_models,  # noqa: E402
                                     model_entrypoint)
from cotnet_tpu_torch.utils.convert import (jax_to_torch_state_dict,  # noqa: E402
                                            load_checkpoint_into,
                                            model_family)

MODULES = {"resnest": 10, "sknet": 8, "res2net": 7, "resnet_rs": 4,
           "psresnet": 2, "regnet": 24, "densenet": 9, "rexnet": 8,
           "xception": 1}
# the port's family of each module (None: the chassis' default names)
FAMILIES = {"resnest": None, "resnet_rs": None, "sknet": "sknet",
            "res2net": "res2net", "psresnet": "psresnet",
            "regnet": "regnet", "densenet": "densenet", "rexnet": "rexnet",
            "xception": "xception"}
ROWS = [(module, name) for module in MODULES
        for name in jax_registry.list_models(module=module)]
# one key of each module, whose seeded weights go there and back
ONE_EACH = ("resnest50d_4s2x40d", "skresnet50d", "res2next50",
            "resnet_rs50", "psresnet50", "regnety_002", "densenetblur121d",
            "rexnetr_100", "xception")
# the test_models.py PARAM_EXACT rows of these modules
PARAM_EXACT = {"resnest14d": 10611688, "resnest50d": 27483240,
               "skresnet18": 11958056, "res2net50_26w_4s": 25699120,
               "resnet_rs50": 35654920, "regnetx_002": 2684792,
               "regnety_002": 3162996, "densenet121": 7978856,
               "xception": 22855952, "rexnet_100": 4796873}


def avg_down(name):
    """The ResNet-D shortcut as the variant table builds it."""
    row = RESNEST_VARIANTS.get(name) or SKNET_VARIANTS.get(name) or {}
    return bool(row.get("avg_down", False))


# keys whose JAX variables are another key's (zero-init of the last BN
# and the weights' lineage change no variable)
SAME_VARIABLES = {"resnet_rs101L": "resnet_rs101",
                  "tv_densenet121": "densenet121",
                  "skresnet50_zerobn": "skresnet50",
                  "skresnext50_32x4d_zerobn": "skresnext50_32x4d"}
_TRACED = {}


def jax_shapes(name):
    """``jax.eval_shape`` of the JAX model's init at 64 px, traced once
    per variable structure."""
    key = SAME_VARIABLES.get(name, name)
    if key not in _TRACED:
        model = jax_create_model(key)
        _TRACED[key] = jax.eval_shape(
            lambda r, x: model.init({"params": r}, x, training=False),
            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.float32))
    return _TRACED[key]


def test_the_nine_modules_register_73_keys_and_the_registries_agree():
    assert {m: len(jax_registry.list_models(module=m)) for m in MODULES} \
        == MODULES
    for module in MODULES:
        assert list_models(module=module) == \
            jax_registry.list_models(module=module)
    assert len(ROWS) == 73
    assert list_models() == jax_registry.list_models()
    assert len(list_models()) == 418
    assert {n: model_family(n) for _, n in ROWS} == {
        n: FAMILIES[m] for m, n in ROWS}


def test_the_name_rule_misses_seven_resnest_avg_downs():
    """``model_avg_down`` decides by the name, in both packages alike;
    every ResNeSt row is built with the ResNet-D shortcut."""
    assert all(avg_down(n) for n in RESNEST_VARIANTS)
    missed = sorted(n for n in RESNEST_VARIANTS if not model_avg_down(n))
    assert missed == sorted(["resnest101e", "resnest200e", "resnest269e",
                             "resnest50d_4s2x40d", "resnest50d_1s4x24d",
                             "resnest50", "resnest101"])
    assert avg_down("skresnet50d") and model_avg_down("skresnet50d")


@pytest.mark.parametrize("name", sorted(PARAM_EXACT))
def test_parameter_counts_match_the_jax_package(name):
    with torch.device("meta"):
        port = model_entrypoint(name)()
    assert sum(p.numel() for p in port.parameters()) == PARAM_EXACT[name]


@pytest.mark.parametrize("module,name", ROWS)
def test_state_dict_converts_strictly(module, name):
    with torch.device("meta"):
        port = model_entrypoint(name)()
    sd = {k: np.broadcast_to(np.float32(0), tuple(v.shape))
          for k, v in port.state_dict().items()}
    shapes = jax_shapes(name)
    out = convert_torch_state_dict(sd, shapes, avg_down=avg_down(name),
                                   adapter=model_adapter(name), strict=True)
    n_jax = sum(int(np.prod(s.shape)) for s in
                jax.tree_util.tree_leaves(shapes["params"]))
    assert sum(p.numel() for p in port.parameters()) == n_jax
    # every port tensor is used (the batch counters have no flax
    # counterpart)
    used = sum(len(jax.tree_util.tree_leaves(out[c]))
               for c in ("params", "batch_stats"))
    assert used == sum(1 for k in sd if not k.endswith("num_batches_tracked"))
    del out
    # and back: the JAX names through the port's converter give every key
    # of the port, with its shape
    flat = {f"{c}/" + "/".join(k): np.broadcast_to(np.float32(0), v.shape)
            for c in ("params", "batch_stats")
            for k, v in flatten_dict(shapes.get(c, {})).items()}
    back = jax_to_torch_state_dict(flat, family=model_family(name),
                                   avg_down=avg_down(name))
    assert {k: tuple(v.shape) for k, v in back.items()} == {
        k: tuple(v.shape) for k, v in sd.items()}


@pytest.mark.parametrize("name", ONE_EACH)
def test_round_trip_through_the_jax_converter_is_exact(name):
    """The port's seeded weights (BN statistics made non-trivial) through
    the JAX converter (strict) and back through the port's: every key
    comes back with the same bits."""
    port = create_model(name, device="cpu", seed=3)
    gen = torch.Generator().manual_seed(4)
    for key, v in port.state_dict().items():
        if "running_" in key:
            v.copy_(0.5 + torch.rand(v.shape, generator=gen))
    sd = port.state_dict()
    out = convert_torch_state_dict(
        {k: v.numpy() for k, v in sd.items()}, jax_shapes(name),
        avg_down=avg_down(name), adapter=model_adapter(name), strict=True)
    flat = {f"{c}/" + "/".join(k): v for c in ("params", "batch_stats")
            for k, v in flatten_dict(out[c]).items()}
    back = jax_to_torch_state_dict(flat, family=model_family(name),
                                   avg_down=avg_down(name))
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert torch.equal(back[k].to(v.dtype), v), k


@pytest.mark.parametrize("name", ONE_EACH)
def test_checkpoint_loads_into_the_port(name, tmp_path):
    src = create_model(name, device="cpu", seed=1)
    path = str(tmp_path / f"{name}.pth.tar")
    torch.save({"state_dict": src.state_dict()}, path)
    dst = create_model(name, device="cpu", seed=2)
    result = load_checkpoint_into(dst, path)
    assert not result.missing_keys and not result.unexpected_keys
    for k, v in src.state_dict().items():
        assert torch.equal(dst.state_dict()[k], v), k


def test_psconv_mask_is_no_state_dict_key_and_starts_at_zero():
    """PS-ResNet's dense conv: its mask is a non-persistent buffer (the
    JAX adapter maps none), and the masked places of the seeded weight are
    zero, half of each kernel at four parts."""
    port = create_model("psresnet50", device="cpu", seed=5)
    assert not [k for k in port.state_dict() if "mask" in k]
    for block in (port.layer1[0], port.layer3[2]):
        conv = block.conv2.conv
        masked = conv.mask.expand_as(conv.weight) == 0
        assert float(masked.float().mean()) == 0.5
        assert not conv.weight[masked].any() and conv.weight[~masked].all()
