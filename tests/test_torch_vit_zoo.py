"""Every architecture of the JAX package's ``VIT_VARIANTS`` (34 keys),
``RESNETV2_VARIANTS`` (22) and ``VIT_HYBRID_VARIANTS`` (19) in the PyTorch
port: the port's state_dict, built on the meta device, carries strictly onto
the JAX model's variables (``convert_torch_state_dict(strict=True)`` with
the family's adapter, against ``jax.eval_shape`` of its init at the key's
configured input size and class count), which checks every key and every
shape; and the JAX variables carry back through the port's
``jax_to_torch_state_dict(family=...)`` onto the port's own keys.  The
port's tensors are zero-stride arrays of their shapes: nothing of the
weights is made or run.  The JAX converter copies each array into f32, so a
row holds its parameters once in memory (3.7 GB at resnetv2_152x4_bitm).

The port keeps timm's names where the JAX converter looks two of its
families up under others, which no timm file holds: ResNetV2's deep stems
(``stem.conv1`` ..., the JAX converter's ``stem_c1.conv`` ...) and the
hybrids' ResNet-D backbones (``conv1.0``, ``layer1.0``, ``downsample.1/2``,
the JAX converter's ``conv1_0``, ``layer1_0``, ``downsample.conv`` and
``downsample.1``).  ``jax_converter_names`` renames those keys before the
strict conversion.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax.traverse_util import flatten_dict  # noqa: E402

from cotnet_tpu.models import create_model as jax_create_model  # noqa: E402
from cotnet_tpu.models.resnetv2 import RESNETV2_VARIANTS  # noqa: E402
from cotnet_tpu.models.vision_transformer import VIT_VARIANTS  # noqa: E402
from cotnet_tpu.models.vision_transformer_hybrid import \
    VIT_HYBRID_VARIANTS  # noqa: E402
from cotnet_tpu.utils.convert import (FAMILY_ADAPTERS,  # noqa: E402
                                      convert_torch_state_dict)
from cotnet_tpu_torch.models import (list_models,  # noqa: E402
                                     model_entrypoint, resnetv2,
                                     vision_transformer,
                                     vision_transformer_hybrid)
from cotnet_tpu_torch.utils.convert import (jax_to_torch_state_dict,  # noqa: E402
                                            model_family)

TABLES = {"vit": VIT_VARIANTS, "resnetv2": RESNETV2_VARIANTS,
          "vit_hybrid": VIT_HYBRID_VARIANTS}
# the test_models.py PARAM_EXACT rows of the family
PARAM_EXACT = {"vit_tiny_patch16_224": 5717416,
               "vit_base_patch16_224": 86567656,
               "deit_tiny_patch16_224": 5717416,
               "deit_base_distilled_patch16_224": 87338192}


CFGS = {**vision_transformer.default_cfgs, **resnetv2.default_cfgs,
        **vision_transformer_hybrid.default_cfgs}


def distinct_rows():
    """(family, name) of the first key of each distinct row of the tables,
    as ``test_torch_resnet_zoo.py`` takes them: a key whose row another
    key has (a 384 px or in21k twin) differs only in its configured input
    size, which sizes the position embedding, or class count."""
    seen, rows = set(), []
    for family, table in TABLES.items():
        for name, row in table.items():
            sig = (family, repr(sorted(row.items())))
            if sig not in seen:
                seen.add(sig)
                rows.append((family, name))
    return rows


ROWS = distinct_rows()


def jax_converter_names(sd):
    """The port's timm keys renamed to those the JAX converter looks up,
    where the two differ (see the module docstring)."""
    out = {}
    for key, v in sd.items():
        m = re.match(r"stem\.(conv|norm)(\d)\.(.*)$", key)
        if m:
            kind, i, leaf = m.groups()
            key = (f"stem_conv3.{leaf}" if (kind, i) == ("conv", "3")
                   and "stem.norm3.weight" not in sd
                   else f"stem_c{i}.{kind}.{leaf}")
        if key.startswith("patch_embed.backbone.") and (
                "patch_embed.backbone.conv1.0.weight" in sd):
            stem = {"0": "conv1_0", "1": "bn1_0", "3": "conv1_1",
                    "4": "bn1_1", "6": "conv1_2"}
            key = re.sub(r"backbone\.conv1\.(\d)\.",
                         lambda m: f"backbone.{stem[m.group(1)]}.", key)
            key = re.sub(r"backbone\.layer(\d)\.(\d+)\.",
                         r"backbone.layer\1_\2.", key)
            key = key.replace(".downsample.1.", ".downsample.conv.").replace(
                ".downsample.2.", ".downsample.1.")
        out[key] = v
    return out


def test_the_tables_register_75_keys_in_the_port():
    names = [n for t in TABLES.values() for n in t]
    assert len(names) == 75 and len(set(names)) == 75
    assert set(names) <= set(list_models())
    assert len(list_models()) == 231
    assert {model_family(n) for n in names} == set(TABLES)
    assert len(ROWS) == 44


@pytest.mark.parametrize("name", sorted(PARAM_EXACT))
def test_parameter_counts_match_the_jax_package(name):
    with torch.device("meta"):
        port = model_entrypoint(name)()
    assert sum(p.numel() for p in port.parameters()) == PARAM_EXACT[name]


@pytest.mark.parametrize("family,name", ROWS)
def test_state_dict_converts_strictly(family, name):
    cfg = CFGS[name]
    size, nc = cfg["input_size"][-1], cfg["num_classes"]
    with torch.device("meta"):
        port = model_entrypoint(name)(num_classes=nc)
    sd = {k: np.broadcast_to(np.float32(0), tuple(v.shape))
          for k, v in port.state_dict().items()}
    model = jax_create_model(name, num_classes=nc)
    shapes = jax.eval_shape(
        lambda r, x: model.init({"params": r}, x, training=False),
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3), jnp.float32))
    out = convert_torch_state_dict(jax_converter_names(sd), shapes,
                                   adapter=FAMILY_ADAPTERS[family],
                                   strict=True)
    n_jax = sum(int(np.prod(s.shape)) for s in
                jax.tree_util.tree_leaves(shapes["params"]))
    n_port = sum(p.numel() for p in port.parameters())
    assert n_port == n_jax
    # every port tensor is used (the batch counters have no flax
    # counterpart)
    used = sum(len(jax.tree_util.tree_leaves(out[c]))
               for c in ("params", "batch_stats"))
    assert used == sum(1 for k in sd if not k.endswith("num_batches_tracked"))
    del out
    # and back: the JAX names through the port's converter give the
    # port's keys and shapes
    flat = {f"{c}/" + "/".join(k): np.broadcast_to(np.float32(0), v.shape)
            for c in ("params", "batch_stats")
            for k, v in flatten_dict(shapes.get(c, {})).items()}
    back = jax_to_torch_state_dict(flat, family=model_family(name))
    want = {k: tuple(v.shape) for k, v in sd.items()}
    assert {k: tuple(v.shape) for k, v in back.items()} == want
