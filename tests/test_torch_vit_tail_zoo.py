"""Every architecture of the JAX package's ConViT (3 keys), TNT (2),
``TWINS_VARIANTS`` (6), Visformer (2), ``LEVIT_VARIANTS`` (5) and
``COAT_VARIANTS`` (5) in the PyTorch port: the port's state_dict, built on
the meta device, carries strictly onto the JAX model's variables
(``convert_torch_state_dict(strict=True)`` with the family's adapter,
against ``jax.eval_shape`` of its init at 224 px), which checks every key
and every shape; every tensor of the port's state_dict is used but for
LeViT's ``attention_bias_idxs`` buffers, and each of CoaT's shared tensors
once under its several names; and the JAX variables carry back through the
port's ``jax_to_torch_state_dict(family=...)`` onto the port's own keys and
shapes, the buffers and the aliases included; one key of each module
(both CoaT kinds) carries its seeded weights there and back with the same
bits.  The ``PARAM_EXACT`` counts
of ``tests/test_models.py`` (``parameters()`` counts a shared tensor once),
and ``load_checkpoint_into`` with LeViT's index buffers in the file and
without them.

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
from cotnet_tpu.models.coat import COAT_VARIANTS  # noqa: E402
from cotnet_tpu.models.levit import LEVIT_VARIANTS  # noqa: E402
from cotnet_tpu.models.twins import TWINS_VARIANTS  # noqa: E402
from cotnet_tpu.utils.convert import (FAMILY_ADAPTERS,  # noqa: E402
                                      convert_torch_state_dict)
from cotnet_tpu_torch.models import (create_model, list_models,  # noqa: E402
                                     model_entrypoint)
from cotnet_tpu_torch.utils.convert import (jax_to_torch_state_dict,  # noqa: E402
                                            load_checkpoint_into,
                                            model_family)

TABLES = {"convit": ("convit_tiny", "convit_small", "convit_base"),
          "tnt": ("tnt_s_patch16_224", "tnt_b_patch16_224"),
          "twins": tuple(TWINS_VARIANTS),
          "visformer": ("visformer_tiny", "visformer_small"),
          "levit": tuple(LEVIT_VARIANTS), "coat": tuple(COAT_VARIANTS)}
ADAPTERS = {"convit": "vit", "tnt": "tnt", "twins": "twins",
            "visformer": "visformer", "levit": "levit", "coat": "coat"}
ROWS = [(module, name) for module, names in TABLES.items()
        for name in names]
# the test_models.py PARAM_EXACT rows of the six families
PARAM_EXACT = {"coat_tiny": 5498540, "coat_lite_tiny": 5721960,
               "coat_mini": 10337004, "convit_tiny": 5710512,
               "tnt_s_patch16_224": 23755336,
               "twins_pcpvt_small": 24106216, "twins_svt_small": 24060776,
               "visformer_tiny": 10321368, "levit_128": 8828168,
               "levit_384": 38358300}


def test_the_six_modules_register_23_keys_in_the_port():
    names = [n for _, n in ROWS]
    assert len(names) == 23 and len(set(names)) == 23
    assert set(names) <= set(list_models())
    assert len(list_models()) == 418
    assert {n: model_family(n) for n in names} == {
        n: ADAPTERS[m] for m, n in ROWS}


@pytest.mark.parametrize("name", sorted(PARAM_EXACT))
def test_parameter_counts_match_the_jax_package(name):
    with torch.device("meta"):
        port = model_entrypoint(name)()
    assert sum(p.numel() for p in port.parameters()) == PARAM_EXACT[name]


@pytest.mark.parametrize("module,name", ROWS)
def test_state_dict_converts_strictly(module, name):
    with torch.device("meta"):
        port = model_entrypoint(name)()
    tensors = port.state_dict(keep_vars=True)
    sd = {k: np.broadcast_to(np.zeros((), np.float32), tuple(v.shape))
          for k, v in tensors.items()}
    model = jax_create_model(name)
    shapes = jax.eval_shape(
        lambda r, x: model.init({"params": r}, x, training=False),
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3), jnp.float32))
    out = convert_torch_state_dict(
        sd, shapes, adapter=FAMILY_ADAPTERS[ADAPTERS[module]], strict=True)
    n_jax = sum(int(np.prod(s.shape)) for s in
                jax.tree_util.tree_leaves(shapes["params"]))
    assert sum(p.numel() for p in port.parameters()) == n_jax
    # every distinct port tensor is used (the batch counters and LeViT's
    # bias indices have no flax counterpart; TNT's qk and v make one fused
    # flax qkv)
    used = sum(len(jax.tree_util.tree_leaves(out[c]))
               for c in ("params", "batch_stats"))
    distinct = {id(v) for k, v in tensors.items()
                if not k.endswith(("num_batches_tracked",
                                   "attention_bias_idxs"))}
    fused = sum(k.endswith(".qk.weight") for k in tensors) \
        if module == "tnt" else 0
    assert used + fused == len(distinct)
    del out
    # and back: the JAX names through the port's converter give every key
    # of the port, with its shape
    flat = {f"{c}/" + "/".join(k): np.broadcast_to(np.float32(0), v.shape)
            for c in ("params", "batch_stats")
            for k, v in flatten_dict(shapes.get(c, {})).items()}
    back = jax_to_torch_state_dict(flat, family=model_family(name))
    assert {k: tuple(v.shape) for k, v in back.items()} == {
        k: tuple(v.shape) for k, v in sd.items()}


@pytest.mark.parametrize("with_buffers", [True, False])
def test_levit_checkpoint_loads_with_or_without_index_buffers(
        tmp_path, with_buffers):
    src = create_model("levit_128s", device="cpu", seed=1)
    sd = {k: v for k, v in src.state_dict().items()
          if with_buffers or not k.endswith("attention_bias_idxs")}
    assert any(k.endswith("attention_bias_idxs") for k in sd) == with_buffers
    path = str(tmp_path / "levit.pth.tar")
    torch.save({"state_dict": sd}, path)
    dst = create_model("levit_128s", device="cpu", seed=2)
    result = load_checkpoint_into(dst, path)
    assert not result.missing_keys and not result.unexpected_keys
    for k, v in src.state_dict().items():
        assert torch.equal(dst.state_dict()[k], v), k


@pytest.mark.parametrize("name", ["convit_tiny", "tnt_s_patch16_224",
                                  "twins_pcpvt_small", "visformer_tiny",
                                  "levit_128s", "coat_lite_tiny",
                                  "coat_tiny"])
def test_round_trip_through_the_jax_converter_is_exact(name):
    """The port's seeded weights through the JAX converter (strict) and
    back through the port's: every key, the aliases and index buffers
    included, comes back with the same bits."""
    port = create_model(name, device="cpu", seed=3)
    sd = port.state_dict()
    model = jax_create_model(name)
    shapes = jax.eval_shape(
        lambda r, x: model.init({"params": r}, x, training=False),
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3), jnp.float32))
    module = next(m for m, names in TABLES.items() if name in names)
    out = convert_torch_state_dict(
        {k: v.numpy() for k, v in sd.items()}, shapes,
        adapter=FAMILY_ADAPTERS[ADAPTERS[module]], strict=True)
    flat = {f"{c}/" + "/".join(k): v for c in ("params", "batch_stats")
            for k, v in flatten_dict(out[c]).items()}
    back = jax_to_torch_state_dict(flat, family=model_family(name))
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert torch.equal(back[k].to(v.dtype), v), k
