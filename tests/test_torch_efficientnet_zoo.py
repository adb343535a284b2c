"""Every architecture of the JAX package's ``EFFICIENTNET_VARIANTS`` (89
table rows and the ``mnasnet_b1`` / ``mnasnet_a1`` aliases: 91 keys) in
the PyTorch port: the port's state_dict, built on the meta device, carries
strictly onto the JAX model's variables (``convert_torch_state_dict(
strict=True)`` with the efficientnet adapter, against ``jax.eval_shape``
of its init at 64 px), which checks every key and every shape, and every
tensor of the port's state_dict is used; the JAX variables carry back
through the port's ``jax_to_torch_state_dict(family="efficientnet")`` onto
the port's own keys and shapes.  The 20 efficientnet ``PARAM_EXACT``
counts of ``tests/test_models.py``; the seeded weights of
``efficientnet_b0``, ``mixnet_s`` and ``efficientnet_cc_b0_4e`` there and
back with the same bits; ``load_checkpoint_into``; the pruned keys'
warning.

The port's tensors are zero-stride arrays of their shapes: nothing of the
weights is made or run (the ``l2`` rows hold about 480M parameters).
"""

import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax.traverse_util import flatten_dict  # noqa: E402

from cotnet_tpu.models import create_model as jax_create_model  # noqa: E402
from cotnet_tpu.models.efficientnet import EFFICIENTNET_VARIANTS  # noqa: E402
from cotnet_tpu.utils.convert import (FAMILY_ADAPTERS,  # noqa: E402
                                      convert_torch_state_dict)
from cotnet_tpu_torch.models import (create_model, list_models,  # noqa: E402
                                     model_entrypoint)
from cotnet_tpu_torch.utils.convert import (jax_to_torch_state_dict,  # noqa: E402
                                            load_checkpoint_into,
                                            model_family)

ADAPTER = FAMILY_ADAPTERS["efficientnet"]
# the test_models.py PARAM_EXACT rows of the efficientnet superfamily
PARAM_EXACT = {
    "efficientnet_b0": 5288548, "efficientnet_b2": 9109994,
    "efficientnet_es": 5438392, "efficientnet_lite0": 4652008,
    "efficientnet_cc_b0_4e": 13314116, "efficientnet_cc_b1_8e": 39715968,
    "mixnet_s": 4134606, "mixnet_m": 5014382, "mixnet_l": 7329252,
    "mnasnet_050": 2218512, "mnasnet_100": 4383312, "semnasnet_100": 3887038,
    "mnasnet_small": 2030264, "mobilenetv2_100": 3504872,
    "mobilenetv2_110d": 4516520, "mobilenetv2_140": 6108776,
    "fbnetc_100": 5572200, "spnasnet_100": 4421616,
    "tf_efficientnet_b0": 5288548, "tf_mixnet_m": 5014382}


def distinct_rows():
    """The first key of each distinct row of the table."""
    seen, keys = set(), []
    for name, row in EFFICIENTNET_VARIANTS.items():
        sig = repr(sorted(row.items()))
        if sig not in seen:
            seen.add(sig)
            keys.append(name)
    return keys


ROWS = distinct_rows()
# the row entries that change no variable's name or shape: rows that differ
# only in these share the JAX model's variable tree, traced once
_NO_SHAPE = ("pad_type", "bn_eps", "drop_rate", "pruned")


def _structure(name):
    row = EFFICIENTNET_VARIANTS.get(name)
    return repr(sorted((k, v) for k, v in row.items() if k not in _NO_SHAPE))


_TRACED = {}


def jax_shapes(name):
    """``jax.eval_shape`` of the JAX model's init at 64 px, traced once per
    variable structure."""
    key = _structure(name)
    if key not in _TRACED:
        model = jax_create_model(name)
        _TRACED[key] = jax.eval_shape(
            lambda r, x: model.init({"params": r}, x, training=False),
            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.float32))
    return _TRACED[key]


def test_the_module_registers_91_keys_in_the_port():
    names = list_models(module="efficientnet")
    assert len(EFFICIENTNET_VARIANTS) == 89 and len(ROWS) == 69
    assert sorted(names) == sorted([*EFFICIENTNET_VARIANTS, "mnasnet_b1",
                                    "mnasnet_a1"])
    assert len(list_models()) == 418
    assert {model_family(n) for n in names} == {"efficientnet"}


@pytest.mark.parametrize("name", sorted(PARAM_EXACT))
def test_parameter_counts_match_the_jax_package(name):
    with torch.device("meta"):
        port = model_entrypoint(name)()
    assert sum(p.numel() for p in port.parameters()) == PARAM_EXACT[name]


@pytest.mark.parametrize("name", ROWS)
def test_state_dict_converts_strictly(name):
    with torch.device("meta"):
        port = model_entrypoint(name)()
    sd = {k: np.broadcast_to(np.float32(0), tuple(v.shape))
          for k, v in port.state_dict().items()}
    shapes = jax_shapes(name)
    out = convert_torch_state_dict(sd, shapes, adapter=ADAPTER, strict=True)
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
    back = jax_to_torch_state_dict(flat, family=model_family(name))
    assert {k: tuple(v.shape) for k, v in back.items()} == {
        k: tuple(v.shape) for k, v in sd.items()}


@pytest.mark.parametrize("name", ["efficientnet_b0", "mixnet_s",
                                  "efficientnet_cc_b0_4e"])
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
        adapter=ADAPTER, strict=True)
    flat = {f"{c}/" + "/".join(k): v for c in ("params", "batch_stats")
            for k, v in flatten_dict(out[c]).items()}
    back = jax_to_torch_state_dict(flat, family=model_family(name))
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert torch.equal(back[k].to(v.dtype), v), k


def test_checkpoint_loads_into_the_port(tmp_path):
    src = create_model("efficientnet_cc_b0_4e", device="cpu", seed=1)
    path = str(tmp_path / "cc.pth.tar")
    torch.save({"state_dict": src.state_dict()}, path)
    dst = create_model("efficientnet_cc_b0_4e", device="cpu", seed=2)
    result = load_checkpoint_into(dst, path)
    assert not result.missing_keys and not result.unexpected_keys
    for k, v in src.state_dict().items():
        assert torch.equal(dst.state_dict()[k], v), k


@pytest.mark.parametrize("name", ["efficientnet_b1_pruned",
                                  "efficientnet_b2_pruned",
                                  "efficientnet_b3_pruned"])
def test_pruned_keys_warn_as_the_jax_package_does(name, caplog):
    with caplog.at_level(logging.WARNING):
        jax_create_model(name)
    want = [r.getMessage() for r in caplog.records if name in r.getMessage()]
    caplog.clear()
    with caplog.at_level(logging.WARNING), torch.device("meta"):
        model_entrypoint(name)()
    got = [r.getMessage() for r in caplog.records if name in r.getMessage()]
    assert want and got == want
