"""Every architecture of the JAX package's ``CAIT_VARIANTS`` (11 keys),
``XCIT_VARIANTS`` (42), ``SWIN_VARIANTS`` (10) and ``PIT_VARIANTS`` (8) in
the PyTorch port: the port's state_dict, built on the meta device, carries
strictly onto the JAX model's variables (``convert_torch_state_dict(
strict=True)`` with the family's adapter, against ``jax.eval_shape`` of its
init at the key's configured input size and class count), which checks
every key and every shape; every key of the port's state_dict is used;
and the JAX variables carry back through the port's
``jax_to_torch_state_dict(family=...)`` onto the port's own keys and
shapes.  Swin's ``relative_position_index`` is a non-persistent buffer, so
the state_dict holds exactly the parameters and the BN statistics.

The port's tensors are zero-stride arrays of their shapes: nothing of the
weights is made or run.  The JAX converter copies each array into f32, and
the way back makes each one contiguous, so a row holds its parameters at
most twice in memory (cait_m48_448's 356M the most).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax.traverse_util import flatten_dict  # noqa: E402

from cotnet_tpu.models import create_model as jax_create_model  # noqa: E402
from cotnet_tpu.models.cait import CAIT_VARIANTS  # noqa: E402
from cotnet_tpu.models.pit import PIT_VARIANTS  # noqa: E402
from cotnet_tpu.models.swin_transformer import SWIN_VARIANTS  # noqa: E402
from cotnet_tpu.models.xcit import XCIT_VARIANTS  # noqa: E402
from cotnet_tpu.utils.convert import (FAMILY_ADAPTERS,  # noqa: E402
                                      convert_torch_state_dict)
from cotnet_tpu_torch.models import (cait, list_models,  # noqa: E402
                                     model_entrypoint, pit,
                                     swin_transformer, xcit)
from cotnet_tpu_torch.utils.convert import (jax_to_torch_state_dict,  # noqa: E402
                                            model_family)

TABLES = {"cait": CAIT_VARIANTS, "xcit": XCIT_VARIANTS,
          "swin": SWIN_VARIANTS, "pit": PIT_VARIANTS}
CFGS = {**cait.default_cfgs, **xcit.default_cfgs,
        **swin_transformer.default_cfgs, **pit.default_cfgs}
# the test_models.py PARAM_EXACT rows of the four families
PARAM_EXACT = {"swin_tiny_patch4_window7_224": 28288354,
               "swin_large_patch4_window7_224": 196532476,
               "xcit_nano_12_p16_224": 3053224,
               "xcit_small_12_p16_224": 26253304,
               "cait_xxs24_224": 11956264, "cait_s24_224": 46916200,
               "pit_ti_224": 4847272, "pit_b_distilled_224": 74790096}


def distinct_rows():
    """(family, name) of the first key of each distinct row of the tables:
    a key whose row another key has (a 384 px, in22k or ``_dist`` twin)
    differs only in its configured input size, which sizes CaiT's position
    embedding, or class count."""
    seen, rows = set(), []
    for family, table in TABLES.items():
        for name, row in table.items():
            sig = (family, repr(sorted(row.items())))
            if sig not in seen:
                seen.add(sig)
                rows.append((family, name))
    return rows


ROWS = distinct_rows()


def test_the_tables_register_71_keys_in_the_port():
    names = [n for t in TABLES.values() for n in t]
    assert len(names) == 71 and len(set(names)) == 71
    assert set(names) <= set(list_models())
    assert len(list_models()) == 231
    assert {n: model_family(n) for n in names} == {
        n: f for f, t in TABLES.items() for n in t}
    assert [sum(f == family for f, _ in ROWS) for family in TABLES] == [
        7, 14, 6, 8]


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
    out = convert_torch_state_dict(sd, shapes, adapter=FAMILY_ADAPTERS[family],
                                   strict=True)
    n_jax = sum(int(np.prod(s.shape)) for s in
                jax.tree_util.tree_leaves(shapes["params"]))
    assert sum(p.numel() for p in port.parameters()) == n_jax
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
