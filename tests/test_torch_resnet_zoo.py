"""Every architecture of the JAX package's ``RESNET_VARIANTS`` (68 keys, 48
distinct rows) in the PyTorch port: the port's state_dict, built on the
meta device, carries strictly onto the JAX model's variables
(``convert_torch_state_dict(strict=True)`` against ``jax.eval_shape`` of its
init at 64 px), which checks every key and every shape.  The port's
tensors are zero-stride arrays of their shapes: nothing of the weights is
made or run.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cotnet_tpu.models import create_model as jax_create_model  # noqa: E402
from cotnet_tpu.models.resnet import RESNET_VARIANTS  # noqa: E402
from cotnet_tpu.utils.convert import convert_torch_state_dict  # noqa: E402
from cotnet_tpu_torch.models import model_entrypoint  # noqa: E402


def distinct_rows():
    """The first key of each distinct row of the table."""
    seen, keys = set(), []
    for name, row in RESNET_VARIANTS.items():
        sig = repr(sorted((k, getattr(v, "__name__", v))
                          for k, v in row.items()))
        if sig not in seen:
            seen.add(sig)
            keys.append(name)
    return keys


ROWS = distinct_rows()


def test_the_table_has_48_distinct_rows():
    assert len(RESNET_VARIANTS) == 68 and len(ROWS) == 48


@pytest.mark.parametrize("name", ROWS)
def test_state_dict_converts_strictly(name):
    with torch.device("meta"):
        port = model_entrypoint(name)()
    sd = {k: np.broadcast_to(np.float32(0), tuple(v.shape))
          for k, v in port.state_dict().items()}
    model = jax_create_model(name)
    shapes = jax.eval_shape(
        lambda r, x: model.init({"params": r}, x, training=False),
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.float32))
    avg_down = RESNET_VARIANTS[name].get("avg_down", False)
    out = convert_torch_state_dict(sd, shapes, avg_down=avg_down,
                                   strict=True)
    n_jax = sum(int(np.prod(s.shape)) for s in
                jax.tree_util.tree_leaves(shapes["params"]))
    n_port = sum(p.numel() for p in port.parameters())
    assert n_port == n_jax
    # every port tensor is used: params, running means and variances (the
    # batch counters have no flax counterpart)
    used = sum(len(jax.tree_util.tree_leaves(out[c]))
               for c in ("params", "batch_stats"))
    assert used == sum(1 for k in sd if not k.endswith("num_batches_tracked"))
