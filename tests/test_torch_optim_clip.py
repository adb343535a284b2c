"""Parity of the port's gradient clipping and Lookahead with the JAX
package's optax chains: each clip mode alone and under five optimizers,
Lookahead's sync and ``sync_lookahead``, over the small CoT net's converted
parameters from the same seeded numpy gradients, in f32 on the CPU (the
fixtures and helpers are ``test_torch_optim.py``'s).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cotnet_tpu.train import optim as jax_optim  # noqa: E402
from cotnet_tpu.train.state import TrainState as JaxTrainState  # noqa: E402
from cotnet_tpu_torch.train import loss as port_loss  # noqa: E402
from cotnet_tpu_torch.train import optim as port_optim  # noqa: E402
from cotnet_tpu_torch.train import step as port_step  # noqa: E402
from cotnet_tpu_torch.train.state import TrainState  # noqa: E402
from cotnet_tpu_torch.utils.convert import jax_to_torch_state_dict  # noqa: E402
from test_torch_optim import (  # noqa: E402
    CLIP,
    WEIGHT_DECAY,
    as_port,
    assert_params_close,
    check_three_steps,
    jax_params,
    run_jax,
    run_port,
    tree,  # noqa: F401  (the fixture)
)


@pytest.mark.parametrize("clip", sorted(CLIP))
@pytest.mark.parametrize("name", ["sgd", "adam", "adafactor", "lamb",
                                  "adamp"])
def test_clipped_optimizer_three_steps_match_optax(tree, name, clip):
    """Three clipped updates (the clip first, as in the JAX chain), at the
    tolerances of ``test_optimizer_three_steps_match_optax``."""
    check_three_steps(tree, name, clip)


@pytest.mark.parametrize("name", ["lookahead_adam", "sgd_lookahead",
                                  "lookahead_lamb"])
def test_lookahead_and_sync_match_jax(tree, name):
    """Seven steps, so the sync of every sixth fires, with norm clipping
    inside the wrapper, then the epoch-end ``sync_lookahead`` on both
    sides; the wrapper's state_dict holds the slow weights and the count
    and restores them."""
    flat, grads = tree
    cfg = dict(opt=name, weight_decay=WEIGHT_DECAY, clip_mode="norm",
               clip_grad=CLIP["norm"])
    rtol = 1e-5 if name.endswith("lamb") else 1e-6
    start = jax_to_torch_state_dict(flat)
    ref, opt_state = run_jax(cfg, flat, grads, 7)
    got, optimizer = run_port(cfg, flat, grads, 7)
    assert isinstance(optimizer, port_optim.Lookahead)
    assert optimizer.count == 7
    assert_params_close(got, as_port(ref), start, rtol)

    jstate = JaxTrainState(step=jnp.asarray(7), params=ref, batch_stats={},
                           opt_state=opt_state)
    ref = jax_optim.sync_lookahead(jstate).params
    saved = optimizer.state_dict()
    state = port_optim.sync_lookahead(TrainState(model=None,
                                                 optimizer=optimizer))
    assert state.optimizer is optimizer
    assert_params_close(got, as_port(ref), start, rtol)
    assert saved["count"] == 7 and len(saved["slow"]) == len(got)
    optimizer.load_state_dict(saved)
    assert optimizer.count == 7


def test_sync_lookahead_without_the_wrapper_is_a_no_op():
    p = torch.ones(2, 2, requires_grad=True)
    optimizer = port_optim.create_optimizer(dict(opt="adam"), [p])
    state = TrainState(model=None, optimizer=optimizer)
    assert port_optim.sync_lookahead(state) is state
    assert torch.equal(p.detach(), torch.ones(2, 2))


@pytest.mark.parametrize("mode", ["norm", "value", "agc"])
def test_clip_gradients_match_optax(tree, mode):
    """The clipped gradients themselves: optax's global norm clip (not
    ``clip_grad_norm_``'s ``norm + 1e-6``), the clamp, and AGC's unit norms
    taken per output channel of OIHW / ``[out, in]`` as optax takes them
    over HWIO's axes 0-2 and Dense's axis 0 (rtol 1e-6)."""
    flat, grads = tree
    value = {"norm": 20.0, "value": 0.5, "agc": 0.01}[mode]
    tx = jax_optim.clip_transform(mode, value)
    # jitted, as the JAX train step runs it (one compile, not one for each
    # operation and tensor shape)
    ref, _ = jax.jit(tx.update)(jax_params(grads[1]),
                                tx.init(jax_params(flat)), jax_params(flat))
    params = jax_to_torch_state_dict(flat)
    unclipped = jax_to_torch_state_dict(grads[1])
    for k, g in unclipped.items():
        params[k].grad = g.clone()
    port_optim.clip_gradients(list(params.values()), mode, value)
    clipped = 0
    for k, r in as_port(ref).items():
        got = params[k].grad.numpy()
        np.testing.assert_allclose(got, r.numpy(), rtol=1e-6, atol=1e-9,
                                   err_msg=k)
        clipped += not np.array_equal(got, unclipped[k].numpy())
    assert clipped == len(params)


def test_clip_keeps_the_step_grad_norm_before_clipping():
    """Clipping runs inside ``optimizer.step`` (a step pre-hook), so the
    train step's ``grad_norm`` is the norm before it, as the JAX step's."""
    torch.manual_seed(0)
    model = torch.nn.Linear(4, 3)
    optimizer = port_optim.create_optimizer(
        dict(opt="adamw", clip_mode="norm", clip_grad=1e-3),
        model.parameters())
    step = port_step.make_train_step(model, optimizer, lambda s: 0.1,
                                     port_loss.cross_entropy)
    x = torch.randn(8, 4)
    labels = torch.arange(8) % 3
    _, m = step(TrainState(model=model, optimizer=optimizer),
                {"image": x, "label": labels})
    assert float(m["grad_norm"]) > 1e-2
    norm = port_optim.global_norm([p.grad for p in model.parameters()])
    np.testing.assert_allclose(float(norm), 1e-3, rtol=1e-5)
