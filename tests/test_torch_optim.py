"""Parity of the port's optimizers with the JAX package's optax chains:
every optimizer name and AdaHessian's update, each over the small CoT net's
converted parameters (plus one conv large enough for Adafactor to factor)
from the same seeded numpy gradients, in f32 on the CPU.  Clipping and
Lookahead are in ``test_torch_optim_clip.py``; the second-order step, the
schedules, the losses, mixup's ``pair`` mode and whole train steps in
``test_torch_train_stack.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from flax.traverse_util import flatten_dict  # noqa: E402

from cotnet_tpu.models.cotnet import CotBottleneck as JaxCotBottleneck  # noqa: E402
from cotnet_tpu.models.resnet import ResNet as JaxResNet  # noqa: E402
from cotnet_tpu.train import optim as jax_optim  # noqa: E402
from cotnet_tpu_torch.train import optim as port_optim  # noqa: E402
from cotnet_tpu_torch.utils.convert import jax_to_torch_state_dict  # noqa: E402
from test_torch_cotnet import SMALL_NET, random_variables, unflatten  # noqa: E402

# ---- the optimizers on the small CoT net's parameters ---------------------

# the JAX package's names (create_optimizer, cotnet_tpu/train/optim.py)
OPTIMIZERS = ("sgd", "nesterov", "momentum", "adam", "adamw", "nadam",
              "radam", "adamp", "sgdp", "adadelta", "rmsprop", "rmsproptf",
              "rmsprop_tf", "novograd", "nvnovograd", "adafactor", "lamb",
              "lars")
FUSED = ("fusedsgd", "fusedmomentum", "fusedadam", "fusedadamw", "fusedlamb",
         "fusednovograd")
# a changing LR, indexed by the optimizer's update count
LRS = (0.1, 0.25, 0.05, 0.2, 0.15, 0.1, 0.05, 0.3)
WEIGHT_DECAY = 1e-3
# clip thresholds that clip every step of these gradients
CLIP = {"norm": 20.0, "value": 0.5, "agc": 0.01}
# optimizers whose update takes sums over a tensor (the trust ratio, the
# AdamP / SGDP projection), which run over HWIO in JAX and OIHW here
REDUCTION_ORDER = ("adamp", "sgdp", "lamb", "fusedlamb", "lars")


@pytest.fixture(scope="module")
def tree():
    """The small CoT net's parameters (flax names, numpy) plus one 3x3 conv
    of 128 -> 256 channels, where Adafactor factors its second moment, and
    three gradients of them.  Each gradient element is at least 0.5 of its
    step's scale away from zero, and the decay (1e-3 of a parameter) is far
    below it: Adam's first updates are ``g / (|g| + eps)``, so where a
    decayed gradient nears zero, a rounding difference of one ulp in its
    sum (XLA's and torch's) moves the update by up to the LR."""
    x = np.zeros((2, 64, 64, 3), np.float32)
    _, flat = random_variables(JaxResNet(block=JaxCotBottleneck, **SMALL_NET),
                               jnp.asarray(x), seed=6)
    flat = {k: v for k, v in flat.items() if k.startswith("params/")}
    rng = np.random.RandomState(0)
    flat["params/extra/kernel"] = (
        rng.randn(3, 3, 128, 256) / np.sqrt(9 * 128)).astype(np.float32)
    grads = [{k: (np.sign(rng.randn(*v.shape)) * (0.5 + rng.rand(*v.shape))
                  * (0.1 + i)).astype(np.float32) for k, v in flat.items()}
             for i in range(len(LRS))]
    return flat, grads


def jax_params(flat):
    return unflatten(flat)["params"]


def as_port(params) -> dict:
    """A JAX params tree -> the port's tensors by state_dict name."""
    return jax_to_torch_state_dict(
        {"params/" + k: np.asarray(v)
         for k, v in flatten_dict(params, sep="/").items()})


# ``optax.apply_updates`` jitted once for the module: one compile for the
# tree, not one for each of its tensor shapes
_apply_updates = jax.jit(optax.apply_updates)


def run_jax(cfg, flat, grads, steps):
    tx = jax_optim.create_optimizer(cfg, lambda c: jnp.asarray(LRS)[c])
    params = jax_params(flat)
    opt_state = tx.init(params)
    update = jax.jit(lambda g, s, p: tx.update(g, s, p))
    for g in grads[:steps]:
        updates, opt_state = update(jax_params(g), opt_state, params)
        params = _apply_updates(params, updates)
    return params, opt_state


def run_port(cfg, flat, grads, steps):
    params = {k: v.clone().requires_grad_()
              for k, v in jax_to_torch_state_dict(flat).items()}
    optimizer = port_optim.create_optimizer(cfg, params.values())
    for lr, g in zip(LRS, grads[:steps]):
        for group in optimizer.param_groups:
            group["lr"] = lr
        for k, v in jax_to_torch_state_dict(g).items():
            params[k].grad = v.clone()
        optimizer.step()
    return params, optimizer


def assert_params_close(got, ref, start, rtol):
    """Every tensor within ``rtol`` of the reference, relative to each
    element and to the tensor's largest total update (an update of up to
    0.3 a step is a few ulps of f32 where a parameter crosses zero), and
    every tensor moved."""
    for k, r in ref.items():
        r, s = r.numpy(), start[k].numpy()
        moved = np.abs(r - s).max()
        assert moved > 0, k
        np.testing.assert_allclose(got[k].detach().numpy(), r, rtol=rtol,
                                   atol=rtol * moved, err_msg=k)


def check_three_steps(tree, name, clip=None):
    """Three updates under a changing LR from the same converted
    parameters and gradients, against the JAX package's optax chain (the
    tolerances: ``test_optimizer_three_steps_match_optax``)."""
    flat, grads = tree
    cfg = dict(opt=name, weight_decay=WEIGHT_DECAY, momentum=0.9)
    if clip:
        cfg.update(clip_mode=clip, clip_grad=CLIP[clip])
    ref, _ = run_jax(cfg, flat, grads, 3)
    got, optimizer = run_port(cfg, flat, grads, 3)
    rtol = 1e-5 if name in REDUCTION_ORDER else 1e-6
    assert_params_close(got, as_port(ref), jax_to_torch_state_dict(flat),
                        rtol)
    state_devices = {t.device.type for s in optimizer.state.values()
                     for t in s.values() if torch.is_tensor(t)}
    assert state_devices <= {"cpu"}


@pytest.mark.parametrize("name", OPTIMIZERS + FUSED)
def test_optimizer_three_steps_match_optax(tree, name):
    """Three updates under a changing LR from the same converted
    parameters and gradients, against the JAX package's optax chain.
    rtol 1e-6 (with the same bound on the update's size) where the f32
    operations and their order are the same: they are in the Adam family,
    RMSprop, Novograd, Adafactor, Adadelta and SGD (largest measured 0.83e-6
    of Adafactor, summing a factored moment over other axes).  1e-5 where a
    sum over a tensor runs in another order, HWIO against OIHW: AdamP /
    SGDP's projection, the trust ratios of LAMB and LARS (largest measured
    4.9e-6, LAMB under AGC)."""
    check_three_steps(tree, name)


def test_radam_rectifies_after_the_threshold(tree):
    """RAdam's rectified update, which starts once the approximated SMA's
    length reaches 5 (the sixth step at b2 = 0.999): eight steps against
    optax (rtol 1e-6)."""
    flat, grads = tree
    cfg = dict(opt="radam", weight_decay=WEIGHT_DECAY)
    ref, _ = run_jax(cfg, flat, grads, 8)
    got, _ = run_port(cfg, flat, grads, 8)
    assert_params_close(got, as_port(ref), jax_to_torch_state_dict(flat),
                        1e-6)


def test_adafactor_factors_by_size(tree):
    """The 3x3 conv of 128 -> 256 has a row and a column moment over its
    two largest dimensions (picked by size, as optax does); the small net's
    tensors below 128 in their second largest dimension keep a full one."""
    flat, grads = tree
    got, optimizer = run_port(dict(opt="adafactor"), flat, grads, 1)
    state = optimizer.state[got["extra.weight"]]
    assert set(state) == {"v_row", "v_col"}
    assert {state["v_row"].shape, state["v_col"].shape} == {
        (256, 3, 3), (128, 3, 3)}
    assert set(optimizer.state[got["conv1.weight"]]) == {"v"}
    assert port_optim._factored_dims((256, 128, 3, 3), 128) == (1, 0)
    assert port_optim._factored_dims((64, 128, 3, 3), 128) is None


def test_create_optimizer_names_and_errors():
    """The unknown names still raise ValueError; adahessian takes neither
    Lookahead nor the clipping and decays every parameter; the apex names
    and the Lookahead forms build their optimizers."""
    p = [torch.zeros(2, 2, requires_grad=True), torch.zeros(2,
                                                            requires_grad=True)]
    for name in ("nope", "lookahead_nope", "adam_lookahead_x"):
        with pytest.raises(ValueError):
            port_optim.create_optimizer(dict(opt=name), p)
    with pytest.raises(ValueError):
        port_optim.create_optimizer(dict(opt="sgd", clip_mode="nope",
                                         clip_grad=1.0), p)
    ah = port_optim.create_optimizer(dict(
        opt="lookahead_adahessian", weight_decay=0.1, clip_grad=1.0), p)
    assert isinstance(ah, port_optim.AdaHessian)
    assert [g["weight_decay"] for g in ah.param_groups] == [0.1]
    assert not ah._optimizer_step_pre_hooks
    assert isinstance(port_optim.create_optimizer(dict(opt="fusedlamb"), p),
                      port_optim.AdamFamily)
    la = port_optim.create_optimizer(dict(opt="novograd_lookahead"), p)
    assert isinstance(la.inner, port_optim.Novograd)
    assert la.param_groups is la.inner.param_groups


# ---- AdaHessian -----------------------------------------------------------

def test_adahessian_update_matches_jax_given_the_hessian(tree):
    """Three updates given the same Hessian diagonals: spatial averaging of
    |h| over a conv kernel's taps (HWIO axes 0-1, OIHW dims 2-3), decay
    without a mask, and the rate read at ``count + 1`` (rtol 1e-6)."""
    flat, grads = tree
    cfg = dict(opt="adahessian", weight_decay=WEIGHT_DECAY)
    tx = jax_optim.create_optimizer(cfg, lambda c: jnp.asarray(LRS)[c])
    params = jax_params(flat)
    opt_state = tx.init(params)
    # as far from zero as the gradients: the update divides by |h|
    rng = np.random.RandomState(3)
    hessians = [{k: (np.sign(rng.randn(*v.shape)) * (0.5 + rng.rand(*v.shape))
                     ).astype(np.float32) for k, v in flat.items()}
                for _ in range(3)]
    # jitted, as in the train step: eager, ``b2 ** count`` multiplies
    # count times, jitted it is a pow, and 1 - b2^3 differs by 2e-5
    update = jax.jit(lambda g, s, p, h: tx.update(g, s, p, hessian_diag=h))
    for g, h in zip(grads, hessians):
        updates, opt_state = update(jax_params(g), opt_state, params,
                                    jax_params(h))
        params = optax.apply_updates(params, updates)

    got = {k: v.clone().requires_grad_()
           for k, v in jax_to_torch_state_dict(flat).items()}
    optimizer = port_optim.create_optimizer(cfg, got.values())
    assert optimizer.schedule_offset == 1
    order = [p for g in optimizer.param_groups for p in g["params"]]
    name = {id(v): k for k, v in got.items()}
    for t, (g, h) in enumerate(zip(grads, hessians)):
        optimizer.param_groups[0]["lr"] = LRS[t + 1]
        for k, v in jax_to_torch_state_dict(g).items():
            got[k].grad = v.clone()
        hd = jax_to_torch_state_dict(h)
        optimizer.step(hessian_diag=[hd[name[id(p)]] for p in order])
    assert_params_close(got, as_port(params), jax_to_torch_state_dict(flat),
                        1e-6)
    with pytest.raises(ValueError):
        optimizer.step()
