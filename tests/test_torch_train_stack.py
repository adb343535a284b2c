"""Parity of the rest of the port's training stack with the JAX package:
AdaHessian's Hessian probe and second-order step, the tanh / step /
multistep / plateau schedules and the LR noise, the asymmetric losses and
mixup's ``pair`` mode, each from the same seeded numpy inputs on both sides
in f32 on the CPU; then two train steps of the small CoT net under three
combined solvers against ``cotnet_tpu.train.step.make_train_step``.

Random draws cannot match across the frameworks: the LR noise and mixup
are held given the draws, the second-order step given the JAX step's own
Rademacher probes.  The optimizers themselves are in
``test_torch_optim.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import flax.linen as fnn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax.traverse_util import flatten_dict  # noqa: E402

from cotnet_tpu.data import mixup as jax_mixup  # noqa: E402
from cotnet_tpu.models.cotnet import CotBottleneck as JaxCotBottleneck  # noqa: E402
from cotnet_tpu.models.resnet import ResNet as JaxResNet  # noqa: E402
from cotnet_tpu.train import loss as jax_loss  # noqa: E402
from cotnet_tpu.train import optim as jax_optim  # noqa: E402
from cotnet_tpu.train import schedule as jax_schedule  # noqa: E402
from cotnet_tpu.train.state import TrainState as JaxTrainState  # noqa: E402
from cotnet_tpu.train.step import make_train_step as jax_make_train_step  # noqa: E402
from cotnet_tpu_torch.data.mixup import Mixup  # noqa: E402
from cotnet_tpu_torch.models.cotnet import CotBottleneck  # noqa: E402
from cotnet_tpu_torch.models.resnet import ResNet  # noqa: E402
from cotnet_tpu_torch.nn import BatchNorm2d, Conv2d  # noqa: E402
from cotnet_tpu_torch.train import loss as port_loss  # noqa: E402
from cotnet_tpu_torch.train import optim as port_optim  # noqa: E402
from cotnet_tpu_torch.train import schedule as port_schedule  # noqa: E402
from cotnet_tpu_torch.train import step as port_step  # noqa: E402
from cotnet_tpu_torch.train.state import TrainState  # noqa: E402
from cotnet_tpu_torch.utils.convert import jax_to_torch_state_dict  # noqa: E402
from test_torch_cotnet import SMALL_NET, nchw, random_variables, unflatten  # noqa: E402
from test_torch_train import SOLVER  # noqa: E402

# ---- AdaHessian's probe and second-order step -----------------------------

class JaxTinyNet(fnn.Module):
    """The conv net of the JAX package's AdaHessian test
    (``tests/test_train.py``), its conv without the bias: a bias that a
    BatchNorm follows has a gradient of zero in exact arithmetic, so both
    sides compute rounding noise there, which AdaHessian's normalized
    update scales up to the LR."""

    @fnn.compact
    def __call__(self, x, training=False):
        x = fnn.Conv(8, (3, 3), padding=1, use_bias=False)(x)
        x = fnn.BatchNorm(use_running_average=not training, momentum=0.9)(x)
        x = fnn.relu(x)
        x = jnp.mean(x, axis=(1, 2))
        return fnn.Dense(4)(x)


class TinyNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = Conv2d(3, 8, 3, padding=1)
        self.bn = BatchNorm2d(8)
        self.fc = torch.nn.Linear(8, 4)

    def forward(self, x):
        x = torch.relu(self.bn(self.conv(x)))
        return self.fc(x.mean((2, 3)))


# flax leaf -> (port parameter, to the port's layout)
_TINY = {"Conv_0/kernel": ("conv.weight", lambda a: a.transpose(3, 2, 0, 1)),
         "BatchNorm_0/scale": ("bn.weight", lambda a: a),
         "BatchNorm_0/bias": ("bn.bias", lambda a: a),
         "Dense_0/kernel": ("fc.weight", lambda a: a.T),
         "Dense_0/bias": ("fc.bias", lambda a: a)}


@pytest.fixture(scope="module")
def tiny():
    """TinyNet's seeded variables on both sides and a batch."""
    rng = np.random.RandomState(7)
    x = rng.randn(8, 8, 8, 3).astype(np.float32) * np.linspace(
        0.5, 2.0, 8).astype(np.float32)[:, None, None, None]
    labels = np.arange(8) % 4
    model = JaxTinyNet()
    variables = jax.jit(lambda x: model.init(
        {"params": jax.random.PRNGKey(0)}, x, training=True))(jnp.asarray(x))
    port = TinyNet()
    flat = flatten_dict(variables["params"], sep="/")
    sd = port.state_dict()
    for key, (name, to_port) in _TINY.items():
        sd[name] = torch.from_numpy(np.array(to_port(np.asarray(flat[key]))))
    port.load_state_dict(sd)
    return dict(x=x, labels=labels, model=model, variables=variables,
                port=port)


def _to_port(tree) -> dict:
    flat = flatten_dict(tree, sep="/")
    return {name: np.array(to_port(np.asarray(flat[key])))
            for key, (name, to_port) in _TINY.items()}


def test_hessian_probe_matches_jax_jvp(tiny):
    """``z * Hz`` by the port's double backward against ``jax.jvp`` of
    ``jax.grad`` on the same net, batch and probes (rtol 1e-5, atol 1e-5 of
    the largest: second derivatives through BN's batch statistics, summed
    in another order)."""
    model, variables = tiny["model"], tiny["variables"]
    x, labels = jnp.asarray(tiny["x"]), jnp.asarray(tiny["labels"])
    leaves, treedef = jax.tree.flatten(variables["params"])
    rng = np.random.RandomState(8)
    z = treedef.unflatten([jnp.asarray(
        rng.randint(0, 2, l.shape) * 2 - 1, jnp.float32) for l in leaves])

    def loss(params):
        out, _ = model.apply({"params": params,
                              "batch_stats": variables["batch_stats"]},
                             x, training=True, mutable=["batch_stats"])
        return jax_loss.cross_entropy(out, labels)

    _, hz = jax.jvp(jax.grad(loss), (variables["params"],), (z,))
    ref = _to_port(jax.tree.map(lambda a, b: a * b, z, hz))

    port = tiny["port"]
    port.train()
    params = dict(port.named_parameters())
    z_port = _to_port(z)
    names = list(params)
    out = port(nchw(tiny["x"]))
    hd = port_step.hessian_diagonal(
        port_loss.cross_entropy(out, torch.from_numpy(tiny["labels"])),
        [params[n] for n in names],
        [torch.from_numpy(z_port[n]) for n in names])
    for n, h in zip(names, hd):
        scale = np.abs(ref[n]).max()
        assert scale > 0, n
        np.testing.assert_allclose(h.numpy(), ref[n], rtol=1e-5,
                                   atol=1e-5 * scale, err_msg=n)
        assert params[n].grad is not None


def test_second_order_step_matches_jax_given_its_probes(tiny, monkeypatch):
    """Two AdaHessian steps with ``second_order=True`` on TinyNet, the port
    fed the JAX step's own Rademacher probes: loss and gradient norm (rtol
    2e-5, as the whole-step tests), the LR metric and the parameters (rtol
    1e-4, atol 1e-5, the two_steps bounds); the loss falls."""
    model, variables = tiny["model"], tiny["variables"]
    sched = lambda s: 0.01 * (1.0 + s)  # noqa: E731
    cfg = dict(opt="adahessian", weight_decay=1e-4)
    tx = jax_optim.create_optimizer(cfg, sched)
    jstate = JaxTrainState.create(variables, tx)
    jstep = jax_make_train_step(model, tx, sched, jax_loss.cross_entropy,
                                donate=False, second_order=True)
    batch = {"image": jnp.asarray(tiny["x"]),
             "label": jnp.asarray(tiny["labels"])}
    key = jax.random.PRNGKey(0)
    ref_metrics, probes = [], []
    for step in range(2):
        # the draws of the JAX step: fold_in(fold_in(rng, step), 1)
        z_rng = jax.random.fold_in(jax.random.fold_in(key, step), 1)
        leaves, treedef = jax.tree.flatten(jstate.params)
        keys = jax.random.split(z_rng, len(leaves))
        probes.append(_to_port(treedef.unflatten([
            jax.random.rademacher(k, l.shape, jnp.float32)
            for k, l in zip(keys, leaves)])))
        jstate, m = jstep(jstate, batch, key)
        ref_metrics.append({k: float(v) for k, v in m.items()})

    port = TinyNet()
    port.load_state_dict(tiny["port"].state_dict())
    names = [n for n, _ in port.named_parameters()]
    optimizer = port_optim.create_optimizer(cfg, port.parameters())
    drawn = iter(probes)
    monkeypatch.setattr(port_step, "rademacher_probes", lambda params, gen: [
        torch.from_numpy(z) for z in (lambda d: [d[n] for n in names])(
            next(drawn))])
    step = port_step.make_train_step(port, optimizer, sched,
                                     port_loss.cross_entropy,
                                     second_order=True)
    state = TrainState.create(port, optimizer)
    p_batch = {"image": nchw(tiny["x"]),
               "label": torch.from_numpy(tiny["labels"])}
    metrics = []
    for _ in range(2):
        state, m = step(state, p_batch)
        metrics.append({k: float(v) for k, v in m.items()})
    for got, ref in zip(metrics, ref_metrics):
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=2e-5)
        np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"],
                                   rtol=2e-5)
        np.testing.assert_allclose(got["lr"], ref["lr"], rtol=1e-6)
    assert metrics[1]["loss"] < metrics[0]["loss"]
    ref = _to_port(jstate.params)
    for n, p in port.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[n], rtol=1e-4,
                                   atol=1e-5, err_msg=n)


def test_second_order_step_refuses_the_aggregation_op():
    """A model holding a CotLayer has no twice-differentiable backward
    (nor has the JAX package's op: ``jax.jvp`` of its ``custom_vjp``
    raises), so the step refuses before any work."""
    model = ResNet(block=CotBottleneck, **SMALL_NET)
    optimizer = port_optim.create_optimizer(dict(opt="adahessian"),
                                            model.parameters())
    with pytest.raises(ValueError, match="aggregation"):
        port_step.make_train_step(model, optimizer, lambda s: 0.1,
                                  port_loss.cross_entropy, second_order=True)


# ---- schedules ------------------------------------------------------------

def _sampled_steps(cfg, total, spe):
    """The steps ``test_cosine_schedule_matches_jax`` samples."""
    warm = cfg.get("warmup_epochs", 0) * spe
    steps = sorted({0, 1, 2, warm - 1, warm, warm + 1, 10 * spe - 1,
                    10 * spe, 30 * spe, 70 * spe - 1, 70 * spe,
                    total * spe - 1, total * spe, total * spe + 5}
                   | set(range(3, total * spe, 97)))
    return [s for s in steps if s >= 0]


@pytest.mark.parametrize("cfg", [
    dict(SOLVER, sched="tanh"),
    dict(SOLVER, sched="tanh", warmup_epochs=0, epochs=10, lr_cycle_limit=3,
         lr_cycle_mul=2.0, decay_rate=0.5),
    dict(SOLVER, sched="step", decay_epochs=30),
    dict(SOLVER, sched="step", decay_epochs=7, decay_rate=0.5,
         warmup_epochs=0),
    dict(SOLVER, sched="multistep", decay_milestones=[60, 10, 30]),
    dict(SOLVER, sched="plateau"),
    dict(SOLVER, sched="plateau", warmup_epochs=0, cooldown_epochs=3),
], ids=["tanh", "tanh_restarts", "step", "step_no_warmup", "multistep",
        "plateau", "plateau_cooldown"])
def test_schedule_matches_jax(cfg):
    """The LR at the cosine test's sample of steps, warm-up boundary and
    the last cycle included, and the total epochs (rtol 2e-5, atol 1e-8:
    JAX's schedules are f32, the port's Python floats)."""
    spe = 7
    ref_fn, ref_total = jax_schedule.create_scheduler(dict(cfg), spe)
    fn, total = port_schedule.create_scheduler(dict(cfg), spe)
    assert total == ref_total
    steps = _sampled_steps(cfg, total, spe)
    got = np.asarray([fn(s) for s in steps])
    ref = np.asarray([float(ref_fn(jnp.asarray(s, jnp.float32)))
                      for s in steps])
    assert all(isinstance(fn(s), float) for s in steps[:3])
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=1e-8)


@pytest.mark.parametrize("noise,std", [(0.4, 1.0), ((0.2, 0.6), 1.0),
                                       (0.3, 0.0)])
def test_lr_noise_matches_jax_given_the_draw(noise, std):
    """The noisy schedule with the JAX package's own draws passed in (its
    threefry ``fold_in(PRNGKey(seed), epoch)``): the same rate at every
    sampled step, inside the window and outside it."""
    spe, seed, pct, epochs = 5, 3, 0.5, 20
    base, _ = port_schedule.create_scheduler(
        dict(SOLVER, epochs=epochs), spe)
    ref_fn = jax_schedule.with_lr_noise(
        lambda s: jnp.asarray(base(int(s)), jnp.float32), epochs, spe,
        noise, pct, std, seed)
    key = jax.random.PRNGKey(seed)

    def jax_draw(epoch):
        k = jax.random.fold_in(key, epoch)
        if std > 0:
            return float(jnp.clip(jax.random.normal(k) * std, -pct, pct))
        return float(2 * (jax.random.uniform(k) - 0.5) * pct)

    fn = port_schedule.with_lr_noise(base, epochs, spe, noise, pct, std,
                                     seed, draw=jax_draw)
    steps = range(0, epochs * spe + 3, 2)
    np.testing.assert_allclose([fn(s) for s in steps],
                               [float(ref_fn(jnp.asarray(s))) for s in steps],
                               rtol=2e-6, atol=1e-9)
    assert sum(fn(s) != base(s) for s in steps) > 10


def test_lr_noise_own_draw():
    """The port's own draw: one value an epoch (the same at every step of
    it), within +-noise_pct, none outside the window, the same for the same
    seed and another for another seed."""
    spe, epochs = 4, 30
    cfg = dict(SOLVER, epochs=epochs, lr_noise=[0.2, 0.8], lr_noise_pct=0.3,
               seed=5)
    fn, _ = port_schedule.create_scheduler(cfg, spe)
    base, _ = port_schedule.create_scheduler(
        {k: v for k, v in cfg.items() if k != "lr_noise"}, spe)
    ratios = {}
    for s in range(epochs * spe):
        ratios.setdefault(s // spe, set()).add(round(fn(s) / base(s) - 1, 9))
    for epoch, r in ratios.items():
        assert len(r) == 1, epoch
        n = r.pop()
        inside = 0.2 * epochs <= epoch < 0.8 * epochs
        assert (abs(n) <= 0.3 and n != 0) if inside else n == 0, epoch
    again, _ = port_schedule.create_scheduler(dict(cfg), spe)
    other, _ = port_schedule.create_scheduler(dict(cfg, seed=6), spe)
    steps = range(8 * spe, 20 * spe)
    assert [fn(s) for s in steps] == [again(s) for s in steps]
    assert [fn(s) for s in steps] != [other(s) for s in steps]
    assert port_schedule.lr_noise_draw(5, 9) == port_schedule.lr_noise_draw(
        5, 9)


def test_plateau_controller_matches_jax():
    """The scale after each epoch's metric, with patience, threshold and
    cooldown, in both modes; the step's LR is the plateau schedule's times
    ``TrainState.lr_scale``."""
    metrics = [0.5, 0.6, 0.6, 0.59, 0.6, 0.6001, 0.58, 0.7, 0.7, 0.7, 0.7,
               0.69, 0.7, 0.7, 0.7, 0.71]
    for mode in ("max", "min"):
        kw = dict(decay_rate=0.5, patience=2, threshold=1e-3, mode=mode,
                  cooldown=1, min_scale=0.1)
        ref = jax_schedule.PlateauController(**kw)
        got = port_schedule.PlateauController(**kw)
        seen = [m if mode == "max" else 1.0 - m for m in metrics]
        scales = [got.update(m) for m in seen]
        assert scales == [ref.update(m) for m in seen]
        assert min(scales) < 1.0

    model = torch.nn.Linear(4, 3)
    optimizer = port_optim.create_optimizer(dict(opt="sgd"),
                                            model.parameters())
    fn, _ = port_schedule.create_scheduler(dict(SOLVER, sched="plateau"), 10)
    step = port_step.make_train_step(model, optimizer, fn,
                                     port_loss.cross_entropy)
    state = TrainState.create(model, optimizer)
    state.step = 100
    state.lr_scale = got.update(0.0)
    _, m = step(state, {"image": torch.randn(4, 4),
                        "label": torch.arange(4) % 3})
    assert m["lr"] == SOLVER["lr"] * state.lr_scale
    assert optimizer.param_groups[0]["lr"] == m["lr"]


# ---- losses, mixup --------------------------------------------------------

@pytest.mark.parametrize("name,kwargs", [
    ("asymmetric_loss_multilabel", {}),
    ("asymmetric_loss_multilabel", dict(clip=0.0, gamma_pos=0.0)),
    ("asymmetric_loss_single_label", {}),
    ("asymmetric_loss_single_label", dict(eps=0.0, gamma_pos=1.0)),
])
def test_asymmetric_loss_matches_jax(name, kwargs):
    """Each loss and its gradient in the logits, f32 on both sides
    (rtol 1e-5)."""
    rng = np.random.RandomState(4)
    logits = (3 * rng.randn(6, 10)).astype(np.float32)
    if name.endswith("multilabel"):
        target = (rng.rand(6, 10) < 0.3).astype(np.float32)
    else:
        target = rng.randint(0, 10, size=6)
    ref, ref_grad = jax.value_and_grad(lambda z: getattr(jax_loss, name)(
        z, jnp.asarray(target), **kwargs))(jnp.asarray(logits))
    z = torch.from_numpy(logits).requires_grad_()
    got = getattr(port_loss, name)(z, torch.from_numpy(target), **kwargs)
    got.backward()
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)
    np.testing.assert_allclose(z.grad.numpy(), np.asarray(ref_grad),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mixup_alpha,cutmix_alpha", [(0.8, 1.0), (0.0, 1.0),
                                                      (0.8, 0.0)])
def test_mixup_pair_matches_jax_given_draws(mixup_alpha, cutmix_alpha):
    """Mode ``pair`` is per sample, as in the JAX package: its draws for
    one key go to the port's ``apply``; ``cutmix_minmax`` is accepted and
    stored on both sides."""
    n, h, w, k = 6, 10, 12, 10
    rng = np.random.RandomState(9)
    images = rng.randn(n, h, w, 3).astype(np.float32)
    labels = rng.randint(0, k, size=n)
    args = dict(mixup_alpha=mixup_alpha, cutmix_alpha=cutmix_alpha,
                cutmix_minmax=(0.2, 0.8), mode="pair", label_smoothing=0.1,
                num_classes=k)
    jm = jax_mixup.Mixup(**args)
    key = jax.random.PRNGKey(2)
    ref_img, ref_tgt = jm(key, jnp.asarray(images), jnp.asarray(labels))
    k_lam, k_box = jax.random.split(key)
    lam, use_cutmix = jm._sample_lam(k_lam, (n,))
    box = jax_mixup._rand_bbox(k_box, h, w, lam, (n,))

    def t(a):
        return torch.from_numpy(np.asarray(a).copy())

    mix = Mixup(**args)
    assert mix.cutmix_minmax == (0.2, 0.8)
    got_img, got_tgt = mix.apply(nchw(images), torch.from_numpy(labels),
                                 t(lam), t(use_cutmix),
                                 tuple(t(b).long() for b in box))
    np.testing.assert_allclose(got_img.numpy().transpose(0, 2, 3, 1),
                               np.asarray(ref_img), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_tgt.numpy(), np.asarray(ref_tgt),
                               rtol=1e-6, atol=1e-7)
    gen = torch.Generator().manual_seed(0)
    lam, use_cutmix, box = mix.sample(n, h, w, "cpu", gen)
    assert lam.shape == use_cutmix.shape == box[0].shape == (n,)


# ---- the slice as a whole -------------------------------------------------

STEPS_PER_EPOCH = 2
EMA_DECAY = 0.9
SOLVERS = {
    "adamw_agc_tanh": dict(SOLVER, opt="adamw", clip_mode="agc",
                           clip_grad=0.01, sched="tanh"),
    "lamb_norm_step": dict(SOLVER, opt="lamb", clip_mode="norm",
                           clip_grad=1.0, sched="step", decay_epochs=1),
    "lookahead_adamp_value_plateau": dict(
        SOLVER, opt="lookahead_adamp", clip_mode="value", clip_grad=0.01,
        sched="plateau"),
}


@pytest.fixture(scope="module", params=sorted(SOLVERS))
def two_steps(request):
    """Two train steps of the small CoT net on both sides from the same
    variables and batch under a combined solver (``SOLVERS``), with label
    smoothing and EMA, drop rates 0 and no mixup; images of differing
    contrast (see ``test_torch_train.two_steps``)."""
    cfg = SOLVERS[request.param]
    rng = np.random.RandomState(5)
    x = rng.randn(4, 64, 64, 3) * np.linspace(0.3, 2.0, 4)[:, None, None, None]
    x = (x + np.linspace(-1, 1, 4)[:, None, None, None]).astype(np.float32)
    labels = rng.randint(0, SMALL_NET["num_classes"], size=4)
    jmodel = JaxResNet(block=JaxCotBottleneck, **SMALL_NET)
    _, flat = random_variables(jmodel, jnp.asarray(x), seed=6)

    sched, _ = jax_schedule.create_scheduler(dict(cfg), STEPS_PER_EPOCH)
    tx = jax_optim.create_optimizer(cfg, sched)
    loss_fn, _ = jax_loss.create_loss_fn(dict(smoothing=0.1), False)
    jstate = JaxTrainState.create(unflatten(flat), tx, ema=True)
    jstep = jax_make_train_step(jmodel, tx, sched, loss_fn,
                                ema_decay=EMA_DECAY, donate=False)
    batch = {"image": jnp.asarray(x), "label": jnp.asarray(labels)}
    ref_metrics = []
    for _ in range(2):
        jstate, m = jstep(jstate, batch, jax.random.PRNGKey(0))
        ref_metrics.append({k: float(v) for k, v in m.items()})

    model = ResNet(block=CotBottleneck, **SMALL_NET)
    model.load_state_dict(jax_to_torch_state_dict(flat), strict=True)
    p_sched, _ = port_schedule.create_scheduler(dict(cfg), STEPS_PER_EPOCH)
    optimizer = port_optim.create_optimizer(cfg, model.parameters())
    p_loss, _ = port_loss.create_loss_fn(dict(smoothing=0.1), False)
    state = TrainState.create(model, optimizer, ema=True)
    step = port_step.make_train_step(model, optimizer, p_sched, p_loss,
                                     ema_decay=EMA_DECAY)
    p_batch = {"image": nchw(x), "label": torch.from_numpy(labels)}
    metrics = []
    for _ in range(2):
        state, m = step(state, p_batch, None)
        metrics.append({k: float(v) for k, v in m.items()})

    def as_state(params, batch_stats):
        tree = {"params": params, "batch_stats": batch_stats}
        return jax_to_torch_state_dict(
            {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()})

    return dict(ref_metrics=ref_metrics, metrics=metrics, state=state,
                ref_live=as_state(jstate.params, jstate.batch_stats),
                ref_ema=as_state(jstate.ema_params, jstate.ema_batch_stats),
                start=jax_to_torch_state_dict(flat),
                lr_sum=sum(m["lr"] for m in metrics))


def test_combined_solver_metrics_match_jax(two_steps):
    """loss and grad_norm of both steps at rtol 2e-5 (the gradient norm is
    the one before clipping on both sides), the LR at rtol 1e-6."""
    for got, ref in zip(two_steps["metrics"], two_steps["ref_metrics"]):
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=2e-5)
        np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"],
                                   rtol=2e-5)
        np.testing.assert_allclose(got["lr"], ref["lr"], rtol=1e-6)
    assert two_steps["state"].step == 2


@pytest.mark.parametrize("which", ["params", "running_stats", "ema"])
def test_combined_solver_state_matches_jax(two_steps, which):
    """Parameters, BN running stats and the EMA after two steps at the
    ``two_steps`` bounds (rtol 1e-4, atol 1e-5), and nearly every tensor
    moved; the running stats all within the bounds.

    Of the parameters and their EMA, at most 1e-3 of the elements
    (measured: 0.005-0.023%) may differ by more, up to 3 times the sum of
    the two steps' LRs.  These adaptive updates are about ``lr * g / |g|``
    an element, so where an element's gradients are as small as their
    port-against-JAX rounding difference, each side moves it by up to the
    LR in its own direction.  20-98% of those elements are the SE's
    first bias, which a BatchNorm follows: its gradient is zero in exact
    arithmetic, and rounding noise on both sides."""
    live = two_steps["state"].model.state_dict()
    if which == "ema":
        got, ref = two_steps["state"].ema, two_steps["ref_ema"]
        keys = sorted(got)
    else:
        got, ref = live, two_steps["ref_live"]
        keys = sorted(k for k in live if live[k].is_floating_point()
                      and ("running_" in k) == (which == "running_stats"))
    assert keys
    moved = outside = total = 0
    for k in keys:
        g, r = got[k].detach().numpy(), ref[k].numpy()
        diff = np.abs(g - r)
        off = diff > 1e-5 + 1e-4 * np.abs(r)
        if which == "running_stats":
            np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-5, err_msg=k)
        assert diff[off].max(initial=0) <= 3 * two_steps["lr_sum"], k
        outside += off.sum()
        total += off.size
        moved += not np.allclose(g, two_steps["start"][k].numpy(),
                                 rtol=1e-7, atol=0)
    assert moved >= 0.9 * len(keys), f"only {moved} of {len(keys)} moved"
    assert outside <= 1e-3 * total, f"{outside} of {total} elements"
