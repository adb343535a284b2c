"""Parity of the PyTorch port's training path with the JAX package.

Losses, the cosine schedule, the weight-decay mask, SGD, the EMA and mixup
each get the same seeded numpy inputs on both sides, in f32 on the CPU; then
the slice as a whole: two train steps of the small CoT net from the same
variables and batch against ``cotnet_tpu.train.step.make_train_step``.
Random draws cannot match across the two frameworks, so mixup is held given
its drawn values and the whole-step test runs with the drop rates at 0 and
no mixup.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from flax.traverse_util import flatten_dict  # noqa: E402

from cotnet_tpu.data import mixup as jax_mixup  # noqa: E402
from cotnet_tpu.models.cotnet import CotBottleneck as JaxCotBottleneck  # noqa: E402
from cotnet_tpu.models.resnet import ResNet as JaxResNet  # noqa: E402
from cotnet_tpu.train import loss as jax_loss  # noqa: E402
from cotnet_tpu.train import optim as jax_optim  # noqa: E402
from cotnet_tpu.train import schedule as jax_schedule  # noqa: E402
from cotnet_tpu.train.state import TrainState as JaxTrainState  # noqa: E402
from cotnet_tpu.train.state import ema_update as jax_ema_update  # noqa: E402
from cotnet_tpu.train.step import make_train_step as jax_make_train_step  # noqa: E402
from cotnet_tpu_torch.data.mixup import Mixup, one_hot_smooth  # noqa: E402
from cotnet_tpu_torch.models.cotnet import CotBottleneck  # noqa: E402
from cotnet_tpu_torch.models.resnet import ResNet  # noqa: E402
from cotnet_tpu_torch.ops import local_agg as la  # noqa: E402
from cotnet_tpu_torch.train import loss as port_loss  # noqa: E402
from cotnet_tpu_torch.train import optim as port_optim  # noqa: E402
from cotnet_tpu_torch.train import schedule as port_schedule  # noqa: E402
from cotnet_tpu_torch.train.state import TrainState, ema_update  # noqa: E402
from cotnet_tpu_torch.train.step import make_train_step  # noqa: E402
from cotnet_tpu_torch.utils.convert import jax_to_torch_state_dict  # noqa: E402
from test_torch_cotnet import (  # noqa: E402
    SMALL_NET,
    nchw,
    random_variables,
    unflatten,
)

# the recipe of cot_experiments/CoTNet-50-350epoch/config.yaml
SOLVER = dict(opt="sgd", momentum=0.9, weight_decay=4e-5, sched="cosine",
              lr=0.25, base_lr=0.25, warmup_lr=1e-4, min_lr=1e-5, epochs=350,
              warmup_epochs=5, decay_rate=0.1)


# ---- losses ---------------------------------------------------------------

def _logits(seed, n=6, k=10):
    rng = np.random.RandomState(seed)
    return (3 * rng.randn(n, k)).astype(np.float32), rng.randint(0, k, size=n)


@pytest.mark.parametrize("name", ["cross_entropy",
                                  "label_smoothing_cross_entropy",
                                  "soft_target_cross_entropy",
                                  "jsd_cross_entropy", "jsd_no_smoothing"])
def test_loss_matches_jax(name):
    """Each loss and its gradient in the logits (rtol 1e-5: both sides are
    f32 log-softmax sums)."""
    logits, labels = _logits(0)
    kwargs = {}
    if name == "soft_target_cross_entropy":
        target = np.random.RandomState(1).dirichlet(np.ones(10), size=6)
        j_t, p_t = jnp.asarray(target, jnp.float32), torch.from_numpy(
            target.astype(np.float32))
    elif name.startswith("jsd"):
        labels = labels[:2]                     # 3 splits of 2
        kwargs = dict(num_splits=3, alpha=12.0,
                      smoothing=0.1 if name == "jsd_cross_entropy" else 0.0)
        name = "jsd_cross_entropy"
        j_t, p_t = jnp.asarray(labels), torch.from_numpy(labels)
    else:
        j_t, p_t = jnp.asarray(labels), torch.from_numpy(labels)
    ref, ref_grad = jax.value_and_grad(
        lambda z: getattr(jax_loss, name)(z, j_t, **kwargs))(
            jnp.asarray(logits))
    z = torch.from_numpy(logits).requires_grad_()
    got = getattr(port_loss, name)(z, p_t, **kwargs)
    got.backward()
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)
    np.testing.assert_allclose(z.grad.numpy(), np.asarray(ref_grad),
                               rtol=1e-5, atol=1e-7)


def test_loss_is_f32_for_bf16_logits():
    logits, labels = _logits(2)
    z = torch.from_numpy(logits).to(torch.bfloat16)
    for fn in (port_loss.cross_entropy,
               port_loss.label_smoothing_cross_entropy):
        out = fn(z, torch.from_numpy(labels))
        assert out.dtype == torch.float32
        np.testing.assert_allclose(
            out.item(), fn(z.float(), torch.from_numpy(labels)).item(),
            rtol=1e-6)


@pytest.mark.parametrize("cfg,mixup,which", [
    (dict(smoothing=0.1), True, "soft_target_cross_entropy"),
    (dict(smoothing=0.1), False, "label_smoothing"),
    (dict(), False, "cross_entropy"),
    (dict(jsd=True, aug_splits=3, smoothing=0.1), False, "jsd"),
])
def test_create_loss_fn_selection(cfg, mixup, which):
    """The same branch as the JAX factory, checked by value."""
    logits, labels = _logits(3)
    if which == "jsd":
        labels = labels[:2]
    if mixup:
        t = np.random.RandomState(4).dirichlet(np.ones(10), size=6).astype(
            np.float32)
        j_t, p_t = jnp.asarray(t), torch.from_numpy(t)
    else:
        j_t, p_t = jnp.asarray(labels), torch.from_numpy(labels)
    j_train, j_eval = jax_loss.create_loss_fn(cfg, mixup)
    p_train, p_eval = port_loss.create_loss_fn(cfg, mixup)
    np.testing.assert_allclose(
        p_train(torch.from_numpy(logits), p_t).item(),
        float(j_train(jnp.asarray(logits), j_t)), rtol=1e-5)
    assert p_eval is port_loss.cross_entropy
    with pytest.raises(ValueError):
        port_loss.create_loss_fn(dict(jsd=True), False)


# ---- schedule -------------------------------------------------------------

@pytest.mark.parametrize("cfg", [
    SOLVER,
    dict(SOLVER, warmup_epochs=0),
    dict(SOLVER, epochs=10, lr_cycle_limit=3, lr_cycle_mul=2.0,
         decay_rate=0.5),
    dict(SOLVER, epochs=10, lr_cycle_limit=2, cooldown_epochs=3),
], ids=["recipe", "no_warmup", "restarts_mul2", "two_cycles"])
def test_cosine_schedule_matches_jax(cfg):
    """The LR at a grid of steps, the warm-up boundary and the end of the
    last cycle included.  The JAX schedule is f32, the port's Python
    floats: rtol 2e-5 for the f32 rounding of t, and atol 1e-8 = 4e-8 of
    the base LR, an f32 ulp of ``1 + cos`` where the cosine nears -1."""
    spe = 7
    ref_fn, ref_total = jax_schedule.create_scheduler(dict(cfg), spe)
    fn, total = port_schedule.create_scheduler(dict(cfg), spe)
    assert total == ref_total
    warm = cfg["warmup_epochs"] * spe
    steps = sorted({0, 1, 2, warm - 1, warm, warm + 1, 10 * spe - 1,
                    10 * spe, 30 * spe, 70 * spe - 1, 70 * spe,
                    total * spe - 1, total * spe, total * spe + 5}
                   | set(range(3, total * spe, 97)))
    steps = [s for s in steps if s >= 0]
    got = np.asarray([fn(s) for s in steps])
    ref = np.asarray([float(ref_fn(jnp.asarray(s, jnp.float32)))
                      for s in steps])
    assert all(isinstance(fn(s), float) for s in steps[:3])
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=1e-8)


def test_schedule_not_ported_raises():
    """Every schedule name of the JAX package builds, with and without the
    LR noise; only an unknown name raises (ValueError)."""
    for name in ("cosine", "tanh", "step", "multistep", "plateau"):
        for noise in (None, 0.5):
            fn, _ = port_schedule.create_scheduler(
                dict(SOLVER, sched=name, lr_noise=noise), 10)
            assert isinstance(fn(3000), float)
    for name in ("nope", "Cosine", ""):
        with pytest.raises(ValueError):
            port_schedule.create_scheduler(dict(SOLVER, sched=name), 10)


# ---- optimizer, EMA -------------------------------------------------------

def _toy_tree(seed):
    rng = np.random.RandomState(seed)
    return {"conv": {"kernel": rng.randn(3, 3, 4, 5).astype(np.float32),
                     "bias": rng.randn(5).astype(np.float32)},
            "bn": {"scale": rng.randn(5).astype(np.float32)},
            "fc": {"kernel": rng.randn(5, 3).astype(np.float32)}}


def test_wd_mask_matches_jax():
    tree = _toy_tree(0)
    ref = flatten_dict(jax_optim.wd_mask(tree), sep="/")
    flat = flatten_dict(tree, sep="/")
    got = port_optim.wd_mask([torch.from_numpy(v) for v in flat.values()])
    assert got == [bool(ref[k]) for k in flat]
    assert dict(zip(flat, got)) == {"conv/kernel": True, "conv/bias": False,
                                    "bn/scale": False, "fc/kernel": True}


@pytest.mark.parametrize("opt", ["sgd", "momentum", "nesterov"])
def test_sgd_three_steps_match_optax(opt):
    """Three updates of a toy tree under a changing LR: masked decay added
    to the gradient, then (Nesterov) momentum.  rtol 1e-6: the same f32
    operations in the same order."""
    cfg = dict(opt=opt, momentum=0.9, weight_decay=0.05)
    lrs = [0.1, 0.25, 0.05]
    tree = _toy_tree(1)
    grads = [_toy_tree(10 + i) for i in range(3)]
    tx = jax_optim.create_optimizer(
        cfg, lambda count: jnp.asarray(lrs)[count])
    params = jax.tree.map(jnp.asarray, tree)
    opt_state = tx.init(params)
    for g in grads:
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, g),
                                       opt_state, params)
        params = optax.apply_updates(params, updates)

    flat = {k: torch.from_numpy(v.copy()).requires_grad_()
            for k, v in flatten_dict(tree, sep="/").items()}
    optimizer = port_optim.create_optimizer(cfg, flat.values())
    assert [g["weight_decay"] for g in optimizer.param_groups] == [0.05, 0.0]
    for lr, g in zip(lrs, grads):
        for group in optimizer.param_groups:
            group["lr"] = lr
        for k, v in flatten_dict(g, sep="/").items():
            flat[k].grad = torch.from_numpy(v.copy())
        optimizer.step()
    for k, v in flatten_dict(params, sep="/").items():
        np.testing.assert_allclose(flat[k].detach().numpy(), np.asarray(v),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


def test_optimizer_not_ported_raises():
    """The names that raised before they were ported build now, clipping
    included; only an unknown name or clip mode raises (ValueError)."""
    p = [torch.zeros(2, 2, requires_grad=True)]
    for name in ("adamw", "lamb", "adahessian", "lookahead_sgd",
                 "fusedadam"):
        assert port_optim.create_optimizer(dict(opt=name), p) is not None
    assert port_optim.create_optimizer(dict(opt="sgd", clip_grad=1.0), p)
    for cfg in (dict(opt="nope"), dict(opt="lookahead_nope"),
                dict(opt="sgd", clip_mode="nope", clip_grad=1.0)):
        with pytest.raises(ValueError):
            port_optim.create_optimizer(cfg, p)


def test_ema_update_matches_jax():
    ema, new = _toy_tree(2), _toy_tree(3)
    ref = jax_ema_update(jax.tree.map(jnp.asarray, ema),
                         jax.tree.map(jnp.asarray, new), 0.9)
    ref = flatten_dict(ref, sep="/")
    keys = sorted(ref)
    e = [torch.from_numpy(flatten_dict(ema, sep="/")[k].copy()) for k in keys]
    ema_update(e, [torch.from_numpy(flatten_dict(new, sep="/")[k])
                   for k in keys], 0.9)
    for k, got in zip(keys, e):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


# ---- mixup ----------------------------------------------------------------

def test_one_hot_smooth_matches_jax():
    labels = np.asarray([0, 3, 9, 3])
    ref = jax_mixup.one_hot_smooth(jnp.asarray(labels), 10, 0.1)
    got = one_hot_smooth(torch.from_numpy(labels), 10, 0.1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)


@pytest.mark.parametrize("correct_lam", [True, False])
@pytest.mark.parametrize("mode,mixup_alpha,cutmix_alpha", [
    ("batch", 0.8, 1.0), ("elem", 0.8, 1.0), ("batch", 0.8, 0.0),
    ("elem", 0.0, 1.0)])
@pytest.mark.parametrize("seed", [0, 1])
def test_mixup_apply_matches_jax_given_draws(seed, mode, mixup_alpha,
                                             cutmix_alpha, correct_lam):
    """The JAX Mixup draws lam, the mixup/cutmix switch and the box from
    its key; the same values go to the port's ``apply``, whose images and
    soft targets then match (the permutation is the batch flip on both
    sides)."""
    n, h, w, k = 6, 10, 12, 10
    rng = np.random.RandomState(seed)
    images = rng.randn(n, h, w, 3).astype(np.float32)
    labels = rng.randint(0, k, size=n)
    args = dict(mixup_alpha=mixup_alpha, cutmix_alpha=cutmix_alpha,
                mode=mode, correct_lam=correct_lam, label_smoothing=0.1,
                num_classes=k)
    jm = jax_mixup.Mixup(**args)
    key = jax.random.PRNGKey(seed)
    ref_img, ref_tgt = jm(key, jnp.asarray(images), jnp.asarray(labels))
    # the draws of Mixup.__call__, repeated
    k_lam, k_box = jax.random.split(key)
    shape = (n,) if mode == "elem" else ()
    lam, use_cutmix = jm._sample_lam(k_lam, shape)
    box = jax_mixup._rand_bbox(k_box, h, w, lam, shape)

    def t(a):
        return torch.from_numpy(np.asarray(a).copy())

    got_img, got_tgt = Mixup(**args).apply(
        nchw(images), torch.from_numpy(labels), t(lam), t(use_cutmix),
        tuple(t(b).long() for b in box))
    np.testing.assert_allclose(got_img.numpy().transpose(0, 2, 3, 1),
                               np.asarray(ref_img), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_tgt.numpy(), np.asarray(ref_tgt),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("mode", ["batch", "elem"])
def test_mixup_sample_statistics(mode):
    """What the port draws itself: lam in [0, 1] with mean 1/2 (Beta(a, a)
    is symmetric), cutmix about ``switch_prob`` of the time, boxes inside
    the image of the area lam asks for, and the same draws from the same
    seed."""
    n, h, w = 4000, 32, 32
    mix = Mixup(0.8, 1.0, mode="elem", switch_prob=0.3, num_classes=10)
    gen = torch.Generator().manual_seed(0)
    lam, use_cutmix, (yl, yh, xl, xh) = mix.sample(n, h, w, "cpu", gen)
    assert lam.shape == (n,) and lam.dtype == torch.float32
    assert float(lam.min()) >= 0 and float(lam.max()) <= 1
    assert abs(float(lam.mean()) - 0.5) < 0.03
    assert abs(float(use_cutmix.float().mean()) - 0.3) < 0.03
    assert bool(((0 <= yl) & (yl <= yh) & (yh <= h) & (0 <= xl) & (xl <= xh)
                 & (xh <= w)).all())
    area = ((yh - yl) * (xh - xl)).float() / (h * w)
    assert bool((area <= 1 - lam + 2.0 / h).all())
    again = mix.sample(n, h, w, "cpu", torch.Generator().manual_seed(0))
    assert torch.equal(again[0], lam) and torch.equal(again[2][0], yl)

    mix = Mixup(0.8, 1.0, mode=mode, num_classes=10)
    images = torch.randn(8, 3, h, w)
    labels = torch.randint(0, 10, (8,))
    out, target = mix(images, labels, gen)
    assert out.shape == images.shape and target.shape == (8, 10)
    np.testing.assert_allclose(target.sum(-1).numpy(), np.ones(8), rtol=1e-5)
    off = Mixup(0.0, 0.0, mode=mode, num_classes=10, label_smoothing=0.0)
    out, target = off(images, labels, gen)
    assert torch.equal(out, images)
    assert torch.equal(target.argmax(-1), labels)
    assert Mixup(mode="pair").sample(3, h, w, "cpu", gen)[0].shape == (3,)
    with pytest.raises(ValueError):
        Mixup(mode="nope")


# ---- the slice as a whole -------------------------------------------------

STEPS_PER_EPOCH = 2   # the LR changes between the two steps (warm-up)
EMA_DECAY = 0.9


@pytest.fixture(scope="module")
def two_steps():
    """Two train steps of the small CoT net (one CotBottleneck per stage at
    64 px, 4 images) on both sides, from the same variables and batch:
    nesterov SGD with masked weight decay, cosine warm-up, label smoothing,
    EMA; drop rates 0 and no mixup.  bn3 scales are non-zero, so every
    aggregation reaches the loss.

    Each image has its own contrast and brightness.  With four images of
    the same statistics the pooled vector that feeds each CotLayer's
    ``se.1`` BatchNorm is nearly the same for every sample, its one-pass
    variance ``E[x^2] - E[x]^2`` cancels, and an f32 ulp in the input moves
    the JAX package's own gradients by 1e-4 relative: the comparison would
    measure that, not the port."""
    rng = np.random.RandomState(5)
    x = rng.randn(4, 64, 64, 3) * np.linspace(0.3, 2.0, 4)[:, None, None, None]
    x = (x + np.linspace(-1, 1, 4)[:, None, None, None]).astype(np.float32)
    labels = rng.randint(0, SMALL_NET["num_classes"], size=4)
    jmodel = JaxResNet(block=JaxCotBottleneck, **SMALL_NET)
    _, flat = random_variables(jmodel, jnp.asarray(x), seed=6)
    variables = unflatten(flat)

    sched, _ = jax_schedule.create_scheduler(dict(SOLVER), STEPS_PER_EPOCH)
    tx = jax_optim.create_optimizer(SOLVER, sched)
    loss_fn, _ = jax_loss.create_loss_fn(dict(smoothing=0.1), False)
    jstate = JaxTrainState.create(variables, tx, ema=True)
    jstep = jax_make_train_step(jmodel, tx, sched, loss_fn,
                                ema_decay=EMA_DECAY, donate=False)
    batch = {"image": jnp.asarray(x), "label": jnp.asarray(labels)}
    ref_metrics = []
    for _ in range(2):
        jstate, m = jstep(jstate, batch, jax.random.PRNGKey(0))
        ref_metrics.append({k: float(v) for k, v in m.items()})

    model = ResNet(block=CotBottleneck, **SMALL_NET)
    model.load_state_dict(jax_to_torch_state_dict(flat), strict=True)
    p_sched, _ = port_schedule.create_scheduler(dict(SOLVER), STEPS_PER_EPOCH)
    optimizer = port_optim.create_optimizer(SOLVER, model.parameters())
    p_loss, _ = port_loss.create_loss_fn(dict(smoothing=0.1), False)
    state = TrainState.create(model, optimizer, ema=True)
    step = make_train_step(model, optimizer, p_sched, p_loss,
                           ema_decay=EMA_DECAY)
    p_batch = {"image": nchw(x), "label": torch.from_numpy(labels)}
    la.reset_counts()
    metrics, grad_dtypes = [], set()
    for _ in range(2):
        state, m = step(state, p_batch, None)
        metrics.append({k: float(v) for k, v in m.items()})
        grad_dtypes |= {p.grad.dtype for p in model.parameters()}
    counts = (la.PLAIN_CALLS, la.PLAIN_BWD_CALLS, la.LAUNCHES)

    def as_port(params, batch_stats):
        tree = {"params": params, "batch_stats": batch_stats}
        return jax_to_torch_state_dict(
            {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()})

    return dict(
        ref_metrics=ref_metrics, metrics=metrics, state=state, counts=counts,
        grad_dtypes=grad_dtypes, metric_types={k: type(v) for k, v in m.items()},
        ref_live=as_port(jstate.params, jstate.batch_stats),
        ref_ema=as_port(jstate.ema_params, jstate.ema_batch_stats),
        start=jax_to_torch_state_dict(flat))


def test_train_step_metrics_match_jax(two_steps):
    """loss, grad_norm and lr of both steps.  rtol 2e-5 on the loss and the
    gradient norm (they agree to about 2e-6): f32 on both sides with the
    sums of the convolutions, the BN statistics and the aggregation taken
    in another order; the second step also carries the first update's
    differences.  The LR is host arithmetic on both sides (rtol 1e-6)."""
    for got, ref in zip(two_steps["metrics"], two_steps["ref_metrics"]):
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=2e-5)
        np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"],
                                   rtol=2e-5)
        np.testing.assert_allclose(got["lr"], ref["lr"], rtol=1e-6)
    lrs = [m["lr"] for m in two_steps["metrics"]]
    assert lrs[0] == pytest.approx(1e-4) and lrs[1] > lrs[0]
    assert two_steps["metric_types"]["lr"] is float
    assert two_steps["state"].step == 2


def test_train_step_goes_through_the_op(two_steps):
    """Per step, one forward and one backward of the aggregation per
    CotLayer (4), on the CPU through the plain versions; every gradient
    arrives in f32."""
    assert two_steps["counts"] == (8, 8, 0)
    assert two_steps["grad_dtypes"] == {torch.float32}


@pytest.mark.parametrize("which", ["params", "running_stats", "ema"])
def test_train_step_state_matches_jax(two_steps, which):
    """Updated parameters, BN running stats (the variance is the biased
    one) and the EMA of both after two steps, at rtol 1e-4, atol 1e-5: f32
    gradients that agree to about 1e-5 relative, times an LR of at most
    0.025 here; the running stats and the EMA are averages of values that
    agree as closely (the largest difference seen is 2e-6 of a tensor's
    largest value)."""
    live = two_steps["state"].model.state_dict()
    is_stat = lambda k: "running_" in k  # noqa: E731
    if which == "ema":
        got, ref = two_steps["state"].ema, two_steps["ref_ema"]
        keys = sorted(got)
        assert keys == sorted(k for k in live
                              if live[k].is_floating_point())
    else:
        got, ref = live, two_steps["ref_live"]
        keys = sorted(k for k in live if live[k].is_floating_point()
                      and is_stat(k) == (which == "running_stats"))
    assert keys
    moved = 0
    for k in keys:
        np.testing.assert_allclose(got[k].detach().numpy(), ref[k].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
        moved += not np.allclose(got[k].detach().numpy(),
                                 two_steps["start"][k].numpy(), rtol=1e-7,
                                 atol=0)
    assert moved >= 0.9 * len(keys), f"only {moved} of {len(keys)} moved"
    if which == "running_stats":
        assert int(live["bn1.num_batches_tracked"]) == 2


def test_train_step_draws_from_its_generator():
    """With mixup and the drop rates on, the step draws only from the
    generator it is given: the same seed gives the same loss, another seed
    another."""
    def run(seed):
        torch.manual_seed(0)
        model = ResNet(block=CotBottleneck, zero_init_last_bn=False,
                       drop_rate=0.25, drop_path_rate=0.2,
                       drop_block_rate=0.1, **SMALL_NET)
        for m in model.modules():
            if hasattr(m, "reset_parameters"):
                m.reset_parameters(torch.Generator().manual_seed(1))
        optimizer = port_optim.create_optimizer(SOLVER, model.parameters())
        mix = Mixup(0.8, 1.0, num_classes=SMALL_NET["num_classes"])
        loss_fn, _ = port_loss.create_loss_fn(dict(smoothing=0.1), True)
        step = make_train_step(model, optimizer, lambda s: 0.05, loss_fn,
                               mixup_fn=mix)
        state = TrainState.create(model, optimizer)
        assert state.ema is None
        data = torch.Generator().manual_seed(2)
        batch = {"image": torch.randn(4, 3, 32, 32, generator=data),
                 "label": torch.randint(0, 10, (4,), generator=data)}
        gen = torch.Generator().manual_seed(seed)
        return [float(step(state, batch, gen)[1]["loss"]) for _ in range(2)]

    a, b, c = run(3), run(3), run(4)
    assert a == b
    assert a != c
    assert all(np.isfinite(a + c))
