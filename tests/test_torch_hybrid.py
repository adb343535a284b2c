"""Parity of the port's SE-CoTNetD family with the JAX package: its pieces
(BlurPool, the avg-down shortcut and its ceil-mode pool, the deep stems,
SplitAttn at radix 1 and 2), the structure of se_cotnetd_50 and
se_cotnetd_152, the converter with ``avg_down``, and reduced-depth hybrids
built by both packages' ``_se_cotnetd`` in eval and over two train steps.

Variables are drawn with numpy from a seed into the JAX structure, carried
into the port by ``jax_to_torch_state_dict(avg_down=True)`` and loaded with
``strict=True``; both sides then run the same input in f32 on the CPU.
Images differ in contrast and brightness: the pooled vectors that
SplitAttn's ``bn1`` and the CoT ``se`` BN normalize in training would
otherwise be nearly alike.  Even so the whole reduced net's f32 gradient
norm is ill-conditioned (in JAX alone a 1e-6 change of the input moves it
by up to 4e-4), so each block is held in training on its own, and the
train steps against a noise floor measured in the same test.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax.traverse_util import flatten_dict  # noqa: E402

import cotnet_tpu.models.cotnet as cm  # noqa: E402
from cotnet_tpu.models import create_model as jax_create_model  # noqa: E402
from cotnet_tpu.models.cotnet_hybrid import CotHybridBottleneck as JaxHybrid  # noqa: E402
from cotnet_tpu.models.cotnet_hybrid import _se_cotnetd as jax_se_cotnetd  # noqa: E402
from cotnet_tpu.models.resnet import Downsample as JaxDownsample  # noqa: E402
from cotnet_tpu.models.resnet import ResNet as JaxResNet  # noqa: E402
from cotnet_tpu.nn import BlurPool2d as JaxBlurPool2d  # noqa: E402
from cotnet_tpu.nn import SplitAttnConv2d as JaxSplitAttn  # noqa: E402
from cotnet_tpu.nn.pool import avg_pool2d as jax_avg_pool2d  # noqa: E402
from cotnet_tpu.train import loss as jax_loss  # noqa: E402
from cotnet_tpu.train import optim as jax_optim  # noqa: E402
from cotnet_tpu.train import schedule as jax_schedule  # noqa: E402
from cotnet_tpu.train.state import TrainState as JaxTrainState  # noqa: E402
from cotnet_tpu.train.step import make_train_step as jax_make_train_step  # noqa: E402
from cotnet_tpu.utils.convert import convert_torch_state_dict  # noqa: E402
from cotnet_tpu_torch.models import create_model  # noqa: E402
from cotnet_tpu_torch.models.cotnet import CotLayer  # noqa: E402
from cotnet_tpu_torch.models.cotnet_hybrid import (  # noqa: E402
    CotHybridBottleneck,
    _se_cotnetd,
)
from cotnet_tpu_torch.models.resnet import Downsample, ResNet  # noqa: E402
from cotnet_tpu_torch.nn import BlurPool2d, SplitAttnConv2d, avg_pool2d  # noqa: E402
from cotnet_tpu_torch.ops import local_agg as la  # noqa: E402
from cotnet_tpu_torch.train import loss as port_loss  # noqa: E402
from cotnet_tpu_torch.train import optim as port_optim  # noqa: E402
from cotnet_tpu_torch.train import schedule as port_schedule  # noqa: E402
from cotnet_tpu_torch.train.state import TrainState  # noqa: E402
from cotnet_tpu_torch.train.step import make_train_step  # noqa: E402
from cotnet_tpu_torch.utils.convert import jax_to_torch_state_dict  # noqa: E402
from test_torch_cotnet import nchw, random_variables, unflatten  # noqa: E402
from test_torch_train import SOLVER  # noqa: E402


def _images(seed, n, size, c=3):
    """n NHWC images, each of its own contrast and brightness."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, size, size, c) * np.linspace(0.3, 2.0, n)[:, None,
                                                               None, None]
    return (x + np.linspace(-1, 1, n)[:, None, None, None]).astype(
        np.float32)


def _flat_np(tree, collection):
    return {f"{collection}/{k}": np.asarray(v)
            for k, v in flatten_dict(tree, sep="/").items()}


# ---- the pieces ------------------------------------------------------------

@pytest.mark.parametrize("size", [8, 9])
def test_blur_pool_matches_jax(size):
    """Reflect pad, binomial 3x3 filter, stride 2, on an even and an odd
    map (rtol/atol 1e-6); no state_dict entry."""
    x = _images(0, 2, size, c=5)
    ref = JaxBlurPool2d(stride=2).apply({}, jnp.asarray(x))
    pool = BlurPool2d(5)
    assert pool.state_dict() == {}
    got = pool(nchw(x))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                               np.asarray(ref), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("size", [7, 15, 25, 8])
def test_avg_down_pool_matches_jax(size):
    """``avg_pool2d(2, 2, ceil_mode=True, count_include_pad=False)``, the
    avg-down shortcut's pool, against JAX's own on odd maps (where the last
    window holds one row or column and divides by what it holds) and an
    even one (rtol/atol 1e-6)."""
    x = _images(1, 2, size, c=3)
    ref = jax_avg_pool2d(jnp.asarray(x), 2, 2, ceil_mode=True,
                         count_include_pad=False)
    got = avg_pool2d(nchw(x), 2, 2, ceil_mode=True, count_include_pad=False)
    assert got.shape[-1] == -(-size // 2)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                               np.asarray(ref), rtol=1e-6, atol=1e-6)


def _prefixed(flat, prefix):
    """The flat variables of a lone module as if it sat at ``prefix``."""
    return {k.replace("/", f"/{prefix}/", 1): v for k, v in flat.items()}


@pytest.mark.parametrize("stride,size", [(1, 8), (2, 8), (2, 9)])
def test_avg_down_shortcut_matches_jax(stride, size):
    """The ResNet-D ``Downsample`` (avg-pool, 1x1 conv, BN as
    ``downsample.1/2``; no pool at stride 1) in eval against JAX's, with the
    converter's ``avg_down`` names (rtol/atol 1e-5)."""
    x = _images(2, 2, size, c=16)
    module = JaxDownsample(out_channels=32, stride=stride, avg=True)
    _, flat = random_variables(module, jnp.asarray(x), seed=3)
    ref = module.apply(unflatten(flat), jnp.asarray(x), training=False)
    sd = jax_to_torch_state_dict(_prefixed(flat, "downsample"),
                                 avg_down=True)
    port = Downsample(16, 32, stride, avg=True).eval()
    port.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()},
                         strict=True)
    with torch.no_grad():
        got = port(nchw(x))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                               np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("stem_type", ["deep", "deep_tiered",
                                       "deep_tiered_narrow"])
def test_deep_stem_matches_jax(stem_type):
    """The deep stems (three 3x3 convs as ``conv1.{0,1,3,4,6}``, then
    ``bn1`` and ReLU) in eval: the JAX chassis' stem output (its
    ``features_only`` index 0) against the port's on the same converted
    weights (rtol/atol 1e-5)."""
    x = _images(4, 2, 20)
    kw = dict(layers=(1, 1, 1, 1), stem_type=stem_type, stem_width=32,
              stem_act="relu", avg_down=True, replace_stem_pool=True)
    module = JaxResNet(block=JaxHybrid, features_only=True, out_indices=(0,),
                       block_args=dict(conv_dim=(64,)), **kw)
    _, flat = random_variables(module, jnp.asarray(x), seed=5)
    ref = module.apply(unflatten(flat), jnp.asarray(x), training=False)[0]
    port = ResNet(block=CotHybridBottleneck,
                  block_args=dict(conv_dim=(64,)), **kw).eval()
    missing, unexpected = port.load_state_dict(
        jax_to_torch_state_dict(flat, avg_down=True), strict=False)
    assert not unexpected
    assert missing and all(k.startswith(("layer2", "layer3", "layer4", "fc"))
                           for k in missing)
    with torch.no_grad():
        got = port.stem_act(port.bn1(port.conv1(nchw(x))))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                               np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_blur_stem_pool_matches_jax():
    """``aa_layer="blur"`` on the default stem (no ``replace_stem_pool``):
    a stride-1 max-pool then a BlurPool (``stem_aa``), then stage 1; the
    JAX chassis' stage-1 output (``features_only`` index 1) against the
    port's on the same converted weights, in eval (rtol/atol 1e-5)."""
    x = _images(5, 2, 20)
    kw = dict(layers=(1, 1, 1, 1), aa_layer="blur")
    module = JaxResNet(block=JaxHybrid, features_only=True, out_indices=(1,),
                       block_args=dict(conv_dim=(64,)), **kw)
    _, flat = random_variables(module, jnp.asarray(x), seed=6)
    ref = module.apply(unflatten(flat), jnp.asarray(x), training=False)[0]
    port = ResNet(block=CotHybridBottleneck,
                  block_args=dict(conv_dim=(64,)), **kw).eval()
    port.load_state_dict(jax_to_torch_state_dict(flat), strict=False)
    with torch.no_grad():
        y = port.stem_act(port.bn1(port.conv1(nchw(x))))
        got = port.layer1(port.stem_aa(torch.nn.functional.max_pool2d(
            y, 3, 1, 1)))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                               np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("radix,groups", [(1, 1), (2, 1), (2, 2)])
@pytest.mark.parametrize("training", [False, True])
def test_split_attn_matches_jax(training, radix, groups):
    """SplitAttnConv2d (swish, 3x3, stride 1) against JAX's: the output
    (rtol/atol 2e-4) and in training the gradients of ``sum(out * r)`` in
    the input and every parameter at 5e-4 of each tensor's largest entry
    (``fc1.bias`` feeds a train-mode BN, which cancels it, so it is held to
    the size of its neighbour's)."""
    x = _images(6, 4, 6, c=32)
    r = np.random.RandomState(7).randn(4, 6, 6, 32).astype(np.float32)
    module = JaxSplitAttn(out_channels=32, kernel_size=3, padding=1,
                          groups=groups, radix=radix, act="swish")
    _, flat = random_variables(module, jnp.asarray(x), seed=8)
    variables = unflatten(flat)

    def loss(params, x_):
        out, _ = module.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, x_,
            training=training, mutable=["batch_stats"])
        return jnp.vdot(out, jnp.asarray(r)), out

    (_, ref), (ref_gp, ref_gx) = jax.value_and_grad(
        loss, (0, 1), has_aux=True)(variables["params"], jnp.asarray(x))
    port = SplitAttnConv2d(32, 32, 3, padding=1, groups=groups, radix=radix,
                           act="swish").train(training)
    port.load_state_dict(jax_to_torch_state_dict(flat), strict=True)
    xt = nchw(x).requires_grad_()
    got = port(xt)
    np.testing.assert_allclose(got.detach().numpy().transpose(0, 2, 3, 1),
                               np.asarray(ref), rtol=2e-4, atol=2e-4)
    if not training:
        return
    (got * nchw(r)).sum().backward()
    want = jax_to_torch_state_dict(_flat_np(ref_gp, "params"))
    grads = {k: p.grad for k, p in port.named_parameters()}
    assert sorted(grads) == sorted(want)
    grads["x"], want["x"] = xt.grad, nchw(np.asarray(ref_gx))
    largest = float(want["fc1.weight"].abs().max())
    for k, g in grads.items():
        scale = largest if k == "fc1.bias" else float(want[k].abs().max())
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), rtol=0,
                                   atol=5e-4 * scale, err_msg=k)


# ---- structure --------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_shapes(name):
    model = jax_create_model(name)
    return jax.eval_shape(
        lambda r, x: model.init({"params": r}, x, training=False),
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.float32))


@pytest.mark.parametrize("name,millions", [("se_cotnetd_50", 23.1),
                                           ("se_cotnetd_152", None)])
def test_parameter_count_and_keys(name, millions):
    """The port's model has the JAX model's parameters (shapes only, no
    forward), se_cotnetd_50 the reference's 23.1 M
    (``tests/test_models.py``), and its state_dict the converter's keys."""
    shapes = _jax_shapes(name)
    jax_count = sum(int(np.prod(s.shape)) for s in
                    jax.tree_util.tree_leaves(shapes["params"]))
    port = create_model(name, device="cpu")
    count = sum(p.numel() for p in port.parameters())
    assert count == jax_count
    if millions is not None:
        assert round(count / 1e6, 1) == millions
    flat = {k: np.zeros(s.shape, np.float32)
            for k, s in flatten_dict(shapes, sep="/").items()}
    assert (sorted(jax_to_torch_state_dict(flat, avg_down=True))
            == sorted(port.state_dict()))


def test_se_cotnetd_152_layer_plan():
    """21 CoT layers at (C, map at 256 px, layers) = (256, 32, 1),
    (256, 16, 17), (512, 16, 1), (512, 8, 2): stage 3's even blocks and
    all of stage 4, the first of each before its BlurPool; split attention
    everywhere else (29 blocks); both switches reach every CoT layer."""
    port = create_model("se_cotnetd_152", device="cpu", gn_fold_train=True,
                        mega_fuse=True, block_args=dict(impl="torch"))
    seen = {}

    def record(m, args):
        c, h = args[0].shape[1], args[0].shape[2]
        seen[(c, h)] = seen.get((c, h), 0) + 1

    cot = [m for m in port.modules() if isinstance(m, CotLayer)]
    assert {(m.gn_fold_train, m.mega_fuse, m.impl) for m in cot} == {
        (True, True, "torch")}
    assert sum(isinstance(m, SplitAttnConv2d) for m in port.modules()) == 29
    hooks = [m.register_forward_pre_hook(record) for m in cot]
    # the map sizes need the forward only as far as the shapes: run the
    # chassis on a 256 px image through meta tensors
    meta = port.to("meta")
    with torch.no_grad():
        meta(torch.empty(1, 3, 256, 256, device="meta"))
    for h in hooks:
        h.remove()
    assert seen == {(256, 32): 1, (256, 16): 17, (512, 16): 1, (512, 8): 2}


# ---- reduced-depth hybrids, both packages' builders --------------------------

# (aa, avd, avd_first, stem_width): se_cotnetd_152's kind and se_cotnetd_50's
STYLES = {"152": (True, True, False, 64), "50": (False, False, True, 32)}
LAYERS = (1, 1, 2, 1)   # stage 3: a CoT block, then a split-attention block
SIZE = 72               # maps 36, 18, 9, 5, 3: odd at the avg-down pools


def _builders(style, **kwargs):
    aa, avd, avd_first, stem_width = STYLES[style]
    args = dict(layers=LAYERS, stem_width=stem_width, aa=aa, c4_blocks=2,
                avd=avd, avd_first=avd_first, num_classes=10)
    name = f"se_cotnetd_{style}"
    return (jax_se_cotnetd(name, False, **args),
            _se_cotnetd(name, **args, **kwargs))


@functools.lru_cache(maxsize=None)
def _small(style):
    x = _images(9, 4, SIZE)
    jmodel, _ = _builders(style)
    shapes, flat = random_variables(jmodel, jnp.asarray(x), seed=10)
    return x, jmodel, shapes, flat


@pytest.mark.parametrize("style", sorted(STYLES))
def test_convert_round_trip_avg_down(style):
    """jax_to_torch_state_dict(avg_down=True), then the JAX package's own
    convert_torch_state_dict(avg_down=True, strict=True), gives back every
    variable exactly: deep stem, avg-down shortcuts, SplitAttn and CoT
    children all map."""
    _, _, shapes, flat = _small(style)
    sd = {k: v.numpy() for k, v in
          jax_to_torch_state_dict(flat, avg_down=True).items()}
    assert any(k.startswith("conv1.6") for k in sd)
    assert any(".downsample.2." in k for k in sd)
    assert any(".conv2.fc1." in k for k in sd)
    back = flatten_dict(convert_torch_state_dict(sd, shapes, avg_down=True,
                                                 strict=True), sep="/")
    assert sorted(back) == sorted(flat)
    for key, v in flat.items():
        np.testing.assert_array_equal(np.asarray(back[key]), v, err_msg=key)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("style", sorted(STYLES))
def test_small_hybrid_eval_parity(style, fused):
    """Logits of a reduced-depth hybrid, JAX against the port, within
    5e-4 of max|logit| in f32, with and without the fused embed op on both
    sides; one aggregation (or fused op) per CoT layer."""
    x, jmodel, _, flat = _small(style)
    with cm_switches(mega_fuse=fused):
        ref = jax.jit(lambda v, x_: jmodel.apply(v, x_, training=False))(
            unflatten(flat), jnp.asarray(x))
    _, port = _builders(style, mega_fuse=fused)
    port.load_state_dict(jax_to_torch_state_dict(flat, avg_down=True),
                         strict=True)
    port.eval()
    la.reset_counts()
    with torch.no_grad():
        logits = port(nchw(x))
    assert (la.PLAIN_CALLS, la.PLAIN_EMBED_GN_CALLS) == (
        (0, 2) if fused else (2, 0))
    scale = float(np.abs(np.asarray(ref)).max())
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref), rtol=0,
                               atol=5e-4 * scale)


class cm_switches:
    """The JAX package's CoT module globals, set while a fresh function is
    traced and put back."""

    def __init__(self, **flags):
        self.flags = {k.upper(): v for k, v in flags.items()}

    def __enter__(self):
        self.old = {k: getattr(cm, k) for k in self.flags}
        for k, v in self.flags.items():
            setattr(cm, k, v)

    def __exit__(self, *exc):
        for k, v in self.old.items():
            setattr(cm, k, v)


@functools.lru_cache(maxsize=None)
def _two_steps(style):
    """Two train steps of the reduced-depth hybrid on both sides from the
    same variables and batch, as ``two_steps`` of ``test_torch_train.py``:
    nesterov SGD with masked weight decay, the recipe's cosine warm-up at 2
    steps an epoch, label smoothing; drop rates 0 and no mixup.  The JAX
    steps also run from the input moved by 1e-6 (relative) in two seeded
    directions: the most that moves a metric is its noise floor."""
    x, jmodel, _, flat = _small(style)
    labels = np.random.RandomState(11).randint(0, 10, size=4)
    sched, _ = jax_schedule.create_scheduler(dict(SOLVER), 2)
    tx = jax_optim.create_optimizer(SOLVER, sched)
    loss_fn, _ = jax_loss.create_loss_fn(dict(smoothing=0.1), False)
    jstep = jax_make_train_step(jmodel, tx, sched, loss_fn, donate=False)
    runs = []
    for seed in (None, 12, 13):
        xs = x if seed is None else x * (1 + 1e-6 * np.random.RandomState(
            seed).randn(*x.shape).astype(np.float32))
        jstate = JaxTrainState.create(unflatten(flat), tx)
        runs.append([])
        for _ in range(2):
            jstate, m = jstep(jstate, {"image": jnp.asarray(xs),
                                       "label": jnp.asarray(labels)},
                              jax.random.PRNGKey(0))
            runs[-1].append({k: float(v) for k, v in m.items()})
    ref, moved = runs[0], runs[1:]

    _, model = _builders(style)
    model.load_state_dict(jax_to_torch_state_dict(flat, avg_down=True),
                          strict=True)
    optimizer = port_optim.create_optimizer(SOLVER, model.parameters())
    p_loss, _ = port_loss.create_loss_fn(dict(smoothing=0.1), False)
    p_sched, _ = port_schedule.create_scheduler(dict(SOLVER), 2)
    step = make_train_step(model, optimizer, p_sched, p_loss)
    state = TrainState.create(model, optimizer)
    p_batch = {"image": nchw(x), "label": torch.from_numpy(labels)}
    la.reset_counts()
    got = []
    for _ in range(2):
        state, m = step(state, p_batch, None)
        got.append({k: float(v) for k, v in m.items()})
    return got, ref, moved, (la.PLAIN_CALLS, la.PLAIN_BWD_CALLS)


@pytest.mark.parametrize("style", sorted(STYLES))
def test_small_hybrid_train_steps_match_jax(style):
    """Loss, gradient norm and LR of both steps against
    ``cotnet_tpu.train.step``: rtol 2e-5, as ``test_torch_train.py`` holds
    cotnet's, or 3 times the metric's noise floor where that is larger (the
    152-style net's gradient norm moves by 2.5e-4 under the 1e-6 input
    changes); each of the two CoT layers ran one aggregation and one
    backward a step."""
    got, ref, moved, counts = _two_steps(style)
    for i, (g, r) in enumerate(zip(got, ref)):
        for key in ("loss", "grad_norm"):
            floor = max(abs(m[i][key] - r[key]) for m in moved) / abs(r[key])
            np.testing.assert_allclose(g[key], r[key],
                                       rtol=max(2e-5, 3 * floor),
                                       err_msg=key)
        np.testing.assert_allclose(g["lr"], r["lr"], rtol=1e-6)
    assert counts == (4, 4)


BLOCKS = {
    "split_attn_stride2": dict(conv_dim=(16,)),
    "cot_avgpool_first": dict(),
    "cot_blurpool_after": dict(avd=True, aa=True, avd_first=False),
    "split_attn_blurpool_after": dict(conv_dim=(16,), avd=True, aa=True,
                                      avd_first=False),
}


@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_hybrid_block_train_parity(kind):
    """One strided CotHybridBottleneck (width 16, an avg-down shortcut, a
    9x9 map) in training, each kind of middle layer and pool: the output at
    rtol/atol 2e-5 and the gradients of ``sum(out * r)`` in the input and
    every parameter at 5e-4 of each tensor's largest entry against
    ``jax.grad`` of the JAX block.  A bias that feeds a train-mode BN
    (``fc1.bias``, ``se.0.bias``) has a zero gradient but for rounding and
    is held to the size of its neighbour's."""
    kw = BLOCKS[kind]
    x = _images(3, 4, 9, c=32)
    r = np.random.RandomState(4).randn(4, 5, 5, 64).astype(np.float32)
    block = JaxHybrid(planes=16, stride=2, downsample=dict(stride=2,
                                                           avg=True), **kw)
    _, flat = random_variables(block, jnp.asarray(x), seed=5)
    variables = unflatten(flat)

    def loss(params, x_):
        out, _ = block.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, x_,
            training=True, mutable=["batch_stats"])
        return jnp.vdot(out, jnp.asarray(r)), out

    (_, ref), (ref_gp, ref_gx) = jax.jit(jax.value_and_grad(
        loss, (0, 1), has_aux=True))(variables["params"], jnp.asarray(x))
    port = CotHybridBottleneck(32, 16, stride=2,
                               downsample=Downsample(32, 64, 2, avg=True),
                               **kw).train()
    port.load_state_dict(jax_to_torch_state_dict(flat, avg_down=True),
                         strict=True)
    assert isinstance(port.conv2, SplitAttnConv2d) == ("split" in kind)
    xt = nchw(x).requires_grad_()
    got = port(xt)
    np.testing.assert_allclose(got.detach().numpy().transpose(0, 2, 3, 1),
                               np.asarray(ref), rtol=2e-5, atol=2e-5)
    (got * nchw(r)).sum().backward()
    want = jax_to_torch_state_dict(_flat_np(ref_gp, "params"), avg_down=True)
    grads = {k: p.grad for k, p in port.named_parameters()}
    assert sorted(grads) == sorted(want)
    grads["x"], want["x"] = xt.grad, nchw(np.asarray(ref_gx))
    for k, g in grads.items():
        neighbour = {"conv2.fc1.bias": "conv2.fc1.weight",
                     "conv2.se.0.bias": "conv2.se.0.weight"}.get(k, k)
        np.testing.assert_allclose(
            g.numpy(), want[k].numpy(), rtol=0,
            atol=5e-4 * float(want[neighbour].abs().max()), err_msg=k)
