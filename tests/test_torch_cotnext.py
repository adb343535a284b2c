"""Parity of the port's two CoT switches and of its CoTNeXt models with the
JAX package.

``gn_fold_train`` (the embed GroupNorm folded into the aggregation in
training) and ``mega_fuse`` (embed conv + GroupNorm + aggregation as one op
in eval) are constructor arguments in the port and module globals
(``GN_FOLD_TRAIN``, ``MEGA_FUSE``) in ``cotnet_tpu.models.cotnet``, read
when a function is traced: each JAX reference here is a fresh function made
while the globals are set.  CotLayer and CoXtLayer are held in all four
modes, then cotnext50_2x48d's structure, the converter with ``dw_group=2``,
a small CoTNeXt's logits and a folded train step, all in f32 on the CPU with
the same numpy variables and inputs on both sides.
"""

import contextlib
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
from cotnet_tpu.models.resnet import ResNet as JaxResNet  # noqa: E402
from cotnet_tpu.train import loss as jax_loss  # noqa: E402
from cotnet_tpu.train import optim as jax_optim  # noqa: E402
from cotnet_tpu.train.state import TrainState as JaxTrainState  # noqa: E402
from cotnet_tpu.train.step import make_train_step as jax_make_train_step  # noqa: E402
from cotnet_tpu.utils.convert import convert_torch_state_dict  # noqa: E402
from cotnet_tpu_torch.models import create_model  # noqa: E402
from cotnet_tpu_torch.models.cotnet import (  # noqa: E402
    CotBottleneck,
    CotLayer,
    CoXtLayer,
)
from cotnet_tpu_torch.models.resnet import ResNet  # noqa: E402
from cotnet_tpu_torch.ops import local_agg as la  # noqa: E402
from cotnet_tpu_torch.train import loss as port_loss  # noqa: E402
from cotnet_tpu_torch.train import optim as port_optim  # noqa: E402
from cotnet_tpu_torch.train.state import TrainState  # noqa: E402
from cotnet_tpu_torch.train.step import make_train_step  # noqa: E402
from cotnet_tpu_torch.utils.convert import jax_to_torch_state_dict  # noqa: E402
from test_torch_cotnet import (  # noqa: E402
    SMALL_NET,
    nchw,
    random_variables,
    unflatten,
)
from test_torch_train import SOLVER  # noqa: E402

LAYERS = {"cot": (cm.CotLayer, CotLayer, 1), "coxt": (cm.CoXtLayer, CoXtLayer, 2)}
# mode -> (training, the port's switches)
MODES = {
    "eval": (False, {}),
    "eval_fused": (False, dict(mega_fuse=True)),
    "train": (True, {}),
    "train_fold": (True, dict(gn_fold_train=True)),
}
# cardinality 2 at base width 16: CoXt widths 32..256, Cw 2..16 per group
SMALL_NEXT = dict(SMALL_NET, cardinality=2)


@contextlib.contextmanager
def jax_switches(gn_fold_train=False, mega_fuse=False):
    """The JAX package's two module globals, set for the tracing of fresh
    functions and put back."""
    old = (cm.GN_FOLD_TRAIN, cm.MEGA_FUSE)
    cm.GN_FOLD_TRAIN, cm.MEGA_FUSE = gn_fold_train, mega_fuse
    try:
        yield
    finally:
        cm.GN_FOLD_TRAIN, cm.MEGA_FUSE = old


def _flat_np(tree, collection):
    return {f"{collection}/{k}": np.asarray(v)
            for k, v in flatten_dict(tree, sep="/").items()}


@functools.lru_cache(maxsize=None)
def _layer_case(which, mode):
    """One layer (dim 32, 9x9, 4 images of differing contrast) on both
    sides in one mode: outputs, and in training the updated running stats
    and the gradients of ``sum(out * r)`` in the input and every parameter,
    the JAX ones carried over by the converter (which is linear)."""
    jax_cls, port_cls, dw_group = LAYERS[which]
    training, switches = MODES[mode]
    dim = 32
    rng = np.random.RandomState(10)
    x = (rng.randn(4, 9, 9, dim)
         * np.linspace(0.3, 2.0, 4)[:, None, None, None]).astype(np.float32)
    r = rng.randn(4, 9, 9, dim).astype(np.float32)
    layer = jax_cls(dim=dim, kernel_size=3)
    _, flat = random_variables(layer, jnp.asarray(x), seed=11)
    variables = unflatten(flat)

    def loss(params, x_):
        out, mutated = layer.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, x_,
            training=training, mutable=["batch_stats"])
        return jnp.vdot(out, jnp.asarray(r)), (out, mutated["batch_stats"])

    with jax_switches(**switches):
        (_, (ref, ref_stats)), (ref_gp, ref_gx) = jax.jit(jax.value_and_grad(
            loss, (0, 1), has_aux=True))(variables["params"], jnp.asarray(x))

    port = port_cls(dim, **switches).train(training)
    port.load_state_dict(jax_to_torch_state_dict(flat, dw_group=dw_group),
                         strict=True)
    xt = nchw(x).requires_grad_(training)
    la.reset_counts()
    with torch.set_grad_enabled(training):
        got = port(xt)
        if training:
            (got * nchw(r)).sum().backward()
    case = dict(
        got=got.detach().numpy().transpose(0, 2, 3, 1), ref=np.asarray(ref),
        counts=(la.PLAIN_CALLS, la.PLAIN_BWD_CALLS, la.PLAIN_EMBED_GN_CALLS))
    if training:
        want = jax_to_torch_state_dict(_flat_np(ref_gp, "params"),
                                       dw_group=dw_group)
        grads = {k: p.grad for k, p in port.named_parameters()}
        assert sorted(grads) == sorted(want)
        grads["x"], want["x"] = xt.grad, nchw(np.asarray(ref_gx))
        case.update(
            grads=grads, want=want, state=port.state_dict(),
            stats=jax_to_torch_state_dict(_flat_np(ref_stats, "batch_stats")))
    return case


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("which", sorted(LAYERS))
def test_layer_output_matches_jax(which, mode):
    """The layer's output against the JAX layer's at rtol/atol 2e-4, as
    ``test_torch_cotnet.py`` holds the default CotLayer; and the mode took
    the op it names, once for all channel groups: the fused op in
    ``eval_fused``, else one aggregation (and one backward in training)."""
    case = _layer_case(which, mode)
    np.testing.assert_allclose(case["got"], case["ref"], rtol=2e-4,
                               atol=2e-4)
    assert case["counts"] == {"eval": (1, 0, 0), "eval_fused": (0, 0, 1),
                              "train": (1, 1, 0),
                              "train_fold": (1, 1, 0)}[mode]


@pytest.mark.parametrize("mode", ["train", "train_fold"])
@pytest.mark.parametrize("which", sorted(LAYERS))
def test_layer_gradients_match_jax(which, mode):
    """Gradients in the input and in every parameter against ``jax.grad``
    of the JAX layer in the same mode, at 5e-4 of each tensor's largest
    entry.  Fold on is held against fold on: both sides then share the
    fold's ``b = beta - mean*s`` and its cancellation.  ``se.0.bias`` feeds
    a train-mode BN, which cancels it: its gradient is zero but for
    rounding, so it is held to the size of its neighbour's."""
    case = _layer_case(which, mode)
    grads, want = case["grads"], case["want"]
    largest = float(want["se.0.weight"].abs().max())
    for k, g in grads.items():
        scale = largest if k == "se.0.bias" else float(want[k].abs().max())
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), rtol=0,
                                   atol=5e-4 * scale, err_msg=k)


@pytest.mark.parametrize("mode", ["train", "train_fold"])
@pytest.mark.parametrize("which", sorted(LAYERS))
def test_layer_running_stats_match_jax(which, mode):
    case = _layer_case(which, mode)
    keys = [k for k in case["stats"] if "running_" in k]
    assert len(keys) == 10          # five BNs
    for k in keys:
        np.testing.assert_allclose(case["state"][k].numpy(),
                                   case["stats"][k].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("which", sorted(LAYERS))
def test_fold_in_training_matches_materialized(which):
    """The port's fold on against its fold off, same weights and input: the
    loss to 1e-4 and every parameter's gradient to 2e-2 of its largest
    entry, the JAX package's own bound for this pair
    (``tests/test_local_agg.py::test_gn_fold_train_model_grads``): exact
    algebra, but ``b = beta - mean*s`` cancels where |mean| >> std.
    ``se.0.bias`` (true gradient 0) is left out, as there."""
    off, on = _layer_case(which, "train"), _layer_case(which, "train_fold")
    np.testing.assert_allclose(on["got"], off["got"], rtol=1e-4, atol=1e-4)
    checked = 0
    for k, g in on["grads"].items():
        if k == "se.0.bias":
            continue
        ref = off["grads"][k]
        assert float((g - ref).abs().max()) <= 2e-2 * float(ref.abs().max()), k
        checked += 1
    assert checked == len(on["grads"]) - 1 >= 20


@pytest.mark.parametrize("name,flags", [
    ("cotnet50", dict()),
    ("cotnet50", dict(gn_fold_train=True)),
    ("cotnet50", dict(mega_fuse=True, block_args=dict(impl="torch"))),
    ("cotnext50_2x48d", dict(gn_fold_train=True, mega_fuse=True)),
], ids=["default", "fold", "fuse_and_block_args", "cotnext_both"])
def test_switches_reach_every_cot_layer(name, flags):
    """``create_model`` hands both switches down to each of the 16 CoT
    layers, beside what ``block_args`` holds; both are off by default."""
    model = create_model(name, device="cpu", **flags)
    cls = CoXtLayer if "next" in name else CotLayer
    layers = [m for m in model.modules() if isinstance(m, CotLayer)]
    assert len(layers) == 16 and all(type(m) is cls for m in layers)
    assert {(m.gn_fold_train, m.mega_fuse) for m in layers} == {
        (flags.get("gn_fold_train", False), flags.get("mega_fuse", False))}
    assert {m.impl for m in layers} == {
        flags.get("block_args", {}).get("impl", "auto")}


def test_switches_act_in_their_own_mode_only():
    """With both switches on, eval takes the fused op and no aggregation,
    training the folded aggregation and its backward and no fused op."""
    model = ResNet(block=CotBottleneck,
                   block_args=dict(gn_fold_train=True, mega_fuse=True),
                   **SMALL_NEXT).eval()
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(0))
    la.reset_counts()
    with torch.no_grad():
        model(x)
    assert (la.PLAIN_EMBED_GN_CALLS, la.PLAIN_CALLS) == (4, 0)
    la.reset_counts()
    model.train()
    model(x).sum().backward()
    assert (la.PLAIN_EMBED_GN_CALLS, la.PLAIN_CALLS,
            la.PLAIN_BWD_CALLS) == (0, 4, 4)


# ---- CoTNeXt's structure and the converter ----------------------------------

@pytest.mark.parametrize("name,millions", [("cotnext50_2x48d", 30.1),
                                           ("cotnext101_2x48d", 53.4)])
def test_cotnext_parameter_count(name, millions):
    """The port's model has the JAX model's parameters (shapes only, no
    forward), the published count (README.md:45-52 of the reference; that
    of cotnext101_2x48d from the paper's table) to 1%, and a state_dict of
    the converter's keys."""
    model = jax_create_model(name)
    shapes = jax.eval_shape(
        lambda r, x: model.init({"params": r}, x, training=False),
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.float32))
    jax_count = sum(int(np.prod(s.shape)) for s in
                    jax.tree_util.tree_leaves(shapes["params"]))
    port = create_model(name, device="cpu")
    count = sum(p.numel() for p in port.parameters())
    assert count == jax_count
    assert abs(count / 1e6 - millions) <= 0.01 * millions
    flat = {k: np.zeros(s.shape, np.float32)
            for k, s in flatten_dict(shapes, sep="/").items()}
    assert (sorted(jax_to_torch_state_dict(flat, dw_group=2))
            == sorted(port.state_dict()))
    widths = [m.dim for m in port.modules() if isinstance(m, CoXtLayer)]
    assert sorted(set(widths)) == [96, 192, 384, 768]


@pytest.fixture(scope="module")
def small_next():
    """The ResNet chassis with one CotBottleneck of cardinality 2 per stage
    at 64 px, in JAX, with seeded numpy variables."""
    rng = np.random.RandomState(2)
    x = rng.randn(4, 64, 64, 3) * np.linspace(0.3, 2.0, 4)[:, None, None, None]
    x = (x + np.linspace(-1, 1, 4)[:, None, None, None]).astype(np.float32)
    model = JaxResNet(block=cm.CotBottleneck, **SMALL_NEXT)
    shapes, flat = random_variables(model, jnp.asarray(x), seed=3)
    return dict(x=x, model=model, shapes=shapes, flat=flat,
                labels=rng.randint(0, SMALL_NEXT["num_classes"], size=4))


@pytest.mark.parametrize("which", ["coxt_layer", "small_next"])
def test_convert_round_trip_dw_group_2(which, small_next):
    """jax_to_torch_state_dict(dw_group=2), then the JAX package's own
    convert_torch_state_dict(dw_group=2), gives back every variable
    exactly; with ``dw_group=1`` it would not."""
    if which == "coxt_layer":
        x = jnp.zeros((1, 9, 9, 32), jnp.float32)
        shapes, flat = random_variables(cm.CoXtLayer(dim=32), x, seed=4)
    else:
        shapes, flat = small_next["shapes"], small_next["flat"]
    sd = {k: v.numpy() for k, v in
          jax_to_torch_state_dict(flat, dw_group=2).items()}
    back = flatten_dict(convert_torch_state_dict(sd, shapes, dw_group=2,
                                                 strict=True), sep="/")
    assert sorted(back) == sorted(flat)
    for key, v in flat.items():
        np.testing.assert_array_equal(np.asarray(back[key]), v, err_msg=key)
    wrong = jax_to_torch_state_dict(flat, dw_group=1)
    assert any(not np.array_equal(wrong[k].numpy(), sd[k]) for k in sd
               if "embed.3" in k or "embed.4" in k)


@pytest.mark.parametrize("fused", [False, True])
def test_small_cotnext_eval_parity(small_next, fused):
    """Logits of the small CoTNeXt, JAX against the port, at the converted
    whole-net tolerance of 5e-4, with and without the fused embed op on
    both sides; one op call per CoXtLayer for both channel groups."""
    x, flat, model = (small_next[k] for k in ("x", "flat", "model"))
    with jax_switches(mega_fuse=fused):
        ref = jax.jit(lambda v, x_: model.apply(v, x_, training=False))(
            unflatten(flat), jnp.asarray(x))
    port = ResNet(block=CotBottleneck, block_args=dict(mega_fuse=fused),
                  **SMALL_NEXT).eval()
    port.load_state_dict(jax_to_torch_state_dict(flat, dw_group=2),
                         strict=True)
    la.reset_counts()
    with torch.no_grad():
        logits = port(nchw(x))
    assert (la.PLAIN_CALLS, la.PLAIN_EMBED_GN_CALLS) == (
        (0, 4) if fused else (4, 0))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref), rtol=5e-4,
                               atol=5e-4)


# ---- the folded train step ------------------------------------------------

@functools.lru_cache(maxsize=None)
def _folded_step(family):
    """One train step with the fold on in training on both sides, from the
    same variables and batch: nesterov SGD with masked weight decay, the
    warm-up LR, label smoothing; drop rates 0 and no mixup.  The images
    differ in contrast and brightness (see ``two_steps`` in
    ``test_torch_train.py``)."""
    net, dw_group = {"cotnet": (SMALL_NET, 1), "cotnext": (SMALL_NEXT, 2)}[
        family]
    rng = np.random.RandomState(5)
    x = rng.randn(4, 64, 64, 3) * np.linspace(0.3, 2.0, 4)[:, None, None, None]
    x = (x + np.linspace(-1, 1, 4)[:, None, None, None]).astype(np.float32)
    labels = rng.randint(0, net["num_classes"], size=4)
    jmodel = JaxResNet(block=cm.CotBottleneck, **net)
    _, flat = random_variables(jmodel, jnp.asarray(x), seed=6)

    # the warm-up starts at 1e-4; a larger constant rate makes the update
    # large enough to compare
    sched = lambda step: jnp.asarray(0.05, jnp.float32)  # noqa: E731
    tx = jax_optim.create_optimizer(SOLVER, sched)
    loss_fn, _ = jax_loss.create_loss_fn(dict(smoothing=0.1), False)
    jstate = JaxTrainState.create(unflatten(flat), tx)
    with jax_switches(gn_fold_train=True):
        jstep = jax_make_train_step(jmodel, tx, sched, loss_fn, donate=False)
        jstate, ref_metrics = jstep(
            jstate, {"image": jnp.asarray(x), "label": jnp.asarray(labels)},
            jax.random.PRNGKey(0))

    model = ResNet(block=CotBottleneck,
                   block_args=dict(gn_fold_train=True), **net)
    start = jax_to_torch_state_dict(flat, dw_group=dw_group)
    model.load_state_dict(start, strict=True)
    optimizer = port_optim.create_optimizer(SOLVER, model.parameters())
    p_loss, _ = port_loss.create_loss_fn(dict(smoothing=0.1), False)
    step = make_train_step(model, optimizer, lambda s: 0.05, p_loss)
    la.reset_counts()
    state, metrics = step(TrainState.create(model, optimizer),
                          {"image": nchw(x),
                           "label": torch.from_numpy(labels)}, None)
    tree = {"params": jstate.params, "batch_stats": jstate.batch_stats}
    return dict(
        metrics={k: float(v) for k, v in metrics.items()},
        ref_metrics={k: float(v) for k, v in ref_metrics.items()},
        counts=(la.PLAIN_CALLS, la.PLAIN_BWD_CALLS), start=start,
        live=state.model.state_dict(),
        ref_live=jax_to_torch_state_dict(
            {k: np.asarray(v) for k, v in
             flatten_dict(tree, sep="/").items()}, dw_group=dw_group))


@pytest.mark.parametrize("family", ["cotnet", "cotnext"])
def test_folded_train_step_metrics_match_jax(family):
    """Loss and gradient norm of the folded step against
    ``cotnet_tpu.train.step`` with ``GN_FOLD_TRAIN`` on, at rtol 2e-5 and
    1e-4: the loss as the unfolded steps of ``test_torch_train.py``, the
    norm looser, since the fold's cancellation enters every embed gradient
    on both sides with sums in another order.  Each CoT layer ran one
    (affine) aggregation and one backward."""
    case = _folded_step(family)
    np.testing.assert_allclose(case["metrics"]["loss"],
                               case["ref_metrics"]["loss"], rtol=2e-5)
    np.testing.assert_allclose(case["metrics"]["grad_norm"],
                               case["ref_metrics"]["grad_norm"], rtol=1e-4)
    assert case["counts"] == (4, 4)


@pytest.mark.parametrize("which", ["params", "running_stats"])
@pytest.mark.parametrize("family", ["cotnet", "cotnext"])
def test_folded_train_step_state_matches_jax(family, which):
    """The updated parameters and running stats at rtol 1e-4, atol 1e-5
    (as ``test_train_step_state_matches_jax``), and nearly all moved."""
    case = _folded_step(family)
    live = case["live"]
    keys = sorted(k for k in live if live[k].is_floating_point()
                  and ("running_" in k) == (which == "running_stats"))
    assert keys
    moved = 0
    for k in keys:
        np.testing.assert_allclose(live[k].detach().numpy(),
                                   case["ref_live"][k].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
        moved += not np.allclose(live[k].detach().numpy(),
                                 case["start"][k].numpy(), rtol=1e-7, atol=0)
    assert moved >= 0.9 * len(keys), f"only {moved} of {len(keys)} moved"
