"""The port's checkpoints, resume and reference-format loading.

- ``tests/test_checkpoint.py``'s cases against the port's
  ``CheckpointSaver``: round trip, top-N, recovery, weights with the EMA
  selected, ``last`` surviving a worst-ranked save; and a save that fails
  midway leaving the previous file readable.
- Resume trajectory equivalence, exact: train(2N) against train(N) ->
  ``save_recovery`` -> restore into a fresh model and optimizer ->
  train(N), on the small CoT net with EMA, a cosine warm-up (a new LR every
  step), mixup, dropout and drop path, under three optimizers, the step's
  draws seeded as ``train_cli`` seeds them.
- Across the packages: a file from the port's ``save_weights`` through the
  JAX package's ``convert_torch_checkpoint``; a reference-layout
  ``.pth.tar`` (``module.`` prefixes, ``state_dict_ema``, an ``args``
  Namespace) into the port; ``adapt_input_conv`` and ``surgery`` against
  the JAX package's on the same arrays.
"""

import argparse
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax.traverse_util import flatten_dict  # noqa: E402
from torch import nn  # noqa: E402

from cotnet_tpu.models.cotnet import CotBottleneck as JaxCotBottleneck  # noqa: E402
from cotnet_tpu.models.resnet import ResNet as JaxResNet  # noqa: E402
from cotnet_tpu.utils import convert as jax_convert  # noqa: E402
from cotnet_tpu_torch import train_cli  # noqa: E402
from cotnet_tpu_torch.data.mixup import Mixup  # noqa: E402
from cotnet_tpu_torch.models.cotnet import CotBottleneck  # noqa: E402
from cotnet_tpu_torch.models.resnet import ResNet  # noqa: E402
from cotnet_tpu_torch.train.loss import soft_target_cross_entropy  # noqa: E402
from cotnet_tpu_torch.train.optim import Lookahead, create_optimizer  # noqa: E402
from cotnet_tpu_torch.train.schedule import create_scheduler  # noqa: E402
from cotnet_tpu_torch.train.state import TrainState  # noqa: E402
from cotnet_tpu_torch.train.step import make_train_step  # noqa: E402
from cotnet_tpu_torch.utils import checkpoint, convert  # noqa: E402
from test_torch_cotnet import SMALL_NET, nchw, random_variables  # noqa: E402


class _Tiny(nn.Module):
    """A linear layer and a BN: parameters, running stats and a batch
    counter, every kind of tensor a checkpoint holds."""

    def __init__(self):
        super().__init__()
        self.dense = nn.Linear(3, 4)
        self.bn = nn.BatchNorm1d(4)
        with torch.no_grad():
            self.dense.weight.fill_(1.0)
            self.dense.bias.zero_()


def _tiny_state():
    model = _Tiny()
    opt = create_optimizer(dict(opt="momentum", momentum=0.9),
                           model.parameters(), lr=0.1)
    return TrainState.create(model, opt, ema=True)


def test_roundtrip(tmp_path):
    saver = checkpoint.CheckpointSaver(str(tmp_path / "ckpt"), max_history=3)
    state = _tiny_state()
    with torch.no_grad():
        state.model.dense.weight.add_(5.0)
    state.step, state.lr_scale = 7, 0.5
    saver.save_checkpoint(state, epoch=1, metric=50.0)

    restored = saver.restore(_tiny_state())
    np.testing.assert_allclose(restored.model.dense.weight.detach().numpy(), 6.0)
    np.testing.assert_allclose(restored.ema["dense.weight"].numpy(), 1.0)
    assert restored.step == 7 and restored.lr_scale == 0.5
    saved = torch.load(str(tmp_path / "ckpt" / "checkpoint-1.pth.tar"),
                       weights_only=True)
    assert sorted(saved) == ["arch", "epoch", "lr_scale", "metric",
                             "optimizer", "state_dict", "state_dict_ema",
                             "step"]
    assert saved["epoch"] == 1 and saved["metric"] == 50.0
    # the EMA is a full state_dict: the BN batch counter from the model
    assert sorted(saved["state_dict_ema"]) == sorted(saved["state_dict"])


def test_topn_retention(tmp_path):
    saver = checkpoint.CheckpointSaver(str(tmp_path / "ckpt"), max_history=2)
    state = _tiny_state()
    saver.save_checkpoint(state, 1, metric=10.0)
    saver.save_checkpoint(state, 2, metric=30.0)
    saver.save_checkpoint(state, 3, metric=20.0)  # evicts epoch 1 (worst)
    epochs = sorted(e["epoch"] for e in saver.index)
    assert epochs == [2, 3]
    assert saver.best()["epoch"] == 2
    assert not (tmp_path / "ckpt" / "checkpoint-1.pth.tar").exists()
    # the index survives a new saver on the same folder
    assert checkpoint.CheckpointSaver(str(tmp_path / "ckpt")).index == \
        saver.index


def test_recovery(tmp_path):
    saver = checkpoint.CheckpointSaver(str(tmp_path / "ckpt"),
                                       recovery_interval=2)
    state = _tiny_state()
    saver.save_recovery(state, 1)           # not on the interval
    assert saver.find_recovery() is None
    state.step = 3
    saver.save_recovery(state, 2)
    info = saver.find_recovery()
    assert info is not None and info["epoch"] == 2
    restored = saver.restore(_tiny_state(), path=info["path"])
    assert restored.step == 3


def test_weights_io_ema_select(tmp_path):
    state = _tiny_state()
    sd = state.model.state_dict()
    ema = {k: v * 2 + 1 if v.is_floating_point() else v
           for k, v in sd.items()}
    path = str(tmp_path / "weights.pth.tar")
    checkpoint.save_weights(path, sd, ema)
    plain = checkpoint.load_weights(path)
    np.testing.assert_allclose(plain["dense.weight"].numpy(), 1.0)
    chosen = checkpoint.load_weights(path, use_ema=True)
    np.testing.assert_allclose(chosen["dense.weight"].numpy(), 3.0)
    # without an EMA in the file, use_ema takes the weights
    checkpoint.save_weights(path, sd)
    np.testing.assert_allclose(
        checkpoint.load_weights(path, use_ema=True)["dense.weight"].numpy(),
        1.0)


def test_last_survives_worst_ranked_save(tmp_path):
    """A newest epoch that ranks worst is not pruned from under 'last'."""
    saver = checkpoint.CheckpointSaver(str(tmp_path / "ckpt"), max_history=2)
    state = _tiny_state()
    saver.save_checkpoint(state, 1, metric=30.0)
    saver.save_checkpoint(state, 2, metric=20.0)
    state.step = 11
    saver.save_checkpoint(state, 3, metric=5.0)  # worst so far, but newest
    epochs = sorted(e["epoch"] for e in saver.index)
    assert 3 in epochs and len(epochs) == 2
    restored = saver.restore(_tiny_state())  # via last -> epoch 3
    assert restored.step == 11


def test_failed_save_leaves_the_previous_file(tmp_path, monkeypatch):
    """A save that fails midway (a partial write, then an error) leaves the
    previous checkpoint, the index and the recovery file readable and
    unchanged, and no temporary file."""
    saver = checkpoint.CheckpointSaver(str(tmp_path / "ckpt"),
                                       recovery_interval=1)
    state = _tiny_state()
    state.step = 1
    saver.save_checkpoint(state, 1, metric=10.0)
    saver.save_recovery(state, 1)
    before = sorted(os.listdir(tmp_path / "ckpt"))
    index = (tmp_path / "ckpt" / "index.json").read_text()

    def broken(obj, f, *args, **kwargs):
        f.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", broken)
    state.step = 2
    with pytest.raises(OSError, match="disk full"):
        saver.save_checkpoint(state, 1, metric=20.0)
    with pytest.raises(OSError, match="disk full"):
        saver.save_recovery(state, 2)
    monkeypatch.undo()
    assert sorted(os.listdir(tmp_path / "ckpt")) == before
    assert (tmp_path / "ckpt" / "index.json").read_text() == index
    assert saver.restore(_tiny_state()).step == 1
    assert saver.restore(_tiny_state(),
                         saver.find_recovery()["path"]).step == 1


# ---- resume trajectory equivalence ----------------------------------------

STEPS_PER_EPOCH = 4
N = 4   # 2N = 8 steps cross Lookahead's sync at the sixth
SOLVERS = {
    "sgd": dict(opt="sgd", momentum=0.9, weight_decay=4e-5, lr=0.25),
    "adamw": dict(opt="adamw", weight_decay=0.05, lr=1e-3),
    "lookahead_adamp": dict(opt="lookahead_adamp", weight_decay=1e-4,
                            lr=1e-3),
}


@pytest.fixture(scope="module")
def small_weights():
    """The small CoT net's variables as a port state_dict, from JAX's
    shapes (non-zero bn3 scales, so every aggregation reaches the loss)."""
    from cotnet_tpu_torch.utils.convert import jax_to_torch_state_dict

    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    _, flat = random_variables(JaxResNet(block=JaxCotBottleneck,
                                         **SMALL_NET), x, seed=8)
    return jax_to_torch_state_dict(flat)


def _batch_at(i):
    """The batch of global step i: a function of i alone."""
    rng = np.random.RandomState(100 + i)
    x = rng.randn(4, 64, 64, 3) * np.linspace(0.3, 2.0, 4)[:, None, None,
                                                           None]
    return {"image": nchw(x.astype(np.float32)),
            "label": torch.from_numpy(rng.randint(0, 10, size=4))}


def _trajectory(opt, weights):
    """A fresh (state, step, schedule) of the small CoT net: dropout 0.25,
    drop path 0.1, cosine warm-up, mixup and cutmix with smoothing, EMA."""
    model = ResNet(block=CotBottleneck, drop_rate=0.25, drop_path_rate=0.1,
                   **SMALL_NET)
    if weights is not None:
        model.load_state_dict(weights)
    solver = dict(SOLVERS[opt], sched="cosine", epochs=10, warmup_epochs=2,
                  warmup_lr=1e-4, min_lr=1e-5, base_lr=SOLVERS[opt]["lr"])
    schedule, _ = create_scheduler(solver, STEPS_PER_EPOCH)
    optimizer = create_optimizer(solver, model.parameters())
    state = TrainState.create(model, optimizer, ema=True)
    mixup = Mixup(mixup_alpha=0.8, cutmix_alpha=1.0, label_smoothing=0.1,
                  num_classes=10)
    step = make_train_step(model, optimizer, schedule,
                           soft_target_cross_entropy, ema_decay=0.99,
                           mixup_fn=mixup)
    return state, step


def _run(state, step, first, last):
    gen = torch.Generator()
    lrs = []
    for i in range(first, last):
        gen.manual_seed(train_cli.step_seed(1 + 777, state.step))
        state, m = step(state, _batch_at(i), gen)
        lrs.append(m["lr"])
    return lrs


def _assert_same(a, b, what):
    if torch.is_tensor(a):
        assert torch.equal(a, b), what
    elif isinstance(a, dict):
        assert sorted(a, key=str) == sorted(b, key=str), what
        for k in a:
            _assert_same(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{what}[{i}]")
    else:
        assert a == b, what


@pytest.mark.parametrize("opt", sorted(SOLVERS))
def test_resume_trajectory_equivalence(opt, small_weights, tmp_path):
    """train(2N) == train(N) -> save_recovery -> restore into a fresh model
    (other weights) and optimizer -> train(N), bit for bit: parameters, BN
    stats, EMA, optimizer state (Lookahead's slow weights and count, the
    chains' step counts), step and the LR of every step after the resume."""
    state_a, step_a = _trajectory(opt, small_weights)
    lrs_a = _run(state_a, step_a, 0, 2 * N)

    state_b, step_b = _trajectory(opt, small_weights)
    lrs_b = _run(state_b, step_b, 0, N)
    saver = checkpoint.CheckpointSaver(str(tmp_path / "ckpt"),
                                       recovery_interval=1)
    saver.save_recovery(state_b, 1)

    fresh, step_c = _trajectory(opt, None)
    restored = saver.restore(fresh, saver.find_recovery()["path"])
    assert restored.step == N
    lrs_b += _run(restored, step_c, N, 2 * N)

    assert len(set(lrs_a)) == 2 * N    # a new LR every step
    assert lrs_a == lrs_b
    assert restored.step == state_a.step == 2 * N
    _assert_same(state_a.model.state_dict(), restored.model.state_dict(),
                 "model")
    _assert_same(state_a.ema, restored.ema, "ema")
    _assert_same(state_a.optimizer.state_dict(),
                 restored.optimizer.state_dict(), "optimizer")
    if opt.startswith("lookahead"):
        assert isinstance(restored.optimizer, Lookahead)
        assert restored.optimizer.count == 2 * N


# ---- across the packages --------------------------------------------------

def _small_pair(seed, in_chans=3, num_classes=10):
    """(JAX model, its shapes, its variables as a port state_dict, x)."""
    from cotnet_tpu_torch.utils.convert import jax_to_torch_state_dict

    rng = np.random.RandomState(seed)
    x = rng.randn(2, 64, 64, in_chans).astype(np.float32)
    cfg = dict(SMALL_NET, num_classes=num_classes)
    jmodel = JaxResNet(block=JaxCotBottleneck, **cfg)
    shapes, flat = random_variables(jmodel, jnp.asarray(x), seed=seed)
    return jmodel, shapes, jax_to_torch_state_dict(flat), x


def test_save_weights_through_jax_convert(tmp_path):
    """The port's save_weights file, through the JAX package's
    convert_torch_checkpoint (strict), gives the port's logits within the
    converted whole-net tolerance (5e-4, f32), the weights and the EMA."""
    jmodel, shapes, sd, x = _small_pair(11)
    _, _, ema_sd, _ = _small_pair(12)
    path = str(tmp_path / "weights.pth.tar")
    checkpoint.save_weights(path, sd, ema_sd)
    apply = jax.jit(lambda v, x: jmodel.apply(v, x, training=False))
    for use_ema, weights in ((False, sd), (True, ema_sd)):
        variables = jax_convert.convert_torch_checkpoint(
            path, shapes, use_ema=use_ema, strict=True)
        ref = apply(variables, jnp.asarray(x))
        port = ResNet(block=CotBottleneck, **SMALL_NET).eval()
        port.load_state_dict(weights)
        with torch.no_grad():
            got = port(nchw(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=5e-4,
                                   atol=5e-4)


def test_reference_layout_loads_into_the_port(tmp_path):
    """A .pth.tar as the reference's saver writes it: 'module.' prefixes
    (DataParallel), state_dict_ema, an optimizer and an argparse Namespace;
    also a bare state_dict and a {'model': ...} file."""
    _, _, sd, _ = _small_pair(13)
    _, _, ema_sd, _ = _small_pair(14)
    path = str(tmp_path / "model_best.pth.tar")
    torch.save({"epoch": 300, "arch": "cotnet50",
                "state_dict": {f"module.{k}": v for k, v in sd.items()},
                "state_dict_ema": {f"module.{k}": v
                                   for k, v in ema_sd.items()},
                "optimizer": {"state": {}, "param_groups": []},
                "args": argparse.Namespace(lr=0.1, model="cotnet50"),
                "metric": 81.2}, path)
    for use_ema, want in ((False, sd), (True, ema_sd)):
        model = ResNet(block=CotBottleneck, **SMALL_NET)
        result = convert.load_checkpoint_into(model, path, use_ema=use_ema)
        assert not result.missing_keys and not result.unexpected_keys
        _assert_same(model.state_dict(), want, f"use_ema={use_ema}")
    for obj in (sd, {"model": sd}):
        torch.save(obj, path)
        _assert_same(convert.load_torch_checkpoint(path), sd, "bare")


@pytest.mark.parametrize("in_chans", [1, 2, 4, 5])
def test_adapt_input_conv_matches_jax(in_chans):
    rng = np.random.RandomState(in_chans)
    oihw = rng.randn(16, 3, 7, 7).astype(np.float32)
    got = convert.adapt_input_conv(torch.from_numpy(oihw), in_chans)
    ref = jax_convert.adapt_input_conv(oihw.transpose(2, 3, 1, 0), in_chans)
    assert tuple(got.shape) == (16, in_chans, 7, 7)
    np.testing.assert_allclose(got.numpy(), ref.transpose(3, 2, 0, 1),
                               rtol=1e-6, atol=1e-6)
    weight = torch.from_numpy(oihw)
    assert convert.adapt_input_conv(weight, 3) is weight


@pytest.mark.parametrize("in_chans", [1, 2, 4, 5])
def test_surgery_matches_jax(in_chans, tmp_path):
    """A 3-channel, 10-class state_dict against a model of ``in_chans`` and
    7 classes: the first conv adapted as the JAX package adapts it, the
    classifier left out (fresh), every other tensor kept; then
    load_checkpoint_into does the same from a file."""
    jmodel3, shapes3, sd, x = _small_pair(15)
    _, shapes, _, _ = _small_pair(16, in_chans=in_chans, num_classes=7)
    variables = jax_convert.convert_torch_state_dict(
        {k: v.numpy() for k, v in sd.items()}, shapes3, strict=True)
    ref = flatten_dict(jax_convert.surgery(variables, shapes)["params"],
                       sep="/")
    model = ResNet(block=CotBottleneck, in_chans=in_chans,
                   **dict(SMALL_NET, num_classes=7))
    fresh_fc = {k: v.clone() for k, v in model.state_dict().items()
                if k.startswith("fc.")}
    got = convert.surgery(sd, model)
    assert "conv1.weight" in got and not any(k.startswith("fc.") for k in got)
    assert not any(k.startswith("head/") or k.startswith("fc") for k in ref)
    np.testing.assert_allclose(
        got["conv1.weight"].numpy(),
        np.asarray(ref["conv1/kernel"]).transpose(3, 2, 0, 1), rtol=1e-6,
        atol=1e-6)
    assert sorted(got) == sorted(k for k in model.state_dict()
                                 if not k.startswith("fc."))

    path = str(tmp_path / "ref.pth.tar")
    torch.save({"state_dict": sd}, path)
    result = convert.load_checkpoint_into(model, path, in_chans=in_chans)
    assert sorted(result.missing_keys) == sorted(fresh_fc)
    _assert_same({k: v for k, v in model.state_dict().items()
                  if k.startswith("fc.")}, fresh_fc, "fresh classifier")
    assert torch.equal(model.conv1.weight, got["conv1.weight"])


def test_model_avg_down_matches_jax():
    for name in ("cotnet50", "cotnext50_2x48d", "cotnet101",
                 "cotnext101_2x48d", "se_cotnetd_50", "se_cotnetd_101",
                 "se_cotnetd_152", "resnet50d", "resnet50", "resnest50d",
                 "resnest50d_4s2x40d", "resnest101e", "skresnet50d"):
        assert convert.model_avg_down(name) == \
            jax_convert.model_avg_down(name), name
