"""Parity of the port's Visformer (``models/visformer.py``) and LeViT
(``models/levit.py``) with the JAX package, and of the BN over tokens
(``nn.TokenBatchNorm``), in f32 on the CPU.

The same seeded numpy variables go into both sides (carried into the port
by ``jax_to_torch_state_dict(family=...)``), and the output, the updated
running statistics and the gradients of ``sum(out * r)`` in the input and
in every parameter are held against ``jax.value_and_grad`` of the JAX
module, jitted once (``torch_family_parity.check_parity``): at ``1e-5 *
max|ref|``, or where a train-mode BN's cancelling sums move the JAX
gradient by more under a 1e-7 input perturbation, at 3 times that move.

- the token BN against the JAX package's ``batch_norm`` on ``[N, L, D]``
  and ``[N, D]``, in training and eval, and over a simulated group of two
  identical ranks (the all-reduce doubles its tensor): the output, the
  input gradient and the running statistics of one process on the batch
  taken twice, and half its parameter gradients;
- LeViT's bias index (``bias_index``, each module's
  ``attention_bias_idxs``) against the JAX ``_attn_bias_idx`` at
  resolutions 4, 7 and 14, at stride 1 and 2; its attention and
  subsampling in training and eval; a reduced LeViT at 64 px (maps 4, 2,
  1) in eval, plain, distilled and ``features_only``, and in training held
  with the JAX f32 model against the JAX model in f64 (the BNs over its
  last stage's few values amplify f32 rounding); a state_dict without
  the index buffers loads;
- Visformer's two kinds of block in training, and a reduced Visformer at
  64 px (maps 8, 4, 2) in training and eval, plain and ``features_only``;
  it is built for one input size and refuses another by name.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import linen as fnn  # noqa: E402
from flax.traverse_util import flatten_dict  # noqa: E402
from torch import nn  # noqa: E402

from cotnet_tpu.models import levit as jlevit  # noqa: E402
from cotnet_tpu.models import visformer as jvis  # noqa: E402
from cotnet_tpu.nn import batch_norm  # noqa: E402
from cotnet_tpu_torch.models import levit as plevit  # noqa: E402
from cotnet_tpu_torch.models import visformer as pvis  # noqa: E402
from cotnet_tpu_torch.nn import TokenBatchNorm, norm  # noqa: E402
from cotnet_tpu_torch.parallel import collectives  # noqa: E402
from cotnet_tpu_torch.utils.convert import \
    jax_to_torch_state_dict  # noqa: E402
from torch_family_parity import (check_parity, images,  # noqa: E402
                                 load_port, nchw, random_variables,
                                 unflatten)

LEVIT = dict(embed_dims=(32, 48, 64), key_dim=8, num_heads=(2, 3, 4),
             depths=(1, 1, 1), num_classes=10)
VIS = dict(init_channels=8, embed_dim=32, depths=(1, 1, 1), num_heads=2,
           num_classes=10)


def tokens(shape, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape) * np.linspace(0.5, 2.0, shape[-1]) \
        + np.linspace(-1.0, 1.0, shape[-1])
    return x.astype(np.float32)


class _JaxBN(fnn.Module):
    @fnn.compact
    def __call__(self, x, training: bool = False):
        return batch_norm(x, training, name="bn")


class _PortBN(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.bn = TokenBatchNorm(dim)

    def forward(self, x):
        return self.bn(x)


@pytest.mark.parametrize("shape", [(2, 9, 16), (6, 16)])
@pytest.mark.parametrize("training", [True, False])
def test_token_bn_matches_jax_batch_norm(shape, training):
    check_parity(_PortBN(16), _JaxBN(), tokens(shape, 0), 1, "levit",
                 training=training)


def test_token_bn_over_two_ranks(monkeypatch):
    """Two identical ranks: each rank's output and input gradient are one
    process's on the batch taken twice, at its rows, and so are the running
    statistics; its parameter gradients are half that process's (the step
    averages them across ranks)."""
    x = tokens((2, 9, 16), 2)
    r = np.random.RandomState(3).randn(*x.shape).astype(np.float32)
    flat = random_variables(_JaxBN(), x, 4)
    variables = unflatten(flat)

    def loss(params, x_, r_):
        out, stats = _JaxBN().apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            x_, training=True, mutable=["batch_stats"])
        return jnp.vdot(out, r_), (out, stats)

    twice = [np.concatenate([a, a]) for a in (x, r)]
    (_, (out, stats)), (gp, gx) = jax.value_and_grad(
        loss, (0, 1), has_aux=True)(variables["params"], *map(jnp.asarray,
                                                               twice))
    monkeypatch.setattr(collectives, "group_size", lambda group=None: 2)
    monkeypatch.setattr(norm, "group_size", lambda group=None: 2)
    monkeypatch.setattr(collectives.dist, "all_reduce",
                        lambda t, group=None: t.mul_(2))
    port = _PortBN(16).train()
    with torch.no_grad():
        port.bn.weight.copy_(torch.from_numpy(flat["params/bn/scale"]))
        port.bn.bias.copy_(torch.from_numpy(flat["params/bn/bias"]))
        port.bn.running_mean.copy_(
            torch.from_numpy(flat["batch_stats/bn/mean"]))
        port.bn.running_var.copy_(
            torch.from_numpy(flat["batch_stats/bn/var"]))
    xt = torch.from_numpy(x).requires_grad_()
    y = port(xt)
    (y * torch.from_numpy(r)).sum().backward()
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(out)[:2],
                               **tol)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx)[:2], **tol)
    np.testing.assert_allclose(2 * port.bn.weight.grad.numpy(),
                               np.asarray(gp["bn"]["scale"]), **tol)
    np.testing.assert_allclose(2 * port.bn.bias.grad.numpy(),
                               np.asarray(gp["bn"]["bias"]), **tol)
    np.testing.assert_allclose(port.bn.running_mean.numpy(),
                               np.asarray(stats["batch_stats"]["bn"]["mean"]),
                               **tol)
    np.testing.assert_allclose(port.bn.running_var.numpy(),
                               np.asarray(stats["batch_stats"]["bn"]["var"]),
                               **tol)


@pytest.mark.parametrize("res", [4, 7, 14])
def test_bias_index_is_the_jax_index(res):
    want, n_off = jlevit._attn_bias_idx(res, res)
    got, m = plevit.bias_index(res, res)
    assert m == n_off == res * res
    np.testing.assert_array_equal(got, want)
    attn = plevit.Attention(16, 8, 2, 2.0, res)
    np.testing.assert_array_equal(attn.attention_bias_idxs.numpy(), want)
    res_q = (res - 1) // 2 + 1
    want, n_off = jlevit._attn_bias_idx(res_q, res, stride=2)
    sub = plevit.AttentionSubsample(16, 24, 8, 2, 4.0, res)
    np.testing.assert_array_equal(sub.attention_bias_idxs.numpy(), want)
    assert tuple(sub.attention_biases.shape) == (2, n_off)
    assert tuple(sub.attention_bias_idxs.shape) == (res_q * res_q, res * res)


@pytest.mark.parametrize("training", [True, False])
def test_levit_attention_matches_jax(training):
    check_parity(plevit.Attention(16, 8, 2, 2.0, 4),
                 jlevit.LevitAttention(8, 2, 2.0, 4), tokens((2, 16, 16), 5),
                 6, "levit", training=training)


@pytest.mark.parametrize("training", [True, False])
def test_levit_subsample_matches_jax(training):
    check_parity(plevit.AttentionSubsample(16, 24, 8, 2, 4.0, 7),
                 jlevit.LevitSubsample(24, 8, 2, 4.0, 7),
                 tokens((2, 49, 16), 7), 8, "levit", training=training)


@pytest.mark.parametrize("features_only", [False, True])
def test_reduced_levit_matches_jax(features_only):
    """Eval mode: logits (each stage's map for ``features_only``) and every
    gradient at 1e-5 of the largest."""
    kw = dict(LEVIT, features_only=features_only)
    check_parity(plevit.Levit(img_size=64, **kw), jlevit.Levit(**kw),
                 images(4, 64), 9, "levit", image=True)


def _jax_train_grads(model, flat, x, r, dtype):
    """Train-mode ``sum(out * r)`` of the JAX ``model`` in ``dtype``: the
    output, d/dx and the parameter gradients (flattened ``params/...``) and
    the updated running statistics, as f64 numpy."""
    def loss(variables, x_):
        out, stats = model.apply(variables, x_, training=True,
                                 mutable=["batch_stats"])
        out = (jnp.concatenate([o.reshape(-1) for o in out])
               if isinstance(out, list) else out)
        return jnp.vdot(out, jnp.asarray(r, dtype)), (out, stats)

    variables = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype),
                                       unflatten(flat))
    (_, (out, stats)), (gv, gx) = jax.jit(jax.value_and_grad(
        loss, (0, 1), has_aux=True))(variables, jnp.asarray(x, dtype))
    flat_g = flatten_dict(gv["params"], sep="/")
    return (np.asarray(out, np.float64), np.asarray(gx, np.float64),
            {f"params/{k}": np.asarray(v, np.float64)
             for k, v in flat_g.items()},
            {f"batch_stats/{k}": np.asarray(v, np.float64) for k, v in
             flatten_dict(stats["batch_stats"], sep="/").items()})


@pytest.mark.parametrize("features_only", [False, True])
def test_reduced_levit_in_training_is_as_exact_as_jax(features_only):
    """Training mode: the BNs over the last stage's 4 tokens and the head's
    4 images are ill-conditioned (a channel's 4 values nearly equal), so
    two f32 programs that sum in other orders differ by up to 3e-4 of the
    largest gradient, beyond the JAX gradient's own move under a 1e-7
    input perturbation.  Both are held against the JAX model in f64
    instead: each of the port's output, input gradient, parameter
    gradients and running statistics lies within 1e-5 of its largest f64
    value of the f64 one, or within 10 times the JAX f32 model's distance
    from it (3.2 times the most seen here)."""
    kw = dict(LEVIT, features_only=features_only)
    model = jlevit.Levit(**kw)
    x = images(4, 64)
    flat = random_variables(model, x, 9)
    shape = jax.eval_shape(lambda x_: model.apply(unflatten(flat), x_),
                           jnp.asarray(x))
    n_out = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(
        shape))
    r = np.random.RandomState(10).randn(n_out).astype(np.float32)
    ref32 = _jax_train_grads(model, flat, x, r, jnp.float32)
    with jax.enable_x64(True):
        ref64 = _jax_train_grads(model, flat, x, r, jnp.float64)
    port = load_port(plevit.Levit(img_size=64, **kw), flat,
                     "levit").train()
    xt = nchw(x).requires_grad_()
    out = port(xt)
    out = (torch.cat([o.permute(0, 2, 3, 1).reshape(-1) for o in out])
           if features_only else out.reshape(-1))
    (out * torch.from_numpy(r)).sum().backward()
    params = dict(port.named_parameters())
    got = {"out": out.detach().numpy(),
           "dx": xt.grad.numpy().transpose(0, 2, 3, 1)}
    got.update({k: p.grad.numpy() for k, p in params.items()})
    got.update({k: v.numpy() for k, v in port.state_dict().items()
                if "running_" in k})

    def by_name(ref):
        out64, dx64, grads, stats = ref
        named = {"out": out64.reshape(-1), "dx": dx64}
        for tree in (grads, stats):
            named.update({k: v.numpy() for k, v in jax_to_torch_state_dict(
                tree, family="levit").items() if k in got})
        return named

    exact, jax32 = by_name(ref64), by_name(ref32)
    assert sorted(exact) == sorted(got)

    # a gradient that is zero but for rounding (a softmax over one key) is
    # held against the largest
    top = max(float(np.abs(v).max()) for v in exact.values())
    for k, v in exact.items():
        scale = max(float(np.abs(v).max()), 1e-6 * top)
        err = float(np.abs(got[k] - v).max())
        err32 = float(np.abs(jax32[k] - v).max())
        assert err <= max(1e-5 * scale, 10 * err32), (k, err, err32, scale)


def test_levit_distilled_head_matches_jax():
    kw = dict(LEVIT, distillation=True)
    port = plevit.Levit(img_size=64, **kw)
    assert port.head_dist.bn is None
    check_parity(port, jlevit.Levit(**kw), images(4, 64), 10, "levit",
                 image=True)


def test_levit_loads_a_state_dict_without_the_index_buffers():
    port = plevit.Levit(img_size=64, **LEVIT)
    sd = {k: v for k, v in port.state_dict().items()
          if not k.endswith("attention_bias_idxs")}
    assert len(sd) < len(port.state_dict())
    fresh = plevit.Levit(img_size=64, **LEVIT)
    fresh.load_state_dict(sd, strict=True)
    for k, v in port.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    with pytest.raises(ValueError, match="img_size"):
        port(torch.zeros(1, 3, 32, 32))


class _JaxVisBlock(fnn.Module):
    attn: bool

    @fnn.compact
    def __call__(self, x, training: bool = False):
        return [jvis.VisBlock(2, 1.0, 4.0, 8, attn_disabled=not self.attn,
                              spatial_conv=not self.attn, name="blk")(
            x, training)]


class _PortVisBlock(nn.Module):
    def __init__(self, attn):
        super().__init__()
        self.blk = pvis.VisBlock(16, 2, 1.0, 4.0, 8, attn_disabled=not attn,
                                 spatial_conv=not attn)

    def forward(self, x):
        return [self.blk(x)]


@pytest.mark.parametrize("attn", [True, False])
def test_visformer_block_matches_jax(attn):
    """The attention stages' block, and the first stage's (no attention,
    the grouped 3x3 in the MLP), in training."""
    check_parity(_PortVisBlock(attn), _JaxVisBlock(attn),
                 images(2, 6, 16, seed=11), 12, "visformer", image=True,
                 training=True)


@pytest.mark.parametrize("training,features_only", [
    (True, False), (False, False), (True, True)])
def test_reduced_visformer_matches_jax(training, features_only):
    kw = dict(VIS, features_only=features_only)
    check_parity(pvis.Visformer(img_size=64, **kw), jvis.Visformer(**kw),
                 images(2, 64), 13, "visformer", image=True,
                 training=training)


def test_visformer_shapes():
    port = pvis.Visformer(img_size=64, **VIS)
    assert port.pos_embed1.shape == (1, 16, 8, 8)
    assert port.pos_embed3.shape == (1, 64, 2, 2)
    assert port.stage1[0].attn is None
    assert port.stage1[0].mlp.conv2.weight.shape == (32, 4, 3, 3)
    assert port.stage2[0].mlp.conv1.weight.shape == (128, 32, 1, 1)
    with pytest.raises(ValueError, match="img_size"):
        port(torch.zeros(1, 3, 32, 32))
