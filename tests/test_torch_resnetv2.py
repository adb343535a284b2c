"""Parity of the port's ResNetV2 (``models/resnetv2.py``), its ``nn``
pieces (``pad_same``, ``max_pool2d_same``, ``StdConv2d``, the 32-group
``GroupNorm``) and the hybrid ViTs (``models/vision_transformer_hybrid.py``)
with the JAX package, in f32 on the CPU.

The same seeded numpy variables go into both sides (carried into the port
by ``jax_to_torch_state_dict(family=...)``; ``tests/torch_family_parity.py``
makes them), each JAX function jitted once.  Modules: the output and the
gradients of ``sum(out * r)`` in the input and every parameter at 1e-5 of
the largest, or at 3 times the JAX gradient's own move under a 1e-7
relative perturbation of the input where a train-mode norm's sum cancels
(``check_train_grads``).  Reduced nets (64 px, two stages of one block):
train-mode logits, the updated BN statistics, the gradients, and eval
logits from the seeded running statistics, each at the limit its test
gives with its reason.
"""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import linen as fnn  # noqa: E402

from cotnet_tpu.models import resnetv2 as jrv2  # noqa: E402
from cotnet_tpu.models import vision_transformer_hybrid as jhyb  # noqa: E402
from cotnet_tpu.models.vision_transformer import \
    VisionTransformer as JaxViT  # noqa: E402
from cotnet_tpu.nn import StdConv2d as JaxStdConv2d  # noqa: E402
from cotnet_tpu.nn import max_pool2d_same as jax_max_pool2d_same  # noqa: E402
from cotnet_tpu.nn import pad_same as jax_pad_same  # noqa: E402
from cotnet_tpu_torch.models import resnetv2 as prv2  # noqa: E402
from cotnet_tpu_torch.models import vision_transformer_hybrid as phyb  # noqa: E402
from cotnet_tpu_torch.models.vision_transformer import VisionTransformer  # noqa: E402
from cotnet_tpu_torch.nn import (GroupNorm, StdConv2d, max_pool2d_same,  # noqa: E402
                                 pad_same)
from cotnet_tpu_torch.utils.convert import jax_to_torch_state_dict  # noqa: E402
from torch_family_parity import (check_train_grads, flat_np,  # noqa: E402
                                 images, nchw, random_variables, to_nhwc,
                                 unflatten)


# ---- TF-SAME padding and pooling, the standardized conv, the GroupNorm -----

@pytest.mark.parametrize("size,k,s", [(7, 3, 2), (8, 3, 2), (9, 7, 2),
                                      (8, 7, 2), (5, 3, 1), (6, 2, 2),
                                      (11, 3, 3)])
def test_pad_same_and_max_pool_same_match_jax(size, k, s):
    """Odd and even sizes and strides: the same pads, the same values and
    the same pooled bits (the pad's float32 minimum never wins a window)."""
    x = images(2, size, c=4)
    x[:, :, 0] -= 5.0  # negative edges, where a zero pad would win
    got = pad_same(nchw(x), k, s, value=1.5)
    want = np.asarray(jax_pad_same(jnp.asarray(x), (k, k), (s, s),
                                   value=1.5))
    np.testing.assert_array_equal(to_nhwc(got), want)
    got = max_pool2d_same(nchw(x), k, s)
    want = np.asarray(jax_max_pool2d_same(jnp.asarray(x), k, s))
    np.testing.assert_array_equal(to_nhwc(got), want)


@pytest.mark.parametrize("eps,groups,stride", [(1e-5, 1, 1), (1e-8, 1, 2),
                                               (1e-5, 4, 1)])
def test_std_conv_matches_jax(eps, groups, stride):
    """The weight standardized as ``(w - mean) / (std + eps)`` with the
    biased std, both eps values, grouped: output and gradients at 1e-5 of
    the largest (``check_train_grads``)."""
    x = images(2, 9, c=8)
    module = _Training(JaxStdConv2d(16, 3, stride, 1, groups=groups,
                                    eps=eps))
    port = _Named(StdConv2d(8, 16, 3, stride, 1, groups=groups, eps=eps),
                  "inner")
    flat = random_variables(module, x, seed=3)
    shape = jax.eval_shape(lambda x_: module.apply(unflatten(flat), x_),
                           jnp.asarray(x)).shape
    r = np.random.RandomState(4).randn(*shape).astype(np.float32)
    check_train_grads(port, module, flat, x, r, family="resnetv2")


class _Training(fnn.Module):
    """A module without ``training`` under the parity helpers' call."""

    inner: fnn.Module

    @fnn.compact
    def __call__(self, x, training: bool = False):
        return self.inner(x)


def dyadic_far_from_zero(seed, shape):
    """Values ``4 + k/64`` with k in [-2, 2]: |mean| >> std, and every sum
    of up to 128 of them and of their squares exact in f32, so the
    statistics are the same bits in any order of summation."""
    k = np.random.RandomState(seed).randint(-2, 3, size=shape)
    return (4.0 + k / 64.0).astype(np.float32)


def test_group_norm_follows_the_one_pass_form():
    """64 channels at 8x8 (128 values a group): the port's GroupNorm
    against flax's ``GroupNorm(num_groups=32)`` at 1e-5 of the largest,
    output and gradients; the two-pass ``torch.nn.functional.group_norm``
    differs from both by more than 1e-4 of the largest, since
    ``E[x^2] - E[x]^2`` cancels here."""
    x = dyadic_far_from_zero(5, (2, 8, 8, 64))
    module = _Training(fnn.GroupNorm(num_groups=32, epsilon=1e-5))
    flat = random_variables(module, x, seed=6)
    r = np.random.RandomState(7).randn(*x.shape).astype(np.float32)
    port = _Named(GroupNorm(64, 32, 1e-5), "inner")
    check_train_grads(port, module, flat, x, r, family="resnetv2")
    with torch.no_grad():
        got = port(nchw(x))
        two_pass = torch.nn.functional.group_norm(
            nchw(x), 32, port.inner.weight, port.inner.bias, 1e-5)
    assert float((got - two_pass).abs().max()) > 1e-4 * float(
        got.abs().max())


class _Named(torch.nn.Module):
    """``module`` under the name the JAX side gives it."""

    def __init__(self, module, name):
        super().__init__()
        self.add_module(name, module)
        self.name = name

    def forward(self, x):
        return getattr(self, self.name)(x)


# ---- the bottlenecks --------------------------------------------------------

# (preact, std_conv + GN or plain conv + BN, pad_mode, avg_down)
BLOCKS = {
    "preact_gn_same": (True, "gn", "same", False),
    "preact_bn_avg_down": (True, "bn", "symmetric", True),
    "plain_gn_same_avg_down": (False, "gn", "same", True),
    "plain_bn": (False, "bn", "symmetric", False),
}


@pytest.mark.parametrize("case", list(BLOCKS))
def test_bottleneck_matches_jax(case):
    """A strided bottleneck with its projection shortcut (64 -> 128
    channels, 9x9 -> 5x5), train mode: output, BN statistics and
    gradients (``check_train_grads``)."""
    preact, norm, pad_mode, avg_down = BLOCKS[case]
    std = norm == "gn"
    jax_cls = jrv2.PreActBottleneck if preact else jrv2.Bottleneck
    block = jax_cls(128, 32, stride=2, avg_down=avg_down, std_conv=std,
                    norm=norm, pad_mode=pad_mode)
    x = images(2, 9, c=64)
    flat = random_variables(block, x, seed=11)
    r = np.random.RandomState(12).randn(2, 5, 5, 128).astype(np.float32)
    f = prv2.ConvFactory(std, norm, same=pad_mode == "same")
    port_cls = prv2.PreActBottleneck if preact else prv2.Bottleneck
    check_train_grads(port_cls(f, 64, 128, 32, 2, avg_down), block, flat, x,
                      r, family="resnetv2")


# ---- reduced nets -----------------------------------------------------------

def f64_twin(port):
    """A copy of ``port`` that computes in f64."""
    twin = copy.deepcopy(port).double()
    for m in twin.modules():
        if getattr(m, "dtype", None) == torch.float32:
            m.dtype = torch.float64
    return twin


def net_parity(jax_model, port, x, seed, family, rel_logits, rel_grads):
    """Train-mode logits, the updated BN statistics and the gradients of
    ``sum(logits * r)`` in the image and every parameter, then the eval
    logits from those statistics, of ``port`` against ``jax_model`` (one
    jitted function, run again on a 1e-7 relative perturbation of the
    image).  Logits at ``rel_logits`` of the largest.  A gradient at
    ``rel_grads`` of its largest, or at 3 times the larger of the JAX
    gradient's move under the perturbation and the port's own f32 error
    against its f64 twin: both measure how the function's conditioning
    amplifies f32 rounding.  The train-mode BN's one-pass variance, whose
    gradient ``2(x - mean)/N`` is formed as ``2x/N - 2mean/N``, cancels
    where a channel's |mean| >> std: under the deep preact stem the port's
    f32 input gradient lies 4e-4 of its largest from the f64 value on one
    thread (3e-8 on several, which sum in blocks), the JAX package's fused
    BN backward 1e-4.  Returns the worst ratio of error to limit."""
    flat = random_variables(jax_model, x, seed)
    variables = unflatten(flat)
    stats = variables.get("batch_stats", {})
    shape = jax.eval_shape(
        lambda x_: jax_model.apply(variables, x_, training=False),
        jnp.asarray(x)).shape
    r = np.random.RandomState(seed + 1).randn(*shape).astype(np.float32)

    def loss(params, x_):
        out, mutated = jax_model.apply(
            {"params": params, "batch_stats": stats}, x_, training=True,
            mutable=["batch_stats"])
        return jnp.vdot(out, jnp.asarray(r)), (
            out, mutated.get("batch_stats", {}))

    @jax.jit
    def fn(params, x_):
        (_, (out, new_stats)), grads = jax.value_and_grad(
            loss, (0, 1), has_aux=True)(params, x_)
        # eval from the statistics the train forward left, as the port's
        evals = jax_model.apply({"params": params,
                                 "batch_stats": new_stats}, x_,
                                training=False)
        return out, new_stats, grads, evals

    noise = 1e-7 * np.random.RandomState(99).randn(*x.shape)
    out, new_stats, (gp, gx), evals = fn(variables["params"],
                                         jnp.asarray(x))
    _, _, (gp2, gx2), _ = fn(variables["params"],
                             jnp.asarray((x * (1 + noise)).astype(np.float32)))
    port.load_state_dict(jax_to_torch_state_dict(flat, family=family),
                         strict=True)
    twin = f64_twin(port).train()
    x64 = nchw(x).double().requires_grad_()
    (twin(x64) * torch.from_numpy(r).double()).sum().backward()
    port.train()
    xt = nchw(x).requires_grad_()
    got = port(xt)
    (got * torch.from_numpy(r)).sum().backward()
    worst = []

    def close(what, g, want, rel, noise=0.0):
        want = np.asarray(want)
        limit = max(rel * float(np.abs(want).max()), 3 * noise)
        err = float(np.abs(g - want).max())
        worst.append(err / limit)
        assert err <= limit, (what, err, limit)

    def spread(a, b, c, d):
        return max(float(np.abs(np.asarray(a) - np.asarray(b)).max()),
                   float(np.abs(np.asarray(c) - np.asarray(d)).max()))

    close("train logits", got.detach().numpy(), out, rel_logits)
    dx = to_nhwc(xt.grad)
    close("dx", dx, gx, rel_grads, spread(gx2, gx, dx, to_nhwc(x64.grad)))
    want = jax_to_torch_state_dict(flat_np(gp, "params"), family=family)
    want2 = jax_to_torch_state_dict(flat_np(gp2, "params"), family=family)
    grads = dict(port.named_parameters())
    grads64 = dict(twin.named_parameters())
    assert sorted(want) == sorted(grads)
    for name, g in want.items():
        got_g = grads[name].grad.numpy()
        close(name, got_g, g.numpy(), rel_grads,
              spread(want2[name], g, got_g, grads64[name].grad))
    sd = port.state_dict()
    for k, v in jax_to_torch_state_dict(flat_np(new_stats, "batch_stats"),
                                        family=family).items():
        if "running_" in k:
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=k)
    port.eval()
    with torch.no_grad():
        close("eval logits", port(nchw(x)).numpy(), evals, rel_logits)
    return max(worst)


# stem -> the norm its rows take (the BiT stems GN with standardized
# convs, the torch-style ones BN with avg_down)
STEMS = {"": "bn", "fixed": "gn", "same": "gn", "deep": "bn", "tiered": "bn"}


@pytest.mark.parametrize("preact", [True, False])
@pytest.mark.parametrize("stem", list(STEMS))
def test_reduced_resnetv2_matches_jax(stem, preact):
    """ResNetV2 with two stages of one block at 64 px, each stem, preact on
    and off.  Logits at 1e-5 of the largest (1.5e-6 the worst seen);
    gradients at 2e-5 of their largest (1.1e-5 the worst seen where that
    limit governs), or at ``net_parity``'s measure of the rounding the
    function amplifies."""
    norm = STEMS[stem]
    kw = dict(layers=(1, 1), num_classes=10, stem_type=stem, preact=preact,
              std_conv=norm == "gn", norm=norm, avg_down=norm == "bn")
    worst = net_parity(jrv2.ResNetV2(**kw), prv2.ResNetV2(**kw),
                       images(2, 64), seed=21, family="resnetv2",
                       rel_logits=1e-5, rel_grads=2e-5)
    assert worst <= 1.0


HYBRID = dict(embed_dim=64, depth=1, num_heads=4, num_classes=10)
# backbone -> (JAX backbone, the port's, patch size)
HYBRIDS = {
    "r_stem_only": (lambda: jhyb._r_backbone(()),
                    lambda: phyb.r_backbone(()), 8),
    "r_two_stages": (lambda: jhyb._r_backbone((1, 1)),
                     lambda: phyb.r_backbone((1, 1)), 1),
    "d_resnet": (lambda: jhyb._d_backbone((1, 1), 2),
                 lambda: phyb.d_backbone((1, 1), 2), 1),
}


@pytest.mark.parametrize("case", list(HYBRIDS))
def test_reduced_hybrid_matches_jax(case):
    """A one-block ViT on each backbone kind at 64 px: the R+Ti stem alone
    (patch 8, 2x2 tokens), ResNetV2 with two stages and the ResNet-D
    chassis to its second stage (8x8 tokens).  Limits as the reduced
    ResNetV2's."""
    jax_backbone, port_backbone, patch = HYBRIDS[case]
    jax_model = JaxViT(backbone=jax_backbone(), patch_size=patch, **HYBRID)
    port = VisionTransformer(img_size=64, backbone=port_backbone(),
                             patch_size=patch, **HYBRID)
    worst = net_parity(jax_model, port, images(2, 64), seed=31,
                       family="vit_hybrid", rel_logits=1e-5,
                       rel_grads=2e-5)
    assert worst <= 1.0
