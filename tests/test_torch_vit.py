"""Parity of the port's Vision Transformer (``models/vision_transformer.py``)
and its LayerNorm with the JAX package, in f32 on the CPU.

The same seeded numpy variables go into both sides (carried into the port
by ``jax_to_torch_state_dict(family="vit")``), and the output and the
gradients of ``sum(out * r)`` in the input and in every parameter are held
against ``jax.value_and_grad`` of the JAX module, each function jitted
once: ``Attention``, ``Mlp`` and ``Block`` on ``[2, 17, 64]`` tokens, and a
reduced ``VisionTransformer`` (patch 8, 32 px, dim 64, depth 2, 4 heads)
plain, distilled, with the representation layer, without the qkv bias and
``features_only``.  Each tensor is held at ``1e-5 * max|ref|``; the worst
ratio seen is 9.3e-7 (f32 matmuls with the sums in another order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cotnet_tpu.models import vision_transformer as jvit  # noqa: E402
from cotnet_tpu.nn.norm import LayerNorm as JaxLayerNorm  # noqa: E402
from cotnet_tpu_torch.models import vision_transformer as pvit  # noqa: E402
from cotnet_tpu_torch.nn import LayerNorm  # noqa: E402
from cotnet_tpu_torch.utils.convert import jax_to_torch_state_dict  # noqa: E402
from torch_family_parity import (flat_np, images, nchw,  # noqa: E402
                                 random_variables, unflatten)


def jax_grads(module, flat, x, r):
    """(out, d/dx, d/dparams flattened as ``params/...``) of ``sum(out *
    r)``, one jitted function; ``out`` may be a list (``features_only``)."""
    variables = unflatten(flat)

    def loss(params, x_):
        out = module.apply({"params": params}, x_, training=False)
        flat_out = (jnp.stack(out) if isinstance(out, (list, tuple))
                    else out)
        return jnp.vdot(flat_out, jnp.asarray(r)), flat_out

    (_, out), (gp, gx) = jax.jit(jax.value_and_grad(loss, (0, 1),
                                                    has_aux=True))(
        variables["params"], jnp.asarray(x))
    return np.asarray(out), np.asarray(gx), flat_np(gp, "params")


def check(port, module, x, seed, rel, image=False):
    """Forward and gradients of ``port`` against ``module`` on ``x``
    (NHWC images where ``image``, else tokens); returns the worst ratio of
    error to the reference's largest value."""
    flat = random_variables(module, x, seed)
    shape = jax.eval_shape(
        lambda x_: module.apply(unflatten(flat), x_, training=False),
        jnp.asarray(x))
    shape = ((len(shape),) + shape[0].shape if isinstance(shape, list)
             else shape.shape)
    r = np.random.RandomState(seed + 1).randn(*shape).astype(np.float32)
    out, gx, gp = jax_grads(module, flat, x, r)
    port.load_state_dict(jax_to_torch_state_dict(flat, family="vit"),
                         strict=True)
    xt = (nchw(x) if image else torch.from_numpy(x)).requires_grad_()
    got = port(xt)
    if isinstance(got, list):
        got = torch.stack(got)
    (got * torch.from_numpy(r)).sum().backward()
    worst = []

    def close(what, g, want):
        err = float(np.abs(g - want).max())
        scale = float(np.abs(want).max())
        if scale == 0:   # the final norm under features_only: not used
            assert err == 0, what
            return
        worst.append(err / scale)
        assert err <= rel * scale, (what, err, scale)

    close("out", got.detach().numpy(), out)
    dx = xt.grad.numpy()
    close("dx", dx.transpose(0, 2, 3, 1) if image else dx, gx)
    want = jax_to_torch_state_dict(gp, family="vit")
    grads = dict(port.named_parameters())
    assert sorted(want) == sorted(grads)
    for name, g in want.items():
        got_g = grads[name].grad
        close(name, np.zeros(g.shape, np.float32) if got_g is None
              else got_g.numpy(), g.numpy())
    return max(worst)


def tokens(seed, n=2, length=17, d=64):
    """Tokens with a per-token offset (as after a residual add) and unit
    spread."""
    rng = np.random.RandomState(seed)
    return (rng.randn(n, length, d)
            + rng.randn(n, length, 1)).astype(np.float32)


MODULES = {
    "attention": (lambda: jvit.Attention(num_heads=4),
                  lambda: pvit.Attention(64, num_heads=4)),
    "attention_no_qkv_bias": (lambda: jvit.Attention(num_heads=4,
                                                     qkv_bias=False),
                              lambda: pvit.Attention(64, 4, qkv_bias=False)),
    "mlp": (lambda: jvit.Mlp(hidden=256), lambda: pvit.Mlp(64, 256)),
    "block": (lambda: jvit.Block(num_heads=4), lambda: pvit.Block(64, 4)),
}


@pytest.mark.parametrize("name", list(MODULES))
def test_module_matches_jax(name):
    """Output and gradients at 1e-5 of the largest."""
    jax_module, port = MODULES[name]
    assert check(port(), jax_module(), tokens(1), seed=3, rel=1e-5) < 1e-5


NET = dict(patch_size=8, embed_dim=64, depth=2, num_heads=4, num_classes=10)
NETS = {
    "plain": {},
    "distilled": dict(distilled=True),
    "representation": dict(representation_size=32),
    "no_qkv_bias": dict(qkv_bias=False),
    "features_only": dict(features_only=True),
}


@pytest.mark.parametrize("variant", list(NETS))
def test_reduced_vit_matches_jax(variant):
    """A reduced ViT on 32 px images, 16 patches: logits (each block's
    tokens for ``features_only``) and the gradients in the image and every
    parameter, at 1e-5 of the largest."""
    kw = dict(NET, **NETS[variant])
    x = images(2, 32)
    port = pvit.VisionTransformer(img_size=32, **kw)
    assert check(port, jvit.VisionTransformer(**kw), x, seed=5, rel=1e-5,
                 image=True) < 1e-5


def test_vit_is_built_for_one_input_size():
    port = pvit.VisionTransformer(img_size=32, **NET)
    assert port.pos_embed.shape == (1, 17, 64)
    with pytest.raises(ValueError, match="img_size"):
        port(torch.zeros(1, 3, 64, 64))


def test_representation_layer_dropped_for_another_class_count():
    from cotnet_tpu_torch.models import model_entrypoint

    with torch.device("meta"):
        kept = model_entrypoint("vit_base_patch16_sam_224")()
        dropped = model_entrypoint("vit_large_patch32_224_in21k")(
            num_classes=1000)
        in21k = model_entrypoint("vit_large_patch32_224_in21k")(
            num_classes=21843)
    assert kept.pre_logits is not None and dropped.pre_logits is None
    assert in21k.pre_logits.weight.shape == (1024, 1024)


def test_layernorm_on_tokens_far_from_zero():
    """Tokens with |mean| = 3 and std 0.02: the port's two-pass LayerNorm
    against the JAX package's; the one-pass form ``E[x^2] - E[x]^2``
    misses by more than 1e-3 there.  The output at 1e-5 of the largest,
    the gradients at 1e-4: the mean's own f32 rounding (half an ulp of 3,
    1.2e-7) shifts every normalized value by 6e-6 of the std, in another
    direction on each side (the sums run in another order), and dweight
    and dbias add 36 of them (1.6e-5 the worst seen)."""
    rng = np.random.RandomState(7)
    x = (3.0 + 0.02 * rng.randn(4, 9, 256)).astype(np.float32)
    r = rng.randn(*x.shape).astype(np.float32)
    scale = (1 + 0.1 * rng.randn(256)).astype(np.float32)
    bias = (0.1 * rng.randn(256)).astype(np.float32)
    module = JaxLayerNorm(epsilon=1e-6)
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}

    def loss(p, x_):
        y = module.apply({"params": p}, x_)
        return jnp.vdot(y, jnp.asarray(r)), y

    (_, want), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, (0, 1), has_aux=True))(params, jnp.asarray(x))
    port = LayerNorm(256, 1e-6)
    port.load_state_dict({"weight": torch.from_numpy(scale),
                          "bias": torch.from_numpy(bias)})
    xt = torch.from_numpy(x).requires_grad_()
    got = port(xt)
    (got * torch.from_numpy(r)).sum().backward()
    for what, g, ref in (("out", got.detach(), want), ("dx", xt.grad, gx),
                         ("dweight", port.weight.grad, gp["scale"]),
                         ("dbias", port.bias.grad, gp["bias"])):
        ref = np.asarray(ref)
        rel = 1e-5 if what == "out" else 1e-4
        np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                   atol=rel * np.abs(ref).max(),
                                   err_msg=what)
    xt = torch.from_numpy(x)
    mean = xt.mean(-1, keepdim=True)
    var = (xt.square().mean(-1, keepdim=True) - mean.square()).clamp_min(0)
    with torch.no_grad():
        one_pass = ((xt - mean) * torch.rsqrt(var + 1e-6) * port.weight
                    + port.bias)
    assert float((one_pass - got.detach()).abs().max()) > 1e-3
