"""Shared parity helpers of the comparison-family tests
(``test_torch_san.py``, ``test_torch_lrnet.py``,
``test_torch_attn_families.py``, ``test_torch_chassis_ext.py``): seeded
variables of any JAX module, carried into the port by
``jax_to_torch_state_dict``, and the forward and gradients of one module on
both sides in f32 on the CPU.

The JAX side runs ``impl="xla"`` (the aggregation's XLA form), each
function jitted once; the port runs its plain versions.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from cotnet_tpu_torch.nn import BatchNorm2d
from cotnet_tpu_torch.utils.convert import jax_to_torch_state_dict


def images(n=2, size=64, c=3, seed=0):
    """NHWC f32 inputs of differing contrast and brightness."""
    rng = np.random.RandomState(seed)
    return (rng.randn(n, size, size, c)
            * np.linspace(0.5, 2.0, n)[:, None, None, None]
            + np.linspace(-0.5, 0.5, n)[:, None, None, None]).astype(
                np.float32)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def to_nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def random_variables(module, x_nhwc, seed, *args):
    """``module``'s variables from a numpy seed, flattened to '/'-joined
    ``{params, batch_stats}`` keys: fan-in scaled kernels, norm scales in
    [0.5, 1], small biases, random BN running stats, and the raw parameters
    (position and relative embeddings, projections) at unit scale over the
    square root of their last dim.  ``args`` follow the input in the
    module's call."""
    shapes = jax.eval_shape(
        lambda r, x: module.init({"params": r}, x, *args, training=False),
        jax.random.PRNGKey(0), x_nhwc)
    rng = np.random.RandomState(seed)
    flat = {}
    for key, sds in sorted(flatten_dict(shapes, sep="/").items()):
        shape, leaf = sds.shape, key.rsplit("/", 1)[-1]
        if leaf == "kernel":
            v = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif leaf == "scale":
            v = 0.5 + 0.5 * rng.rand(*shape)
        elif leaf in ("bias", "mean"):
            v = 0.1 * rng.randn(*shape)
        elif leaf == "var":
            v = 0.5 + rng.rand(*shape)
        else:
            v = rng.randn(*shape) / np.sqrt(shape[-1])
        flat[key] = v.astype(np.float32)
    return flat


def unflatten(flat):
    out = {}
    for key, v in flat.items():
        node = out
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return out


def flat_np(tree, collection):
    return {f"{collection}/{k}": np.asarray(v)
            for k, v in flatten_dict(tree, sep="/").items()}


def load_port(port, flat, family=None, **kw):
    port.load_state_dict(jax_to_torch_state_dict(flat, family=family, **kw),
                         strict=True)
    return port


def jax_train_grads(module, flat, xs, r):
    """``sum(out * r)`` of ``module`` in training mode at each input of
    ``xs`` (one jitted function): per input (out, the updated batch stats,
    d/dx, d/dparams flattened as ``params/...``)."""
    variables = unflatten(flat)

    def loss(params, x_):
        out, mutated = module.apply(
            {"params": params,
             "batch_stats": variables.get("batch_stats", {})}, x_,
            training=True, mutable=["batch_stats"])
        return jnp.vdot(out, jnp.asarray(r)), (
            out, mutated.get("batch_stats", {}))

    fn = jax.jit(jax.value_and_grad(loss, (0, 1), has_aux=True))
    results = []
    for x in xs:
        (_, (out, stats)), (gp, gx) = fn(variables["params"], jnp.asarray(x))
        results.append((np.asarray(out), flat_np(stats, "batch_stats"),
                        np.asarray(gx), flat_np(gp, "params")))
    return results


def check_train_grads(port, module, flat, x, r, family=None, rel=1e-5,
                      **kw):
    """One module in training mode on both sides: the output, the updated
    running statistics, and the gradients of ``sum(out * r)`` in the input
    and in every parameter (the converter is linear, so it carries the JAX
    gradients onto the port's names).  Each is held at ``rel * max|ref|``,
    or where the JAX gradient itself moves by more under a 1e-7 relative
    perturbation of the input (a BN scale's gradient, a sum of products
    that cancel), at 3 times that move.  A gradient that a train-mode BN
    cancels (zero but for rounding, below 1e-6 of the largest parameter
    gradient) is held against that largest instead.  Returns the worst
    ratio of error to scale."""
    noise = 1e-7 * np.random.RandomState(99).randn(*x.shape)
    (out, stats, gx, gp), (_, _, gx2, gp2) = jax_train_grads(
        module, flat, [x, (x * (1 + noise)).astype(np.float32)], r)
    load_port(port, flat, family, **kw).train()
    xt = nchw(x).requires_grad_()
    got = port(xt)
    (got * nchw(r)).sum().backward()
    worst = []

    def close(what, g, want, moved=0.0, scale=None):
        scale = float(np.abs(want).max()) if scale is None else scale
        err = float(np.abs(g - want).max())
        worst.append(err / scale)
        limit = max(rel * scale, 3 * moved)
        assert err <= limit, (what, err, scale, moved)

    close("out", to_nhwc(got), out)
    close("dx", to_nhwc(xt.grad), gx, float(np.abs(gx2 - gx).max()))
    want = jax_to_torch_state_dict(gp, family=family, **kw)
    want2 = jax_to_torch_state_dict(gp2, family=family, **kw)
    top = max(float(v.abs().max()) for v in want.values())
    grads = dict(port.named_parameters())
    assert sorted(want) == sorted(grads)
    for name, g in want.items():
        scale = float(g.abs().max())
        close(name, grads[name].grad.numpy(), g.numpy(),
              float((want2[name] - g).abs().max()),
              scale if scale > 1e-6 * top else top)
    sd = port.state_dict()
    for k, v in jax_to_torch_state_dict(stats, family=family, **kw).items():
        if "running_" in k:
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=k)
    return max(worst)


def calibrate(port, x):
    """Running statistics of every BN set to the batch statistics of its
    own input on ``x`` (one eval forward with pre-hooks), so that an eval
    forward keeps its activations in range: at random init with identity
    statistics SAN's overflow (``tests/test_models.py:151-155``)."""
    def set_stats(m, args):
        xin = args[0].float()
        m.running_mean.copy_(xin.mean((0, 2, 3)))
        m.running_var.copy_(xin.var((0, 2, 3), unbiased=False))

    hooks = [m.register_forward_pre_hook(set_stats) for m in port.modules()
             if isinstance(m, BatchNorm2d)]
    try:
        with torch.no_grad():
            port.eval()(x)
    finally:
        for h in hooks:
            h.remove()


def check_logits(jax_model, port, flat, x, family=None, rel=5e-4, **kw):
    """Train-mode logits, the updated running statistics, then the eval
    logits after the port's BN statistics are calibrated on ``x`` and the
    calibrated statistics carried back into the JAX variables; logits at
    ``rel * max|logit|``."""
    from cotnet_tpu.utils.convert import convert_torch_state_dict

    variables = unflatten(flat)
    train_fn = jax.jit(lambda v, x_: jax_model.apply(
        v, x_, training=True, mutable=["batch_stats"]))
    eval_fn = jax.jit(lambda v, x_: jax_model.apply(v, x_, training=False))
    want, stats = train_fn(variables, jnp.asarray(x))
    load_port(port, flat, family, **kw).train()
    with torch.no_grad():
        got = port(nchw(x)).numpy()
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max()),
                               err_msg="train logits")
    sd = port.state_dict()
    for k, v in jax_to_torch_state_dict(flat_np(stats["batch_stats"],
                                                "batch_stats"),
                                        family=family, **kw).items():
        if "running_" in k:
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=k)
    calibrate(port, nchw(x))
    calibrated = convert_torch_state_dict(
        {k: v.numpy() for k, v in port.state_dict().items()}, variables,
        strict=True, **_jax_kw(family, **kw))
    want = np.asarray(eval_fn(calibrated, jnp.asarray(x)))
    with torch.no_grad():
        got = port.eval()(nchw(x)).numpy()
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max()),
                               err_msg="eval logits")


def _jax_kw(family, avg_down=False, **_):
    from cotnet_tpu.utils.convert import FAMILY_ADAPTERS

    return dict(avg_down=avg_down,
                adapter=FAMILY_ADAPTERS[family] if family else None)


def _flat_out(out, lib):
    """A module's output as one array: a list (``features_only``) is
    flattened and concatenated."""
    if isinstance(out, (list, tuple)):
        return lib.concatenate([o.reshape(-1) for o in out])
    return out


def check_parity(port, module, x, seed, family, rel=1e-5, *, image=False,
                 args=(), training=False):
    """Forward and gradients of one module or net on both sides in f32:
    the same seeded variables (``random_variables``, carried into the port
    by ``jax_to_torch_state_dict(family=...)``), the output, and the
    gradients of ``sum(out * r)`` in the input and in every parameter,
    against ``jax.value_and_grad`` of the JAX module, jitted once.  ``x``
    is NHWC images where ``image`` (the port takes NCHW, and its maps come
    back NCHW), else tokens; ``args`` follow the input in both calls (a
    numpy array goes to the port as a tensor);
    ``training`` runs both in training mode, with the BNs' batch
    statistics, and compares the updated running statistics too (rtol
    1e-5).  Each tensor is held at ``rel * max|ref|``, or where the JAX
    gradient itself moves by more under a 1e-7 relative perturbation of
    the input (a train-mode BN's cancelling sums), at 3 times that move;
    a gradient below 1e-6 of the largest parameter gradient is held
    against that largest.  Returns the worst ratio of error to scale
    (above ``rel`` only where a perturbation's move allowed it)."""
    flat = random_variables(module, x, seed, *args)
    variables = unflatten(flat)
    stats_in = variables.get("batch_stats", {})

    def apply(params, x_):
        v = {"params": params, "batch_stats": stats_in}
        if training:
            out, mutated = module.apply(v, x_, *args, training=True,
                                        mutable=["batch_stats"])
            return _flat_out(out, jnp), mutated.get("batch_stats", {})
        return _flat_out(module.apply(v, x_, *args, training=False),
                         jnp), {}

    shape = jax.eval_shape(lambda p, x_: apply(p, x_)[0],
                           variables["params"], jnp.asarray(x)).shape
    r = np.random.RandomState(seed + 1).randn(*shape).astype(np.float32)

    def loss(params, x_):
        out, stats = apply(params, x_)
        return jnp.vdot(out, jnp.asarray(r)), (out, stats)

    fn = jax.jit(jax.value_and_grad(loss, (0, 1), has_aux=True))
    noise = 1e-7 * np.random.RandomState(99).randn(*x.shape)
    results = []
    for xi in (x, (x * (1 + noise)).astype(np.float32)):
        (_, (out, stats)), (gp, gx) = fn(variables["params"],
                                         jnp.asarray(xi))
        results.append((np.asarray(out), flat_np(stats, "batch_stats"),
                        np.asarray(gx), flat_np(gp, "params")))
    (out, stats, gx, gp), (_, _, gx2, gp2) = results

    load_port(port, flat, family).train(training)
    xt = (nchw(x) if image else torch.from_numpy(x)).requires_grad_()
    got = port(xt, *(torch.from_numpy(a) if isinstance(a, np.ndarray)
                     else a for a in args))
    if isinstance(got, (list, tuple)) and image:
        got = [g.permute(0, 2, 3, 1) for g in got]
    got = _flat_out(got, torch)
    (got * torch.from_numpy(r)).sum().backward()
    worst = []

    def close(what, g, want, moved=0.0, scale=None):
        scale = float(np.abs(want).max()) if scale is None else scale
        err = float(np.abs(g - want).max())
        if scale == 0:   # a parameter the output does not reach
            assert err == 0, what
            return
        worst.append(err / scale)
        assert err <= max(rel * scale, 3 * moved), (what, err, scale, moved)

    close("out", got.detach().numpy(), out)
    dx = xt.grad.numpy()
    close("dx", dx.transpose(0, 2, 3, 1) if image else dx, gx,
          float(np.abs(gx2 - gx).max()))
    want = jax_to_torch_state_dict(gp, family=family)
    want2 = jax_to_torch_state_dict(gp2, family=family)
    top = max(float(v.abs().max()) for v in want.values())
    grads = dict(port.named_parameters())
    assert sorted(want) == sorted(grads)
    for name, g in want.items():
        scale = float(g.abs().max())
        got_g = grads[name].grad
        close(name, np.zeros(g.shape, np.float32) if got_g is None
              else got_g.numpy(), g.numpy(),
              float((want2[name] - g).abs().max()),
              scale if scale > 1e-6 * top else top)
    sd = port.state_dict()
    for k, v in jax_to_torch_state_dict(stats, family=family).items():
        if "running_" in k:
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=k)
    return max(worst)
