"""Parity of the port's last JAX API pieces with the JAX package, in f32 on
the CPU: the pools ``avg_pool2d_same`` and ``median_pool2d``; the layer
tail of ``nn/extra.py`` (``Shiftlution``, ``TBConv``, ``Kerv2d``,
``space_to_depth``, the EvoNorms with ``instance_std`` / ``group_std``,
``SplitBatchNorm``, ``test_time_pool``); ``normalize_padding`` and
``DenseGroupedConv``, also as the CoT key conv in a reduced cotnet50 (the
JAX package's ``COTNET_DENSE_GROUPED`` form); ``local_aggregate_wt``; ``resolve_data_config`` and
``set_layer_config``.

The same seeded numpy variables go into both sides, each tensor carried
across by hand (a kernel HWIO -> OIHW, a vector to the port's shape).  The
output and the gradients of ``sum(out * r)`` in the input and in every
parameter are held against ``jax.value_and_grad`` of the JAX function,
jitted once, at ``1e-5 * max|ref|`` (both sides sum in f32, in other
orders) unless a test says otherwise; data movement (the shifts,
space-to-depth, the median's sort) is held bit for bit.
"""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax.traverse_util import flatten_dict  # noqa: E402

import cotnet_tpu.models.cotnet as jcot  # noqa: E402
import cotnet_tpu.ops.local_agg_pallas as lap  # noqa: E402
from cotnet_tpu.models import helpers as jhelpers  # noqa: E402
from cotnet_tpu.models import list_models as jax_list_models  # noqa: E402
from cotnet_tpu.models.resnet import ResNet as JaxResNet  # noqa: E402
from cotnet_tpu.nn import config as jconfig  # noqa: E402
from cotnet_tpu.nn import conv as jconv  # noqa: E402
from cotnet_tpu.nn import extra as jextra  # noqa: E402
from cotnet_tpu.nn import pool as jpool  # noqa: E402
from cotnet_tpu.ops import local_aggregate_wt as jax_local_aggregate_wt  # noqa: E402
from cotnet_tpu_torch import config as pconfig_pkg  # noqa: E402
from cotnet_tpu_torch import models as pmodels  # noqa: E402
from cotnet_tpu_torch.models import factory as pfactory  # noqa: E402
from cotnet_tpu_torch.models import helpers as phelpers  # noqa: E402
from cotnet_tpu_torch.models.cotnet import CotBottleneck, CotLayer  # noqa: E402
from cotnet_tpu_torch.models.resnet import ResNet  # noqa: E402
from cotnet_tpu_torch.nn import config as pconfig  # noqa: E402
from cotnet_tpu_torch.nn import conv as pconv  # noqa: E402
from cotnet_tpu_torch.nn import extra as pextra  # noqa: E402
from cotnet_tpu_torch.nn import pool as ppool  # noqa: E402
from cotnet_tpu_torch.ops import local_agg as la  # noqa: E402
from cotnet_tpu_torch.utils.convert import jax_to_torch_state_dict  # noqa: E402
from torch_family_parity import (flat_np, maps, nchw,  # noqa: E402
                                 random_variables, to_nhwc, unflatten)


def close(what, got, want, rel=1e-5):
    scale = float(np.abs(want).max())
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rel * scale, (what, err, scale)


def jax_variables(module, x, seed, **call):
    """``module``'s variables flattened to '/'-joined keys, from a numpy
    seed: fan-in scaled kernels, biases and running means near 0, scales,
    ``v``, running variances and balances near 1."""
    shapes = jax.eval_shape(
        lambda r, x_: module.init({"params": r}, x_, **call),
        jax.random.PRNGKey(0), x)
    rng = np.random.RandomState(seed)
    flat = {}
    for key, sds in sorted(flatten_dict(shapes, sep="/").items()):
        shape, leaf = sds.shape, key.rsplit("/", 1)[-1]
        if leaf == "kernel":
            v = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif leaf in ("bias", "mean"):
            v = 0.1 * rng.randn(*shape)
        else:   # scale, v, var, balance
            v = 0.5 + rng.rand(*shape)
        flat[key] = v.astype(np.float32)
    return flat


def to_port_layout(v, shape):
    """A JAX variable in the port's layout: HWIO kernels to OIHW, the rest
    reshaped."""
    v = np.asarray(v)
    if v.ndim == 4:
        v = v.transpose(3, 2, 0, 1)
    return torch.from_numpy(np.array(v.reshape(shape)))


def check_module(port, module, x, mapping, seed=0, training=None,
                 init=None, rel=1e-5):
    """One module on both sides: the output, the gradients of ``sum(out *
    r)`` in the input and in each parameter, and in training the updated
    batch statistics.  ``mapping`` names the JAX flat key of each entry of
    the port's state_dict; ``training`` is passed to a module that takes
    it; ``init`` are the call's arguments at init (default the
    ``training`` flag)."""
    call = {} if training is None else {"training": training}
    flat = jax_variables(module, jnp.asarray(x), seed,
                         **(call if init is None else init))
    variables = unflatten(flat)
    stats = variables.get("batch_stats", {})

    def loss(params, x_):
        out, mutated = module.apply({"params": params, "batch_stats": stats},
                                    x_, mutable=["batch_stats"], **call)
        rr = jnp.asarray(np.random.RandomState(seed + 1).randn(
            *out.shape).astype(np.float32))
        return jnp.vdot(out, rr), (out, rr, mutated.get("batch_stats", {}))

    (_, (out, rr, new_stats)), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, (0, 1), has_aux=True))(variables["params"], jnp.asarray(x))
    sd = port.state_dict()
    assert sorted(mapping) == sorted(k for k in sd
                                     if not k.endswith("num_batches_tracked"))
    port.load_state_dict({**sd, **{name: to_port_layout(flat[key],
                                                        sd[name].shape)
                                   for name, key in mapping.items()}})
    port.train(bool(training))
    xt = nchw(x).requires_grad_()
    got = port(xt)
    (got * nchw(np.asarray(rr))).sum().backward()
    close("out", to_nhwc(got), np.asarray(out), rel)
    close("dx", to_nhwc(xt.grad), np.asarray(gx), rel)
    grads = flat_np(gp, "params")
    params = dict(port.named_parameters())
    assert sorted(params) == sorted(k for k, v in mapping.items()
                                    if v.startswith("params/"))
    for name, p in params.items():
        # a parameter the call does not use (an aux BN in eval) has no
        # gradient, and JAX's is zero
        got_grad = torch.zeros_like(p) if p.grad is None else p.grad
        close(name, got_grad.numpy(),
              to_port_layout(grads[mapping[name]], p.shape).numpy(), rel)
    if training:
        stats = flat_np(new_stats, "batch_stats")
        for name, key in mapping.items():
            if key.startswith("batch_stats/"):
                close(name, port.state_dict()[name].numpy(),
                      to_port_layout(stats[key], sd[name].shape).numpy(),
                      rel)
    return got


# --- the pools ---------------------------------------------------------------

@pytest.mark.parametrize("k, s, shape", [
    (3, 2, (2, 9, 10, 5)), (2, 2, (2, 7, 7, 3)), (3, 1, (1, 6, 5, 4)),
    ((3, 5), (2, 1), (2, 11, 8, 3))])
def test_avg_pool2d_same_matches_jax(k, s, shape):
    """Padding left out of each window's count: the corner windows of an
    odd map divide by fewer than k*k."""
    x = maps(shape, 0)
    ref = np.asarray(jpool.avg_pool2d_same(jnp.asarray(x), k, s))
    got = ppool.avg_pool2d_same(nchw(x), k, s)
    close("avg_pool2d_same", to_nhwc(got), ref, 1e-6)


@pytest.mark.parametrize("k, s, p", [(3, 1, 1), (2, 1, 0), (4, 2, 1),
                                     ((3, 2), (1, 2), (1, 0))],
                         ids=["odd3", "even2", "even4", "3x2"])
def test_median_pool2d_matches_jax(k, s, p):
    """Bit for bit, an odd window's middle tap and an even window's mean of
    the two middle ones; for an even window ``torch.median``'s lower middle
    differs."""
    x = maps((2, 7, 6, 3), 1)
    ref = np.asarray(jpool.median_pool2d(jnp.asarray(x), k, s, p))
    got = to_nhwc(ppool.median_pool2d(nchw(x), k, s, p))
    np.testing.assert_array_equal(got, ref)
    (kh, kw), (sh, sw), (ph, pw) = (jconv.to_2tuple(v) for v in (k, s, p))
    if (kh * kw) % 2 == 0:
        xp = torch.nn.functional.pad(nchw(x), (pw, pw, ph, ph))
        lower = xp.unfold(2, kh, sh).unfold(3, kw, sw).flatten(-2).median(
            -1).values
        assert not np.array_equal(to_nhwc(lower), ref)


# --- the layer tail ----------------------------------------------------------

@pytest.mark.parametrize("kh, kw, c", [(3, 3, 20), (5, 3, 33)])
def test_shiftlution_matches_jax(kh, kw, c):
    """The offsets in numpy's argsort order, and the shifted spans (the
    leftover channels passed through) bit for bit."""
    assert pextra._sorted_shifts(kh, kw) == jextra._sorted_shifts(kh, kw)
    assert pextra._sorted_shifts(kh, kw)[0] == (0, 0)
    x = maps((2, 7, 6, c), 2)
    module = jextra.Shiftlution(channels=c, kernel_h=kh, kernel_w=kw)
    ref = np.asarray(module.apply({}, jnp.asarray(x)))
    got = pextra.Shiftlution(c, kh, kw)(nchw(x))
    np.testing.assert_array_equal(to_nhwc(got), ref)
    with pytest.raises(ValueError, match="channels"):
        pextra.Shiftlution(c + 1, kh, kw)(nchw(x))


@pytest.mark.parametrize("kw", [
    dict(kernel_size=3, stride=1, blocks=2, bias=True),
    dict(kernel_size=3, stride=2, blocks=4, bias=False),
    dict(kernel_size=1, stride=1, blocks=2, bias=True, groups=2)],
    ids=["k3b2", "k3s2b4", "k1b2g2"])
def test_tbconv_matches_jax(kw):
    kw = dict(kw)
    bias = kw.pop("bias")
    module = jextra.TBConv(out_channels=16, use_bias=bias, **kw)
    port = pextra.TBConv(8, 16, **kw, bias=bias)
    mapping = {"conv.weight": "params/conv/kernel"}
    if bias:
        mapping["conv.bias"] = "params/conv/bias"
    check_module(port, module, maps((2, 9, 8, 8), 3), mapping)


@pytest.mark.parametrize("learnable, bias", [(False, True), (True, True),
                                             (True, False)])
def test_kerv2d_matches_jax(learnable, bias):
    """The bias added before and after the power, the balance a parameter
    or the constant."""
    module = jextra.Kerv2d(out_channels=6, balance=0.7, power=3,
                           use_bias=bias, learnable_kernel=learnable)
    port = pextra.Kerv2d(5, 6, balance=0.7, power=3, bias=bias,
                         learnable_kernel=learnable)
    mapping = {"conv.weight": "params/conv/kernel"}
    if bias:
        mapping["bias"] = "params/bias"
    if learnable:
        mapping["balance"] = "params/balance"
    check_module(port, module, maps((2, 5, 6, 5), 4), mapping)


def test_space_to_depth_matches_jax():
    x = maps((2, 8, 12, 3), 5)
    ref = np.asarray(jextra.space_to_depth(jnp.asarray(x), 4))
    np.testing.assert_array_equal(to_nhwc(pextra.space_to_depth(nchw(x), 4)),
                                  ref)
    np.testing.assert_array_equal(
        to_nhwc(pextra.SpaceToDepth(2)(nchw(x))),
        np.asarray(jextra.SpaceToDepth(2).apply({}, jnp.asarray(x))))


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("apply_act", [True, False])
def test_evonorm_b0_matches_jax(apply_act, training):
    """In training the batch variance, which moves ``running_var`` by
    flax's momentum; in eval ``running_var``."""
    module = jextra.EvoNorm2dB0(apply_act=apply_act)
    port = pextra.EvoNorm2dB0(8, apply_act=apply_act)
    mapping = {"weight": "params/scale", "bias": "params/bias"}
    if apply_act:
        mapping.update(v="params/v", running_var="batch_stats/var")
    check_module(port, module, maps((3, 5, 6, 8), 6), mapping,
                 training=training, init={"training": False})


@pytest.mark.parametrize("groups, apply_act", [(4, True), (2, True),
                                               (4, False)])
def test_evonorm_s0_matches_jax(groups, apply_act):
    module = jextra.EvoNorm2dS0(groups=groups, apply_act=apply_act)
    port = pextra.EvoNorm2dS0(8, groups=groups, apply_act=apply_act)
    mapping = {"weight": "params/scale", "bias": "params/bias"}
    if apply_act:
        mapping["v"] = "params/v"
    check_module(port, module, maps((2, 5, 6, 8), 7), mapping,
                 training=False)


def test_instance_and_group_std_match_jax():
    x = maps((2, 5, 6, 8), 8)
    close("instance_std",
          to_nhwc(pextra.instance_std(nchw(x), 1e-3)),
          np.asarray(jextra.instance_std(jnp.asarray(x), 1e-3)))
    close("group_std", to_nhwc(pextra.group_std(nchw(x), 4)),
          np.asarray(jextra.group_std(jnp.asarray(x), 4)))


@pytest.mark.parametrize("num_splits, training", [(2, True), (2, False),
                                                  (3, True), (1, True)])
def test_split_batch_norm_matches_jax(num_splits, training):
    """JAX's ``bn_0`` is the port's main BN, ``bn_{i}`` its
    ``aux_bn.{i-1}``: in training each split's statistics and running
    statistics, in eval the main BN on the whole batch.  The gradients of
    a train-mode BN are sums that cancel: held at 2e-5 of the largest."""
    module = jextra.SplitBatchNorm(num_splits=num_splits)
    port = pextra.SplitBatchNorm(4, num_splits=num_splits)
    mapping = {}
    for i in range(num_splits):
        name = "" if i == 0 else f"aux_bn.{i - 1}."
        for p, j in (("weight", "params/{}/scale"), ("bias", "params/{}/bias"),
                     ("running_mean", "batch_stats/{}/mean"),
                     ("running_var", "batch_stats/{}/var")):
            mapping[name + p] = j.format(f"bn_{i}")
    x = maps((6, 5, 4, 4), 9) + np.linspace(-1, 1, 6, dtype=np.float32)[
        :, None, None, None]
    check_module(port, module, x, mapping, training=training,
                 init={"training": True}, rel=2e-5 if training else 1e-5)
    if num_splits > 1:
        with pytest.raises(ValueError, match="equal splits"):
            port.train()(torch.zeros(2 * num_splits + 1, 4, 3, 3))


def test_test_time_pool_matches_jax():
    """The mean over H and W of a 1x1 classifier's per-position logits."""
    x = maps((2, 5, 6, 8), 10)
    w = np.random.RandomState(11).randn(8, 7).astype(np.float32)
    ref = np.asarray(jextra.test_time_pool(
        lambda t: jnp.einsum("nhwc,co->nhwo", t, jnp.asarray(w)),
        jnp.asarray(x), 224))
    wt = torch.from_numpy(w.T.copy()).view(7, 8, 1, 1)
    got = pextra.test_time_pool(
        lambda t: torch.nn.functional.conv2d(t, wt), nchw(x), 224)
    close("test_time_pool", got.numpy(), ref)


# --- the conv helpers --------------------------------------------------------

@pytest.mark.parametrize("padding, k, s, d", [
    (None, 3, 1, 1), (None, 3, 2, 1), (None, 5, 1, 2), (2, 3, 1, 1),
    ((1, 2), (3, 5), 1, 1), ("SAME", 3, 1, 1), ("valid", 3, 1, 1)])
def test_normalize_padding_matches_jax(padding, k, s, d):
    """What ``F.conv2d`` takes for the geometry: the same output as the
    JAX package's flax padding through ``lax.conv_general_dilated``."""
    want = jconv.normalize_padding(padding, k, s, d)
    got = pconv.normalize_padding(padding, k, s, d)
    if isinstance(want, str):
        assert got == want.lower()
    else:
        assert got == tuple(p for p, _ in want)
    ks = jconv.to_2tuple(k)
    x = maps((1, 9, 10, 3), 12)
    w = np.random.RandomState(13).randn(*ks, 3, 4).astype(np.float32)
    ref = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (s, s), want, rhs_dilation=(d, d),
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    out = torch.nn.functional.conv2d(
        nchw(x), torch.from_numpy(w.transpose(3, 2, 0, 1).copy()), None, s,
        got, d)
    close("conv", to_nhwc(out), np.asarray(ref))


@pytest.mark.parametrize("groups, stride, bias", [(4, 1, True), (8, 2, False)])
def test_dense_grouped_conv_matches_grouped_and_jax(groups, stride, bias):
    """``DenseGroupedConv`` has ``Conv2d``'s state_dict with the same groups
    and computes its function and gradients; and it matches the JAX
    package's ``DenseGroupedConv`` on the same weights."""
    cin, cout, k = 16, 24, 3
    x = maps((2, 9, 9, cin), 14)
    dense = pconv.DenseGroupedConv(cin, cout, k, stride, 1, groups=groups,
                                   bias=bias)
    grouped = pconv.Conv2d(cin, cout, k, stride, 1, groups=groups, bias=bias)
    assert {k_: v.shape for k_, v in dense.state_dict().items()} == {
        k_: v.shape for k_, v in grouped.state_dict().items()}
    mapping = {"weight": "params/kernel"}
    if bias:
        mapping["bias"] = "params/bias"
    module = jconv.DenseGroupedConv(
        features=cout, kernel_size=(k, k), strides=(stride, stride),
        padding=((1, 1), (1, 1)), groups=groups, use_bias=bias)
    got = check_module(dense, module, x, mapping)
    grouped.load_state_dict(dense.state_dict())
    xt = nchw(x).requires_grad_()
    ref = grouped(xt)
    r = torch.from_numpy(np.random.RandomState(15).randn(
        *ref.shape).astype(np.float32))
    (ref * r).sum().backward()
    xd = nchw(x).requires_grad_()
    dense.zero_grad()
    (dense(xd) * r).sum().backward()
    close("out", got.detach().numpy(), ref.detach().numpy())
    close("dx", xd.grad.numpy(), xt.grad.numpy())
    close("dweight", dense.weight.grad.numpy(), grouped.weight.grad.numpy())
    dw = dense.dense_weight()
    o, ig = cout // groups, cin // groups
    mask = torch.block_diag(*[torch.ones(o, ig)] * groups)
    assert not dw[mask == 0].any()


# --- DenseGroupedConv as the CoT key conv -----------------------------------

def dense_key_convs(model):
    """Swap each CoT layer's key conv ``key_embed.0`` for a
    ``DenseGroupedConv`` with the same weights, in place: the net the JAX
    package builds under ``COTNET_DENSE_GROUPED``."""
    for layer in list(model.modules()):
        if isinstance(layer, CotLayer):
            conv = layer.key_embed[0]
            dense = pconv.DenseGroupedConv(
                conv.weight.shape[1] * conv.groups, conv.weight.shape[0],
                conv.kernel_size, conv.stride, conv.padding, conv.dilation,
                conv.groups, conv.bias is not None, conv.dtype)
            dense.load_state_dict(conv.state_dict())
            layer.key_embed[0] = dense
    return model


@contextlib.contextmanager
def jax_dense_grouped():
    """The JAX package's module global, set for the tracing of fresh
    functions and put back."""
    old = jcot.DENSE_GROUPED
    jcot.DENSE_GROUPED = True
    try:
        yield
    finally:
        jcot.DENSE_GROUPED = old


SMALL_NET = dict(layers=(1, 1, 1, 1), base_width=16, num_classes=10)


def test_cotnet_dense_grouped_matches_jax():
    """A reduced cotnet50 (one CotBottleneck a stage, CoT widths 16..128)
    at 32 px with its key convs dense (``dense_key_convs``): the state_dict
    of the grouped net (keys and shapes), a state_dict loading across the
    two, eval logits against the JAX net with ``DENSE_GROUPED`` set (5e-4
    of the largest, the converted whole-net tolerance of
    ``test_torch_cotnet.py``) and against the grouped port (1e-5: the same
    function, summed in another order in the key convs)."""
    x = maps((2, 32, 32, 3), 16)
    model = JaxResNet(block=jcot.CotBottleneck, **SMALL_NET)
    flat = random_variables(model, jnp.asarray(x), 17)
    with jax_dense_grouped():
        ref = np.asarray(jax.jit(lambda v, x_: model.apply(
            v, x_, training=False))(unflatten(flat), jnp.asarray(x)))
    on = dense_key_convs(ResNet(block=CotBottleneck, **SMALL_NET)).eval()
    off = ResNet(block=CotBottleneck, **SMALL_NET).eval()
    assert {k: v.shape for k, v in on.state_dict().items()} == {
        k: v.shape for k, v in off.state_dict().items()}
    assert isinstance(on.layer1[0].conv2.key_embed[0],
                      pconv.DenseGroupedConv)
    assert not isinstance(off.layer1[0].conv2.key_embed[0],
                          pconv.DenseGroupedConv)
    off.load_state_dict(jax_to_torch_state_dict(flat), strict=True)
    on.load_state_dict(off.state_dict(), strict=True)
    with torch.no_grad():
        got, got_off = on(nchw(x)), off(nchw(x))
    close("logits against JAX", got.numpy(), ref, 5e-4)
    close("logits against the grouped net", got.numpy(), got_off.numpy())


@pytest.mark.parametrize("dim", [32, 64])
def test_cot_layer_dense_grouped_train_matches_jax(dim):
    """One CotLayer in training with a dense key conv: the output and
    the gradients of ``sum(out * r)`` in the input and every parameter,
    the key conv's through the scatter, against ``jax.grad`` of the JAX
    layer under ``DENSE_GROUPED`` at 5e-4 of each largest (the tolerance
    of ``test_torch_cotnet.py``'s train parity: the layer's BNs and
    GroupNorm in train mode)."""
    rng = np.random.RandomState(18)
    x = (rng.randn(4, 9, 9, dim)
         * np.linspace(0.3, 2.0, 4)[:, None, None, None]).astype(np.float32)
    r = rng.randn(4, 9, 9, dim).astype(np.float32)
    layer = jcot.CotLayer(dim=dim, kernel_size=3)
    flat = random_variables(layer, jnp.asarray(x), 19)
    variables = unflatten(flat)

    def loss(params, x_):
        out, _ = layer.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, x_,
            training=True, mutable=["batch_stats"])
        return jnp.vdot(out, jnp.asarray(r)), out

    with jax_dense_grouped():
        (_, ref), (gp, gx) = jax.jit(jax.value_and_grad(
            loss, (0, 1), has_aux=True))(variables["params"], jnp.asarray(x))
    port = dense_key_convs(CotLayer(dim)).train()
    port.load_state_dict(jax_to_torch_state_dict(flat), strict=True)
    xt = nchw(x).requires_grad_()
    got = port(xt)
    (got * nchw(r)).sum().backward()
    close("out", to_nhwc(got), np.asarray(ref), 5e-4)
    close("dx", to_nhwc(xt.grad), np.asarray(gx), 5e-4)
    want = jax_to_torch_state_dict(flat_np(gp, "params"))
    largest = float(want["se.0.weight"].abs().max())
    for k, p in port.named_parameters():
        # se.0.bias feeds a train-mode BN, which cancels it
        scale = largest if k == "se.0.bias" else float(want[k].abs().max())
        err = float((p.grad - want[k]).abs().max())
        assert err <= 5e-4 * scale, (k, err, scale)


# --- local_aggregate_wt ------------------------------------------------------

@pytest.fixture
def chwn_flags():
    """The JAX package's CHWN dispatch flags, set as
    ``tests/test_local_agg.py::test_chwn_resident_weights`` sets them, and
    put back."""
    old = (lap.CHWN_DISPATCH, lap.CHWN_ANY_N)
    lap.CHWN_DISPATCH = lap.CHWN_ANY_N = True
    yield
    lap.CHWN_DISPATCH, lap.CHWN_ANY_N = old


def test_local_aggregate_wt_matches_jax(chwn_flags):
    """The output and both gradients, dwt in the ``[Cw, K*K, Ho, Wo, N]``
    layout, against the JAX package's ``local_aggregate_wt`` (its Pallas
    kernels in interpret mode), at 1e-5 of each largest; a weight with a
    heads axis is refused."""
    n, h, c, cw, k = 4, 9, 16, 2, 3
    rng = np.random.RandomState(20)
    x = rng.randn(n, h, h, c).astype(np.float32)
    wt = rng.randn(cw, k * k, h, h, n).astype(np.float32)
    dy = rng.randn(n, h, h, c).astype(np.float32)
    assert lap.chwn_wt_plan(x.shape, wt.shape, 4, (1, 1)) is not None

    def f(x_, wt_):
        return jnp.vdot(jax_local_aggregate_wt(x_, wt_, kernel_size=k,
                                               padding=1), jnp.asarray(dy))

    ref = np.asarray(jax_local_aggregate_wt(jnp.asarray(x), jnp.asarray(wt),
                                            kernel_size=k, padding=1))
    gx, gwt = jax.grad(f, (0, 1))(jnp.asarray(x), jnp.asarray(wt))
    xt = nchw(x).requires_grad_()
    wtt = torch.from_numpy(wt).requires_grad_()
    la.reset_counts()
    got = la.local_aggregate_wt(xt, wtt, kernel_size=k, padding=1)
    (got * nchw(dy)).sum().backward()
    assert (la.PLAIN_CALLS, la.PLAIN_BWD_CALLS) == (1, 1)
    close("out", to_nhwc(got), ref)
    close("dx", to_nhwc(xt.grad), np.asarray(gx))
    assert wtt.grad.shape == wtt.shape
    close("dwt", wtt.grad.numpy(), np.asarray(gwt))
    with pytest.raises(ValueError, match="one head"):
        la.local_aggregate_wt(xt, wtt[None], kernel_size=k, padding=1)


# --- resolve_data_config and set_layer_config --------------------------------

@pytest.mark.parametrize("args", [
    {}, {"img_size": 288}, {"input_size": (3, 320, 256)},
    {"in_chans": 1, "img_size": 100},
    {"mean": (0.5, 0.4, 0.3), "std": (0.2, 0.2, 0.2), "crop_pct": 0.9,
     "interpolation": "bilinear", "num_classes": 10}],
    ids=["empty", "img_size", "input_size", "in_chans", "overrides"])
def test_resolve_data_config_matches_jax(args):
    """Every registry key, the template, and an override cfg; the port's
    exports from ``config`` and ``models`` beside the JAX package's."""
    names = pmodels.list_models()
    assert names == jax_list_models() and len(names) == 418
    for name in names:
        assert phelpers.resolve_data_config(args, name) == \
            jhelpers.resolve_data_config(args, name), name
    assert phelpers.resolve_data_config(args) == \
        jhelpers.resolve_data_config(args)
    override = jhelpers.default_cfg(input_size=(3, 256, 256), crop_pct=1.0)
    assert phelpers.resolve_data_config(
        args, "cotnet50", default_cfg_override=override) == \
        jhelpers.resolve_data_config(args, "cotnet50",
                                     default_cfg_override=override)
    for pkg in (pconfig_pkg, pmodels):
        assert pkg.resolve_data_config is phelpers.resolve_data_config
        assert (pkg.IMAGENET_DEFAULT_MEAN, pkg.IMAGENET_DEFAULT_STD) == (
            jhelpers.IMAGENET_DEFAULT_MEAN, jhelpers.IMAGENET_DEFAULT_STD)


def test_set_layer_config_restores_after_an_exception(monkeypatch):
    """The flags inside the block, their values back after an exception
    raised in it, as the JAX package's; ``create_model`` builds inside
    the block."""
    for cfg in (pconfig, jconfig):
        before = (cfg.is_scriptable(), cfg.is_exportable(), cfg.is_no_jit())
        with pytest.raises(RuntimeError, match="inside"):
            with cfg.set_layer_config(scriptable=True, no_jit=True):
                assert (cfg.is_scriptable(), cfg.is_exportable(),
                        cfg.is_no_jit()) == (True, before[1], True)
                with cfg.set_layer_config(exportable=True):
                    assert cfg.is_exportable()
                assert cfg.is_exportable() == before[1]
                raise RuntimeError("inside")
        assert (cfg.is_scriptable(), cfg.is_exportable(),
                cfg.is_no_jit()) == before == (False, False, False)

    seen = []

    def entrypoint(**kwargs):
        seen.append((pconfig.is_scriptable(), pconfig.is_exportable(),
                     pconfig.is_no_jit()))
        return torch.nn.Identity()

    monkeypatch.setattr(pfactory, "model_entrypoint", lambda name: entrypoint)
    pfactory.create_model("resnet18", device="cpu", scriptable=True,
                          no_jit=True)
    assert seen == [(True, False, True)]
    assert not (pconfig.is_scriptable() or pconfig.is_no_jit())
