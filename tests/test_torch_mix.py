"""Parity of the port's dual-kernel ("mix") aggregation and its per-channel
dilated aggregation with the JAX package.

``local_aggregate_mix`` / ``_mix_merge`` aggregate one input with a 3x3 and
a 5x5 weight; ``local_aggregate_dilated`` gives each weight channel its own
dilation.  The same seeded numpy inputs go to both packages, permuted
(NHWC / k-major there, NCHW / cw-major here), in f32, forward and
gradients.  The JAX reference runs its fused Pallas kernels in interpret
mode (``impl="pallas"``) and its XLA composition (``impl="xla"``).  On the
CPU the port runs its plain versions; the Hopper kernels' own tests are in
``test_torch_hopper_gpu.py``.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cotnet_tpu.ops.local_agg import local_aggregate_dilated as jax_dilated  # noqa: E402
from cotnet_tpu.ops.local_agg import local_aggregate_mix as jax_mix  # noqa: E402
from cotnet_tpu.ops.local_agg import local_aggregate_mix_merge as jax_mix_merge  # noqa: E402
from cotnet_tpu_torch.ops import local_agg as la  # noqa: E402
from test_torch_hopper_gpu import make_mix_inputs, to_nhwc, to_port  # noqa: E402


def _port_mix(x, w1, w2):
    return to_port(x, w1)[:2] + (to_port(x, w2)[1],)


def _to_kmajor(wt):
    """cw-major torch ``[N, heads, Cw, K2, H, W]`` -> the JAX package's
    k-major numpy ``[N, H, W, heads, K2, Cw]``."""
    return wt.detach().numpy().transpose(0, 4, 5, 1, 3, 2)


def _cotangent(shape, seed=11):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("heads", [1, 2])
@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_mix_matches_jax(impl, heads):
    """The fused plain forward against the JAX fused Pallas kernel
    (interpret mode) and its XLA composition: kernel-major channels
    ``[half, head, c]`` with Cw dividing C twice (g = 2), f32, rtol/atol
    1e-5 (f32 sums in another order)."""
    x, w1, w2 = make_mix_inputs(10 + heads, heads=heads)
    ref = _jax(jax_mix, impl=impl)(jnp.asarray(x), jnp.asarray(w1),
                                   jnp.asarray(w2))
    la.reset_counts()
    got = la.local_aggregate_mix(*_port_mix(x, w1, w2))
    assert (la.PLAIN_MIX_CALLS, la.PLAIN_CALLS) == (1, 0)
    assert got.shape == (2, 2 * heads * 8, 7, 6)
    np.testing.assert_allclose(to_nhwc(got), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def _port_mix_grads(x, w1, w2, r, merge=False, **kwargs):
    xt, w1t, w2t = (t.requires_grad_() for t in _port_mix(x, w1, w2))
    if merge:
        wm = torch.cat([w1t, w2t], dim=3).detach().requires_grad_()
        out = la.local_aggregate_mix_merge(xt, wm, **kwargs)
    else:
        out = la.local_aggregate_mix(xt, w1t, w2t, **kwargs)
    (out * _nchw(r)).sum().backward()
    if merge:
        return to_nhwc(xt.grad), _to_kmajor(wm.grad[:, :, :, :9]), \
            _to_kmajor(wm.grad[:, :, :, 9:])
    return to_nhwc(xt.grad), _to_kmajor(w1t.grad), _to_kmajor(w2t.grad)


def _jax(fn, **kwargs):
    """``fn`` with these keyword arguments, jitted: one compile a shape, not
    one for each operation of the JAX form run eagerly."""
    return jax.jit(functools.partial(fn, **kwargs))


def _jax_mix_grads(x, w1, w2, r, fn=jax_mix, **kwargs):
    f = lambda *a: jnp.vdot(fn(*a, **kwargs), jnp.asarray(r))  # noqa: E731
    return jax.jit(jax.grad(f, (0, 1, 2)))(
        *(jnp.asarray(a) for a in (x, w1, w2)))


@pytest.mark.parametrize("heads", [1, 2])
@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_mix_grads_match_jax(impl, heads):
    """dx, dw1, dw2 of ``sum(out * r)`` for a seeded r against ``jax.grad``
    of the JAX fused kernels (interpret mode) and of the XLA composition,
    f32, rtol/atol 1e-5; one plain backward computes all three."""
    x, w1, w2 = make_mix_inputs(20 + heads, heads=heads)
    r = _cotangent((2, 7, 6, 2 * heads * 8))
    la.reset_counts()
    got = _port_mix_grads(x, w1, w2, r)
    assert la.PLAIN_MIX_CALLS == 2
    ref = _jax_mix_grads(x, w1, w2, r, impl=impl)
    for name, g, want in zip(("dx", "dw1", "dw2"), got, ref):
        np.testing.assert_allclose(g, np.asarray(want), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


# (N, C, Cw, H, W, heads, the JAX form): the edges of the card's forward,
# dx and dw tiles, where the card's checks trust the plain versions: maps
# smaller than the 5x5 window (1x1, 2x3) and than one row tile (3x3), one
# weight channel a group (C = Cw), 13x11 with Cw = 6 at two heads.
# "pallas": the JAX package's fused TPU kernels in interpret mode, which
# ``mix_plan`` takes at every one of these geometries (the XLA form
# otherwise).
MIX_TILE_EDGES = {
    "1x1": (2, 8, 4, 1, 1, 1, "pallas"),
    "2x3": (2, 8, 4, 2, 3, 2, "pallas"),
    "3x3": (2, 16, 4, 3, 3, 1, "pallas"),
    "c_eq_cw": (2, 4, 4, 7, 6, 1, "pallas"),
    "13x11_cw6_heads2": (2, 12, 6, 13, 11, 2, "pallas"),
}


@pytest.mark.parametrize("merge", [False, True])
@pytest.mark.parametrize("edge", sorted(MIX_TILE_EDGES))
def test_mix_matches_jax_at_the_tile_edges(edge, merge):
    """The plain mix forward (the oracle of the card's forward tiles)
    against the JAX mix forward at the edges of the tiles, the weights
    separate and packed (``_mix_merge`` on both sides), f32, rtol/atol
    1e-5."""
    from cotnet_tpu.ops.local_agg_pallas import mix_plan

    n, c, cw, h, w, heads, impl = MIX_TILE_EDGES[edge]
    assert (mix_plan((n, h, w, c), (n, h, w, heads, 9, cw),
                     (n, h, w, heads, 25, cw), 4) is not None) == (
        impl == "pallas")
    x, w1, w2 = make_mix_inputs(len(edge) + 5 * heads, n=n, c=c, cw=cw,
                                hi=h, wi=w, heads=heads)
    xt, w1t, w2t = _port_mix(x, w1, w2)
    la.reset_counts()
    if merge:
        got = la.local_aggregate_mix_merge(xt, torch.cat([w1t, w2t], dim=3))
        ref = _jax(jax_mix_merge, impl=impl)(
            jnp.asarray(x), jnp.asarray(np.concatenate([w1, w2], axis=4)))
    else:
        got = la.local_aggregate_mix(xt, w1t, w2t)
        ref = _jax(jax_mix, impl=impl)(jnp.asarray(x), jnp.asarray(w1),
                                       jnp.asarray(w2))
    assert (la.PLAIN_MIX_CALLS, la.PLAIN_CALLS) == (1, 0)
    assert got.shape == (n, 2 * heads * c, h, w)
    np.testing.assert_allclose(to_nhwc(got), np.asarray(ref), rtol=1e-5,
                               atol=1e-5, err_msg=f"against JAX {impl}")


@pytest.mark.parametrize("merge", [False, True])
@pytest.mark.parametrize("edge", sorted(MIX_TILE_EDGES))
def test_mix_grads_match_jax_at_the_tile_edges(edge, merge):
    """The plain mix backward (the oracle of the card's dx and dw tiles)
    against ``jax.grad`` of the JAX mix at the edges of the tiles, the
    weights separate and packed (``_mix_merge`` on both sides), f32,
    rtol/atol 1e-5."""
    from cotnet_tpu.ops.local_agg_pallas import mix_plan

    n, c, cw, h, w, heads, impl = MIX_TILE_EDGES[edge]
    plan = mix_plan((n, h, w, c), (n, h, w, heads, 9, cw),
                    (n, h, w, heads, 25, cw), 4)
    assert (plan is not None) == (impl == "pallas")
    x, w1, w2 = make_mix_inputs(len(edge) + 7 * heads, n=n, c=c, cw=cw,
                                hi=h, wi=w, heads=heads)
    r = _cotangent((n, h, w, 2 * heads * c), seed=len(edge))
    la.reset_counts()
    got = _port_mix_grads(x, w1, w2, r, merge=merge)
    assert la.PLAIN_MIX_CALLS == 2
    if merge:
        wm = np.concatenate([w1, w2], axis=4)
        f = lambda x_, w_: jnp.vdot(  # noqa: E731
            jax_mix_merge(x_, w_, impl=impl), jnp.asarray(r))
        dx, dwm = jax.jit(jax.grad(f, (0, 1)))(jnp.asarray(x),
                                               jnp.asarray(wm))
        ref = (dx, dwm[..., :9, :], dwm[..., 9:, :])
    else:
        ref = _jax_mix_grads(x, w1, w2, r, impl=impl)
    for name, g, want in zip(("dx", "dw1", "dw2"), got, ref):
        np.testing.assert_allclose(g, np.asarray(want), rtol=1e-5, atol=1e-5,
                                   err_msg=f"{name} against JAX {impl}")


@pytest.mark.parametrize("heads", [1, 2])
def test_mix_merge_matches_mix_and_jax(heads):
    """The packed weight ``[N, heads, Cw, 9 + 25, H, W]`` (the 3x3 taps
    first, as ``tests/test_local_agg.py`` packs the JAX one) gives what the
    two halves give, exactly (the same plain arithmetic), and its gradient
    comes back packed; both against JAX's ``local_aggregate_mix_merge``
    (rtol/atol 1e-5)."""
    x, w1, w2 = make_mix_inputs(30 + heads, heads=heads)
    xt, w1t, w2t = _port_mix(x, w1, w2)
    wm = torch.cat([w1t, w2t], dim=3)
    got = la.local_aggregate_mix_merge(xt, wm)
    torch.testing.assert_close(got, la.local_aggregate_mix(xt, w1t, w2t),
                               rtol=0, atol=0)
    ref = _jax(jax_mix_merge)(jnp.asarray(x),
                              jnp.asarray(np.concatenate([w1, w2], axis=4)))
    np.testing.assert_allclose(to_nhwc(got), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    r = _cotangent((2, 7, 6, 2 * heads * 8), seed=12)
    got_g = _port_mix_grads(x, w1, w2, r, merge=True)
    for name, g, want in zip(("dx", "dw1", "dw2"), got_g,
                             _port_mix_grads(x, w1, w2, r)):
        np.testing.assert_array_equal(g, want, err_msg=name)


@pytest.mark.parametrize("case", ["stride2", "dilation2", "reflect", "k3k7"])
def test_unfused_geometry_composes_two_aggregations(case):
    """Off the fused geometry the op is two ``local_aggregate`` calls and a
    concatenation, as in JAX: no mix call, two plain aggregations, values
    and gradients against JAX's composition at rtol/atol 1e-5."""
    k2, stride, dil, pad_mode = {
        "stride2": (5, 2, 1, "zeros"), "dilation2": (5, 1, 2, "zeros"),
        "reflect": (5, 1, 1, "reflect"), "k3k7": (7, 1, 1, "zeros")}[case]
    p2 = (dil * (k2 - 1) + 1) // 2
    ho = (9 + 2 * p2 - dil * (k2 - 1) - 1) // stride + 1
    rng = np.random.RandomState(40)
    x = rng.randn(2, 9, 9, 8).astype(np.float32)
    w1 = rng.randn(2, ho, ho, 1, 9, 4).astype(np.float32)
    w2 = rng.randn(2, ho, ho, 1, k2 * k2, 4).astype(np.float32)
    kwargs = dict(kernel_size2=k2, stride=stride, dilation=dil,
                  pad_mode=pad_mode)
    r = _cotangent((2, ho, ho, 16))
    la.reset_counts()
    got = _port_mix_grads(x, w1, w2, r, **kwargs)
    assert (la.PLAIN_MIX_CALLS, la.PLAIN_CALLS) == (0, 2)
    ref = _jax_mix_grads(x, w1, w2, r, kernel_size2=k2, stride=stride,
                         dilation=dil, pad_mode=pad_mode, impl="xla")
    for name, g, want in zip(("dx", "dw1", "dw2"), got, ref):
        np.testing.assert_allclose(g, np.asarray(want), rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    out = la.local_aggregate_mix(*_port_mix(x, w1, w2), **kwargs)
    want = _jax(jax_mix, impl="xla", **kwargs)(
        jnp.asarray(x), jnp.asarray(w1), jnp.asarray(w2))
    np.testing.assert_allclose(to_nhwc(out), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_fused_equals_composition_in_f32():
    """The fused plain mix against the port's own composition of two
    ``local_aggregate`` calls, f32 values and gradients (rtol/atol 1e-5):
    the same function on the fused geometry."""
    x, w1, w2 = make_mix_inputs(50, heads=2)
    r = _cotangent((2, 7, 6, 32), seed=13)
    fused = _port_mix_grads(x, w1, w2, r)
    xt, w1t, w2t = (t.requires_grad_() for t in _port_mix(x, w1, w2))
    out = torch.cat([la.local_aggregate(xt, w1t, kernel_size=3),
                     la.local_aggregate(xt, w2t, kernel_size=5)], dim=1)
    (out * _nchw(r)).sum().backward()
    for name, g, want in zip(("dx", "dw1", "dw2"), fused,
                             (to_nhwc(xt.grad), _to_kmajor(w1t.grad),
                              _to_kmajor(w2t.grad))):
        np.testing.assert_allclose(g, want, rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_bf16_dx_is_one_rounding_of_both_halves():
    """In bf16 the fused backward rounds dx once, after both halves are
    summed in f32, as the TPU kernel's shared accumulator does: it is
    bit for bit the f32 backward of the same bf16 values, rounded once.
    The composition rounds each half's dx, so in bf16 it is another
    function (held against the kernel only in f32)."""
    x, w1, w2 = make_mix_inputs(60, heads=2)
    args = [t.to(torch.bfloat16) for t in _port_mix(x, w1, w2)]
    dy = torch.from_numpy(_cotangent((2, 32, 7, 6), seed=14)).to(
        torch.bfloat16)
    dx = la.local_aggregate_mix_bwd_plain(*args, dy, need_dw=False)[0]
    dx32 = la.local_aggregate_mix_bwd_plain(
        *(t.float() for t in args), dy.float(), need_dw=False)[0]
    assert dx.dtype == torch.bfloat16
    assert torch.equal(dx, dx32.to(torch.bfloat16))
    halves = [la.local_aggregate_bwd_plain(
        torch.nn.functional.pad(args[0], (p,) * 4), wg, dyh, (k, k), (1, 1),
        need_dw=False)[0][..., p:p + 7, p:p + 6]
        for wg, k, p, dyh in ((args[1], 3, 1, dy[:, :16]),
                              (args[2], 5, 2, dy[:, 16:]))]
    assert not torch.equal(dx, halves[0] + halves[1])


def test_plain_mix_backward_matches_autograd_f64():
    """The closed-form plain backward against autograd through the plain
    forward's slices, in f64 (rtol 1e-10)."""
    x, w1, w2 = make_mix_inputs(70, heads=2)
    leaves = [t.double().requires_grad_() for t in _port_mix(x, w1, w2)]
    dy = torch.from_numpy(_cotangent((2, 32, 7, 6), seed=15)).double()
    want = torch.autograd.grad(la.local_aggregate_mix_plain(*leaves), leaves,
                               dy)
    got = la.local_aggregate_mix_bwd_plain(*leaves, dy)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("merge", [False, True])
def test_gradcheck_through_the_mix_f64(merge):
    """torch.autograd.gradcheck through the op at f64, with the weights
    separate and packed."""
    x, w1, w2 = make_mix_inputs(80, n=1, c=4, cw=2, hi=5, wi=4)
    xt, w1t, w2t = (t.double() for t in _port_mix(x, w1, w2))
    if merge:
        args = (xt, torch.cat([w1t, w2t], dim=3))
        fn = la.local_aggregate_mix_merge
    else:
        args = (xt, w1t, w2t)
        fn = la.local_aggregate_mix
    args = tuple(a.requires_grad_() for a in args)
    assert torch.autograd.gradcheck(fn, args, eps=1e-6, atol=1e-8)


@pytest.mark.parametrize("need", ["dx", "dw1", "dw2"])
def test_mix_backward_computes_only_what_is_needed(need):
    """A gradient wanted for x alone takes no dw pass, and one for a weight
    alone no dx pass; one dw pass serves both weights."""
    x, w1, w2 = make_mix_inputs(90)
    tensors = dict(zip(("dx", "dw1", "dw2"), _port_mix(x, w1, w2)))
    tensors[need].requires_grad_()
    out = la.local_aggregate_mix(*tensors.values())
    calls = []
    plain = la.local_aggregate_mix_bwd_plain

    def spy(*args, need_dx, need_dw):
        calls.append((need_dx, need_dw))
        return plain(*args, need_dx=need_dx, need_dw=need_dw)

    la.local_aggregate_mix_bwd_plain = spy
    try:
        out.sum().backward()
    finally:
        la.local_aggregate_mix_bwd_plain = plain
    assert calls == [(need == "dx", need != "dx")]
    assert tensors[need].grad is not None


@pytest.mark.parametrize("fn", ["mix", "merge"])
def test_hopper_on_cpu_tensor_raises(fn):
    x, w1, w2 = _port_mix(*make_mix_inputs(0))
    with pytest.raises(ValueError, match="CUDA"):
        if fn == "mix":
            la.local_aggregate_mix(x, w1, w2, impl="hopper")
        else:
            la.local_aggregate_mix_merge(x, torch.cat([w1, w2], dim=3),
                                         impl="hopper")


def test_mix_refuses_bad_shapes_and_impl():
    x, w1, w2 = _port_mix(*make_mix_inputs(0))
    with pytest.raises(ValueError, match="weights"):
        la.local_aggregate_mix(x, w2, w1)
    with pytest.raises(ValueError, match="weights"):
        la.local_aggregate_mix(x, w1, w2[:, :, :3])
    with pytest.raises(ValueError, match="weights"):
        la.local_aggregate_mix_merge(x, w1)
    with pytest.raises(ValueError, match="impl"):
        la.local_aggregate_mix(x, w1, w2, impl="pallas")


def test_mix_route_refuses_other_kernels_and_bad_shapes():
    """``mix_route`` routes the mix's own kernels only (the forward, dx and
    dw), and checks the weights' shapes before it asks the kernels'
    library."""
    x, w1, w2 = _port_mix(*make_mix_inputs(0))
    with pytest.raises(ValueError, match="fwd, dx and dw"):
        la.mix_route("dw_affine", x, w1, w2)
    with pytest.raises(ValueError, match="weights"):
        la.mix_route("dx", x, w2, w1)


def test_reset_counts_zeroes_the_mix_counts():
    la.MIX_LAUNCHES.update(fwd=2, dx=1, dw=1)
    la.MIX_LAUNCHES_BY_SHAPE[("fwd", "k")] = 2
    la.PLAIN_MIX_CALLS = 3
    la.reset_counts()
    assert la.MIX_LAUNCHES == {"fwd": 0, "dx": 0, "dw": 0}
    assert (la.MIX_LAUNCHES_BY_SHAPE, la.PLAIN_MIX_CALLS) == ({}, 0)
    x, w1, w2 = _port_mix(*make_mix_inputs(1))
    assert la.mix_key(x.bfloat16(), w1, w2) == (
        "bfloat16", (2, 8, 7, 6), 1, 4, False)
    assert la.mix_key(x, torch.cat([w1, w2], dim=3), None)[-1] is True


# ---- per-channel dilation ---------------------------------------------------

@pytest.mark.parametrize("heads,dilations", [
    (1, (1, 2, 1, 2)), (2, (2, 1, 3, 1)), (1, (2, 2, 2, 2)),
    (2, (1, 1, 1, 1))], ids=["1-2", "heads2-1-2-3", "all2", "all1"])
def test_dilated_matches_jax(heads, dilations):
    """Values and gradients of ``sum(out * r)`` against the JAX op (XLA),
    f32, rtol/atol 1e-5; one aggregation per distinct dilation."""
    rng = np.random.RandomState(100 + heads)
    x = rng.randn(2, 9, 9, 8).astype(np.float32)
    w = rng.randn(2, 9, 9, heads, 9, 4).astype(np.float32)
    r = _cotangent((2, 9, 9, heads * 8), seed=16)
    ref = _jax(jax_dilated, dilations=dilations, impl="xla")(
        jnp.asarray(x), jnp.asarray(w))
    f = lambda x_, w_: jnp.vdot(  # noqa: E731
        jax_dilated(x_, w_, dilations, impl="xla"), jnp.asarray(r))
    ref_dx, ref_dw = jax.jit(jax.grad(f, (0, 1)))(jnp.asarray(x),
                                                  jnp.asarray(w))
    xt, wt = (t.requires_grad_() for t in to_port(x, w)[:2])
    la.reset_counts()
    out = la.local_aggregate_dilated(xt, wt, dilations)
    (out * _nchw(r)).sum().backward()
    distinct = len(set(dilations))
    assert (la.PLAIN_CALLS, la.PLAIN_BWD_CALLS) == (distinct, distinct)
    np.testing.assert_allclose(to_nhwc(out), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(to_nhwc(xt.grad), np.asarray(ref_dx),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_to_kmajor(wt.grad), np.asarray(ref_dw),
                               rtol=1e-5, atol=1e-5)


def test_dilated_casts_once_and_checks_its_dilations():
    """A bf16 input: the masked sum is f32 and the result is cast once to
    bf16; a dilation count other than Cw raises."""
    rng = np.random.RandomState(110)
    x = rng.randn(1, 6, 6, 8).astype(np.float32)
    w = rng.randn(1, 6, 6, 1, 9, 4).astype(np.float32)
    xt, wt = (t.to(torch.bfloat16) for t in to_port(x, w)[:2])
    out = la.local_aggregate_dilated(xt, wt, (1, 2, 1, 2))
    assert out.dtype == torch.bfloat16
    ref = la.local_aggregate_dilated(xt.float(), wt.float(), (1, 2, 1, 2))
    torch.testing.assert_close(out.float(), ref, rtol=8e-3,
                               atol=1e-3 * float(ref.abs().max()))
    with pytest.raises(ValueError, match="dilation"):
        la.local_aggregate_dilated(xt, wt, (1, 2))
