"""Parity of the port's GroupNorm-folded backward and fused-embed op with
the JAX package.

Three things are held, each with the same seeded numpy inputs on both sides,
in f32 on the CPU (where the port runs its plain versions):

- the backward of the aggregation with the folded affine ``w*s + b``: all
  four cotangents against ``jax.vjp`` of the XLA formulation and against
  the TPU kernels ``_dx_kernel_affine`` / ``_dw_kernel_affine`` in interpret
  mode;
- ``SubChannelGroupNorm.fold``'s gradients against ``jax.grad`` through the
  flax module with ``fold=True``;
- ``local_aggregate_embed_gn`` against the JAX op, both its XLA composition
  and the TPU kernel ``_fused_embed_kernel`` in interpret mode.

The Hopper kernels' own tests are in ``test_torch_hopper_gpu.py``.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import cotnet_tpu.ops.local_agg_pallas as lap  # noqa: E402
from cotnet_tpu.nn import SubChannelGroupNorm as JaxSubChannelGroupNorm  # noqa: E402
from cotnet_tpu.ops.local_agg import local_aggregate as jax_aggregate  # noqa: E402
from cotnet_tpu.ops.local_agg import local_aggregate_embed_gn as jax_embed_gn  # noqa: E402
from cotnet_tpu_torch import nn as tnn  # noqa: E402
from cotnet_tpu_torch.ops import local_agg as la  # noqa: E402
from test_torch_local_agg import make_inputs, to_nhwc, to_port  # noqa: E402

WRT = ("x", "w", "s", "b")


def _cotangent(shape, seed=11):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _port_affine_grads(x, w, s, b, r, **kwargs):
    """dx, dw, ds, db of ``sum(out * r)`` from the port, in the JAX
    layouts (NHWC, k-major w, ``[N, heads, K2, Cw]`` affine)."""
    leaves = [t.requires_grad_() for t in to_port(x, w, s, b)]
    out = la.local_aggregate(leaves[0], leaves[1], w_scale=leaves[2],
                             w_bias=leaves[3], **kwargs)
    (out * torch.from_numpy(np.ascontiguousarray(
        r.transpose(0, 3, 1, 2)))).sum().backward()
    gx, gw, gs, gb = (t.grad for t in leaves)
    return (to_nhwc(gx), gw.numpy().transpose(0, 4, 5, 1, 3, 2),
            gs.numpy().transpose(0, 1, 3, 2), gb.numpy().transpose(0, 1, 3, 2))


@functools.lru_cache(maxsize=None)
def _xla_case(k, dil, heads, pad_mode):
    x, w, s, b, pad = make_inputs(k * 100 + dil * 10 + heads, k=k, dil=dil,
                                  heads=heads, affine=True)
    r = _cotangent((2, 9, 8, heads * 8))
    kwargs = dict(kernel_size=k, padding=pad, dilation=dil,
                  pad_mode=pad_mode)
    plain_bwd = la.PLAIN_BWD_CALLS
    got = _port_affine_grads(x, w, s, b, r, **kwargs)
    assert la.PLAIN_BWD_CALLS == plain_bwd + 1
    _, vjp = jax.vjp(
        lambda *a: jax_aggregate(a[0], a[1], w_scale=a[2], w_bias=a[3],
                                 impl="xla", **kwargs),
        *(jnp.asarray(a) for a in (x, w, s, b)))
    return dict(zip(WRT, got)), dict(zip(WRT, map(np.asarray,
                                                  vjp(jnp.asarray(r)))))


@pytest.mark.parametrize("wrt", WRT)
@pytest.mark.parametrize("pad_mode", ["zeros", "reflect"])
@pytest.mark.parametrize("heads", [1, 2])
@pytest.mark.parametrize("k,dil", [(3, 1), (5, 2)])
def test_affine_grads_match_jax_xla(k, dil, heads, pad_mode, wrt):
    """Each cotangent of the affine aggregation against ``jax.vjp`` of the
    XLA formulation.  dx and dw at rtol/atol 1e-5 (f32 sums of a few dozen
    products in another order); ds and db are sums over the 72 positions of
    such sums, so they are held as a whole at 2e-5 of their largest entry."""
    got, ref = _xla_case(k, dil, heads, pad_mode)
    if wrt in ("x", "w"):
        np.testing.assert_allclose(got[wrt], ref[wrt], rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got[wrt], ref[wrt], rtol=0,
                                   atol=2e-5 * np.abs(ref[wrt]).max())


@functools.lru_cache(maxsize=None)
def _pallas_case(heads):
    """The shapes of the JAX package's own test of the affine VJP
    (``tests/test_local_agg.py::test_affine_fold_vjp_matches_composition``),
    which reach ``_dx_kernel_affine`` and ``_dw_kernel_affine``."""
    shape = (dict(n=2, c=64, cw=8, hi=14, wi=14) if heads == 1
             else dict(n=2, c=32, cw=4, hi=8, wi=8, heads=2))
    x, w, s, b, pad = make_inputs(13, affine=True, **shape)
    r = _cotangent(x.shape[:3] + (heads * x.shape[3],))
    plan = lap.pallas_plan(x.shape, w.shape, 4, (pad, pad), affine=True)
    assert plan is not None and plan[0] == "whole", plan
    _, vjp = jax.vjp(
        lambda *a: lap.agg_core_pallas_affine(*a, (3, 3), (1, 1), (pad, pad)),
        *(jnp.asarray(a) for a in (x, w, s, b)))
    ref = dict(zip(WRT, map(np.asarray, vjp(jnp.asarray(r)))))
    got = _port_affine_grads(x, w, s, b, r, kernel_size=3, padding=pad)
    return dict(zip(WRT, got)), ref


@pytest.mark.parametrize("wrt", WRT)
@pytest.mark.parametrize("heads", [1, 2])
def test_affine_grads_match_jax_pallas_interpret(heads, wrt):
    """The port's plain affine backward against the two TPU kernels it
    replaces, in interpret mode: 2e-5 of each cotangent's largest entry
    (f32; ds and db sum up to 196 positions in another order)."""
    got, ref = _pallas_case(heads)
    np.testing.assert_allclose(got[wrt], ref[wrt], rtol=0,
                               atol=2e-5 * np.abs(ref[wrt]).max())


# the maps at which the affine dw's halo tiles split a plane's sums: 57x57
# spans several row tiles of a plane (a second pass adds them), 13x11 with
# Cw = 6 puts several planes in a block; x [N, H, W, C], Cw
TILE_SPLITS = {
    "57x57": dict(n=2, c=8, cw=4, hi=57, wi=57),
    "13x11_cw6": dict(n=2, c=48, cw=6, hi=13, wi=11),
}


@functools.lru_cache(maxsize=None)
def _tile_split_case(name):
    """The port's plain affine backward and the JAX reference at one of
    ``TILE_SPLITS``: the TPU kernels in interpret mode where the Pallas
    plan takes the map, else ``jax.vjp`` of the XLA formulation."""
    x, w, s, b, pad = make_inputs(17, affine=True, **TILE_SPLITS[name])
    r = _cotangent(x.shape[:3] + (x.shape[3],), seed=19)
    if lap.pallas_plan(x.shape, w.shape, 4, (pad, pad), affine=True):
        def fn(*a):
            return lap.agg_core_pallas_affine(*a, (3, 3), (1, 1), (pad, pad))
    else:
        def fn(*a):
            return jax_aggregate(a[0], a[1], w_scale=a[2], w_bias=a[3],
                                 impl="xla", kernel_size=3, padding=pad)
    _, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (x, w, s, b)))
    ref = dict(zip(WRT, map(np.asarray, vjp(jnp.asarray(r)))))
    got = _port_affine_grads(x, w, s, b, r, kernel_size=3, padding=pad)
    return dict(zip(WRT, got)), ref


@pytest.mark.parametrize("wrt", WRT)
@pytest.mark.parametrize("name", sorted(TILE_SPLITS))
def test_affine_grads_match_jax_where_the_tiles_split_a_plane(name, wrt):
    """The port's plain affine backward, the oracle of the affine dw
    kernel's halo tiles, against JAX at the maps where those tiles split a
    plane's ds and db sums (several row tiles; several planes a block), in
    f32: 2e-5 of each cotangent's largest entry (ds and db sum up to 3249
    positions in another order)."""
    got, ref = _tile_split_case(name)
    np.testing.assert_allclose(got[wrt], ref[wrt], rtol=0,
                               atol=2e-5 * np.abs(ref[wrt]).max())


@pytest.mark.parametrize("pad_mode", ["zeros", "reflect"])
def test_affine_gradcheck_through_the_op_f64(pad_mode):
    """``torch.autograd.gradcheck`` of the op with the affine (the Function
    with the plain affine backward, reflect pad outside it) in f64, heads
    2, in all four inputs."""
    gen = torch.Generator().manual_seed(0)

    def leaf(*shape):
        return torch.randn(*shape, dtype=torch.float64, generator=gen,
                           requires_grad=True)

    x, w = leaf(1, 4, 5, 4), leaf(1, 2, 2, 9, 5, 4)
    s, b = leaf(1, 2, 2, 9), leaf(1, 2, 2, 9)
    assert torch.autograd.gradcheck(
        lambda *a: la.local_aggregate(a[0], a[1], pad_mode=pad_mode,
                                      w_scale=a[2], w_bias=a[3]),
        (x, w, s, b))


@pytest.mark.parametrize("k,dil,heads", [(3, 1, 1), (5, 2, 2), (7, 1, 2)])
def test_plain_affine_backward_matches_autograd_f64(k, dil, heads):
    """The plain affine backward against autograd of the plain forward, in
    f64."""
    n, c, cw, h, wd = 2, 8, 4, 7, 6
    pad = (dil * (k - 1) + 1) // 2
    gen = torch.Generator().manual_seed(k)

    def randn(*shape):
        return torch.randn(*shape, dtype=torch.float64, generator=gen)

    x, w = randn(n, c, h, wd), randn(n, heads, cw, k * k, h, wd)
    s, b = randn(n, heads, cw, k * k), randn(n, heads, cw, k * k)
    dy = randn(n, heads * c, h, wd)
    xp = torch.nn.functional.pad(x, (pad,) * 4)
    leaves = [t.clone().requires_grad_() for t in (xp, w, s, b)]
    out = la.local_aggregate_plain(leaves[0], leaves[1], (k, k), (1, 1),
                                   (dil, dil), leaves[2], leaves[3])
    ref = torch.autograd.grad(out, leaves, dy)
    got = la.local_aggregate_bwd_affine_plain(xp, w, s, b, dy, (k, k),
                                              (dil, dil))
    for g, r in zip(got, ref):
        assert g.dtype == torch.float64
        torch.testing.assert_close(g, r, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("need", ["dx", "dw"])
def test_affine_backward_computes_only_what_is_needed(need):
    """``need_dx`` alone gives dx; ``need_dw`` alone gives dw, ds and db
    together (one pass); each equals the all-four call's."""
    x, w, s, b, pad = make_inputs(9, heads=2, affine=True)
    xt, wt, st, bt = to_port(x, w, s, b)
    xp = torch.nn.functional.pad(xt, (pad,) * 4)
    dy = torch.from_numpy(_cotangent((2, 16, 9, 8)))
    both = la.local_aggregate_bwd_affine_plain(xp, wt, st, bt, dy, (3, 3),
                                               (1, 1))
    got = la.local_aggregate_bwd_affine_plain(
        xp, wt, st, bt, dy, (3, 3), (1, 1), need_dx=need == "dx",
        need_dw=need == "dw")
    wanted = (True, False, False, False) if need == "dx" else (
        False, True, True, True)
    for g, ref, want in zip(got, both, wanted):
        if want:
            np.testing.assert_array_equal(g.numpy(), ref.numpy())
        else:
            assert g is None


def test_plain_affine_backward_rounds_once_in_bf16():
    """What is rounded where: with bf16 x, w and dy the plain affine
    backward gives exactly the f32 result on the widened inputs, rounded
    once for dx and dw and not at all for ds and db (which multiply the raw
    bf16 w widened to f32, not a rounded ``w*s + b``)."""
    x, w, s, b, pad = make_inputs(21, affine=True)
    xt, wt, st, bt = to_port(x, w, s, b)
    dy = torch.from_numpy(_cotangent((2, 8, 9, 8)))
    xp = torch.nn.functional.pad(xt, (pad,) * 4)
    low = [t.to(torch.bfloat16) for t in (xp, wt, dy)]
    got = la.local_aggregate_bwd_affine_plain(low[0], low[1], st, bt, low[2],
                                              (3, 3), (1, 1))
    ref = la.local_aggregate_bwd_affine_plain(
        low[0].float(), low[1].float(), st, bt, low[2].float(), (3, 3),
        (1, 1))
    assert [g.dtype for g in got] == [torch.bfloat16, torch.bfloat16,
                                      torch.float32, torch.float32]
    for g, r in zip(got[:2], ref[:2]):
        assert torch.equal(g, r.to(torch.bfloat16))
    for g, r in zip(got[2:], ref[2:]):
        assert torch.equal(g, r)


# ---- the fold's gradients -------------------------------------------------

def _cw_major(a, k2, cw, groups=1):
    """Last axis in the JAX package's order ``[groups][K2][Cw/groups]`` ->
    the port's ``[groups][Cw/groups][K2]``."""
    cwg = cw // groups
    return np.swapaxes(a.reshape(*a.shape[:-1], groups, k2, cwg), -1,
                       -2).reshape(a.shape)


@functools.lru_cache(maxsize=None)
def _fold_case(dw_groups):
    k2, cw = 9, 4
    rng = np.random.RandomState(30 + dw_groups)
    x = (rng.randn(2, 5, 6, k2 * cw) + 0.5).astype(np.float32)
    gamma = (1 + 0.3 * rng.randn(k2 * cw)).astype(np.float32)
    beta = (0.3 * rng.randn(k2 * cw)).astype(np.float32)
    cwg = cw // dw_groups
    rs, rb = (rng.randn(2, dw_groups, k2, cwg).astype(np.float32)
              for _ in range(2))
    module = JaxSubChannelGroupNorm(k2=k2, cw=cw, dw_groups=dw_groups,
                                    fold=True)

    def loss(params, x_):
        s, b = module.apply({"params": params}, x_)
        return jnp.vdot(s, jnp.asarray(rs)) + jnp.vdot(b, jnp.asarray(rb))

    ref_gp, ref_gx = jax.grad(loss, (0, 1))(
        {"scale": jnp.asarray(gamma), "bias": jnp.asarray(beta)},
        jnp.asarray(x))

    gn = tnn.SubChannelGroupNorm(k2, cw).train()
    with torch.no_grad():
        gn.weight.copy_(torch.from_numpy(_cw_major(gamma, k2, cw, dw_groups)))
        gn.bias.copy_(torch.from_numpy(_cw_major(beta, k2, cw, dw_groups)))
    xt = torch.from_numpy(np.ascontiguousarray(
        _cw_major(x, k2, cw, dw_groups).transpose(0, 3, 1, 2))
    ).requires_grad_()
    s, b = gn.fold(xt)
    assert s.shape == b.shape == (2, 1, cw, k2)

    def as_port(r):      # [N, G, K2, Cwg] -> [N, 1, Cw, K2]
        return torch.from_numpy(np.ascontiguousarray(
            r.transpose(0, 1, 3, 2))).reshape(2, 1, cw, k2)

    ((s * as_port(rs)).sum() + (b * as_port(rb)).sum()).backward()
    got = {"x": xt.grad.numpy().transpose(0, 2, 3, 1),
           "weight": gn.weight.grad.numpy(), "bias": gn.bias.grad.numpy()}
    ref = {"x": _cw_major(np.asarray(ref_gx), k2, cw, dw_groups),
           "weight": _cw_major(np.asarray(ref_gp["scale"]), k2, cw,
                               dw_groups),
           "bias": _cw_major(np.asarray(ref_gp["bias"]), k2, cw, dw_groups)}
    return got, ref


@pytest.mark.parametrize("wrt", ["x", "weight", "bias"])
@pytest.mark.parametrize("dw_groups", [1, 2])
def test_group_norm_fold_gradients(dw_groups, wrt):
    """Gradients arriving at the fold's ``(s, b)`` reach the input and the
    two parameters as ``jax.grad`` through the flax module with
    ``fold=True`` has them: rtol 1e-4, atol 1e-5 of the largest entry (the
    chain through the one-pass statistics cancels sums of 270 values).
    ``dw_groups=2`` is CoXtLayer's channel order on the JAX side; the
    port's groups are blocks of K^2 channels either way."""
    got, ref = _fold_case(dw_groups)
    np.testing.assert_allclose(got[wrt], ref[wrt], rtol=1e-4,
                               atol=1e-5 * np.abs(ref[wrt]).max())


def test_group_norm_raw_returns_the_parameters():
    gn = tnn.SubChannelGroupNorm(9, 4)
    weight, bias = gn.raw()
    assert weight is gn.weight and bias is gn.bias


# ---- the fused embed conv + GroupNorm + aggregation -------------------------

def _embed_inputs(seed, n=4, h=14, w=14, c=64, cp=32, k=3, groups=1):
    """numpy inputs in the JAX package's layouts: NHWC x and w_pre, w2
    ``[Cp/groups, F]`` and b2/gamma/beta ``[F]`` with F k-major within each
    group."""
    rng = np.random.RandomState(seed)
    f = k * k * (c // 8)
    x = rng.randn(n, h, w, c).astype(np.float32)
    w_pre = np.maximum(rng.randn(n, h, w, cp), 0).astype(np.float32)
    w2 = (0.1 * rng.randn(cp // groups, f)).astype(np.float32)
    b2 = (0.1 * rng.randn(f)).astype(np.float32)
    gamma = (1 + 0.2 * rng.randn(f)).astype(np.float32)
    beta = (0.2 * rng.randn(f)).astype(np.float32)
    return x, w_pre, w2, b2, gamma, beta


def _port_embed_gn(x, w_pre, w2, b2, gamma, beta, k, groups=1, **kwargs):
    """The port's op on the same inputs, permuted to its layouts; NHWC
    back."""
    k2, cw = k * k, x.shape[-1] // 8

    def vec(v):
        return torch.from_numpy(_cw_major(v, k2, cw, groups))

    w2t = torch.from_numpy(np.ascontiguousarray(
        _cw_major(w2, k2, cw, groups).T))           # [F, Cp/groups]
    with torch.no_grad():
        out = la.local_aggregate_embed_gn(
            torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))),
            torch.from_numpy(np.ascontiguousarray(
                w_pre.transpose(0, 3, 1, 2))),
            w2t, vec(b2), vec(gamma), vec(beta), kernel_size=k,
            groups=groups, **kwargs)
    return to_nhwc(out)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_embed_gn_matches_jax(impl):
    """The port's plain fused op against the JAX op at the shape of the JAX
    package's own test: its XLA composition, and ``_fused_embed_kernel`` in
    interpret mode.  atol 2e-4 with outputs up to about 10: f32 on both
    sides, the product's and the statistics' sums in another order, and the
    XLA form normalizes as ``w*s + b``, which cancels where the kernel's
    subtract-first form does not."""
    x, w_pre, w2, b2, gamma, beta = _embed_inputs(0)
    if impl == "pallas":
        assert lap.fused_embed_plan(x.shape, w_pre.shape, w2.shape[1], 4,
                                    (1, 1)) is not None
    ref = jax.jit(lambda *a: jax_embed_gn(*a, kernel_size=3, padding=1,
                                          impl=impl))(
        *(jnp.asarray(a) for a in (x, w_pre, w2, b2, gamma, beta)))
    plain = la.PLAIN_EMBED_GN_CALLS
    got = _port_embed_gn(x, w_pre, w2, b2, gamma, beta, 3, padding=1)
    assert la.PLAIN_EMBED_GN_CALLS == plain + 1
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=2e-4)


@pytest.mark.parametrize("k,dil,h,w", [(5, 2, 9, 7), (7, 1, 8, 6)])
def test_embed_gn_general_geometry_matches_jax_xla(k, dil, h, w):
    """K = 5 with dilation 2, K = 7, non-square maps, Cp not a multiple of
    32: against the JAX op's XLA composition (atol 2e-4, as above)."""
    pad = (dil * (k - 1) + 1) // 2
    args = _embed_inputs(k, n=2, h=h, w=w, c=16, cp=24, k=k)
    ref = jax_embed_gn(*(jnp.asarray(a) for a in args), kernel_size=k,
                       padding=pad, dilation=dil, impl="xla")
    got = _port_embed_gn(*args, k, padding=pad, dilation=dil)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=2e-4)


# (n, h, w, C, Cp) where the Hopper kernel's tiling changes its course: a
# plane over several row tiles (57x57, 56x56 N = 2, 40x40: the statistics
# kernel runs first, in row tiles of its own; at 40x40 with Cp = 20, no
# multiple of its 16-channel stages), an odd width with Cw = C/8 = 6, whole
# 7x7 planes with Cp = 64, several to a block.  The plain version is what
# the CPU runs; these hold it against the JAX op at the same geometries
# (and with groups = 2, below).
EMBED_TILING = {
    "57x57": (2, 57, 57, 16, 8),
    "56x56": (2, 56, 56, 32, 16),
    "40x40_cp20": (2, 40, 40, 16, 20),
    "13x11_cw6": (2, 13, 11, 48, 24),
    "7x7_cp64": (2, 7, 7, 128, 64),
}


@pytest.mark.parametrize("case,impl", [
    ("57x57", "xla"), ("56x56", "xla"), ("40x40_cp20", "xla"),
    ("13x11_cw6", "xla"), ("13x11_cw6", "pallas"),
    ("7x7_cp64", "xla"), ("7x7_cp64", "pallas")])
def test_embed_gn_tiling_geometries_match_jax(case, impl):
    """The port's plain fused op against the JAX op's XLA composition, and
    against ``_fused_embed_kernel`` in interpret mode where
    ``fused_embed_plan`` takes the map (up to 28x28), at the geometries the
    Hopper kernel's tiling meets (atol 2e-4, as above)."""
    n, h, w, c, cp = EMBED_TILING[case]
    args = _embed_inputs(len(case), n=n, h=h, w=w, c=c, cp=cp)
    if impl == "pallas":
        assert lap.fused_embed_plan(args[0].shape, args[1].shape,
                                    args[2].shape[1], 4, (1, 1)) is not None
    ref = jax.jit(lambda *a: jax_embed_gn(*a, kernel_size=3, padding=1,
                                          impl=impl))(
        *(jnp.asarray(a) for a in args))
    got = _port_embed_gn(*args, 3, padding=1)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=2e-4)


def _jax_embed_gn_per_group(x, w_pre, w2, b2, gamma, beta, groups, k=3):
    """The JAX package's form of a grouped layer: one call of the JAX op per
    channel group with that group's slices of the grouped conv's kernel and
    of the GroupNorm parameters (``cotnet_tpu/models/cotnet.py:298-305``)."""
    fg, cg = w2.shape[1] // groups, x.shape[-1] // groups
    cpg = w_pre.shape[-1] // groups
    outs = []
    for g in range(groups):
        sl = slice(g * fg, (g + 1) * fg)
        outs.append(jax_embed_gn(
            jnp.asarray(x[..., g * cg:(g + 1) * cg]),
            jnp.asarray(w_pre[..., g * cpg:(g + 1) * cpg]),
            jnp.asarray(w2[:, sl]), jnp.asarray(b2[sl]),
            jnp.asarray(gamma[sl]), jnp.asarray(beta[sl]), kernel_size=k,
            padding=1, impl="xla"))
    return np.concatenate([np.asarray(o) for o in outs], axis=-1)


@pytest.mark.parametrize("case", sorted(EMBED_TILING))
def test_embed_gn_groups_at_tiling_geometries_match_jax(case):
    """``groups=2`` at the tiling geometries above, against one JAX call per
    channel group (atol 2e-4, as above)."""
    groups = 2
    n, h, w, c, cp = EMBED_TILING[case]
    c = max(c, 32)                 # Cw = C/8 over both groups, 2 or more each
    args = _embed_inputs(len(case) + 20, n=n, h=h, w=w, c=c, cp=cp,
                         groups=groups)
    ref = _jax_embed_gn_per_group(*args, groups)
    got = _port_embed_gn(*args, 3, groups=groups, padding=1)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-4)


def test_embed_gn_groups_match_jax_per_group_calls():
    """``groups=2`` against the JAX package's form of it: one call of the
    JAX op per channel half with that half's slices of the grouped conv's
    kernel and of the GroupNorm parameters
    (``cotnet_tpu/models/cotnet.py:298-305``).  Cw = 6 per group."""
    groups, c, cp, k = 2, 96, 48, 3
    args = _embed_inputs(3, n=2, h=7, w=6, c=c, cp=cp, groups=groups)
    ref = _jax_embed_gn_per_group(*args, groups, k)
    got = _port_embed_gn(*args, k, groups=groups, padding=1)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-4)


def test_embed_gn_rounds_w_raw_to_the_model_dtype():
    """In bf16 the statistics and the normalize see ``w_raw`` rounded to
    bf16, as the TPU kernel's scratch holds it: the plain version equals
    its own f32 run fed that rounded tensor through an identity conv, and
    differs from the f32 run on the unrounded one."""
    x, w_pre, w2, b2, gamma, beta = _embed_inputs(5, n=2, h=6, w=5, c=16,
                                                  cp=8)
    low = torch.bfloat16

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)

    xt, wp = t(x.transpose(0, 3, 1, 2), low), t(w_pre.transpose(0, 3, 1, 2),
                                                low)
    w2t, vecs = t(w2.T), [t(v) for v in (b2, gamma, beta)]
    with torch.no_grad():
        got = la.local_aggregate_embed_gn(xt, wp, w2t, *vecs)
        assert got.dtype == low
        w_raw = (torch.einsum("fc,nchw->nfhw", w2t.to(low).float(),
                              wp.float())
                 + vecs[0][None, :, None, None])
        eye = torch.eye(w2t.shape[0])
        zero = torch.zeros(w2t.shape[0])
        rounded, unrounded = (la.local_aggregate_embed_gn(
            xt.float(), raw, eye, zero, *vecs[1:])
            for raw in (w_raw.to(low).float(), w_raw))
    assert torch.equal(got, rounded.to(low))
    assert not torch.equal(got, unrounded.to(low))


@pytest.mark.parametrize("which", ["x", "w_pre", "w2", "gamma"])
def test_embed_gn_with_grad_is_refused(which):
    """The fused op is the eval path and has no backward, as the TPU kernel
    has no VJP: a call that would record a gradient raises by name."""
    x, w_pre, w2, b2, gamma, beta = _embed_inputs(6, n=1, h=5, w=5, c=16,
                                                  cp=8)
    tensors = dict(
        x=torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))),
        w_pre=torch.from_numpy(np.ascontiguousarray(
            w_pre.transpose(0, 3, 1, 2))),
        w2=torch.from_numpy(np.ascontiguousarray(w2.T)),
        b2=torch.from_numpy(b2), gamma=torch.from_numpy(gamma),
        beta=torch.from_numpy(beta))
    tensors[which].requires_grad_()
    for impl in ("auto", "torch"):
        with pytest.raises(NotImplementedError, match="no backward"):
            la.local_aggregate_embed_gn(*tensors.values(), impl=impl)
    with torch.no_grad():
        assert la.local_aggregate_embed_gn(*tensors.values()).shape == (
            1, 16, 5, 5)


def test_embed_gn_rejects_what_it_cannot_take():
    x = torch.zeros(2, 16, 5, 5)
    w_pre = torch.zeros(2, 8, 5, 5)
    w2, v = torch.zeros(18, 8), torch.zeros(18)
    with pytest.raises(ValueError, match="CUDA"):
        la.local_aggregate_embed_gn(x, w_pre, w2, v, v, v, impl="hopper")
    with pytest.raises(ValueError, match="CUDA"):
        la.local_aggregate_embed_gn_hopper(
            x, w_pre, w2, v, v, v, kernel_size=(3, 3), dilation=(1, 1),
            padding=(1, 1))
    with pytest.raises(ValueError, match="unknown impl"):
        la.local_aggregate_embed_gn(x, w_pre, w2, v, v, v, impl="xla")
    with pytest.raises(ValueError, match="w_pre shape"):
        la.local_aggregate_embed_gn(x, w_pre[:, :4], w2, v, v, v)
    with pytest.raises(ValueError, match="groups"):
        la.local_aggregate_embed_gn(x, w_pre, w2[:17], v, v, v)
    with pytest.raises(ValueError, match=r"shape \(18,\)"):
        la.local_aggregate_embed_gn(x, w_pre, w2, v[:9], v, v)
    # a 1x1 conv's own 4-D weight is taken as it is
    with torch.no_grad():
        assert la.local_aggregate_embed_gn(
            x, w_pre, w2[:, :, None, None], v, v, v).shape == x.shape


def test_reset_counts_zeroes_the_new_counts():
    x, w_pre, w2, b2, gamma, beta = _embed_inputs(7, n=1, h=5, w=5, c=16,
                                                  cp=8)
    _port_embed_gn(x, w_pre, w2, b2, gamma, beta, 3)
    la.EMBED_GN_LAUNCHES_BY_SHAPE[("x",)] = 1
    la.AFFINE_BWD_LAUNCHES["dw"] += 1
    assert la.PLAIN_EMBED_GN_CALLS > 0
    la.reset_counts()
    assert (la.PLAIN_EMBED_GN_CALLS, la.EMBED_GN_LAUNCHES,
            la.EMBED_GN_LAUNCHES_BY_SHAPE, la.AFFINE_BWD_LAUNCHES) == (
                0, 0, {}, {"dx": 0, "dw": 0})
    xt = torch.zeros(2, 16, 5, 5)
    assert la.embed_gn_key(xt, xt[:, :8], 1, (1, 1), (1, 1)) == (
        "float32", (2, 16, 5, 5), (2, 8, 5, 5), 1, (1, 1), (1, 1))
