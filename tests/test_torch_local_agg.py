"""Parity of the PyTorch port's local aggregation with the JAX package.

The port (``cotnet_tpu_torch.ops.local_agg``) works on NCHW activations and
the cw-major weight ``[N, heads, Cw, K*K, Ho, Wo]``; the JAX package on NHWC
and the k-major weight ``[N, Ho, Wo, heads, K*K, Cw]``.  The same seeded
numpy inputs go to both, permuted, in f32, forward and gradients.  On the
CPU the port runs its plain versions; the Hopper kernels' own tests are in
``test_torch_hopper_gpu.py``.
"""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import cotnet_tpu.ops.local_agg_pallas as lap  # noqa: E402
from cotnet_tpu.ops.local_agg import local_aggregate as jax_aggregate  # noqa: E402
from cotnet_tpu_torch.ops import local_agg as la  # noqa: E402
from test_torch_hopper_gpu import make_inputs, to_nhwc, to_port  # noqa: E402,F401


@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("pad_mode", ["zeros", "reflect"])
@pytest.mark.parametrize("heads", [1, 2])
@pytest.mark.parametrize("dil", [1, 2])
@pytest.mark.parametrize("k", [3, 5, 7])
def test_plain_matches_jax_xla(k, dil, heads, pad_mode, stride, affine):
    x, w, s, b, pad = make_inputs(k * 100 + dil * 10 + heads, k=k, dil=dil,
                                  heads=heads, stride=stride, affine=affine)
    ref = jax_aggregate(
        jnp.asarray(x), jnp.asarray(w), kernel_size=k, stride=stride,
        padding=pad, dilation=dil, pad_mode=pad_mode, impl="xla",
        w_scale=None if s is None else jnp.asarray(s),
        w_bias=None if b is None else jnp.asarray(b))
    xt, wt, st, bt = to_port(x, w, s, b)
    got = la.local_aggregate(xt, wt, kernel_size=k, stride=stride,
                             padding=pad, dilation=dil, pad_mode=pad_mode,
                             impl="torch", w_scale=st, w_bias=bt)
    np.testing.assert_allclose(to_nhwc(got), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def _pallas_whole(x, w, s, b, k, d, pad):
    plan = lap.pallas_plan(x.shape, w.shape, 4, (pad, pad),
                           affine=s is not None)
    assert plan is not None and plan[0] == "whole", plan
    if s is None:
        return lap.agg_core_pallas(x, w, (k, k), (d, d), (pad, pad))
    return lap.agg_core_pallas_affine(x, w, s, b, (k, k), (d, d), (pad, pad))


def _pallas_chwn(x, w, s, b, k, d, pad):
    old = (lap.CHWN_DISPATCH, lap.CHWN_ANY_N)
    try:
        lap.CHWN_DISPATCH = True
        lap.CHWN_ANY_N = True
        assert lap.chwn_plan(x.shape, w.shape, 4, (pad, pad)) is not None
        if s is None:
            return lap.agg_core_pallas(x, w, (k, k), (d, d), (pad, pad))
        return lap.agg_core_pallas_affine(x, w, s, b, (k, k), (d, d),
                                          (pad, pad))
    finally:
        lap.CHWN_DISPATCH, lap.CHWN_ANY_N = old


def _pallas_chwn_strip(x, w, s, b, k, d, pad):
    old = (lap.CHWN_DISPATCH, lap.CHWN_ANY_N, lap.chwn_plan, lap.pallas_plan)
    try:
        lap.CHWN_DISPATCH = True
        lap.CHWN_ANY_N = True
        lap.chwn_plan = lambda *a, **kw: None      # whole-image CHWN off
        lap.pallas_plan = lambda *a, **kw: None    # NHWC plans off
        assert lap.chwn_strip_plan(x.shape, w.shape, 4, (pad, pad)) \
            is not None
        return jax_aggregate(x, w, kernel_size=k, padding=pad, dilation=d,
                             impl="pallas", w_scale=s, w_bias=b)
    finally:
        (lap.CHWN_DISPATCH, lap.CHWN_ANY_N, lap.chwn_plan,
         lap.pallas_plan) = old


@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("form,shape", [
    # _fwd_kernel / _fwd_kernel_affine (whole image, NHWC, any heads)
    (_pallas_whole, dict(n=2, c=16, cw=4, hi=8, wi=8, heads=2)),
    # _fwd_chwn_kernel (batch on lanes)
    (_pallas_chwn, dict(n=4, c=16, cw=2, hi=9, wi=9)),
    # _fwd_chwn_strip_kernel (CHWN in H-strips)
    (_pallas_chwn_strip, dict(n=4, c=16, cw=2, hi=8, wi=8)),
], ids=["whole", "chwn", "chwn_strip"])
def test_plain_matches_jax_pallas_interpret(form, shape, affine):
    """The port's plain version against the four TPU forward kernels it
    replaces, run in interpret mode as the JAX package's own tests do."""
    x, w, s, b, pad = make_inputs(7, affine=affine, **shape)
    ref = form(jnp.asarray(x), jnp.asarray(w),
               None if s is None else jnp.asarray(s),
               None if b is None else jnp.asarray(b), 3, 1, pad)
    xt, wt, st, bt = to_port(x, w, s, b)
    got = la.local_aggregate(xt, wt, kernel_size=3, padding=pad,
                             impl="torch", w_scale=st, w_bias=bt)
    np.testing.assert_allclose(to_nhwc(got), np.asarray(ref), atol=2e-4)


def test_plain_matches_unfold_oracle():
    """A second, independent oracle: ``F.unfold`` + broadcast-sum in NCHW
    (the reference's own test form), with the affine pre-applied."""
    x, w, s, b, pad = make_inputs(3, heads=2, affine=True)
    xt, wt, st, bt = to_port(x, w, s, b)
    n, c = xt.shape[:2]
    _, heads, cw, k2, ho, wo = wt.shape
    patches = torch.nn.functional.unfold(xt, 3, padding=pad).view(
        n, 1, c // cw, cw, k2, ho, wo)
    wn = (wt * st[..., None, None] + bt[..., None, None]).unsqueeze(2)
    ref = (wn * patches).sum(4).reshape(n, heads * c, ho, wo)
    got = la.local_aggregate(xt, wt, padding=pad, w_scale=st, w_bias=bt)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5)
    # extract_patches is the same view as nn.Unfold
    np.testing.assert_array_equal(
        la.extract_patches(xt, 3, padding=pad).reshape(n, -1, ho * wo).numpy(),
        torch.nn.functional.unfold(xt, 3, padding=pad).numpy())


def test_hopper_on_cpu_tensor_raises():
    x, w, _, _, pad = make_inputs(0)
    xt, wt, _, _ = to_port(x, w)
    with pytest.raises(ValueError, match="CUDA"):
        la.local_aggregate(xt, wt, padding=pad, impl="hopper")
    with pytest.raises(ValueError, match="CUDA"):
        la.local_aggregate_hopper(xt, wt, kernel_size=(3, 3),
                                  dilation=(1, 1), padding=(pad, pad))


@pytest.mark.parametrize("stride", [1, 2])
def test_auto_on_cpu_takes_plain_version(stride):
    x, w, _, _, pad = make_inputs(0, stride=stride)
    xt, wt, _, _ = to_port(x, w)
    launches, plain = la.LAUNCHES, la.PLAIN_CALLS
    la.local_aggregate(xt, wt, stride=stride, padding=pad, impl="auto")
    assert la.PLAIN_CALLS == plain + 1
    assert la.LAUNCHES == launches


def test_reset_counts_and_launch_key():
    x, w, s, b, pad = make_inputs(0, affine=True)
    xt, wt, st, bt = to_port(x, w, s, b)
    la.local_aggregate(xt, wt, padding=pad, w_scale=st, w_bias=bt)
    la.LAUNCHES_BY_SHAPE[("x",)] = 1
    la.reset_counts()
    assert (la.LAUNCHES, la.PLAIN_CALLS, la.LAUNCHES_BY_SHAPE) == (0, 0, {})
    assert la.launch_key(xt, wt, True, (1, 1), (pad, pad)) == (
        "float32", True, (2, 8, 9, 8), (2, 1, 4, 9, 9, 8), (1, 1),
        (pad, pad))


# ---- gradients on the CPU: the plain backward against the JAX package ------

def _seeded_cotangent(shape, seed=11):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _port_grads(x, w, r, **kwargs):
    """dx, dw of ``sum(out * r)`` from the port, in the JAX layouts."""
    xt, wt = (t.requires_grad_() for t in to_port(x, w)[:2])
    out = la.local_aggregate(xt, wt, **kwargs)
    (out * torch.from_numpy(np.ascontiguousarray(
        r.transpose(0, 3, 1, 2)))).sum().backward()
    return (to_nhwc(xt.grad),
            wt.grad.numpy().transpose(0, 4, 5, 1, 3, 2))   # -> k-major


def _jax_grads(x, w, r, **kwargs):
    f = lambda x_, w_: jnp.vdot(jax_aggregate(x_, w_, **kwargs),  # noqa: E731
                                jnp.asarray(r))
    return jax.grad(f, (0, 1))(jnp.asarray(x), jnp.asarray(w))


@pytest.mark.parametrize("pad_mode", ["zeros", "reflect"])
@pytest.mark.parametrize("heads", [1, 2])
@pytest.mark.parametrize("dil", [1, 2])
@pytest.mark.parametrize("k", [3, 5, 7])
def test_grads_match_jax_xla(k, dil, heads, pad_mode):
    """dx and dw of ``sum(out * r)`` for a seeded r against ``jax.grad`` of
    the XLA formulation (rtol/atol 1e-5: f32 sums in another order)."""
    x, w, _, _, pad = make_inputs(k * 100 + dil * 10 + heads, k=k, dil=dil,
                                  heads=heads)
    r = _seeded_cotangent((2, 9, 8, heads * 8))
    kwargs = dict(kernel_size=k, padding=pad, dilation=dil,
                  pad_mode=pad_mode)
    plain_bwd = la.PLAIN_BWD_CALLS
    got = _port_grads(x, w, r, **kwargs)
    assert la.PLAIN_BWD_CALLS == plain_bwd + 1
    ref = _jax_grads(x, w, r, impl="xla", **kwargs)
    for name, g, want in zip(("dx", "dw"), got, ref):
        np.testing.assert_allclose(g, np.asarray(want), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


# geometries the port's halo-tile kernels do not take, which they run on
# their pointwise route: K = 9 beyond the tiles' 7, a row of 513 positions
# (more than 512 thread items in the general instantiation, and at K = 3
# the width class of 2049), and K = 7 at dilation 8, whose f32 halo tile is
# larger than a block's shared memory
_BEYOND_TILES = {
    "k9": dict(n=2, c=16, cw=4, hi=13, wi=11, k=9),
    "w513_k3": dict(n=1, c=16, cw=8, hi=3, wi=513, k=3),
    "w513_k5": dict(n=1, c=16, cw=8, hi=3, wi=513, k=5),
    "k7_dil8": dict(n=1, c=16, cw=8, hi=16, wi=256, k=7, dil=8),
}


@pytest.mark.parametrize("case", sorted(_BEYOND_TILES))
def test_plain_matches_jax_xla_beyond_the_tiles(case):
    """The plain forward against the XLA formulation at the geometries the
    kernels run pointwise (rtol/atol 1e-5: f32 sums in another order)."""
    geo = _BEYOND_TILES[case]
    x, w, _, _, pad = make_inputs(31, **geo)
    kwargs = dict(kernel_size=geo["k"], padding=pad,
                  dilation=geo.get("dil", 1))
    ref = jax_aggregate(jnp.asarray(x), jnp.asarray(w), impl="xla", **kwargs)
    xt, wt, _, _ = to_port(x, w)
    got = la.local_aggregate(xt, wt, impl="torch", **kwargs)
    np.testing.assert_allclose(to_nhwc(got), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("case", sorted(_BEYOND_TILES))
def test_grads_match_jax_xla_beyond_the_tiles(case):
    """dx and dw of ``sum(out * r)`` through the plain backward against
    ``jax.grad`` of the XLA formulation at the same geometries (rtol/atol
    1e-5)."""
    geo = _BEYOND_TILES[case]
    x, w, _, _, pad = make_inputs(32, **geo)
    r = _seeded_cotangent(x.shape)
    kwargs = dict(kernel_size=geo["k"], padding=pad,
                  dilation=geo.get("dil", 1))
    got = _port_grads(x, w, r, **kwargs)
    ref = _jax_grads(x, w, r, impl="xla", **kwargs)
    for name, g, want in zip(("dx", "dw"), got, ref):
        np.testing.assert_allclose(g, np.asarray(want), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("pad_mode", ["zeros", "reflect"])
def test_strided_grads_match_jax_xla(pad_mode):
    """Stride 2 runs the plain forward alone; autograd differentiates it."""
    x, w, _, _, pad = make_inputs(4, stride=2)
    r = _seeded_cotangent(w.shape[:3] + (8,))
    kwargs = dict(kernel_size=3, stride=2, padding=pad, pad_mode=pad_mode)
    got = _port_grads(x, w, r, **kwargs)
    ref = _jax_grads(x, w, r, impl="xla", **kwargs)
    for name, g, want in zip(("dx", "dw"), got, ref):
        np.testing.assert_allclose(g, np.asarray(want), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


@contextlib.contextmanager
def _pallas_flags(**flags):
    """Module-level dispatch switches of the JAX package's Pallas op, set for
    one call and put back (as its own tests do)."""
    old = {name: getattr(lap, name) for name in flags}
    try:
        for name, value in flags.items():
            setattr(lap, name, value)
        yield
    finally:
        for name, value in old.items():
            setattr(lap, name, value)


_NO_PLAN = lambda *a, **kw: None  # noqa: E731
_SMALL = dict(n=2, c=16, cw=4, hi=8, wi=8, heads=2)
_CHWN = dict(CHWN_DISPATCH=True, CHWN_ANY_N=True)
# name -> (flags, input shape, the plan the shape must get); each reaches
# one backward form of _agg_bwd_rule in interpret mode
_BWD_FORMS = {
    # _dxdw_gather_kernel (fused, NHWC, gather dx)
    "fused_gather": (dict(FUSED_BWD=True, DX_GATHER=True), _SMALL, "whole"),
    # _dxdw_scatter_kernel (fused, scatter dx)
    "fused_scatter": (dict(FUSED_BWD=True, DX_GATHER=False), _SMALL, "whole"),
    # _dx_gather_kernel + _dw_kernel_dot (two launches, big-map forms)
    "split_big_map": (dict(FUSED_BWD=False, DX_GATHER=True, DX_BIG_MAP_MIN=0),
                      _SMALL, "whole"),
    # _dx_kernel + _dw_kernel (two launches, small-map forms)
    "split_small_map": (dict(FUSED_BWD=False, DX_BIG_MAP_MIN=10 ** 9),
                        _SMALL, "whole"),
    # _dxdw_chwn_kernel (batch on lanes, whole image)
    "chwn": (_CHWN, dict(n=4, c=16, cw=2, hi=9, wi=9), "chwn"),
    # _bwd_chwn_strip_g_kernel (CHWN H-strips, g reduced in-kernel)
    "chwn_strip": (dict(_CHWN, chwn_plan=_NO_PLAN, pallas_plan=_NO_PLAN),
                   dict(n=4, c=16, cw=2, hi=8, wi=8), "chwn_strip"),
    # _dw_wloop_kernel (gated 56x56 tiling: whole image, grouped taps)
    "dw_wloop": (dict(WLOOP_DISPATCH=True, _VMEM_BUDGET_BYTES=1 << 20),
                 dict(n=2, c=16, cw=2, hi=32, wi=32), "wloop"),
    # _dw_strip_kernel (gated 56x56 tiling: halo strips)
    "dw_strip": (dict(STRIP_DISPATCH=True),
                 dict(n=2, c=16, cw=2, hi=56, wi=56), "strip"),
}


@pytest.mark.parametrize("form", sorted(_BWD_FORMS))
def test_grads_match_jax_pallas_interpret(form):
    """The port's plain backward against each TPU backward kernel it
    replaces, run in interpret mode as the JAX package's own tests run
    them; atol 2e-4 as for the forward forms (f32, sums in another order,
    gradients of size up to about 10)."""
    flags, shape, want_plan = _BWD_FORMS[form]
    x, w, _, _, pad = make_inputs(7, **shape)
    heads = shape.get("heads", 1)
    r = _seeded_cotangent(x.shape[:3] + (heads * x.shape[3],))
    with _pallas_flags(**flags):
        if want_plan == "chwn":
            assert lap.chwn_plan(x.shape, w.shape, 4, (pad, pad)) is not None
        elif want_plan == "chwn_strip":
            assert lap.chwn_strip_bwd_plan(x.shape, w.shape, 4,
                                           (pad, pad)) is not None
        else:
            assert lap.pallas_plan(x.shape, w.shape, 4,
                                   (pad, pad))[0] == want_plan
        ref = _jax_grads(x, w, r, kernel_size=3, padding=pad, impl="pallas")
    got = _port_grads(x, w, r, kernel_size=3, padding=pad)
    for name, g, want in zip(("dx", "dw"), got, ref):
        np.testing.assert_allclose(g, np.asarray(want), atol=2e-4,
                                   err_msg=name)


@pytest.mark.parametrize("k,dil,heads", [(3, 1, 1), (5, 2, 2), (7, 1, 2)])
def test_plain_backward_matches_autograd_f64(k, dil, heads):
    """The plain backward against autograd of the plain forward, in f64
    (torch only: the JAX side of the tests is f32)."""
    n, c, cw, h, wd = 2, 8, 4, 7, 6
    pad = (dil * (k - 1) + 1) // 2
    gen = torch.Generator().manual_seed(k)
    x = torch.randn(n, c, h, wd, dtype=torch.float64, generator=gen)
    w = torch.randn(n, heads, cw, k * k, h, wd, dtype=torch.float64,
                    generator=gen)
    dy = torch.randn(n, heads * c, h, wd, dtype=torch.float64, generator=gen)
    xp = torch.nn.functional.pad(x, (pad,) * 4).requires_grad_()
    w.requires_grad_()
    out = la.local_aggregate_plain(xp, w, (k, k), (1, 1), (dil, dil))
    ref = torch.autograd.grad(out, (xp, w), dy)
    got = la.local_aggregate_bwd_plain(xp.detach(), w.detach(), dy, (k, k),
                                       (dil, dil))
    for g, r in zip(got, ref):
        assert g.dtype == torch.float64
        torch.testing.assert_close(g, r, rtol=1e-12, atol=1e-12)


def test_gradcheck_through_the_op_f64():
    """``torch.autograd.gradcheck`` of the whole op (the Function with the
    plain backward, reflect pad outside it) in f64."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(1, 4, 5, 4, dtype=torch.float64, generator=gen,
                    requires_grad=True)
    w = torch.randn(1, 2, 2, 9, 5, 4, dtype=torch.float64, generator=gen,
                    requires_grad=True)
    for pad_mode in ("zeros", "reflect"):
        assert torch.autograd.gradcheck(
            lambda a, b: la.local_aggregate(a, b, pad_mode=pad_mode), (x, w))


@pytest.mark.parametrize("need", ["dx", "dw"])
def test_backward_computes_only_what_is_needed(need):
    """Only x, or only w, requires a gradient: the other is not computed,
    and the one that is matches the two-gradient call."""
    x, w, _, _, pad = make_inputs(9, heads=2)
    r = _seeded_cotangent((2, 9, 8, 16))
    both = _port_grads(x, w, r, padding=pad)
    xt, wt = to_port(x, w)[:2]
    (xt if need == "dx" else wt).requires_grad_()
    out = la.local_aggregate(xt, wt, padding=pad)
    (out * torch.from_numpy(np.ascontiguousarray(
        r.transpose(0, 3, 1, 2)))).sum().backward()
    if need == "dx":
        assert wt.grad is None
        np.testing.assert_array_equal(to_nhwc(xt.grad), both[0])
    else:
        assert xt.grad is None
        np.testing.assert_array_equal(
            wt.grad.numpy().transpose(0, 4, 5, 1, 3, 2), both[1])
    dxp, dw = la.local_aggregate_bwd_plain(
        torch.nn.functional.pad(xt.detach(), (pad,) * 4), wt.detach(),
        torch.ones(2, 16, 9, 8), (3, 3), (1, 1), need_dx=need == "dx",
        need_dw=need == "dw")
    assert (dxp is None) == (need == "dw") and (dw is None) == (need == "dx")


@pytest.mark.parametrize("which", ["x", "w", "w_scale", "w_bias"])
def test_affine_with_grad_is_refused(which):
    """The name dates from when such a call raised; it is kept so that the
    four cases stay the cases they were, and now they assert the opposite.
    No call with the GroupNorm fold is refused any more: one that records
    a gradient in any one of its four tensors computes, under either impl,
    and its backward hands that tensor the gradient the all-four call gives
    it and leaves the others alone; under ``no_grad`` it computes too."""
    x, w, s, b, pad = make_inputs(0, affine=True)
    names = ("x", "w", "w_scale", "w_bias")
    r = torch.from_numpy(_seeded_cotangent((2, 8, 9, 8)))

    def grads(needing, impl):
        tensors = dict(zip(names, to_port(x, w, s, b)))
        for name in needing:
            tensors[name].requires_grad_()
        out = la.local_aggregate(
            tensors["x"], tensors["w"], padding=pad, impl=impl,
            w_scale=tensors["w_scale"], w_bias=tensors["w_bias"])
        (out * r).sum().backward()
        return {name: t.grad for name, t in tensors.items()}

    want = grads(names, "torch")
    for impl in ("auto", "torch"):
        got = grads([which], impl)
        assert [name for name in names if got[name] is not None] == [which]
        np.testing.assert_array_equal(got[which].numpy(),
                                      want[which].numpy())
    with torch.no_grad():
        args = to_port(x, w, s, b)
        assert la.local_aggregate(*args[:2], padding=pad, w_scale=args[2],
                                  w_bias=args[3]).shape == (2, 8, 9, 8)


def test_reset_counts_zeroes_the_backward_counts():
    x, w, _, _, pad = make_inputs(0)
    _port_grads(x, w, _seeded_cotangent((2, 9, 8, 8)), padding=pad)
    la.BWD_LAUNCHES["dx"] += 1
    la.BWD_LAUNCHES_BY_SHAPE[("dx", ("x",))] = 1
    assert la.PLAIN_BWD_CALLS > 0
    la.reset_counts()
    assert (la.PLAIN_BWD_CALLS, la.BWD_LAUNCHES,
            la.BWD_LAUNCHES_BY_SHAPE) == (0, {"dx": 0, "dw": 0}, {})
    assert la.AFFINE_BWD_LAUNCHES == {"dx": 0, "dw": 0}


@pytest.mark.parametrize("hw", [(1, 1), (2, 2), (2, 5), (3, 3)])
def test_reflect_pad_beyond_the_map_matches_jax(hw):
    """A reflect pad of 3 (K = 7, SAN's key patches) on maps no larger than
    it reflects again and again, as ``jnp.pad(mode="reflect")`` does:
    ``extract_patches`` and ``local_aggregate(pad_mode="reflect")``, forward
    and the gradient of a seeded scalar loss, against the JAX package's
    (XLA form) in f32 at 1e-6 of the largest value of each."""
    from cotnet_tpu.ops.local_agg import extract_patches as jax_patches

    hi, wi = hw
    x, w, _, _, _ = make_inputs(41, n=2, c=8, cw=4, hi=hi, wi=wi, k=7)
    kwargs = dict(kernel_size=7, padding=3, pad_mode="reflect")
    rng = np.random.RandomState(42)
    rp = rng.randn(2, hi, wi, 49, 8).astype(np.float32)
    r = rng.randn(2, hi, wi, 8).astype(np.float32)

    def jax_loss(x_, w_):
        p = jax_patches(x_, **kwargs)
        out = jax_aggregate(x_, w_, impl="xla", **kwargs)
        return jnp.vdot(p, jnp.asarray(rp)) + jnp.vdot(out, jnp.asarray(r)), (
            p, out)

    (_, (p_ref, out_ref)), g_ref = jax.jit(jax.value_and_grad(
        jax_loss, (0, 1), has_aux=True))(jnp.asarray(x), jnp.asarray(w))
    xt, wt, _, _ = to_port(x, w)
    xt.requires_grad_()
    wt.requires_grad_()
    p = la.extract_patches(xt, **kwargs)          # [N, C, K2, H, W]
    out = la.local_aggregate(xt, wt, impl="torch", **kwargs)
    loss = (p * torch.from_numpy(rp.transpose(0, 4, 3, 1, 2))).sum() + (
        out * torch.from_numpy(r.transpose(0, 3, 1, 2))).sum()
    loss.backward()
    for name, got, want in (
            ("patches", p.detach().numpy().transpose(0, 3, 4, 2, 1), p_ref),
            ("out", to_nhwc(out), out_ref),
            ("dx", to_nhwc(xt.grad), g_ref[0]),
            ("dw", wt.grad.numpy().transpose(0, 4, 5, 1, 3, 2), g_ref[1])):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * float(np.abs(want).max()),
                                   err_msg=name)
