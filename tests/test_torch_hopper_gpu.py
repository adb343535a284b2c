"""The Hopper kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one.  The file imports
only ``torch``, numpy and the port, so it collects on a machine that has no
JAX::

    python -m pytest --noconftest tests/test_torch_hopper_gpu.py

It also holds the seeded numpy inputs (in the JAX package's layouts) and their
permutation into the port's, which the CPU parity tests share.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from cotnet_tpu_torch.ops import local_agg as la  # noqa: E402

pytestmark = pytest.mark.gpu


def make_inputs(seed, n=2, c=8, cw=4, hi=9, wi=8, heads=1, k=3, stride=1,
                dil=1, affine=False):
    """numpy NHWC / k-major inputs of the JAX package's layout."""
    pad = (dil * (k - 1) + 1) // 2
    ho = la.out_size(hi, k, stride, pad, dil)
    wo = la.out_size(wi, k, stride, pad, dil)
    rng = np.random.RandomState(seed)
    x = rng.randn(n, hi, wi, c).astype(np.float32)
    w = rng.randn(n, ho, wo, heads, k * k, cw).astype(np.float32)
    s = b = None
    if affine:
        s = (1.0 + 0.5 * rng.randn(n, heads, k * k, cw)).astype(np.float32)
        b = (0.5 * rng.randn(n, heads, k * k, cw)).astype(np.float32)
    return x, w, s, b, pad


def make_mix_inputs(seed, n=2, c=8, cw=4, hi=7, wi=6, heads=1):
    """numpy x ``[N, H, W, C]`` with the mix's 3x3 and 5x5 weights
    ``[N, H, W, heads, 9 | 25, Cw]``, the JAX package's layout."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, hi, wi, c).astype(np.float32)
    w1 = rng.randn(n, hi, wi, heads, 9, cw).astype(np.float32)
    w2 = rng.randn(n, hi, wi, heads, 25, cw).astype(np.float32)
    return x, w1, w2


def to_port(x, w, s=None, b=None):
    """NHWC / k-major numpy -> NCHW / cw-major torch tensors."""
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    wt = torch.from_numpy(np.ascontiguousarray(w.transpose(0, 3, 5, 4, 1, 2)))
    if s is None:
        return xt, wt, None, None
    st, bt = (torch.from_numpy(np.ascontiguousarray(a.transpose(0, 1, 3, 2)))
              for a in (s, b))
    return xt, wt, st, bt


def to_nhwc(y):
    return y.detach().numpy().transpose(0, 2, 3, 1)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the Hopper kernel has no CPU form)")


def test_hopper_grad_goes_through_the_kernels():
    """A CUDA gradient is computed by the two backward kernels, one launch
    each, and by no plain version."""
    _need_cuda()
    x, w, _, _, pad = make_inputs(0)
    xt, wt = (t.cuda().requires_grad_() for t in to_port(x, w)[:2])
    la.reset_counts()
    la.local_aggregate(xt, wt, padding=pad).square().sum().backward()
    torch.cuda.synchronize()
    assert (la.LAUNCHES, la.BWD_LAUNCHES) == (1, {"dx": 1, "dw": 1})
    assert (la.PLAIN_CALLS, la.PLAIN_BWD_CALLS) == (0, 0)
    assert xt.grad.shape == xt.shape and wt.grad.shape == wt.shape
    key = la.launch_key(xt, wt, False, (1, 1), (pad, pad))
    assert la.BWD_LAUNCHES_BY_SHAPE == {("dx", key): 1, ("dw", key): 1}


@pytest.mark.parametrize("impl", ["auto", "hopper"])
def test_cuda_strided_call_is_refused(impl):
    """The kernel computes stride 1 only.  Under 'hopper' a strided CUDA
    call raises; under 'auto' it takes the plain version, as the JAX
    package's auto takes XLA at any stride above 1, counts as a plain
    call with no launch and warns once for the geometry."""
    _need_cuda()
    x, w, _, _, pad = make_inputs(0, stride=2)
    xt, wt = (t.cuda() for t in to_port(x, w)[:2])
    la.reset_counts()
    plain, launches = la.PLAIN_CALLS, la.LAUNCHES
    if impl == "hopper":
        with pytest.raises(NotImplementedError, match="stride 1"):
            la.local_aggregate(xt, wt, stride=2, padding=pad, impl=impl)
        assert la.PLAIN_CALLS == plain
        return
    with pytest.warns(RuntimeWarning, match="no kernel computes stride"):
        got = la.local_aggregate(xt, wt, stride=2, padding=pad, impl=impl)
    assert len(la.PLAIN_FALLBACKS) == 1
    assert (la.PLAIN_CALLS, la.LAUNCHES) == (plain + 1, launches)
    ref = la.local_aggregate(xt, wt, stride=2, padding=pad, impl="torch")
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


@pytest.mark.parametrize("impl", ["auto", "hopper"])
@pytest.mark.parametrize("taps", ["narrowed", "uncompiled"])
def test_embed_gn_outside_the_compiled_taps(impl, taps, monkeypatch):
    """The fused embed kernel is compiled for the K*K of ``_EMBED_GN_TAPS``.
    Outside them (K = 7 with the tuple narrowed, or K = 9, 81 taps)
    'hopper' raises and 'auto' takes the plain version, as the JAX
    package's embed op falls back to plain jnp where its plan does not
    apply, and warns once for the geometry."""
    _need_cuda()
    k = 7 if taps == "narrowed" else 9
    if taps == "narrowed":
        monkeypatch.setattr(la, "_EMBED_GN_TAPS", (9, 25))
    assert k * k not in la._EMBED_GN_TAPS
    gen = torch.Generator("cuda").manual_seed(2)
    n, c, cp, h, w = 2, 16, 8, 9, 8
    f = k * k * c // 8
    x = torch.randn(n, c, h, w, device="cuda", generator=gen)
    w_pre = torch.randn(n, cp, h, w, device="cuda", generator=gen)
    w2 = 0.1 * torch.randn(f, cp, device="cuda", generator=gen)
    vecs = [0.2 * torch.randn(f, device="cuda", generator=gen)
            for _ in range(3)]
    vecs[1] += 1.0
    la.reset_counts()
    with torch.no_grad():
        if impl == "hopper":
            with pytest.raises(NotImplementedError, match="compiled for"):
                la.local_aggregate_embed_gn(x, w_pre, w2, *vecs,
                                            kernel_size=k, impl=impl)
            assert (la.EMBED_GN_LAUNCHES, la.PLAIN_EMBED_GN_CALLS) == (0, 0)
            return
        with pytest.warns(RuntimeWarning, match=f"{k * k} taps"):
            got = la.local_aggregate_embed_gn(x, w_pre, w2, *vecs,
                                              kernel_size=k, impl=impl)
        assert (la.EMBED_GN_LAUNCHES, la.PLAIN_EMBED_GN_CALLS) == (0, 1)
        assert len(la.PLAIN_FALLBACKS) == 1
        ref = la.local_aggregate_embed_gn(x, w_pre, w2, *vecs, kernel_size=k,
                                          impl="torch")
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hopper_matches_plain_on_card(dtype):
    _need_cuda()
    dt = getattr(torch, dtype)
    x, w, s, b, pad = make_inputs(5, n=4, c=32, cw=8, hi=13, wi=11, heads=2,
                                  k=5, dil=2, affine=True)
    xt, wt, st, bt = (t.cuda() for t in to_port(x, w, s, b))
    xt, wt = xt.to(dt), wt.to(dt)
    launches = la.LAUNCHES
    got = la.local_aggregate(xt, wt, kernel_size=5, padding=pad, dilation=2,
                             w_scale=st, w_bias=bt)
    torch.cuda.synchronize()
    assert la.LAUNCHES == launches + 1
    ref = la.local_aggregate(xt, wt, kernel_size=5, padding=pad, dilation=2,
                             impl="torch", w_scale=st, w_bias=bt)
    if dt == torch.float32:
        rtol, atol = 1e-5, 1e-5          # summation order only
    else:
        # same bf16 inputs, f32 sums, one rounding: within 1 bf16 ulp
        rtol, atol = 8e-3, 1e-3 * float(ref.float().abs().max())
    torch.testing.assert_close(got.float(), ref.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("need", ["both", "dx", "dw"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hopper_bwd_matches_plain_on_card(dtype, need):
    """Both backward kernels against the plain backward on the card, and a
    call that needs one gradient launches that kernel alone."""
    _need_cuda()
    dt = getattr(torch, dtype)
    x, w, _, _, pad = make_inputs(5, n=4, c=32, cw=8, hi=13, wi=11, heads=2,
                                  k=5, dil=2)
    xt, wt = (t.cuda().to(dt) for t in to_port(x, w)[:2])
    dy = torch.randn(4, 64, 13, 11, device="cuda",
                     generator=torch.Generator("cuda").manual_seed(0)).to(dt)
    need_dx, need_dw = need in ("both", "dx"), need in ("both", "dw")
    la.reset_counts()
    got = la.local_aggregate_bwd_hopper(
        xt, wt, dy, kernel_size=(5, 5), dilation=(2, 2), padding=(pad, pad),
        need_dx=need_dx, need_dw=need_dw)
    torch.cuda.synchronize()
    assert la.BWD_LAUNCHES == {"dx": int(need_dx), "dw": int(need_dw)}
    xp = torch.nn.functional.pad(xt, (pad,) * 4)
    dxp, dw = la.local_aggregate_bwd_plain(xp, wt, dy, (5, 5), (2, 2))
    ref = (dxp[..., pad:pad + 13, pad:pad + 11], dw)
    for g, r, wanted in zip(got, ref, (need_dx, need_dw)):
        if not wanted:
            assert g is None
            continue
        if dt == torch.float32:
            rtol, atol = 1e-5, 1e-5      # summation order only
        else:
            # same bf16 inputs, f32 sums, one rounding: within 1 bf16 ulp
            rtol, atol = 8e-3, 1e-3 * float(r.float().abs().max())
        torch.testing.assert_close(g.float(), r.float(), rtol=rtol,
                                   atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hopper_affine_bwd_matches_plain_on_card(dtype):
    """The two affine backward kernels against the plain affine backward,
    through autograd, with one launch of each and no plain call."""
    _need_cuda()
    dt = getattr(torch, dtype)
    x, w, s, b, pad = make_inputs(5, n=4, c=32, cw=8, hi=13, wi=11, heads=2,
                                  k=5, dil=2, affine=True)
    xt, wt, st, bt = (t.cuda() for t in to_port(x, w, s, b))
    xt, wt = xt.to(dt), wt.to(dt)
    dy = torch.randn(4, 64, 13, 11, device="cuda",
                     generator=torch.Generator("cuda").manual_seed(0)).to(dt)
    grads = {}
    for impl in ("hopper", "torch"):
        leaves = [t.clone().requires_grad_() for t in (xt, wt, st, bt)]
        la.reset_counts()
        out = la.local_aggregate(leaves[0], leaves[1], kernel_size=5,
                                 padding=pad, dilation=2, impl=impl,
                                 w_scale=leaves[2], w_bias=leaves[3])
        grads[impl] = torch.autograd.grad(out, leaves, dy)
        torch.cuda.synchronize()
        if impl == "hopper":
            assert la.AFFINE_BWD_LAUNCHES == {"dx": 1, "dw": 1}
            assert la.PLAIN_BWD_CALLS == 0
    for i, (g, r) in enumerate(zip(*grads.values())):
        if i >= 2:
            # ds, db: f32 sums in another order, held as a whole
            assert float((g - r).abs().max()) <= 1e-5 * float(r.abs().max())
        elif dt == torch.float32:
            torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-5)
        else:
            # same bf16 inputs, f32 sums, one rounding: within 1 bf16 ulp
            torch.testing.assert_close(
                g.float(), r.float(), rtol=8e-3,
                atol=1e-3 * float(r.float().abs().max()))


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hopper_embed_gn_matches_plain_on_card(dtype, groups):
    _need_cuda()
    dt = getattr(torch, dtype)
    gen = torch.Generator("cuda").manual_seed(1)
    n, c, cp, h, w = 3, 96, 48, 13, 11
    f = 9 * c // 8
    x = torch.randn(n, c, h, w, device="cuda", generator=gen).to(dt)
    w_pre = torch.randn(n, cp, h, w, device="cuda", generator=gen).to(dt)
    w2 = 0.1 * torch.randn(f, cp // groups, device="cuda", generator=gen)
    vecs = [0.2 * torch.randn(f, device="cuda", generator=gen)
            for _ in range(3)]
    vecs[1] += 1.0
    la.reset_counts()
    with torch.no_grad():
        got = la.local_aggregate_embed_gn(x, w_pre, w2, *vecs, groups=groups)
        torch.cuda.synchronize()
        assert (la.EMBED_GN_LAUNCHES, la.PLAIN_EMBED_GN_CALLS) == (1, 0)
        ref = la.local_aggregate_embed_gn(x, w_pre, w2, *vecs, groups=groups,
                                          impl="torch")
    scale = float(ref.float().abs().max())
    if dt == torch.float32:
        rtol, atol = 1e-5, 1e-5 * scale      # summation order only
    else:
        # the output's rounding, and a w_raw at a rounding boundary
        rtol, atol = 8e-3, 4e-3 * scale
    torch.testing.assert_close(got.float(), ref.float(), rtol=rtol,
                               atol=atol)


def _mix_on_card(seed, dt, merged, n=4, c=32, cw=8, hi=13, wi=11, heads=2):
    """CUDA x, w1, w2 (w1 the packed weight and w2 None when ``merged``)
    and a cotangent dy, from ``make_mix_inputs``."""
    x, w1, w2 = make_mix_inputs(seed, n=n, c=c, cw=cw, hi=hi, wi=wi,
                                heads=heads)
    xt, w1t = (t.cuda().to(dt) for t in to_port(x, w1)[:2])
    w2t = to_port(x, w2)[1].cuda().to(dt)
    if merged:
        w1t, w2t = torch.cat([w1t, w2t], dim=3), None
    dy = torch.randn(n, 2 * heads * c, hi, wi, device="cuda",
                     generator=torch.Generator("cuda").manual_seed(seed)
                     ).to(dt)
    return xt, w1t, w2t, dy


def _close(got, ref, dt):
    if dt == torch.float32:
        rtol, atol = 1e-5, 1e-5          # summation order only
    else:
        # same bf16 inputs, f32 sums, one rounding: within 1 bf16 ulp
        rtol, atol = 8e-3, 1e-3 * float(ref.float().abs().max())
    torch.testing.assert_close(got.float(), ref.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("merged", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mix_kernels_match_plain_on_card(dtype, merged):
    """The three mix kernels against the plain mix at heads 2 with Cw
    dividing C four times, on a 13x11 map, the weights separate and packed:
    the forward, dx (both halves in one f32 sum) and dw, one launch each."""
    _need_cuda()
    dt = getattr(torch, dtype)
    x, w1, w2, dy = _mix_on_card(3, dt, merged)
    la.reset_counts()
    out = la.local_aggregate_mix_hopper(x, w1, w2)
    grads = la.local_aggregate_mix_bwd_hopper(x, w1, w2, dy)
    torch.cuda.synchronize()
    assert la.MIX_LAUNCHES == {"fwd": 1, "dx": 1, "dw": 1}
    assert la.PLAIN_MIX_CALLS == 0
    _close(out, la.local_aggregate_mix_plain(x, w1, w2), dt)
    ref = la.local_aggregate_mix_bwd_plain(x, w1, w2, dy)
    assert (grads[2] is None) == merged
    for g, r in zip(grads, ref):
        if r is not None:
            _close(g, r, dt)


@pytest.mark.parametrize("merged", [False, True])
def test_mix_grad_goes_through_the_kernels(merged):
    """A gradient through ``local_aggregate_mix`` (or ``_merge``) on CUDA
    tensors is one launch of each mix kernel and no plain call."""
    _need_cuda()
    x, w1, w2, dy = _mix_on_card(4, torch.float32, merged)
    leaves = [t.requires_grad_() for t in (x, w1, w2) if t is not None]
    la.reset_counts()
    if merged:
        out = la.local_aggregate_mix_merge(*leaves)
    else:
        out = la.local_aggregate_mix(*leaves)
    out.backward(dy)
    torch.cuda.synchronize()
    assert la.MIX_LAUNCHES == {"fwd": 1, "dx": 1, "dw": 1}
    assert (la.PLAIN_MIX_CALLS, la.LAUNCHES) == (0, 0)
    assert all(t.grad.shape == t.shape for t in leaves)


def test_dilated_goes_through_the_aggregation_kernels():
    """``local_aggregate_dilated`` with dilations 1 and 2: one forward and
    one dx and dw launch per distinct dilation, no plain call, and the
    plain path's values and gradients (f32, rtol/atol 1e-5)."""
    _need_cuda()
    x, w, _, _, _ = make_inputs(6, n=2, c=16, cw=4, hi=9, wi=10)
    grads = {}
    for impl in ("hopper", "torch"):
        xt, wt = (t.cuda().requires_grad_() for t in to_port(x, w)[:2])
        la.reset_counts()
        out = la.local_aggregate_dilated(xt, wt, (1, 2, 2, 1), impl=impl)
        out.square().sum().backward()
        torch.cuda.synchronize()
        grads[impl] = (out.detach(), xt.grad, wt.grad)
        if impl == "hopper":
            assert (la.LAUNCHES, la.BWD_LAUNCHES) == (2, {"dx": 2, "dw": 2})
            assert (la.PLAIN_CALLS, la.PLAIN_BWD_CALLS) == (0, 0)
    for g, r in zip(*grads.values()):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-5)


# (N, C, Cw, H, W, heads, K, dilation): the tiling edges of the forward and
# dx kernels.  K = 3 at dilation 1 (and pad 1, one head) runs the K = 3
# instantiation: a map smaller than one row tile, a height that is not a
# multiple of the row tile, an odd width with Cw not a multiple of the
# vector width, N = 1 at the largest main-path map.  The rest run the
# general one.
TILING_EDGES = {
    "3x3": (2, 64, 8, 3, 3, 1, 3, 1),
    "57x57": (2, 64, 8, 57, 57, 1, 3, 1),
    "13x11_cw6": (4, 48, 6, 13, 11, 1, 3, 1),
    "n1_56x56": (1, 64, 8, 56, 56, 1, 3, 1),
    "heads2_k5_dil2": (3, 32, 8, 13, 11, 2, 5, 2),
    "heads2_k7_dil2": (2, 24, 6, 15, 9, 2, 7, 2),
}


def _edge_tensors(geometry, dt, affine, seed):
    """CUDA x, w, s, b (None without the affine) and dy of one geometry."""
    n, c, cw, h, w, heads, k, dil = geometry
    gen = torch.Generator("cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    x, wt = randn(n, c, h, w).to(dt), randn(n, heads, cw, k * k, h, w).to(dt)
    s = b = None
    if affine:
        s, b = 1.0 + 0.5 * randn(n, heads, cw, k * k), 0.5 * randn(
            n, heads, cw, k * k)
    return x, wt, s, b, randn(n, heads * c, h, w).to(dt)


def _tolerance(dt, ref):
    if dt == torch.float32:
        return 1e-5, 1e-5                # summation order only
    # the same 16-bit inputs, f32 sums, one rounding: within 1 ulp of the
    # reference (2^-8 relative in bf16, 2^-11 in f16)
    rtol = 8e-3 if dt == torch.bfloat16 else 1e-3
    return rtol, 1e-3 * float(ref.float().abs().max())


@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("edge", sorted(TILING_EDGES))
def test_fwd_dx_tiling_edges_match_plain_on_card(edge, dtype, affine):
    """The forward and dx kernels (each instantiation, with and without the
    affine) against their plain versions at the edges of their tiling, one
    launch each and no plain call, and the instantiation each ran."""
    _need_cuda()
    dt = getattr(torch, dtype)
    geometry = TILING_EDGES[edge]
    k, dil = geometry[6:]
    pad = (dil * (k - 1) + 1) // 2
    x, wt, s, b, dy = _edge_tensors(geometry, dt, affine, seed=len(edge))
    geo = dict(kernel_size=(k, k), dilation=(dil, dil), padding=(pad, pad))
    la.reset_counts()
    out = la.local_aggregate_hopper(x, wt, s, b, **geo)
    if affine:
        dx = la.local_aggregate_bwd_affine_hopper(x, wt, s, b, dy, **geo,
                                                  need_dw=False)[0]
    else:
        dx = la.local_aggregate_bwd_hopper(x, wt, dy, **geo, need_dw=False)[0]
    torch.cuda.synchronize()
    assert la.LAUNCHES == 1
    assert (la.AFFINE_BWD_LAUNCHES if affine else la.BWD_LAUNCHES)["dx"] == 1
    assert (la.PLAIN_CALLS, la.PLAIN_BWD_CALLS) == (0, 0)
    c, cw, heads = geometry[1], geometry[2], geometry[5]
    # K = 7 at dilation 1, one head and at most 8 groups: the k7 tiles
    k7 = (k, dil, heads) == (7, 1, 1) and c // cw <= 8
    assert la.kernel_route("fwd", x, wt, **geo) == (
        "k3" if (k, dil) == (3, 1) else "k7" if k7 else "general")
    assert la.kernel_route("dx", x, wt, **geo) == (
        "k3" if (k, dil, heads) == (3, 1, 1) else "k7" if k7 else "general")
    xp = torch.nn.functional.pad(x, (pad,) * 4)
    ref = la.local_aggregate_plain(xp, wt, (k, k), (1, 1), (dil, dil), s, b)
    torch.testing.assert_close(out.float(), ref.float(),
                               **dict(zip(("rtol", "atol"),
                                          _tolerance(dt, ref))))
    if affine:
        ref_dx = la.local_aggregate_bwd_affine_plain(
            xp, wt, s, b, dy, (k, k), (dil, dil), need_dw=False)[0]
    else:
        ref_dx = la.local_aggregate_bwd_plain(xp, wt, dy, (k, k), (dil, dil),
                                              need_dw=False)[0]
    ref_dx = ref_dx[..., pad:pad + x.shape[2], pad:pad + x.shape[3]]
    torch.testing.assert_close(dx.float(), ref_dx.float(),
                               **dict(zip(("rtol", "atol"),
                                          _tolerance(dt, ref_dx))))


@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("k", [3, 5])
def test_fwd_dx_on_a_prepadded_input_match_plain_on_card(k, affine):
    """Hi != Ho: the reflect path hands both kernels a pre-padded x with pad
    0.  The forward and dx kernels against their plain versions there."""
    _need_cuda()
    n, c, cw, h, w = 2, 32, 8, 14, 13
    pad = (k - 1) // 2
    x, wt, s, b, dy = _edge_tensors((n, c, cw, h, w, 1, k, 1), torch.bfloat16,
                                    affine, seed=k)
    xp = torch.nn.functional.pad(x.float(), (pad,) * 4,
                                 mode="reflect").to(x.dtype)
    geo = dict(kernel_size=(k, k), dilation=(1, 1), padding=(0, 0))
    out = la.local_aggregate_hopper(xp, wt, s, b, **geo)
    if affine:
        dxp = la.local_aggregate_bwd_affine_hopper(xp, wt, s, b, dy, **geo,
                                                   need_dw=False)[0]
        ref_dx = la.local_aggregate_bwd_affine_plain(
            xp, wt, s, b, dy, (k, k), (1, 1), need_dw=False)[0]
    else:
        dxp = la.local_aggregate_bwd_hopper(xp, wt, dy, **geo,
                                            need_dw=False)[0]
        ref_dx = la.local_aggregate_bwd_plain(xp, wt, dy, (k, k), (1, 1),
                                              need_dw=False)[0]
    torch.cuda.synchronize()
    assert dxp.shape == xp.shape and xp.shape[2:] != out.shape[2:]
    ref = la.local_aggregate_plain(xp, wt, (k, k), (1, 1), (1, 1), s, b)
    for got, want in ((out, ref), (dxp, ref_dx)):
        torch.testing.assert_close(
            got.float(), want.float(),
            **dict(zip(("rtol", "atol"), _tolerance(torch.bfloat16, want))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("edge", sorted(TILING_EDGES))
def test_dw_tiling_edges_match_plain_on_card(edge, dtype):
    """The dw kernel's halo tiles against the plain backward at the edges
    of their tiling (the forward's), one launch and no plain call, and the
    route each took: ``k3`` at K = 3, dilation 1 (any heads); ``k7`` at
    K = 7, dilation 1, one head and at most 8 groups; else ``general``."""
    _need_cuda()
    dt = getattr(torch, dtype)
    geometry = TILING_EDGES[edge]
    k, dil = geometry[6:]
    pad = (dil * (k - 1) + 1) // 2
    x, wt, _, _, dy = _edge_tensors(geometry, dt, False, seed=len(edge) + 1)
    geo = dict(kernel_size=(k, k), dilation=(dil, dil), padding=(pad, pad))
    la.reset_counts()
    dw = la.local_aggregate_bwd_hopper(x, wt, dy, **geo, need_dx=False)[1]
    torch.cuda.synchronize()
    assert la.BWD_LAUNCHES == {"dx": 0, "dw": 1}
    assert la.PLAIN_BWD_CALLS == 0
    c, cw, heads = geometry[1], geometry[2], geometry[5]
    k7 = (k, dil, heads) == (7, 1, 1) and c // cw <= 8
    assert la.kernel_route("dw", x, wt, **geo) == (
        "k3" if (k, dil) == (3, 1) else "k7" if k7 else "general")
    xp = torch.nn.functional.pad(x, (pad,) * 4)
    ref = la.local_aggregate_bwd_plain(xp, wt, dy, (k, k), (dil, dil),
                                       need_dx=False)[1]
    torch.testing.assert_close(dw.float(), ref.float(),
                               **dict(zip(("rtol", "atol"),
                                          _tolerance(dt, ref))))


@pytest.mark.parametrize("k", [3, 5])
def test_dw_on_a_prepadded_input_matches_plain_on_card(k):
    """Hi != Ho: the reflect path hands dw a pre-padded x with pad 0 (the
    general route).  dw against the plain backward there."""
    _need_cuda()
    n, c, cw, h, w = 2, 32, 8, 14, 13
    pad = (k - 1) // 2
    x, wt, _, _, dy = _edge_tensors((n, c, cw, h, w, 1, k, 1),
                                    torch.bfloat16, False, seed=k + 10)
    xp = torch.nn.functional.pad(x.float(), (pad,) * 4,
                                 mode="reflect").to(x.dtype)
    geo = dict(kernel_size=(k, k), dilation=(1, 1), padding=(0, 0))
    dw = la.local_aggregate_bwd_hopper(xp, wt, dy, **geo, need_dx=False)[1]
    torch.cuda.synchronize()
    assert la.kernel_route("dw", xp, wt, **geo) == "general"
    ref = la.local_aggregate_bwd_plain(xp, wt, dy, (k, k), (1, 1),
                                       need_dx=False)[1]
    torch.testing.assert_close(
        dw.float(), ref.float(),
        **dict(zip(("rtol", "atol"), _tolerance(torch.bfloat16, ref))))


def _affine_dw_on_card(x, wt, s, dy, geo):
    """dw, ds and db from one launch of the affine dw kernels (and none of
    dx), with no plain call.  s stands in for the bias too, which enters
    none of the three."""
    la.reset_counts()
    got = la.local_aggregate_bwd_affine_hopper(x, wt, s, s, dy, **geo,
                                               need_dx=False)
    torch.cuda.synchronize()
    assert la.AFFINE_BWD_LAUNCHES == {"dx": 0, "dw": 1}
    assert la.PLAIN_BWD_CALLS == 0
    assert got[0] is None
    return got[1:]


def _check_affine_dw(got, xp, wt, s, dy, k, dil, dt):
    """dw at ``_tolerance``; ds and db, f32 sums over a plane in another
    order, as a whole at 1e-5 of their largest entry."""
    ref = la.local_aggregate_bwd_affine_plain(xp, wt, s, s, dy, (k, k),
                                              (dil, dil), need_dx=False)[1:]
    torch.testing.assert_close(got[0].float(), ref[0].float(),
                               **dict(zip(("rtol", "atol"),
                                          _tolerance(dt, ref[0]))))
    for g, r in zip(got[1:], ref[1:]):
        assert g.dtype == torch.float32
        assert float((g - r).abs().max()) <= 1e-5 * float(r.abs().max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("edge", sorted(TILING_EDGES))
def test_dw_affine_tiling_edges_match_plain_on_card(edge, dtype):
    """The affine dw's halo tiles (dw, ds and db in one pass) against the
    plain affine backward at the edges of their tiling (dw's), one launch
    and no plain call, and the route each took: ``k3`` at K = 3, dilation
    1 (any heads), else ``general``."""
    _need_cuda()
    dt = getattr(torch, dtype)
    geometry = TILING_EDGES[edge]
    k, dil = geometry[6:]
    pad = (dil * (k - 1) + 1) // 2
    x, wt, s, _, dy = _edge_tensors(geometry, dt, True, seed=len(edge) + 2)
    geo = dict(kernel_size=(k, k), dilation=(dil, dil), padding=(pad, pad))
    got = _affine_dw_on_card(x, wt, s, dy, geo)
    assert la.kernel_route("dw_affine", x, wt, **geo) == (
        "k3" if (k, dil) == (3, 1) else "general")
    xp = torch.nn.functional.pad(x, (pad,) * 4)
    _check_affine_dw(got, xp, wt, s, dy, k, dil, dt)


@pytest.mark.parametrize("k", [3, 5])
def test_dw_affine_on_a_prepadded_input_matches_plain_on_card(k):
    """Hi != Ho: the reflect path hands the affine dw a pre-padded x with
    pad 0 (the general route).  dw, ds and db against the plain affine
    backward there."""
    _need_cuda()
    n, c, cw, h, w = 2, 32, 8, 14, 13
    pad = (k - 1) // 2
    x, wt, s, _, dy = _edge_tensors((n, c, cw, h, w, 1, k, 1),
                                    torch.bfloat16, True, seed=k + 20)
    xp = torch.nn.functional.pad(x.float(), (pad,) * 4,
                                 mode="reflect").to(x.dtype)
    geo = dict(kernel_size=(k, k), dilation=(1, 1), padding=(0, 0))
    got = _affine_dw_on_card(xp, wt, s, dy, geo)
    assert la.kernel_route("dw_affine", xp, wt, **geo) == "general"
    _check_affine_dw(got, xp, wt, s, dy, k, 1, torch.bfloat16)


# (N, C, Cw, H, W): maps at which a plane of the affine dw spans several
# row tiles (56x56: 4 tiles of 18 rows, the last of 2; 57x57: 4 of 17, the
# last of 6), so ds and db add the tiles' partial sums in a second kernel, and
# 7x7, where a block holds several whole planes (14 thread items each) and
# its warps span planes
AFFINE_SUM_MAPS = {
    "56x56": (2, 64, 8, 56, 56),
    "57x57_cw6": (2, 48, 6, 57, 57),
    "7x7": (4, 128, 16, 7, 7),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("edge", sorted(AFFINE_SUM_MAPS))
def test_dw_affine_sums_across_tiles_match_plain_on_card(edge, dtype):
    """dw, ds and db where a plane spans several row tiles (a workspace of
    partial sums and the second kernel) or a block several planes, against
    the plain affine backward, on the ``k3`` route."""
    _need_cuda()
    dt = getattr(torch, dtype)
    n, c, cw, h, w = AFFINE_SUM_MAPS[edge]
    x, wt, s, _, dy = _edge_tensors((n, c, cw, h, w, 1, 3, 1), dt, True,
                                    seed=len(edge) + 30)
    geo = dict(kernel_size=(3, 3), dilation=(1, 1), padding=(1, 1))
    assert la.kernel_route("dw_affine", x, wt, **geo) == "k3"
    part = la.dw_affine_workspace_bytes(x, wt, **geo)
    assert part == (4 * n * cw * 9 * 8 if h > 28 else 0)
    got = _affine_dw_on_card(x, wt, s, dy, geo)
    xp = torch.nn.functional.pad(x, (1,) * 4)
    _check_affine_dw(got, xp, wt, s, dy, 3, 1, dt)


@pytest.mark.parametrize("edge", sorted(AFFINE_SUM_MAPS))
def test_dw_affine_is_deterministic_on_card(edge):
    """Two launches give the same bits of dw, ds and db: every sum, across
    a plane's row tiles too, is taken in a fixed order, with no atomics."""
    _need_cuda()
    n, c, cw, h, w = AFFINE_SUM_MAPS[edge]
    x, wt, s, _, dy = _edge_tensors((n, c, cw, h, w, 1, 3, 1),
                                    torch.bfloat16, True, seed=len(edge) + 40)
    geo = dict(kernel_size=(3, 3), dilation=(1, 1), padding=(1, 1))
    assert la.kernel_route("dw_affine", x, wt, **geo) == "k3"
    first = _affine_dw_on_card(x, wt, s, dy, geo)
    second = _affine_dw_on_card(x, wt, s, dy, geo)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# (N, C, Cw, H, W, heads, K, dilation, dtype): geometries the halo tiles do
# not take, which the forward, dx and dw run on their pointwise route: a
# row of more than 512 thread items in the general instantiation (K = 5,
# Wo = 513) and at K = 3 (Wo = 2049, 513 items of 4), K = 9 beyond the
# general instantiation's 7, and a halo tile beyond a block's shared memory
# (f32, K = 7 at dilation 8 on 16x256: 49 staged rows of 304 elements, four
# stages, 238 KB of the 227 KB a block may have)
BEYOND_TILES = {
    "w513_k5": (1, 16, 8, 3, 513, 1, 5, 1, "bfloat16"),
    "w513_k5_f32": (1, 16, 8, 3, 513, 1, 5, 1, "float32"),
    "w2049_k3": (1, 16, 8, 2, 2049, 1, 3, 1, "bfloat16"),
    "w2049_k3_f32": (1, 16, 8, 2, 2049, 1, 3, 1, "float32"),
    "k9": (2, 16, 4, 13, 11, 1, 9, 1, "bfloat16"),
    "k9_heads2_f32": (2, 16, 4, 13, 11, 2, 9, 1, "float32"),
    "k7_dil8_f32": (1, 16, 8, 16, 256, 1, 7, 8, "float32"),
}


@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("edge", sorted(BEYOND_TILES))
def test_geometries_beyond_the_tiles_match_plain_on_card(edge, affine):
    """The forward, dx and dw (with the affine: dw, ds and db) against their
    plain versions at the geometries the halo tiles do not take, one launch
    of each and no plain call; the forward, dx and dw launchers take the
    pointwise route there."""
    _need_cuda()
    *geometry, dtype = BEYOND_TILES[edge]
    dt = getattr(torch, dtype)
    k, dil = geometry[6:]
    pad = (dil * (k - 1) + 1) // 2
    x, wt, s, b, dy = _edge_tensors(geometry, dt, affine, seed=len(edge))
    geo = dict(kernel_size=(k, k), dilation=(dil, dil), padding=(pad, pad))
    for kernel in ("fwd", "dx", "dw", "dw_affine"):
        assert la.kernel_route(kernel, x, wt, **geo) == "pointwise", kernel
    la.reset_counts()
    out = la.local_aggregate_hopper(x, wt, s, b, **geo)
    if affine:
        got = la.local_aggregate_bwd_affine_hopper(x, wt, s, b, dy, **geo)
    else:
        got = la.local_aggregate_bwd_hopper(x, wt, dy, **geo)
    torch.cuda.synchronize()
    assert la.LAUNCHES == 1
    assert (la.AFFINE_BWD_LAUNCHES if affine else la.BWD_LAUNCHES) == {
        "dx": 1, "dw": 1}
    assert (la.PLAIN_CALLS, la.PLAIN_BWD_CALLS) == (0, 0)
    xp = torch.nn.functional.pad(x, (pad,) * 4)
    ref_out = la.local_aggregate_plain(xp, wt, (k, k), (1, 1), (dil, dil), s,
                                       b)
    if affine:
        ref = la.local_aggregate_bwd_affine_plain(xp, wt, s, b, dy, (k, k),
                                                  (dil, dil))
    else:
        ref = la.local_aggregate_bwd_plain(xp, wt, dy, (k, k), (dil, dil))
    ref = (ref[0][..., pad:pad + x.shape[2], pad:pad + x.shape[3]],) + ref[1:]
    for g, r in ((out, ref_out), *zip(got[:2], ref[:2])):
        torch.testing.assert_close(g.float(), r.float(),
                                   **dict(zip(("rtol", "atol"),
                                              _tolerance(dt, r))))
    for g, r in zip(got[2:], ref[2:]):
        # ds, db: f32 sums in another order, held as a whole
        assert float((g - r).abs().max()) <= 1e-5 * float(r.abs().max())


# ---- the fused embed op on the forward's halo tiles -------------------------

def _embed_tensors(geometry, dt, groups, seed):
    """CUDA x, w_pre, w2, b2, gamma, beta of one TILING_EDGES geometry (Cw
    and Cp = C/2 over all groups, as the models call the op) and its
    geometry arguments."""
    n, c, cw, h, w, _, k, dil = geometry
    gen = torch.Generator("cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    f, cp = cw * k * k, c // 2
    x = randn(n, c, h, w).to(dt)
    w_pre = randn(n, cp, h, w).relu().to(dt)
    w2 = (randn(f, cp // groups) * (2.0 / f) ** 0.5).to(dt)
    b2, gamma, beta = 0.1 * randn(f), 1.0 + 0.2 * randn(f), 0.2 * randn(f)
    pad = (dil * (k - 1) + 1) // 2
    geo = dict(kernel_size=(k, k), dilation=(dil, dil), padding=(pad, pad),
               groups=groups)
    return (x, w_pre, w2, b2, gamma, beta), geo


def _embed_kernels(args, geo):
    """The op's output by one wrapper call on the card, and the names of the
    device kernels the call ran (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    la.reset_counts()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = la.local_aggregate_embed_gn_hopper(*args, **geo)
        torch.cuda.synchronize()
    assert (la.EMBED_GN_LAUNCHES, la.PLAIN_EMBED_GN_CALLS) == (1, 0)
    names = {e.key for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA}
    return out, names


def _check_embed(got, args, geo, dt):
    with torch.no_grad():
        ref = la.local_aggregate_embed_gn_plain(*args, **geo)
    scale = float(ref.float().abs().max())
    if dt == torch.float32:
        rtol, atol = 1e-5, 1e-5 * scale      # summation order only
    else:
        # the output's rounding, and a w_raw at a rounding boundary
        rtol, atol = 8e-3, 4e-3 * scale
    torch.testing.assert_close(got.float(), ref.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("edge", sorted(TILING_EDGES))
def test_embed_gn_tiling_edges_match_plain_on_card(edge, dtype, groups):
    """The fused embed op against its plain version at the edges of the
    forward's halo tiles, which its aggregation kernel runs on: the ``k3``
    route at K = 3, ``general`` at K = 5 and 7 with dilation 2; one launch
    and no plain call."""
    _need_cuda()
    dt = getattr(torch, dtype)
    geometry = TILING_EDGES[edge]
    args, geo = _embed_tensors(geometry, dt, groups, seed=len(edge) + 50)
    k = geometry[6]
    assert la.embed_gn_route(*args[:3], **geo) == (
        "k3" if k == 3 else "general")
    got, _ = _embed_kernels(args, geo)
    _check_embed(got, args, geo, dt)


# (N, C, Cw, H, W) at K = 3: whole planes in a block (the block takes their
# statistics, no statistics launch) or a plane over several row tiles (the
# statistics kernel first, its partial sums in a workspace)
EMBED_PLANES = {
    "7x7_whole": (4, 512, 64, 7, 7, True),
    "28x28_whole": (2, 128, 16, 28, 28, True),
    "56x56_split": (2, 64, 8, 56, 56, False),
    "57x57_split": (2, 48, 6, 57, 57, False),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(EMBED_PLANES))
def test_embed_gn_statistics_launch_only_for_split_planes_on_card(case,
                                                                  dtype):
    """Where a block holds whole planes no statistics kernel is launched
    and no workspace is asked for; where a plane spans several row tiles
    the row tiles' statistics kernel (``embed_gn_stats_rows``, not the
    pointwise route's ``embed_gn_stats``) runs first.  Both on the ``k3``
    route and equal to the plain version."""
    _need_cuda()
    dt = getattr(torch, dtype)
    n, c, cw, h, w, whole = EMBED_PLANES[case]
    args, geo = _embed_tensors((n, c, cw, h, w, 1, 3, 1), dt, 1,
                               seed=len(case) + 60)
    assert la.embed_gn_route(*args[:3], **geo) == "k3"
    workspace = la.embed_gn_workspace_bytes(*args[:3], **geo)
    assert (workspace == 0) == whole
    got, names = _embed_kernels(args, geo)
    assert any("embed_gn_agg<" in name for name in names), names
    assert any("embed_gn_stats_rows<" in name for name in names) == (
        not whole)
    assert not any("embed_gn_stats<" in name for name in names), names
    _check_embed(got, args, geo, dt)


@pytest.mark.parametrize("case", sorted(EMBED_PLANES))
def test_embed_gn_is_deterministic_on_card(case):
    """Two launches give the same bits: the product, the statistics (the
    block's and the statistics kernel's) and the taps are each summed in a
    fixed order, with no atomics."""
    _need_cuda()
    n, c, cw, h, w, _ = EMBED_PLANES[case]
    args, geo = _embed_tensors((n, c, cw, h, w, 1, 3, 1), torch.bfloat16, 1,
                               seed=len(case) + 70)
    first, _ = _embed_kernels(args, geo)
    second, _ = _embed_kernels(args, geo)
    assert torch.equal(first, second)


def test_embed_gn_beyond_the_tiles_takes_pointwise_on_card():
    """K = 3 on 2x2049 (a row of 513 thread items) is beyond the tiles: the
    pointwise route, the statistics kernel and ``embed_gn_agg_pointwise``,
    equal to the plain version."""
    _need_cuda()
    args, geo = _embed_tensors((1, 16, 8, 2, 2049, 1, 3, 1), torch.bfloat16,
                               1, seed=80)
    assert la.embed_gn_route(*args[:3], **geo) == "pointwise"
    assert la.embed_gn_workspace_bytes(*args[:3], **geo) > 0
    got, names = _embed_kernels(args, geo)
    assert any("embed_gn_agg_pointwise<" in name for name in names), names
    assert any("embed_gn_stats<" in name for name in names)
    _check_embed(got, args, geo, torch.bfloat16)


# (N, C, Cp, Cw, H, W, K, groups), C, Cp and Cw over all groups: planes over
# several row tiles of the aggregation, where the statistics pass runs in
# row tiles of its own: cotnet50's 56x56 widths, 57x57 (a width no multiple
# of its items), two groups, a Cp no multiple of its 16-channel stages, and
# the general route at K = 5 and 7
EMBED_STATS_SPLITS = {
    "56x56": (2, 64, 32, 8, 56, 56, 3, 1),
    "57x57": (2, 48, 24, 6, 57, 57, 3, 1),
    "56x56_groups2": (2, 96, 48, 12, 56, 56, 3, 2),
    "40x40_cp20": (2, 32, 20, 4, 40, 40, 3, 1),
    "24x23_k5": (1, 16, 24, 4, 24, 23, 5, 1),
    "22x25_k7": (1, 16, 8, 2, 22, 25, 7, 1),
}


def _stats_tensors(geometry, dt, integer, seed):
    """CUDA x, w_pre, w2, b2, gamma, beta of an EMBED_STATS_SPLITS (or
    EMBED_STATS_FALLBACK) geometry and its geometry arguments; ``integer``: w_pre in {0, 1, 2}, w2 in
    {-1, 0, 1} at every fourth cp (0 elsewhere) and b2 in {-2, ..., 2}, so
    that every w_raw and every sum of the statistics is an integer below
    2^24, exact in f32 in any order."""
    n, c, cp, cw, h, w, k, groups = geometry
    gen = torch.Generator("cuda").manual_seed(seed)
    f, cpg = cw * k * k // groups, cp // groups
    x = torch.randn(n, c, h, w, device="cuda", generator=gen).to(dt)
    if integer:
        w_pre = torch.randint(0, 3, (n, cp, h, w), device="cuda",
                              generator=gen).to(dt)
        w2 = (torch.randint(-1, 2, (groups * f, cpg), device="cuda",
                            generator=gen)
              * (torch.arange(cpg, device="cuda") % 4 == 0)).to(dt)
        b2 = torch.randint(-2, 3, (groups * f,), device="cuda",
                           generator=gen).float()
        assert k * k * h * w * (2 * ((cpg + 3) // 4) + 2) ** 2 < 2 ** 24
    else:
        w_pre = torch.randn(n, cp, h, w, device="cuda",
                            generator=gen).relu().to(dt)
        w2 = (torch.randn(groups * f, cpg, device="cuda", generator=gen)
              * (2.0 / f) ** 0.5).to(dt)
        b2 = 0.1 * torch.randn(groups * f, device="cuda", generator=gen)
    gamma = 1.0 + 0.2 * torch.randn(groups * f, device="cuda", generator=gen)
    beta = 0.2 * torch.randn(groups * f, device="cuda", generator=gen)
    geo = dict(kernel_size=(k, k), dilation=(1, 1), padding=(k // 2,) * 2,
               groups=groups)
    return (x, w_pre, w2, b2, gamma, beta), geo


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("case", sorted(EMBED_STATS_SPLITS))
def test_embed_gn_statistics_totals_match_pointwise_on_card(case, dtype):
    """The row tiles' statistics pass against the pointwise route's on the
    same inputs: each plane's totals of w_raw and w_raw^2 within 1e-6 of
    the largest (f32 sums in another order), equal on integer inputs; the
    fused op, which reads the row tiles' partial sums, runs that kernel and
    equals its plain version."""
    _need_cuda()
    dt = getattr(torch, dtype)
    for integer in (False, True):
        args, geo = _stats_tensors(EMBED_STATS_SPLITS[case], dt, integer,
                                   seed=len(case) + 90)
        x, w_pre, w2, b2 = args[:4]
        assert la.embed_gn_route(x, w_pre, w2, **geo) == (
            "k3" if geo["kernel_size"] == (3, 3) else "general")
        tiled = la.embed_gn_statistics(x, w_pre, w2, b2, **geo)
        ref = la.embed_gn_statistics(x, w_pre, w2, b2, **geo, pointwise=True)
        assert tiled is not None and ref.shape[:2] == tiled.shape[:2]
        assert la.embed_gn_workspace_bytes(x, w_pre, w2, **geo) == (
            tiled.numel() * 4)
        got, want = tiled.double().sum(2), ref.double().sum(2)
        if integer:
            assert torch.equal(got, want)
            continue
        for i in (0, 1):
            assert float((got[..., i] - want[..., i]).abs().max()) <= (
                1e-6 * float(want[..., i].abs().max()))
        out, names = _embed_kernels(args, geo)
        assert any("embed_gn_stats_rows<" in name for name in names), names
        _check_embed(out, args, geo, dt)


# (N, C, Cp, Cw, H, W, K, groups) as EMBED_STATS_SPLITS: planes over several
# row tiles of the aggregation where one channel's w2 does not fit a block
# of the row tiles' statistics kernel (66 bytes a cp at K = 3 in bf16, 306
# at K = 7, over 227 KB), so that the tiled routes take the pointwise
# route's statistics kernel and its 32-pixel partial sums
EMBED_STATS_FALLBACK = {
    "56x56_cp4096": (2, 64, 4096, 8, 56, 56, 3, 1),
    "22x25_k7_cp1024": (1, 16, 1024, 2, 22, 25, 7, 1),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(EMBED_STATS_FALLBACK))
def test_embed_gn_statistics_fallback_on_tiled_routes_on_card(case, dtype):
    """Where the row tiles' statistics kernel cannot hold a channel's w2,
    a tiled route runs ``embed_gn_stats`` and ``embed_gn_agg``: the
    workspace is the 32-pixel tiles' partial sums, the same bits as the
    pointwise route's statistics pass, and the op equals its plain
    version."""
    _need_cuda()
    dt = getattr(torch, dtype)
    n, _, _, cw, h, w, k, _ = EMBED_STATS_FALLBACK[case]
    args, geo = _stats_tensors(EMBED_STATS_FALLBACK[case], dt, False,
                               seed=len(case) + 100)
    x, w_pre, w2, b2 = args[:4]
    assert la.embed_gn_route(x, w_pre, w2, **geo) == (
        "k3" if k == 3 else "general")
    assert la.embed_gn_workspace_bytes(x, w_pre, w2, **geo) == (
        8 * n * cw * -(-h * w // 32))
    tiled = la.embed_gn_statistics(x, w_pre, w2, b2, **geo)
    ref = la.embed_gn_statistics(x, w_pre, w2, b2, **geo, pointwise=True)
    assert torch.equal(tiled, ref)
    out, names = _embed_kernels(args, geo)
    assert any("embed_gn_stats<" in name for name in names), names
    assert any("embed_gn_agg<" in name for name in names), names
    assert not any("embed_gn_stats_rows<" in name
                   or "embed_gn_agg_pointwise<" in name
                   for name in names), names
    _check_embed(out, args, geo, dt)


# ---- the mix's forward, dx and dw on halo tiles -----------------------------

# (N, C, Cw, H, W): the TILING_EDGES geometries that the mix takes (its 3x3
# and 5x5 at dilation 1, SAME padding), and maps smaller than the 5x5 window
# and one weight channel a group (C = Cw)
MIX_EDGES = {edge: TILING_EDGES[edge][:5]
             for edge in ("3x3", "57x57", "13x11_cw6", "n1_56x56")}
MIX_SMALL_MAPS = {
    "1x1": (2, 16, 8, 1, 1),
    "2x3": (2, 16, 8, 2, 3),
    "c_eq_cw": (2, 8, 8, 9, 7),
}


def _check_mix_bwd_tiles(geometry, dt, heads, merged, seed):
    """dx and dw on the tiles route against the plain mix backward at the
    chip_smoke gates, each launched twice for the same bits, and dw1 and
    dw2 bit for bit the pointwise route's (both sum the f32 products over
    the channel groups in order)."""
    n, c, cw, h, w = geometry
    x, w1, w2, dy = _mix_on_card(seed, dt, merged, n=n, c=c, cw=cw, hi=h,
                                 wi=w, heads=heads)
    assert la.mix_route("dx", x, w1, w2) == "tiles"
    assert la.mix_route("dw", x, w1, w2) == "tiles"
    la.reset_counts()
    got = la.local_aggregate_mix_bwd_hopper(x, w1, w2, dy)
    again = la.local_aggregate_mix_bwd_hopper(x, w1, w2, dy)
    torch.cuda.synchronize()
    assert la.MIX_LAUNCHES == {"fwd": 0, "dx": 2, "dw": 2}
    assert la.PLAIN_MIX_CALLS == 0
    ref = la.local_aggregate_mix_bwd_plain(x, w1, w2, dy)
    on_pointwise = la.local_aggregate_mix_bwd_hopper(x, w1, w2, dy,
                                                     need_dx=False,
                                                     pointwise=True)
    assert (got[2] is None) == merged
    for i, (g, a, r) in enumerate(zip(got, again, ref)):
        if r is None:
            continue
        assert torch.equal(g, a)
        _close(g, r, dt)
        if i:
            assert torch.equal(g, on_pointwise[i])


def _check_mix_fwd_tiles(geometry, dt, heads, merged, seed):
    """The forward on the tiles route against the plain mix at the
    chip_smoke gates, launched twice for the same bits, and bit for bit
    the pointwise route's (both sum each half's taps in row-major order
    into one f32 accumulator, the padding as zeros)."""
    n, c, cw, h, w = geometry
    x, w1, w2, _ = _mix_on_card(seed, dt, merged, n=n, c=c, cw=cw, hi=h,
                                wi=w, heads=heads)
    assert la.mix_route("fwd", x, w1, w2) == "tiles"
    la.reset_counts()
    got = la.local_aggregate_mix_hopper(x, w1, w2)
    again = la.local_aggregate_mix_hopper(x, w1, w2)
    torch.cuda.synchronize()
    assert la.MIX_LAUNCHES == {"fwd": 2, "dx": 0, "dw": 0}
    assert la.PLAIN_MIX_CALLS == 0
    assert torch.equal(got, again)
    _close(got, la.local_aggregate_mix_plain(x, w1, w2), dt)
    assert torch.equal(got, la.local_aggregate_mix_hopper(x, w1, w2,
                                                          pointwise=True))


@pytest.mark.parametrize("heads", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("edge", sorted(MIX_EDGES))
def test_mix_fwd_tiling_edges_match_plain_on_card(edge, dtype, heads):
    """The mix forward's tiles at the edges of their tiling, the weights
    separate and packed."""
    _need_cuda()
    for merged in (False, True):
        _check_mix_fwd_tiles(MIX_EDGES[edge], getattr(torch, dtype), heads,
                             merged, seed=len(edge) + heads + 30)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("case", sorted(MIX_SMALL_MAPS))
def test_mix_fwd_small_maps_match_plain_on_card(case, dtype):
    """The forward at maps smaller than the 5x5 window and at C = Cw, at
    heads 1 and 2, the weights separate and packed."""
    _need_cuda()
    for heads in (1, 2):
        for merged in (False, True):
            _check_mix_fwd_tiles(MIX_SMALL_MAPS[case], getattr(torch, dtype),
                                 heads, merged, seed=len(case) + heads + 30)


def test_mix_fwd_routes_on_card():
    """The forward's tiles take cotnet50's four geometries at bs128 in
    bf16, the weights separate and packed; a row too wide for one block
    (2x2049: 1025 items of 2) takes the pointwise route, which gives the
    plain version's values and the same bits twice."""
    _need_cuda()
    for c, hw in ((64, 56), (128, 28), (256, 14), (512, 7)):
        x = torch.empty(128, c, hw, hw, dtype=torch.bfloat16, device="meta")
        w1, w2, packed = (torch.empty(128, 1, c // 8, k, hw, hw,
                                      dtype=torch.bfloat16, device="meta")
                          for k in (9, 25, 34))
        assert la.mix_route("fwd", x, w1, w2) == "tiles", c
        assert la.mix_route("fwd", x, packed) == "tiles", c
    for dt in (torch.bfloat16, torch.float32):
        x, w1, w2, _ = _mix_on_card(91, dt, False, n=1, c=16, cw=8, hi=2,
                                    wi=2049, heads=1)
        assert la.mix_route("fwd", x, w1, w2) == "pointwise"
        got = la.local_aggregate_mix_hopper(x, w1, w2)
        assert torch.equal(got, la.local_aggregate_mix_hopper(x, w1, w2))
        _close(got, la.local_aggregate_mix_plain(x, w1, w2), dt)


@pytest.mark.parametrize("heads", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("edge", sorted(MIX_EDGES))
def test_mix_bwd_tiling_edges_match_plain_on_card(edge, dtype, heads):
    """The mix's dx and dw tiles at the edges of their tiling, the weights
    separate and packed."""
    _need_cuda()
    for merged in (False, True):
        _check_mix_bwd_tiles(MIX_EDGES[edge], getattr(torch, dtype), heads,
                             merged, seed=len(edge) + heads)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("case", sorted(MIX_SMALL_MAPS))
def test_mix_bwd_small_maps_match_plain_on_card(case, dtype):
    """Maps smaller than the 5x5 window (every tap row and column but the
    centre's falls in the zero padding) and C = Cw, at heads 1 and 2, the
    weights separate and packed."""
    _need_cuda()
    for heads in (1, 2):
        for merged in (False, True):
            _check_mix_bwd_tiles(MIX_SMALL_MAPS[case], getattr(torch, dtype),
                                 heads, merged, seed=len(case) + heads)


def test_mix_bwd_routes_on_card():
    """The tiles take cotnet50's four geometries at bs128 in bf16; a row too
    wide for one block (2x2049: 1025 dx items of 2, 513 dw items of 4)
    takes the pointwise route, which gives the plain version's values and
    the same bits twice."""
    _need_cuda()
    for c, hw in ((64, 56), (128, 28), (256, 14), (512, 7)):
        x = torch.empty(128, c, hw, hw, dtype=torch.bfloat16, device="meta")
        w1 = torch.empty(128, 1, c // 8, 9, hw, hw, dtype=torch.bfloat16,
                         device="meta")
        w2 = torch.empty(128, 1, c // 8, 25, hw, hw, dtype=torch.bfloat16,
                         device="meta")
        packed = torch.empty(128, 1, c // 8, 34, hw, hw,
                             dtype=torch.bfloat16, device="meta")
        for kernel in ("dx", "dw"):
            assert la.mix_route(kernel, x, w1, w2) == "tiles", (kernel, c)
            assert la.mix_route(kernel, x, packed) == "tiles", (kernel, c)
    for dt in (torch.bfloat16, torch.float32):
        x, w1, w2, dy = _mix_on_card(90, dt, False, n=1, c=16, cw=8, hi=2,
                                     wi=2049, heads=1)
        for kernel in ("dx", "dw"):
            assert la.mix_route(kernel, x, w1, w2) == "pointwise", kernel
        got = la.local_aggregate_mix_bwd_hopper(x, w1, w2, dy)
        again = la.local_aggregate_mix_bwd_hopper(x, w1, w2, dy)
        ref = la.local_aggregate_mix_bwd_plain(x, w1, w2, dy)
        for g, a, r in zip(got, again, ref):
            assert torch.equal(g, a)
            _close(g, r, dt)


# ---- the data pipeline's device augment and loader on the card -------------

# the device augment ops' tolerances on the 0-255 scale, shared with the CPU
# parity tests (``test_torch_augment.py`` names the rounding behind each)
AUG_EXACT = ("AutoContrast", "Equalize", "Invert", "Posterize", "Solarize",
             "SolarizeAdd", "TranslateX", "TranslateY", "Cutout",
             "PosterizeIncreasing", "PosterizeOriginal", "SolarizeIncreasing")
AUG_BLENDS = ("Color", "Contrast", "Brightness", "Sharpness",
              "ColorIncreasing", "ContrastIncreasing", "BrightnessIncreasing",
              "SharpnessIncreasing")
AUG_AFFINE = ("Rotate", "ShearX", "ShearY", "TranslateXRel", "TranslateYRel")
# a chain of ops: all but this share of the elements within its tolerance
AUG_CHAIN_FRACTION = 1e-3


def aug_affine_tol(h, w) -> float:
    """Four roundings of a sample coordinate (a sum up to twice the image
    size) times the largest bilinear slope, 255 a pixel."""
    return float(4 * 255 * np.spacing(np.float32(2 * max(h, w))))


def aug_op_tol(name, h, w) -> float:
    if name in AUG_EXACT:
        return 0.0
    if name in AUG_BLENDS:
        return float(4 * np.spacing(np.float32(255)))  # 6.1e-5
    assert name in AUG_AFFINE, name
    return aug_affine_tol(h, w)


def aug_chain_tol(h, w) -> float:
    """An affine op's error carried through the enhance factors of later
    ops (up to 2.8 at magnitude 15)."""
    return 3 * aug_affine_tol(h, w)


def assert_chain_close(got, ref):
    got, ref = (np.asarray(a, np.float32) for a in (got, ref))
    tol = aug_chain_tol(*got.shape[-2:])
    err = np.abs(got - ref)
    assert np.mean(err > tol) <= AUG_CHAIN_FRACTION, (
        f"{int((err > tol).sum())} of {err.size} elements beyond {tol}, "
        f"max {err.max()}")


def _augment_batch(seed, n=8, size=224):
    """Seeded 0..255 float NCHW images on the CPU."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (n, 3, size, size), generator=gen).float()


@pytest.mark.parametrize("name", AUG_EXACT + AUG_BLENDS + AUG_AFFINE)
def test_augment_op_on_card(name):
    """Each device augment op at bs8 224 on the card against the CPU, at two
    levels and both signs."""
    _need_cuda()
    from cotnet_tpu_torch.data import policies
    from cotnet_tpu_torch.data.rand_augment import apply_op

    op = policies.OP_IDX[name]
    x = _augment_batch(0)
    xy = torch.rand((8, 2), generator=torch.Generator().manual_seed(1)) * 224
    for level in (3.0, 13.7):
        for sign in (1.0, -1.0):
            lv, sg = torch.full((8,), level), torch.full((8,), sign)
            want = apply_op(op, x, lv, sg, xy)
            got = apply_op(op, x.cuda(), lv.cuda(), sg.cuda(), xy.cuda())
            np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                       rtol=0,
                                       atol=aug_op_tol(name, 224, 224),
                                       err_msg=f"{name} {level} {sign}")


@pytest.mark.parametrize("config", ["rand-m15-mstd0.5-n2", "rand-m9-n3-w0",
                                    "v0-mstd0.5", "augmix-m3-w3"])
def test_policy_on_card(config):
    """A policy's draws from a CPU generator, applied on the card and on the
    CPU, at bs8 224."""
    _need_cuda()
    from cotnet_tpu_torch.data.auto_augment import create_batch_augment

    aug = create_batch_augment(config)
    x = _augment_batch(2)
    draws = aug.draw(torch.Generator().manual_seed(3), 8, 224, 224)
    got = aug.apply(x.cuda(), draws)
    assert got.is_cuda
    assert_chain_close(got.cpu().numpy(), aug.apply(x, draws).numpy())
    # the card's own generator draws on the card
    out = aug(x.cuda(), torch.Generator(device="cuda").manual_seed(0))
    assert out.shape == x.shape and torch.isfinite(out).all()


@pytest.mark.parametrize("mode", ["const", "rand", "pixel"])
def test_random_erasing_on_card(mode):
    _need_cuda()
    from cotnet_tpu_torch.data.random_erasing import RandomErasing

    erasing = RandomErasing(0.5, mode=mode, count=3, num_splits=2)
    x = torch.randn((8, 3, 224, 224), generator=torch.Generator().manual_seed(4))
    draws = erasing.draw(torch.Generator().manual_seed(5), 8, 3, 224, 224)
    got = erasing.apply(x.cuda(), draws).cpu()
    assert torch.equal(got, erasing.apply(x, draws))
    assert torch.equal(got[:4], x[:4])


def test_loader_on_card(tmp_path):
    """The loader on a written image tree yields contiguous NCHW images,
    int64 labels and a float32 mask on the card, through pinned memory."""
    _need_cuda()
    Image = pytest.importorskip("PIL.Image")
    from cotnet_tpu_torch.data.dataset import ImageFolderDataset
    from cotnet_tpu_torch.data.loader import Loader

    rng = np.random.RandomState(0)
    for cls in ("a", "b"):
        (tmp_path / cls).mkdir()
        for i in range(6):
            Image.fromarray(rng.randint(0, 255, (50, 60, 3), np.uint8)).save(
                tmp_path / cls / f"{i}.jpg", quality=90)
    ds = ImageFolderDataset(str(tmp_path))
    train = Loader(ds, batch_size=4, train=True, image_size=32, workers=2,
                   auto_augment="rand-m9-n2", aug_backend="device",
                   reprob=0.25, dtype=torch.bfloat16)
    batches = list(train)
    assert len(batches) == 3
    for b in batches:
        assert b["image"].is_cuda and b["image"].is_contiguous()
        assert b["image"].shape == (4, 3, 32, 32)
        assert b["image"].dtype == torch.bfloat16
        assert b["label"].is_cuda and b["label"].dtype == torch.int64
        assert b["valid"].dtype == torch.float32
    host = train.host_batches()
    assert next(host)[0].is_pinned()
    host.close()
    val = Loader(ds, batch_size=5, train=False, image_size=32, workers=2)
    assert [int(b["valid"].sum()) for b in val] == [5, 5, 2]


# ---- checkpoints, the CLI and the evaler on the card ----------------------

# the small CoT net: one CotBottleneck a stage, CoT widths 16..128
GPU_SMALL_NET = dict(layers=(1, 1, 1, 1), base_width=16, num_classes=10)


def _small_cuda_state(seed, ema=True):
    from cotnet_tpu_torch.models.cotnet import CotBottleneck
    from cotnet_tpu_torch.models.resnet import ResNet
    from cotnet_tpu_torch.train.optim import create_optimizer
    from cotnet_tpu_torch.train.state import TrainState

    torch.manual_seed(seed)
    model = ResNet(block=CotBottleneck, **GPU_SMALL_NET).cuda()
    opt = create_optimizer(dict(opt="lookahead_adamw", weight_decay=0.05),
                           model.parameters(), lr=1e-3)
    return TrainState.create(model, opt, ema=ema)


def _one_step(state):
    from cotnet_tpu_torch.train.loss import cross_entropy
    from cotnet_tpu_torch.train.step import make_train_step

    step = make_train_step(state.model, state.optimizer, lambda s: 1e-3,
                           cross_entropy, ema_decay=0.9)
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = {"image": torch.randn(4, 3, 64, 64, generator=gen,
                                  device="cuda"),
             "label": torch.arange(4, device="cuda")}
    return step(state, batch, gen)[0]


def test_checkpoint_round_trip_and_restore_on_card(tmp_path):
    """A checkpoint saved from the card restores onto the card, into a
    fresh model and optimizer (Lookahead around AdamW): every tensor on the
    card and equal; one saved from the CPU restores onto the card too."""
    _need_cuda()
    from cotnet_tpu_torch.utils.checkpoint import CheckpointSaver

    state = _one_step(_small_cuda_state(0))
    saver = CheckpointSaver(str(tmp_path / "ckpt"), recovery_interval=1)
    saver.save_checkpoint(state, 1, metric=1.0)
    fresh = saver.restore(_small_cuda_state(1))
    assert fresh.step == state.step == 1
    for k, v in state.model.state_dict().items():
        got = fresh.model.state_dict()[k]
        assert got.is_cuda and torch.equal(got, v), k
    for k, v in state.ema.items():
        assert torch.equal(fresh.ema[k], v), k
    assert all(torch.equal(a, b) for a, b in
               zip(fresh.optimizer.slow, state.optimizer.slow))
    inner = fresh.optimizer.inner.state_dict()["state"]
    assert inner and all(t.is_cuda for s in inner.values()
                         for t in s.values() if torch.is_tensor(t))

    cpu = _small_cuda_state(2)
    cpu.model.cpu()
    cpu_saver = CheckpointSaver(str(tmp_path / "cpu"))
    cpu_saver.save_checkpoint(cpu, 1, metric=0.0)
    onto_card = cpu_saver.restore(_small_cuda_state(3, ema=True))
    for k, v in cpu.model.state_dict().items():
        got = onto_card.model.state_dict()[k]
        assert got.is_cuda and torch.equal(got.cpu(), v), k


def test_cli_step_on_card(tmp_path):
    """train_cli on the card: one epoch of one synthetic step of cotnet50 at
    64 px under the CoTNet-50 recipe, through the Hopper kernels (no plain
    call), with its checkpoint written."""
    _need_cuda()
    import os

    from cotnet_tpu_torch import train_cli

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    src = os.path.join(repo, "cot_experiments", "CoTNet-50-350epoch",
                       "config.yaml")
    (tmp_path / "config.yaml").write_text(open(src).read())
    la.reset_counts()
    out = train_cli.main(["--folder", str(tmp_path), "--synthetic",
                          "--steps", "1", "--epochs", "1", "--img-size", "64",
                          "--batch-size", "4"])
    torch.cuda.synchronize()
    assert out["state"].step == 1 and out["eval"]["samples"] == 4
    assert la.LAUNCHES == 16 + 2 * 16      # train, eval and the EMA's eval
    assert la.BWD_LAUNCHES == {"dx": 16, "dw": 16}
    assert (la.PLAIN_CALLS, la.PLAIN_BWD_CALLS) == (0, 0)
    assert (tmp_path / "checkpoints" / "checkpoint-1.pth.tar").exists()
    log = (tmp_path / "log.txt").read_text()
    assert "eval(ema) epoch 1:" in log and "done; best" in log


def test_ema_evaler_on_card():
    """The EMA evaluated on the card without touching the live weights,
    equal to a model that holds the EMA."""
    _need_cuda()
    from cotnet_tpu_torch.evaler import Evaler
    from cotnet_tpu_torch.models.cotnet import CotBottleneck
    from cotnet_tpu_torch.models.resnet import ResNet

    state = _small_cuda_state(4)
    gen = torch.Generator(device="cuda").manual_seed(5)
    with torch.no_grad():
        for v in state.ema.values():
            v.add_(0.3 * torch.randn(v.shape, generator=gen,
                                     device="cuda")).abs_()
    live = {k: v.clone() for k, v in state.model.state_dict().items()}
    batches = [{"image": torch.randn(4, 3, 64, 64, generator=gen,
                                     device="cuda"),
                "label": torch.randint(0, 10, (4,), generator=gen,
                                       device="cuda"),
                "valid": torch.tensor([1.0, 1.0, 1.0, 0.0], device="cuda")}
               for _ in range(2)]
    la.reset_counts()
    got = Evaler(state.model, batches, use_ema=True)(0, state)
    assert la.LAUNCHES == 8 and la.PLAIN_CALLS == 0
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, live[k]), k
    twin = ResNet(block=CotBottleneck, **GPU_SMALL_NET).cuda()
    twin.load_state_dict({**live, **state.ema})
    assert got == Evaler(twin, batches)(0, state)
    assert got["samples"] == 6.0


# SAN19's aggregation in stage 1: K = 7 at 56x56, 64 channels in 8 groups
# of Cw = 8 weight channels, zero pad 3
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_san_k7_general_route_matches_plain_on_card(dtype):
    """At SAN19's stage-1 geometry the forward, dx and dw take the ``k7``
    route (their K = 7 tiles); all three match the plain version: f32 at
    1e-5, bf16 within one ulp of the reference's largest."""
    _need_cuda()
    gen = torch.Generator("cuda").manual_seed(17)
    n, c, cw, k, hw = 4, 64, 8, 7, 56
    x = torch.randn(n, c, hw, hw, device="cuda", generator=gen).to(dtype)
    w = torch.randn(n, 1, cw, k * k, hw, hw, device="cuda",
                    generator=gen).to(dtype)
    dy = torch.randn(n, c, hw, hw, device="cuda", generator=gen).to(dtype)
    geo = dict(kernel_size=(k, k), dilation=(1, 1), padding=(3, 3))
    for kernel, want in (("fwd", "k7"), ("dx", "k7"), ("dw", "k7")):
        assert la.kernel_route(kernel, x, w, **geo) == want, kernel
    la.reset_counts()
    got = la.local_aggregate(x, w, kernel_size=k, padding=3, impl="hopper")
    dx, dw = la.local_aggregate_bwd_hopper(x, w, dy, **geo)
    assert (la.LAUNCHES, la.BWD_LAUNCHES) == (1, {"dx": 1, "dw": 1})
    ref = la.local_aggregate(x, w, kernel_size=k, padding=3, impl="torch")
    xp = torch.nn.functional.pad(x, (3, 3, 3, 3))
    rdx, rdw = la.local_aggregate_bwd_plain(xp, w, dy, (k, k), (1, 1))
    rdx = rdx[..., 3:3 + hw, 3:3 + hw]
    for name, g, r in (("fwd", got, ref), ("dx", dx, rdx), ("dw", dw, rdw)):
        scale = float(r.float().abs().max())
        tol = 1e-5 if dtype == torch.float32 else 8e-3
        err = float((g.float() - r.float()).abs().max())
        assert err <= tol * scale, (name, err, scale)


# (N, C, Cw, H, W) at K = 7, dilation 1, zero pad 3 and one head: the edges
# of the k7 tiles (an odd map whose width is no multiple of a thread's four
# positions; Cw = 5; N = 1 at SAN19's stage-1 map; two groups on a map
# smaller than a tile) and 16 channel groups, which they refuse (general)
K7_EDGES = {
    "13x11": (2, 64, 8, 13, 11),
    "17x23_cw5": (3, 40, 5, 17, 23),
    "n1_56x56": (1, 64, 8, 56, 56),
    "5x5_g2": (2, 16, 8, 5, 5),
    "g16_refused": (2, 64, 4, 14, 14),
}


@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("edge", sorted(K7_EDGES))
def test_k7_edges_match_plain_on_card(edge, dtype, affine):
    """The k7 forward, dx and dw (with and without the affine) at the edges
    of their tiles: the route (``general`` where they refuse, and for the
    affine dw always), two launches each that give the same bits and no
    plain call, and the plain version: f32 within 1e-5 of the reference's
    largest, bf16 within one ulp of it."""
    _need_cuda()
    dt = getattr(torch, dtype)
    n, c, cw, h, w = K7_EDGES[edge]
    x, wt, s, b, dy = _edge_tensors((n, c, cw, h, w, 1, 7, 1), dt, affine,
                                    seed=len(edge) + 7)
    geo = dict(kernel_size=(7, 7), dilation=(1, 1), padding=(3, 3))
    want = "k7" if c // cw <= 8 else "general"
    for kernel in ("fwd", "dx", "dw"):
        assert la.kernel_route(kernel, x, wt, **geo) == want, kernel
    assert la.kernel_route("dw_affine", x, wt, **geo) == "general"
    la.reset_counts()
    outs, dxs, dws = [], [], []
    for _ in range(2):
        outs.append(la.local_aggregate_hopper(x, wt, s, b, **geo))
        for pick, got in ((0, dxs), (1, dws)):
            need = dict(need_dx=pick == 0, need_dw=pick == 1)
            if affine:
                grads = la.local_aggregate_bwd_affine_hopper(
                    x, wt, s, b, dy, **geo, **need)
            else:
                grads = la.local_aggregate_bwd_hopper(x, wt, dy, **geo,
                                                      **need)
            got.append(grads[pick])
    torch.cuda.synchronize()
    assert la.LAUNCHES == 2
    assert (la.AFFINE_BWD_LAUNCHES if affine else la.BWD_LAUNCHES) == {
        "dx": 2, "dw": 2}
    assert (la.PLAIN_CALLS, la.PLAIN_BWD_CALLS) == (0, 0)
    for pair in (outs, dxs, dws):
        assert torch.equal(pair[0], pair[1])
    xp = torch.nn.functional.pad(x, (3,) * 4)
    ref = la.local_aggregate_plain(xp, wt, (7, 7), (1, 1), (1, 1), s, b)
    if affine:
        ref_dx, ref_dw = la.local_aggregate_bwd_affine_plain(
            xp, wt, s, b, dy, (7, 7), (1, 1))[:2]
    else:
        ref_dx, ref_dw = la.local_aggregate_bwd_plain(xp, wt, dy, (7, 7),
                                                      (1, 1))
    ref_dx = ref_dx[..., 3:3 + h, 3:3 + w]
    for name, got, want_t in (("fwd", outs[0], ref), ("dx", dxs[0], ref_dx),
                              ("dw", dws[0], ref_dw)):
        if dt == torch.float32:
            err = float((got - want_t).abs().max())
            assert err <= 1e-5 * float(want_t.abs().max()), (name, err)
        else:
            torch.testing.assert_close(
                got.float(), want_t.float(),
                **dict(zip(("rtol", "atol"), _tolerance(dt, want_t))))


def test_reflect_pad_beyond_the_map_on_card():
    """The reflect pad of 3 on a 2x2 map (SAN19's stage 4 below 128 px),
    through ``extract_patches`` and ``local_aggregate(pad_mode="reflect")``
    on the card, forward and gradient, against the same calls on the
    CPU, at 1e-5 of each tensor's largest value."""
    _need_cuda()
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(2, 16, 2, 2, generator=gen)
    w = torch.randn(2, 1, 8, 49, 2, 2, generator=gen)
    out = {}
    for device in ("cpu", "cuda"):
        xt = x.detach().to(device).requires_grad_()
        wt = w.detach().to(device).requires_grad_()
        p = la.extract_patches(xt, 7, padding=3, pad_mode="reflect")
        y = la.local_aggregate(xt, wt, kernel_size=7, padding=3,
                               pad_mode="reflect")
        (p.square().sum() + y.square().sum()).backward()
        out[device] = [t.detach().cpu() for t in (p, y, xt.grad, wt.grad)]
    # f32 sums in another order (the reflected pixels' gradients gather
    # up to 25 taps each): within 1e-5 of each tensor's largest
    for name, got, ref in zip(("patches", "out", "dx", "dw"), out["cuda"],
                              out["cpu"]):
        err = float((got - ref).abs().max())
        assert err <= 1e-5 * float(ref.abs().max()), (name, err)


# ---- the transformer core: ViT, DeiT, ResNetV2 and the hybrid ViTs ----------

TRANSFORMER_KEYS = ("vit_tiny_patch16_224", "deit_tiny_distilled_patch16_224",
                    "resnetv2_50x1_bitm", "resnetv2_50d",
                    "vit_tiny_r_s16_p8_224", "vit_small_resnet26d_224")


@pytest.mark.parametrize("name", TRANSFORMER_KEYS)
def test_transformer_core_logits_card_against_cpu(name):
    """f32 logits at bs2 and 224 px, seeded weights, TF32 off: the card against the CPU at 1e-3 of the largest
    logit (cuBLAS and cuDNN sum in other orders; a ViT's 12 blocks and a
    ResNetV2's GN statistics carry that from layer to layer).  No op of
    the port runs: no launch and no plain call."""
    _need_cuda()
    from cotnet_tpu_torch.models import create_model

    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 3, 224, 224, generator=gen)
    cpu = create_model(name, device="cpu", seed=0)
    card = create_model(name, device="cuda", seed=0)
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    la.reset_counts()
    try:
        with torch.no_grad():
            ref = cpu(x)
            got = card(x.cuda()).cpu()
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old
    assert got.shape == (2, 1000) and torch.isfinite(got).all()
    err = float((got - ref).abs().max())
    assert err <= 1e-3 * float(ref.abs().max()), err
    assert la.LAUNCHES == la.PLAIN_CALLS == la.EMBED_GN_LAUNCHES == 0


def _embed_case(device, k=3):
    gen = torch.Generator().manual_seed(4)
    n, c, cp, h, w = 2, 16, 8, 9, 8
    f = k * k * c // 8
    tensors = [torch.randn(n, c, h, w, generator=gen),
               torch.randn(n, cp, h, w, generator=gen).clamp_min(0),
               0.1 * torch.randn(f, cp, generator=gen),
               0.1 * torch.randn(f, generator=gen),
               1 + 0.2 * torch.randn(f, generator=gen),
               0.2 * torch.randn(f, generator=gen)]
    return [t.to(device).requires_grad_() for t in tensors]


def test_embed_gn_auto_refuses_a_gradient_at_compiled_taps_on_card():
    """'auto' on CUDA at a K*K the kernels are compiled for takes the
    kernels, which have no backward: a call that would record a gradient
    raises by name, as the JAX package's TPU kernel has no VJP; under
    no_grad it launches."""
    _need_cuda()
    assert 9 in la._EMBED_GN_TAPS
    leaves = _embed_case("cuda")
    la.reset_counts()
    with pytest.raises(NotImplementedError, match="no backward"):
        la.local_aggregate_embed_gn(*leaves, kernel_size=3)
    assert la.EMBED_GN_LAUNCHES == 0
    with torch.no_grad():
        la.local_aggregate_embed_gn(*leaves, kernel_size=3)
    assert la.EMBED_GN_LAUNCHES == 1


def test_embed_gn_plain_gradient_card_against_cpu():
    """``impl='torch'`` differentiated on the card in f32 (TF32 off) gives
    the CPU's gradients in all six inputs within 1e-5 of each one's
    largest."""
    _need_cuda()
    grads = {}
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for device in ("cpu", "cuda"):
            leaves = _embed_case(device)
            out = la.local_aggregate_embed_gn(*leaves, kernel_size=3,
                                              impl="torch")
            gen = torch.Generator().manual_seed(5)
            r = torch.randn(out.shape, generator=gen).to(device)
            (out * r).sum().backward()
            grads[device] = [t.grad.cpu() for t in leaves]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    for got, ref in zip(grads["cuda"], grads["cpu"]):
        err = float((got - ref).abs().max())
        assert err <= 1e-5 * float(ref.abs().max()), err


# ---- the ViT-built transformers: CaiT, XCiT, Swin, PiT ---------------------

# reduced nets (module, class, constructor arguments, image size): CaiT
# with its token-only blocks, XCiT at patch 8 without tokens_norm (the nano
# rows' form) and its BNs, Swin with a shifted block, the merge and an
# unshifted stage, PiT distilled with its pooling
VIT_FAMILY_NETS = {
    "cait": ("cait", "Cait", dict(img_size=32, patch_size=8, embed_dim=64,
                                  depth=2, num_heads=4)),
    "xcit": ("xcit", "XCiT", dict(patch_size=8, embed_dim=64, depth=2,
                                  num_heads=4, tokens_norm=False)),
    "swin": ("swin_transformer", "SwinTransformer",
             dict(patch_size=4, embed_dim=32, depths=(2, 2),
                  num_heads=(2, 4), window_size=4)),
    "pit": ("pit", "PoolingTransformer",
            dict(img_size=32, patch_size=8, stride=4, base_dims=(16, 16),
                 depths=(1, 2), heads=(2, 4), distilled=True)),
}


@pytest.mark.parametrize("name", sorted(VIT_FAMILY_NETS))
def test_vit_family_logits_card_against_cpu(name):
    """f32 logits of a reduced net at bs2 (32 px; 64 px for XCiT), weights
    from a seeded generator, TF32 off: the card against the CPU at 1e-4 of
    the largest logit (cuBLAS and cuDNN sum in other orders over two to
    four blocks).  No op of the port runs: no launch and no plain call."""
    _need_cuda()
    import importlib

    module, cls, kw = VIT_FAMILY_NETS[name]
    build = getattr(importlib.import_module(
        f"cotnet_tpu_torch.models.{module}"), cls)
    cpu = build(num_classes=10, **kw).eval()
    gen = torch.Generator().manual_seed(0)
    for m in cpu.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(gen)
    card = build(num_classes=10, **kw).cuda().eval()
    card.load_state_dict(cpu.state_dict())
    size = 64 if name == "xcit" else 32
    x = torch.randn(2, 3, size, size, generator=gen)
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    la.reset_counts()
    try:
        with torch.no_grad():
            ref = cpu(x)
            got = card(x.cuda()).cpu()
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old
    assert got.shape == (2, 10) and torch.isfinite(got).all()
    err = float((got - ref).abs().max())
    assert err <= 1e-4 * float(ref.abs().max()), err
    assert la.LAUNCHES == la.PLAIN_CALLS == la.EMBED_GN_LAUNCHES == 0


# ---- the last ViT-built transformers: ConViT, TNT, Twins, Visformer,
# LeViT, CoaT ----------------------------------------------------------------

# reduced nets (module, class, constructor arguments, image size): ConViT
# with two GPSA blocks and the class token at the third, TNT's inner and
# outer blocks, Twins-SVT with windows of 7, 7, 3 and 1, Visformer's BN
# stages, LeViT's BN-over-tokens attention and subsampling, CoaT with two
# parallel blocks (the antialiased shrink)
VIT_TAIL_NETS = {
    "convit": ("convit", "ConViT", dict(img_size=32, patch_size=8,
                                        embed_dim=32, depth=3, num_heads=4,
                                        local_layers=2), 32),
    "tnt": ("tnt", "TNT", dict(img_size=32, patch_size=16, embed_dim=32,
                               inner_dim=8, depth=2, outer_heads=4,
                               inner_heads=2), 32),
    "twins": ("twins", "Twins", dict(embed_dims=(16, 32, 32, 32),
                                     num_heads=(2, 2, 4, 4),
                                     depths=(2, 2, 2, 1)), 56),
    "visformer": ("visformer", "Visformer",
                  dict(img_size=64, init_channels=8, embed_dim=32,
                       depths=(1, 1, 1), num_heads=2), 64),
    "levit": ("levit", "Levit", dict(img_size=64, embed_dims=(32, 48, 64),
                                     key_dim=8, num_heads=(2, 3, 4),
                                     depths=(1, 1, 1)), 64),
    "coat": ("coat", "CoaT", dict(embed_dims=(16, 24, 24, 24),
                                  serial_depths=(1, 1, 1, 1),
                                  parallel_depth=2,
                                  mlp_ratios=(2, 2, 2, 2)), 64),
}


@pytest.mark.parametrize("name", sorted(VIT_TAIL_NETS))
def test_vit_tail_logits_card_against_cpu(name):
    """f32 logits of a reduced net at bs2, weights from a seeded generator,
    TF32 off: the card against the CPU at 1e-4 of the largest logit.  No
    op of the port runs: no launch and no plain call."""
    _need_cuda()
    import importlib

    module, cls, kw, size = VIT_TAIL_NETS[name]
    build = getattr(importlib.import_module(
        f"cotnet_tpu_torch.models.{module}"), cls)
    cpu = build(num_classes=10, **kw).eval()
    gen = torch.Generator().manual_seed(0)
    for m in cpu.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(gen)
    card = build(num_classes=10, **kw).cuda().eval()
    card.load_state_dict(cpu.state_dict())
    x = torch.randn(2, 3, size, size, generator=gen)
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    la.reset_counts()
    try:
        with torch.no_grad():
            ref = cpu(x)
            got = card(x.cuda()).cpu()
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old
    assert got.shape == (2, 10) and torch.isfinite(got).all()
    err = float((got - ref).abs().max())
    assert err <= 1e-4 * float(ref.abs().max()), err
    assert la.LAUNCHES == la.PLAIN_CALLS == la.EMBED_GN_LAUNCHES == 0


# ---- the EfficientNet superfamily --------------------------------------------

# reduced nets (arch strings and EfficientNet arguments, at 32 px): swish
# with SE, MixNet's mixed depthwise and grouped pointwise kernels under
# TF-SAME, CondConv's per-sample grouped convs, MobileNetV3's hard-swish,
# reduce-mid hard-sigmoid SE and head_hidden
EFFNET_NETS = {
    "efficientnet": ((("ds_r1_k3_s1_e1_c8_se0.25",),
                      ("ir_r2_k3_s2_e4_c16_se0.25",),
                      ("ir_r1_k5_s2_e3_c24_se0.25",)), dict(act="swish")),
    "mixnet": ((("ds_r1_k3_s1_e1_c8",),
                ("ir_r1_k3_a1.1_p1.1_s2_e3_c16",
                 "ir_r1_k3.5_a1.1_p1.1_s1_e3_c16_se0.5_nsw"),
                ("ir_r1_k3.5.7_s2_e6_c24_se0.25_nsw",)),
               dict(pad_type="same", bn_eps=1e-3)),
    "condconv": ((("ds_r1_k3_s1_e1_c8_se0.25",),
                  ("ir_r1_k3_s2_e4_c16_se0.25",),
                  ("ir_r2_k5_s1_e3_c16_se0.25_cc4",)), dict(act="swish")),
    "mobilenetv3": ((("ds_r1_k3_s1_c8_nre",), ("ir_r1_k3_s2_e4_c16_nre",),
                     ("ir_r1_k5_s2_e3_c24_se0.25",
                      "ir_r1_k5_s1_e3_c24_se0.25")),
                    dict(act="hard_swish", head_hidden=40, fix_stem=True,
                         se_act="relu", se_reduce_mid=True, se_divisor=8,
                         se_gate="hard_sigmoid")),
}


@pytest.mark.parametrize("name", sorted(EFFNET_NETS))
def test_efficientnet_logits_card_against_cpu(name):
    """f32 logits of a reduced net at bs2 and 32 px, weights from a seeded
    generator, TF32 off: the card against the CPU at 1e-4 of the largest
    logit.  No op of the port runs: no launch and no plain call."""
    _need_cuda()
    from cotnet_tpu_torch.models.efficientnet import (EfficientNet,
                                                      decode_arch_def)

    arch, kw = EFFNET_NETS[name]

    def build():
        return EfficientNet(decode_arch_def(arch), num_classes=10,
                            stem_size=8, num_features=32, **kw)
    cpu = build().eval()
    gen = torch.Generator().manual_seed(0)
    for m in cpu.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(gen)
    card = build().cuda().eval()
    card.load_state_dict(cpu.state_dict())
    x = torch.randn(2, 3, 32, 32, generator=gen)
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    la.reset_counts()
    try:
        with torch.no_grad():
            ref = cpu(x)
            got = card(x.cuda()).cpu()
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old
    assert got.shape == (2, 10) and torch.isfinite(got).all()
    err = float((got - ref).abs().max())
    assert err <= 1e-4 * float(ref.abs().max()), err
    assert la.LAUNCHES == la.PLAIN_CALLS == la.EMBED_GN_LAUNCHES == 0


# ---- the CNN tail: ResNeSt, SKNet, Res2Net, ResNet-RS, PS-ResNet on the
# chassis; RegNet, DenseNet, ReXNet, Xception --------------------------------

def _chassis(block_module, block, **kw):
    """A reduced net of one block a stage on the chassis."""
    import importlib

    from cotnet_tpu_torch.models.resnet import ResNet

    cls = getattr(importlib.import_module(
        f"cotnet_tpu_torch.models.{block_module}"), block)
    return lambda: ResNet(cls, (1, 1, 1, 1), num_classes=10, **kw)


def _net(module, cls, **kw):
    import importlib

    build = getattr(importlib.import_module(
        f"cotnet_tpu_torch.models.{module}"), cls)
    return lambda: build(num_classes=10, **kw)


# reduced nets of each module (constructor, image size): the split attention
# with avd, the grouped SK bottleneck, the hierarchical 3x3s, the RS stem
# without pool and SE at 4, the poly-scale conv, RegNetY's SE, DenseNet's
# deep stem with BlurPool, ReXNet's partial residuals, the whole Xception
CNN_TAIL_NETS = {
    "resnest": (_chassis("resnest", "ResNestBottleneck", stem_type="deep",
                         stem_width=8, avg_down=True,
                         block_args=dict(radix=2)), 64),
    "sknet": (_chassis("sknet", "SelectiveKernelBottleneck", cardinality=8,
                       base_width=4, zero_init_last_bn=False), 64),
    "res2net": (_chassis("res2net", "Bottle2neck", base_width=26,
                         block_args=dict(scale=4)), 64),
    "resnet_rs": (_chassis("resnet", "Bottleneck", stem_type="deep",
                           stem_width=8, replace_stem_pool=True,
                           block_args=dict(attn_layer="se",
                                           attn_kwargs=dict(reduction=4))),
                  64),
    "psresnet": (_chassis("psresnet", "PSBottleneck"), 64),
    "regnet": (_net("regnet", "RegNet", widths=(8, 16, 24, 32),
                    depths=(1, 2, 1, 1), group_widths=(8, 8, 8, 8),
                    se_ratio=0.25, stem_width=8), 64),
    "densenet": (_net("densenet", "DenseNet", growth_rate=4,
                      block_config=(2, 1, 1, 1), stem_width=8,
                      stem_type="deep", aa_layer="blur"), 64),
    "rexnet": (_net("rexnet", "ReXNet", width_mult=0.5, depth_mult=0.1),
               64),
    "xception": (_net("xception", "Xception"), 96),
}


def _seeded_pair(build):
    """The net on the CPU with weights from a seeded generator, and its
    copy on the card."""
    cpu = build().eval()
    gen = torch.Generator().manual_seed(0)
    for m in cpu.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(gen)
    card = build().cuda().eval()
    card.load_state_dict(cpu.state_dict())
    return cpu, card, gen


@pytest.mark.parametrize("name", sorted(CNN_TAIL_NETS))
def test_cnn_tail_logits_card_against_cpu(name):
    """f32 logits of a reduced net at bs2, weights from a seeded generator,
    TF32 off: the card against the CPU at 1e-4 of the largest logit.  No
    op of the port runs: no launch and no plain call."""
    _need_cuda()
    build, size = CNN_TAIL_NETS[name]
    cpu, card, gen = _seeded_pair(build)
    x = torch.randn(2, 3, size, size, generator=gen)
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    la.reset_counts()
    try:
        with torch.no_grad():
            ref = cpu(x)
            got = card(x.cuda()).cpu()
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old
    assert got.shape == (2, 10) and torch.isfinite(got).all()
    err = float((got - ref).abs().max())
    assert err <= 1e-4 * float(ref.abs().max()), err
    assert la.LAUNCHES == la.PLAIN_CALLS == la.EMBED_GN_LAUNCHES == 0


def test_psconv_masked_weights_stay_zero_on_the_card():
    """Two SGD steps with momentum and weight decay of the reduced
    PS-ResNet on the card: the masked dense weights get a zero gradient
    and stay exactly zero, the others move."""
    _need_cuda()
    from cotnet_tpu_torch.models.psresnet import MaskedConv2d

    _, card, gen = _seeded_pair(CNN_TAIL_NETS["psresnet"][0])
    card.train()
    convs = [m for m in card.modules() if isinstance(m, MaskedConv2d)]
    before = [m.weight.detach().clone() for m in convs]
    opt = torch.optim.SGD(card.parameters(), lr=0.1, momentum=0.9,
                          weight_decay=1e-4)
    x = torch.randn(4, 3, 64, 64, generator=gen).cuda()
    for _ in range(2):
        opt.zero_grad()
        card(x).square().mean().backward()
        for m in convs:
            masked = (m.mask == 0).expand_as(m.weight)
            assert not m.weight.grad[masked].any()
        opt.step()
    for m, w0 in zip(convs, before):
        masked = (m.mask == 0).expand_as(m.weight)
        assert not m.weight[masked].any()
        assert not torch.equal(m.weight[~masked], w0[~masked])


# ---- the last of the JAX package's API: local_aggregate_wt and
# DenseGroupedConv as the CoT key conv -------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_local_aggregate_wt_against_local_aggregate_on_card(dtype):
    """``local_aggregate_wt`` with the weight ``[Cw, K*K, Ho, Wo, N]`` is
    ``local_aggregate`` on the permuted weight: one forward, one dx and one
    dw launch and no plain call, and the same bits in the output, dx and
    dw (the kernels get identical contiguous inputs); in f32 also against
    the plain version at 1e-5 of the largest."""
    _need_cuda()
    gen = torch.Generator("cuda").manual_seed(3)
    n, c, cw, h, k = 4, 64, 8, 14, 3
    x = torch.randn(n, c, h, h, device="cuda", generator=gen).to(dtype)
    wt = torch.randn(cw, k * k, h, h, n, device="cuda", generator=gen).to(
        dtype)
    dy = torch.randn(n, c, h, h, device="cuda", generator=gen).to(dtype)
    runs = []
    for form in ("wt", "w", "plain"):
        xg = x.clone().requires_grad_()
        wg = wt.clone().requires_grad_()
        w = wg.permute(4, 0, 1, 2, 3).unsqueeze(1)
        la.reset_counts()
        if form == "wt":
            y = la.local_aggregate_wt(xg, wg, kernel_size=k)
        else:
            y = la.local_aggregate(xg, w, kernel_size=k,
                                   impl="auto" if form == "w" else "torch")
        y.backward(dy)
        torch.cuda.synchronize()
        runs.append((y, xg.grad, wg.grad))
        if form == "wt":
            assert (la.LAUNCHES, la.BWD_LAUNCHES) == (1, {"dx": 1, "dw": 1})
            assert (la.PLAIN_CALLS, la.PLAIN_BWD_CALLS) == (0, 0)
    for got, same in zip(runs[0], runs[1]):
        assert torch.equal(got, same)
    if dtype == torch.float32:
        for got, ref in zip(runs[0], runs[2]):
            err = float((got - ref).abs().max())
            assert err <= 1e-5 * float(ref.abs().max()), err


def test_dense_grouped_cotnet_logits_card_against_cpu():
    """A reduced cotnet50 (one CotBottleneck a stage) with its key convs
    swapped for ``DenseGroupedConv`` (the JAX package's
    ``COTNET_DENSE_GROUPED`` form), f32 at bs2 and 64 px, TF32 off: logits
    on the card against the CPU at 1e-4 of the largest, and against the
    same weights with the grouped key convs on the card; 4 forward
    launches a forward and no plain call."""
    _need_cuda()
    from cotnet_tpu_torch.models.cotnet import CotBottleneck, CotLayer
    from cotnet_tpu_torch.models.resnet import ResNet
    from cotnet_tpu_torch.nn import DenseGroupedConv

    def build(dense):
        model = ResNet(CotBottleneck, (1, 1, 1, 1), num_classes=10,
                       base_width=16, zero_init_last_bn=False)
        for layer in list(model.modules()):
            if dense and isinstance(layer, CotLayer):
                conv = layer.key_embed[0]
                layer.key_embed[0] = DenseGroupedConv(
                    conv.weight.shape[1] * conv.groups, conv.weight.shape[0],
                    conv.kernel_size, conv.stride, conv.padding,
                    groups=conv.groups)
        return model

    cpu, card, gen = _seeded_pair(lambda: build(True))
    off = build(False).cuda().eval()
    off.load_state_dict(cpu.state_dict())
    x = torch.randn(2, 3, 64, 64, generator=gen)
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            ref = cpu(x)
            la.reset_counts()
            got = card(x.cuda())
            torch.cuda.synchronize()
            counts = (la.LAUNCHES, la.PLAIN_CALLS)
            got_off = off(x.cuda()).cpu()
            got = got.cpu()
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old
    assert counts == (4, 0)
    assert got.shape == (2, 10) and torch.isfinite(got).all()
    for want in (ref, got_off):
        err = float((got - want).abs().max())
        assert err <= 1e-4 * float(want.abs().max()), err
