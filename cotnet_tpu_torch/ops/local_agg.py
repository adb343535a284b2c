"""Local aggregation (contextual attention) — the CoTNet hot op, in PyTorch.

Counterpart of ``cotnet_tpu/ops/local_agg.py`` on the reference's own
layout:

    out[n, head*C + g*Cw + cw, ho, wo] =
        sum_{kh,kw} w[n, head, cw, kh*Kw + kw, ho, wo]
                    * x[n, g*Cw + cw, ho*s - pad + kh*dil, wo*s - pad + kw*dil]

- ``x`` is NCHW ``[N, C, H, W]``;
- ``w`` is cw-major ``[N, heads, Cw, K*K, Ho, Wo]``, the layout the
  reference's embed conv produces, so converted checkpoints need no
  permutation here;
- the optional GroupNorm fold ``w_scale``/``w_bias`` is
  ``[N, heads, Cw, K*K]`` float32 and is applied as ``w*s + b``.

Two implementations compute the function and its gradients:

- ``local_aggregate_plain`` / ``local_aggregate_bwd_plain`` /
  ``local_aggregate_bwd_affine_plain``: shifted slices of the padded input,
  one tap at a time, accumulated into f32 buffers (no K*K-sized
  intermediate).  Their arithmetic is the TPU kernels': every operand
  widens to f32, ``w*s + b`` is formed in f32, products and sums are f32,
  and each result is rounded once.  They are the CPU path, the in-package
  oracle and the kernels' comparison.
- ``local_aggregate_hopper`` / ``local_aggregate_bwd_hopper`` /
  ``local_aggregate_bwd_affine_hopper``: the CUDA kernels
  ``csrc/local_agg_fwd.cu`` and ``csrc/local_agg_bwd.cu`` (one kernel for
  dx, one for dw, one for dw, ds and db together with the affine, and a
  small one that adds ds and db across a plane's row tiles),
  launched on PyTorch's current stream for CUDA tensors at stride 1.  The
  forward, dx, dw and affine dw kernels each take one of three routes,
  which the launcher picks from the geometry before it launches and
  ``kernel_route`` reports: ``k3`` and ``general``, halo tiles in shared
  memory (K = 3 at dilation 1 unrolled; any K up to 7), and ``pointwise``,
  one thread per output, for every geometry whose tiles do not fit.

``local_aggregate`` is differentiable in x and w and, with the GroupNorm
fold, in ``w_scale`` and ``w_bias`` (once: there is no double backward).

``local_aggregate_embed_gn`` is the eval-only fusion of the embed 1x1 conv,
the GroupNorm and the aggregation: ``local_aggregate_embed_gn_plain``
beside the kernels of ``csrc/local_agg_embed_gn.cu``, whose route
``embed_gn_route`` reports (``k3`` and ``general`` on the forward's halo
tiles, ``pointwise`` beyond them).

``local_aggregate_mix`` / ``local_aggregate_mix_merge`` aggregate one input
with a 3x3 and a 5x5 weight at once (``local_aggregate_mix_plain`` /
``local_aggregate_mix_bwd_plain`` beside the three kernels of
``csrc/local_agg_mix.cu``, whose routes ``mix_route`` reports: ``tiles``,
halo tiles in shared memory, or ``pointwise``);
``local_aggregate_dilated`` gives each weight channel its own dilation
through ``local_aggregate``.

``LAUNCHES`` / ``PLAIN_CALLS`` count the forward calls of each
implementation, ``BWD_LAUNCHES`` and ``AFFINE_BWD_LAUNCHES`` (per kernel,
``"dx"`` and ``"dw"``) / ``PLAIN_BWD_CALLS`` the backward ones,
``EMBED_GN_LAUNCHES`` / ``PLAIN_EMBED_GN_CALLS`` those of the fused op,
``MIX_LAUNCHES`` (``"fwd"``, ``"dx"``, ``"dw"``) / ``PLAIN_MIX_CALLS``
those of the mix, so a run can show which one it went through;
``LAUNCHES_BY_SHAPE``, ``BWD_LAUNCHES_BY_SHAPE``,
``EMBED_GN_LAUNCHES_BY_SHAPE`` and ``MIX_LAUNCHES_BY_SHAPE`` split the
launches by their input shapes.  ``reset_counts()`` zeroes them all.
"""

from __future__ import annotations

import ctypes
import warnings
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

# kernel launches by local_aggregate_hopper; calls of the plain version
LAUNCHES = 0
PLAIN_CALLS = 0
# kernel launches keyed by launch_key(): dtype, affine, x and w shapes,
# dilation, padding
LAUNCHES_BY_SHAPE: Dict[tuple, int] = {}
# the same for the backward: launches of each kernel by
# local_aggregate_bwd_hopper, and calls of local_aggregate_bwd_plain
BWD_LAUNCHES: Dict[str, int] = {"dx": 0, "dw": 0}
PLAIN_BWD_CALLS = 0
# launches of the two affine backward kernels ("dw" writes dw, ds and db) by
# local_aggregate_bwd_affine_hopper; the plain affine backward counts in
# PLAIN_BWD_CALLS
AFFINE_BWD_LAUNCHES: Dict[str, int] = {"dx": 0, "dw": 0}
# keyed by (kernel, launch_key()); the key says whether the affine was on
BWD_LAUNCHES_BY_SHAPE: Dict[tuple, int] = {}
# launches by local_aggregate_embed_gn_hopper (one per call, whether it runs
# one kernel or two), keyed by embed_gn_key(); calls of the plain version
EMBED_GN_LAUNCHES = 0
EMBED_GN_LAUNCHES_BY_SHAPE: Dict[tuple, int] = {}
PLAIN_EMBED_GN_CALLS = 0
# launches of the three mix kernels, by local_aggregate_mix_hopper and
# local_aggregate_mix_bwd_hopper; keyed by (kernel, mix_key()); calls of
# either plain mix version
MIX_LAUNCHES: Dict[str, int] = {"fwd": 0, "dx": 0, "dw": 0}
MIX_LAUNCHES_BY_SHAPE: Dict[tuple, int] = {}
PLAIN_MIX_CALLS = 0
# the geometries that impl='auto' sent to a plain version on the card
# because no kernel computes them, each warned about once
PLAIN_FALLBACKS: set = set()

_LIB_NAME = "local_agg_fwd"
_BWD_LIB_NAME = "local_agg_bwd"
_EMBED_GN_LIB_NAME = "local_agg_embed_gn"
_MIX_LIB_NAME = "local_agg_mix"
# the tap counts (K*K) the fused kernel is compiled for: it keeps them in
# registers
_EMBED_GN_TAPS = (9, 25, 49)
_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        if len(v) != 2:
            raise ValueError(f"expected an int or a pair, got {v!r}")
        return int(v[0]), int(v[1])
    return int(v), int(v)


def out_size(in_size: int, k: int, stride: int, pad: int, dil: int) -> int:
    return (in_size + 2 * pad - (dil * (k - 1) + 1)) // stride + 1


def _pad_input(x, padding, pad_mode):
    ph, pw = padding
    if ph == 0 and pw == 0:
        return x
    if pad_mode == "zeros":
        return F.pad(x, (pw, pw, ph, ph))
    if pad_mode == "reflect":
        return F.pad(x, (pw, pw, ph, ph), mode="reflect")
    raise ValueError(f"unknown pad_mode {pad_mode!r}")


def extract_patches(x, kernel_size=3, stride=1, padding=None, dilation=1,
                    pad_mode: str = "zeros"):
    """K x K neighborhood patches: ``[N, C, H, W] -> [N, C, K*K, Ho, Wo]``,
    taps ordered (kh, kw) — the reference's ``nn.Unfold`` view."""
    kernel_size, stride, dilation = (_pair(kernel_size), _pair(stride),
                                     _pair(dilation))
    padding = _default_padding(padding, kernel_size, dilation)
    n, c, hi, wi = x.shape
    ho = out_size(hi, kernel_size[0], stride[0], padding[0], dilation[0])
    wo = out_size(wi, kernel_size[1], stride[1], padding[1], dilation[1])
    xp = _pad_input(x, padding, pad_mode)
    taps = [_tap(xp, ikh * dilation[0], ikw * dilation[1], ho, wo, stride)
            for ikh in range(kernel_size[0])
            for ikw in range(kernel_size[1])]
    return torch.stack(taps, dim=2)


def _default_padding(padding, kernel_size, dilation):
    if padding is None:
        return tuple((d * (k - 1) + 1) // 2
                     for k, d in zip(kernel_size, dilation))
    return _pair(padding)


def _tap(xp, h0, w0, ho, wo, stride):
    sh, sw = stride
    return xp[..., h0:h0 + (ho - 1) * sh + 1:sh, w0:w0 + (wo - 1) * sw + 1:sw]


def _acc_dtype(t):
    """The plain versions' arithmetic dtype: f32 (f64 for f64 inputs, so
    that ``gradcheck`` can be run on them)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def local_aggregate_plain(xp, w, kernel_size, stride, dilation,
                          w_scale=None, w_bias=None):
    """VALID aggregation of the pre-padded ``xp`` in plain PyTorch.

    xp ``[N, C, Hp, Wp]``, w ``[N, heads, Cw, K2, Ho, Wo]`` ->
    ``[N, heads*C, Ho, Wo]`` in ``xp.dtype``; all arithmetic in f32."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    return _aggregate_taps(xp, w, kernel_size, stride, dilation, w_scale,
                           w_bias)


def _aggregate_taps(xp, w, kernel_size, stride, dilation, w_scale=None,
                    w_bias=None):
    n, c, _, _ = xp.shape
    _, heads, cw, k2, ho, wo = w.shape
    kh, kw = kernel_size
    g = c // cw
    acc = _acc_dtype(xp)
    xv = xp.to(acc).reshape(n, 1, g, cw, *xp.shape[2:])
    wf = w.to(acc)
    if w_scale is not None:
        sf = w_scale.to(acc)[..., None, None]
        bf = w_bias.to(acc)[..., None, None]
    out = torch.zeros(n, heads, g, cw, ho, wo, dtype=acc, device=xp.device)
    for ikh in range(kh):
        for ikw in range(kw):
            k = ikh * kw + ikw
            wk = wf[:, :, :, k]
            if w_scale is not None:
                wk = wk * sf[:, :, :, k] + bf[:, :, :, k]
            xs = _tap(xv, ikh * dilation[0], ikw * dilation[1], ho, wo,
                      stride)
            out += xs * wk[:, :, None]
    return out.view(n, heads * c, ho, wo).to(xp.dtype)


def local_aggregate_bwd_plain(xp, w, dy, kernel_size, dilation,
                              need_dx: bool = True, need_dw: bool = True):
    """Gradients of the stride-1 ``local_aggregate_plain`` in plain PyTorch.

    xp ``[N, C, Hp, Wp]`` (pre-padded), w ``[N, heads, Cw, K2, Ho, Wo]``, dy
    ``[N, heads*C, Ho, Wo]`` -> ``(dxp, dw)`` of the shapes and dtypes of xp
    and w (None where not needed).  One tap at a time: dw's tap is the
    shifted slice of xp times dy summed over the C/Cw channel groups, and
    dxp's shifted slice gains w's tap times dy summed over the heads.  All
    arithmetic in f32, one rounding at the end."""
    global PLAIN_BWD_CALLS
    PLAIN_BWD_CALLS += 1
    n, c, hp, wp = xp.shape
    _, heads, cw, k2, ho, wo = w.shape
    kh, kw = kernel_size
    g = c // cw
    acc = _acc_dtype(xp)
    dyv = dy.to(acc).reshape(n, heads, g, cw, ho, wo)
    dxp = dw = None
    if need_dx:
        wf = w.to(acc)
        dxp = torch.zeros(n, g, cw, hp, wp, dtype=acc, device=xp.device)
    if need_dw:
        xv = xp.to(acc).reshape(n, 1, g, cw, hp, wp)
        dw = torch.empty(w.shape, dtype=acc, device=xp.device)
    for ikh in range(kh):
        for ikw in range(kw):
            k = ikh * kw + ikw
            h0, w0 = ikh * dilation[0], ikw * dilation[1]
            if need_dw:
                dw[:, :, :, k] = (xv[..., h0:h0 + ho, w0:w0 + wo]
                                  * dyv).sum(2)
            if need_dx:
                dxp[..., h0:h0 + ho, w0:w0 + wo] += (
                    wf[:, :, None, :, k] * dyv).sum(1)
    if need_dx:
        dxp = dxp.view(n, c, hp, wp).to(xp.dtype)
    if need_dw:
        dw = dw.to(w.dtype)
    return dxp, dw


def local_aggregate_bwd_affine_plain(xp, w, w_scale, w_bias, dy, kernel_size,
                                     dilation, need_dx: bool = True,
                                     need_dw: bool = True):
    """Gradients of the stride-1 ``local_aggregate_plain`` with the affine
    ``wn = w*w_scale + w_bias``, in plain PyTorch.

    xp ``[N, C, Hp, Wp]`` (pre-padded), w ``[N, heads, Cw, K2, Ho, Wo]``,
    w_scale / w_bias ``[N, heads, Cw, K2]``, dy ``[N, heads*C, Ho, Wo]`` ->
    ``(dxp, dw, ds, db)``: dxp and dw of the shapes and dtypes of xp and w,
    ds and db of w_scale's.  ``need_dw`` asks for dw, ds and db together
    (one pass computes them); what is not needed is None.

    One tap at a time, with the TPU kernels' arithmetic
    (``_dx_kernel_affine``, ``_dw_kernel_affine``): the gradient of the
    normalized weight ``gn = sum_g x_tap * dy`` stays f32 and is never
    stored whole; ``dw = gn * s`` is rounded once; ``ds = sum_hw gn * w``
    takes the raw w widened to f32; ``db = sum_hw gn``; dxp aggregates dy
    with ``w*s + b`` formed in f32."""
    global PLAIN_BWD_CALLS
    PLAIN_BWD_CALLS += 1
    n, c, hp, wp = xp.shape
    _, heads, cw, k2, ho, wo = w.shape
    kh, kw = kernel_size
    g = c // cw
    acc = _acc_dtype(xp)
    dyv = dy.to(acc).reshape(n, heads, g, cw, ho, wo)
    wf = w.to(acc)
    sf = w_scale.to(acc)[..., None, None]
    dxp = dw = ds = db = None
    if need_dx:
        bf = w_bias.to(acc)[..., None, None]
        dxp = torch.zeros(n, g, cw, hp, wp, dtype=acc, device=xp.device)
    if need_dw:
        xv = xp.to(acc).reshape(n, 1, g, cw, hp, wp)
        dw = torch.empty(w.shape, dtype=acc, device=xp.device)
        ds = torch.empty(w_scale.shape, dtype=acc, device=xp.device)
        db = torch.empty_like(ds)
    for ikh in range(kh):
        for ikw in range(kw):
            k = ikh * kw + ikw
            h0, w0 = ikh * dilation[0], ikw * dilation[1]
            if need_dw:
                gn = (xv[..., h0:h0 + ho, w0:w0 + wo] * dyv).sum(2)
                dw[:, :, :, k] = gn * sf[:, :, :, k]
                ds[:, :, :, k] = (gn * wf[:, :, :, k]).sum((-2, -1))
                db[:, :, :, k] = gn.sum((-2, -1))
            if need_dx:
                wn = wf[:, :, :, k] * sf[:, :, :, k] + bf[:, :, :, k]
                dxp[..., h0:h0 + ho, w0:w0 + wo] += (
                    wn[:, :, None] * dyv).sum(1)
    if need_dx:
        dxp = dxp.view(n, c, hp, wp).to(xp.dtype)
    if need_dw:
        dw = dw.to(w.dtype)
        ds, db = ds.to(w_scale.dtype), db.to(w_scale.dtype)
    return dxp, dw, ds, db


def _c_function(lib_name, fn_name, argtypes):
    from cotnet_tpu_torch.ops import _build

    fn = getattr(_build.load(lib_name), fn_name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _kernel():
    return _c_function(_LIB_NAME, "local_agg_fwd_launch",
                       [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 14 + [ctypes.c_void_p])


def _bwd_kernel():
    return _c_function(_BWD_LIB_NAME, "local_agg_bwd_launch",
                       [ctypes.c_int] + [ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 14 + [ctypes.c_void_p])


def _bwd_affine_kernel():
    return _c_function(_BWD_LIB_NAME, "local_agg_bwd_affine_launch",
                       [ctypes.c_int] + [ctypes.c_void_p] * 10
                       + [ctypes.c_longlong] + [ctypes.c_int] * 14
                       + [ctypes.c_void_p])


def dw_affine_workspace_bytes(x, w, kernel_size, dilation, padding) -> int:
    """The bytes of device memory the affine dw kernels need for ds's and
    db's partial sums across a plane's row tiles (0: none), as their
    launcher plans the launch."""
    from cotnet_tpu_torch.ops import _build

    fn = _build.load(_BWD_LIB_NAME).local_agg_bwd_dw_affine_workspace
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 15
        fn.restype = ctypes.c_longlong
    n, c, hi, wi = x.shape
    _, heads, cw, _, ho, wo = w.shape
    return fn(_DTYPE_CODES[x.dtype], n, c, hi, wi, heads, cw, *kernel_size,
              ho, wo, *padding, *dilation)


def _embed_gn_kernel():
    return _c_function(_EMBED_GN_LIB_NAME, "local_agg_embed_gn_launch",
                       [ctypes.c_int] + [ctypes.c_void_p] * 8
                       + [ctypes.c_int] * 15 + [ctypes.c_float,
                                                ctypes.c_void_p])


def _embed_gn_geometry(x, w_pre, w2, kernel_size, dilation, padding,
                       groups) -> tuple:
    """The fused kernels' geometry arguments: images times groups, groups,
    x's channels per group, Hi, Wi, Cp and Cw per group, Kh, Kw, Ho, Wo,
    the padding and the dilation."""
    n, c, hi, wi = x.shape
    _, _, ho, wo = w_pre.shape
    f, cp = w2.shape
    kh, kw = kernel_size
    return (n * groups, groups, c // groups, hi, wi, cp,
            f // groups // (kh * kw), kh, kw, ho, wo, *padding, *dilation)


def embed_gn_route(x, w_pre, w2, *, kernel_size, dilation, padding,
                   groups: int = 1) -> str:
    """The route (``"k3"``, ``"general"`` or ``"pointwise"``) that a launch
    of the fused embed op takes for x ``[N, C, Hi, Wi]``, w_pre
    ``[N, groups*Cp, Ho, Wo]`` and w2 ``[F, Cp]`` in x's dtype, as its
    launcher decides it from the geometry before it launches.  Builds the
    kernel's library."""
    fn = _c_function(_EMBED_GN_LIB_NAME, "local_agg_embed_gn_variant",
                     [ctypes.c_int] * 16)
    return ROUTES[fn(_DTYPE_CODES[x.dtype], *_embed_gn_geometry(
        x, w_pre, w2, kernel_size, dilation, padding, groups))]


def embed_gn_workspace_bytes(x, w_pre, w2, *, kernel_size, dilation, padding,
                             groups: int = 1, pointwise: bool = False) -> int:
    """The bytes of device memory the fused embed op needs for its
    statistics kernel's partial sums ``[N*groups, Cw, tiles, 2]`` (f32), as
    its launcher plans the launch (``pointwise=True``: the pointwise
    route's, whatever the geometry): 0 where a block holds whole planes and
    takes their statistics itself (no statistics launch is made)."""
    from cotnet_tpu_torch.ops import _build

    fn = _build.load(_EMBED_GN_LIB_NAME).local_agg_embed_gn_workspace
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 17
        fn.restype = ctypes.c_longlong
    return fn(_DTYPE_CODES[x.dtype], *_embed_gn_geometry(
        x, w_pre, w2, kernel_size, dilation, padding, groups), int(pointwise))


def embed_gn_statistics(x, w_pre, w2, b2, *, kernel_size, dilation, padding,
                        groups: int = 1, pointwise: bool = False):
    """The statistics pass of the fused embed op alone, as its launcher
    makes it for these tensors (``pointwise=True``: the pointwise route's
    pass, ``embed_gn_stats``, whatever the geometry): the float32 partial
    sums ``[N*groups, Cw, tiles, 2]`` of w_raw and w_raw^2 over each tile's
    pixels and taps, or None where the launch makes no statistics pass (a
    block holds whole planes).  Summed over the tiles, any route's are one
    plane's statistics.  For checks on the card: it counts no launch and
    computes no output.  Tensors as ``local_aggregate_embed_gn_hopper``
    takes them."""
    _check_kernel_tensors("embed_gn_statistics", [x, w_pre, w2, b2],
                          (x, w_pre, w2))
    _check_f32("b2", b2)
    geometry = _embed_gn_geometry(x, w_pre, w2, kernel_size, dilation,
                                  padding, groups)
    nbytes = embed_gn_workspace_bytes(
        x, w_pre, w2, kernel_size=kernel_size, dilation=dilation,
        padding=padding, groups=groups, pointwise=pointwise)
    if nbytes == 0:
        return None
    n, cw = geometry[0], geometry[6]
    partials = torch.empty(n, cw, nbytes // (8 * n * cw), 2,
                           dtype=torch.float32, device=x.device)
    fn = _c_function(_EMBED_GN_LIB_NAME, "local_agg_embed_gn_stats_launch",
                     [ctypes.c_int] + [ctypes.c_void_p] * 4
                     + [ctypes.c_int] * 16 + [ctypes.c_void_p])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(_DTYPE_CODES[x.dtype], w_pre.data_ptr(), w2.data_ptr(),
                 b2.data_ptr(), partials.data_ptr(), *geometry,
                 int(pointwise), stream)
    if err != 0:
        raise RuntimeError(f"embed_gn statistics launch failed: cudaError "
                           f"{err}")
    return partials


# the route of a forward, dx, dw or affine dw launch (and "tiles" of the
# mix's forward, dx or dw), by the code its library's *_variant function
# returns for the geometry
ROUTES = {3: "k3", 0: "general", 1: "pointwise", 4: "tiles"}
_ROUTE_FUNCTIONS = {
    "fwd": (_LIB_NAME, "local_agg_fwd_variant"),
    "dx": (_BWD_LIB_NAME, "local_agg_bwd_dx_variant"),
    "dw": (_BWD_LIB_NAME, "local_agg_bwd_dw_variant"),
    "dw_affine": (_BWD_LIB_NAME, "local_agg_bwd_dw_affine_variant"),
}


def kernel_route(kernel: str, x, w, *, kernel_size, dilation,
                 padding) -> str:
    """The route (``"k3"``, ``"general"`` or ``"pointwise"``) that a launch
    of ``kernel`` takes for x ``[N, C, Hi, Wi]`` and w ``[N, heads, Cw, K2,
    Ho, Wo]`` in x's dtype, as the kernel's launcher decides it from the
    geometry before it launches: ``"fwd"`` and ``"dx"`` with the affine or
    without, ``"dw"`` without it, ``"dw_affine"`` (dw, ds and db) with it.
    Builds the kernel's library."""
    lib, name = _ROUTE_FUNCTIONS[kernel]
    fn = _c_function(lib, name, [ctypes.c_int] * 15)
    n, c, hi, wi = x.shape
    _, heads, cw, _, ho, wo = w.shape
    return ROUTES[fn(_DTYPE_CODES[x.dtype], n, c, hi, wi, heads, cw,
                     *kernel_size, ho, wo, *padding, *dilation)]


def reset_counts():
    global LAUNCHES, PLAIN_CALLS, PLAIN_BWD_CALLS, EMBED_GN_LAUNCHES, \
        PLAIN_EMBED_GN_CALLS, PLAIN_MIX_CALLS
    LAUNCHES = PLAIN_CALLS = PLAIN_BWD_CALLS = 0
    EMBED_GN_LAUNCHES = PLAIN_EMBED_GN_CALLS = PLAIN_MIX_CALLS = 0
    LAUNCHES_BY_SHAPE.clear()
    BWD_LAUNCHES.update(dx=0, dw=0)
    AFFINE_BWD_LAUNCHES.update(dx=0, dw=0)
    BWD_LAUNCHES_BY_SHAPE.clear()
    EMBED_GN_LAUNCHES_BY_SHAPE.clear()
    MIX_LAUNCHES.update(fwd=0, dx=0, dw=0)
    MIX_LAUNCHES_BY_SHAPE.clear()
    PLAIN_FALLBACKS.clear()


def _warn_plain_fallback(op: str, why: str, key: tuple) -> None:
    """Warn once per geometry that ``impl='auto'`` computes a CUDA call
    with the plain version: no Hopper (or TPU) kernel covers it."""
    if (op,) + key in PLAIN_FALLBACKS:
        return
    PLAIN_FALLBACKS.add((op,) + key)
    warnings.warn(f"{op}: no kernel computes {why} ({key}); impl='auto' "
                  "takes the plain version on the card", RuntimeWarning,
                  stacklevel=3)


def launch_key(x, w, affine, dilation, padding) -> tuple:
    """The key under which ``LAUNCHES_BY_SHAPE`` counts a launch."""
    return (str(x.dtype).replace("torch.", ""), bool(affine), tuple(x.shape),
            tuple(w.shape), tuple(dilation), tuple(padding))


def local_aggregate_hopper(x, w, w_scale=None, w_bias=None, *,
                           kernel_size, dilation, padding):
    """Launch the Hopper kernel: stride-1 aggregation with fused zero pad.

    x ``[N, C, Hi, Wi]``, w ``[N, heads, Cw, K2, Ho, Wo]`` (same dtype, one
    of f32/f16/bf16), optional w_scale/w_bias ``[N, heads, Cw, K2]`` f32; all
    contiguous CUDA tensors on one device.  Returns ``[N, heads*C, Ho, Wo]``.
    The shapes are checked by ``local_aggregate``; this checks what the
    kernel needs besides.  It records no autograd graph: gradients come
    from ``local_aggregate``."""
    global LAUNCHES
    tensors = [x, w] + ([] if w_scale is None else [w_scale, w_bias])
    _check_kernel_tensors("local_aggregate_hopper", tensors, (x, w))
    affine = w_scale is not None
    if affine:
        _check_f32("affine", w_scale, w_bias)
    n, c, hi, wi = x.shape
    _, heads, cw, _, ho, wo = w.shape
    kh, kw = kernel_size
    dh, dw = dilation
    ph, pw = padding
    fn = _kernel()
    out = torch.empty(n, heads * c, ho, wo, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(_DTYPE_CODES[x.dtype], int(affine), x.data_ptr(),
                 w.data_ptr(), w_scale.data_ptr() if affine else None,
                 w_bias.data_ptr() if affine else None, out.data_ptr(),
                 n, c, hi, wi, heads, cw, kh, kw, ho, wo, ph, pw, dh, dw,
                 stream)
    if err != 0:
        raise RuntimeError(f"local_agg_fwd launch failed: cudaError {err}")
    LAUNCHES += 1
    key = launch_key(x, w, affine, dilation, padding)
    LAUNCHES_BY_SHAPE[key] = LAUNCHES_BY_SHAPE.get(key, 0) + 1
    return out


def _check_f32(what, *tensors):
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{what} dtypes "
                        f"{'/'.join(str(t.dtype) for t in tensors)}: need "
                        "float32")


def _check_kernel_tensors(who, tensors, same_dtype):
    """What every launch wrapper needs: contiguous CUDA tensors on one
    device, and one supported dtype across ``same_dtype``."""
    first = tensors[0]
    if any(t.device.type != "cuda" or t.device != first.device
           for t in tensors):
        raise ValueError(f"{who} takes CUDA tensors on one device only")
    dtypes = {t.dtype for t in same_dtype}
    if len(dtypes) != 1 or first.dtype not in _DTYPE_CODES:
        raise TypeError(f"{who}: dtypes {sorted(map(str, dtypes))}: need one "
                        f"of {sorted(map(str, _DTYPE_CODES))}, the same for "
                        "all")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{who} takes contiguous tensors")


def local_aggregate_bwd_hopper(x, w, dy, *, kernel_size, dilation, padding,
                               need_dx: bool = True, need_dw: bool = True):
    """Launch the Hopper backward kernels: gradients of the stride-1
    aggregation with fused zero pad.

    x ``[N, C, Hi, Wi]``, w ``[N, heads, Cw, K2, Ho, Wo]``, dy
    ``[N, heads*C, Ho, Wo]``: contiguous CUDA tensors of one dtype
    (f32/f16/bf16) on one device.  Returns ``(dx, dw)`` of the shapes and
    dtypes of x and w; the kernel of a gradient that is not needed is not
    launched and its slot is None."""
    _check_kernel_tensors("local_aggregate_bwd_hopper", [x, w, dy],
                          (x, w, dy))
    n, c, hi, wi = x.shape
    _, heads, cw, _, ho, wo = w.shape
    if tuple(dy.shape) != (n, heads * c, ho, wo):
        raise ValueError(f"dy shape {tuple(dy.shape)} != "
                         f"{(n, heads * c, ho, wo)}")
    kh, kw = kernel_size
    dh, dw_ = dilation
    ph, pw = padding
    if not (need_dx or need_dw):
        return None, None
    fn = _bwd_kernel()
    dx = torch.empty_like(x) if need_dx else None
    dw = torch.empty_like(w) if need_dw else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(_DTYPE_CODES[x.dtype], x.data_ptr(), w.data_ptr(),
                 dy.data_ptr(), dx.data_ptr() if need_dx else None,
                 dw.data_ptr() if need_dw else None,
                 n, c, hi, wi, heads, cw, kh, kw, ho, wo, ph, pw, dh, dw_,
                 stream)
    if err != 0:
        raise RuntimeError(f"local_agg_bwd launch failed: cudaError {err}")
    key = launch_key(x, w, False, dilation, padding)
    for kernel, launched in (("dx", need_dx), ("dw", need_dw)):
        if launched:
            BWD_LAUNCHES[kernel] += 1
            BWD_LAUNCHES_BY_SHAPE[(kernel, key)] = \
                BWD_LAUNCHES_BY_SHAPE.get((kernel, key), 0) + 1
    return dx, dw


def local_aggregate_bwd_affine_hopper(x, w, w_scale, w_bias, dy, *,
                                      kernel_size, dilation, padding,
                                      need_dx: bool = True,
                                      need_dw: bool = True):
    """Launch the Hopper backward kernels of the aggregation with the affine
    ``w*w_scale + w_bias`` folded in (stride 1, fused zero pad).

    x, w, dy as for ``local_aggregate_bwd_hopper``; w_scale, w_bias
    ``[N, heads, Cw, K2]`` float32.  Returns ``(dx, dw, ds, db)``: dx and dw
    of the shapes and dtypes of x and w, ds and db float32 of w_scale's
    shape.  ``need_dw`` asks for dw, ds and db, which one kernel writes
    together (with a second, small one that adds ds's and db's partial
    sums, in a workspace allocated here, where a plane spans several row
    tiles; one launch in ``AFFINE_BWD_LAUNCHES["dw"]`` all the same); the
    kernels of what is not needed are not launched and their slots are
    None."""
    _check_kernel_tensors("local_aggregate_bwd_affine_hopper",
                          [x, w, dy, w_scale, w_bias], (x, w, dy))
    _check_f32("affine", w_scale, w_bias)
    n, c, hi, wi = x.shape
    _, heads, cw, k2, ho, wo = w.shape
    if tuple(dy.shape) != (n, heads * c, ho, wo):
        raise ValueError(f"dy shape {tuple(dy.shape)} != "
                         f"{(n, heads * c, ho, wo)}")
    if not (tuple(w_scale.shape) == tuple(w_bias.shape)
            == (n, heads, cw, k2)):
        raise ValueError(f"affine shape {tuple(w_scale.shape)}/"
                         f"{tuple(w_bias.shape)} != {(n, heads, cw, k2)}")
    kh, kw = kernel_size
    dh, dw_ = dilation
    ph, pw = padding
    if not (need_dx or need_dw):
        return None, None, None, None
    fn = _bwd_affine_kernel()
    dx = torch.empty_like(x) if need_dx else None
    dw = ds = db = part = None
    if need_dw:
        dw = torch.empty_like(w)
        ds, db = torch.empty_like(w_scale), torch.empty_like(w_scale)
        # ds's and db's partial sums when a plane spans several row tiles
        nbytes = dw_affine_workspace_bytes(x, w, kernel_size, dilation,
                                            padding)
        if nbytes:
            part = torch.empty(nbytes, dtype=torch.uint8, device=x.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(_DTYPE_CODES[x.dtype], x.data_ptr(), w.data_ptr(),
                 w_scale.data_ptr(), w_bias.data_ptr(), dy.data_ptr(),
                 ptr(dx), ptr(dw), ptr(ds), ptr(db), ptr(part),
                 0 if part is None else part.numel(),
                 n, c, hi, wi, heads, cw, kh, kw, ho, wo, ph, pw, dh, dw_,
                 stream)
    if err != 0:
        raise RuntimeError(f"local_agg_bwd_affine launch failed: cudaError "
                           f"{err}")
    key = launch_key(x, w, True, dilation, padding)
    for kernel, launched in (("dx", need_dx), ("dw", need_dw)):
        if launched:
            AFFINE_BWD_LAUNCHES[kernel] += 1
            BWD_LAUNCHES_BY_SHAPE[(kernel, key)] = \
                BWD_LAUNCHES_BY_SHAPE.get((kernel, key), 0) + 1
    return dx, dw, ds, db


class _AggregateStride1(torch.autograd.Function):
    """The stride-1 aggregation with zero pad and no affine, as one autograd
    node: the Hopper kernels (``use_kernel``) or the plain versions, in
    forward and backward alike.  Saves x and w."""

    @staticmethod
    def forward(ctx, x, w, kernel_size, dilation, padding, use_kernel):
        ctx.geometry = (kernel_size, dilation, padding, use_kernel)
        if use_kernel:
            x, w = x.contiguous(), w.contiguous()
            out = local_aggregate_hopper(x, w, kernel_size=kernel_size,
                                         dilation=dilation, padding=padding)
        else:
            out = local_aggregate_plain(_pad_input(x, padding, "zeros"), w,
                                        kernel_size, (1, 1), dilation)
        ctx.save_for_backward(x, w)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        kernel_size, dilation, padding, use_kernel = ctx.geometry
        need_dx, need_dw = ctx.needs_input_grad[:2]
        if use_kernel:
            # autograd may hand over a strided gradient
            dx, dw = local_aggregate_bwd_hopper(
                x, w, dy.contiguous(), kernel_size=kernel_size,
                dilation=dilation, padding=padding, need_dx=need_dx,
                need_dw=need_dw)
        else:
            ph, pw = padding
            dx, dw = local_aggregate_bwd_plain(
                _pad_input(x, padding, "zeros"), w, dy, kernel_size,
                dilation, need_dx=need_dx, need_dw=need_dw)
            if need_dx:
                dx = dx[..., ph:ph + x.shape[2], pw:pw + x.shape[3]]
        return dx, dw, None, None, None, None


class _AggregateStride1Affine(torch.autograd.Function):
    """The stride-1 aggregation with zero pad and the affine ``w*s + b``, as
    one autograd node: the Hopper kernels (``use_kernel``) or the plain
    versions, in forward and backward alike.  Saves x, w, s and b."""

    @staticmethod
    def forward(ctx, x, w, s, b, kernel_size, dilation, padding, use_kernel):
        ctx.geometry = (kernel_size, dilation, padding, use_kernel)
        if use_kernel:
            x, w, s, b = (t.contiguous() for t in (x, w, s, b))
            out = local_aggregate_hopper(x, w, s, b, kernel_size=kernel_size,
                                         dilation=dilation, padding=padding)
        else:
            out = local_aggregate_plain(_pad_input(x, padding, "zeros"), w,
                                        kernel_size, (1, 1), dilation, s, b)
        ctx.save_for_backward(x, w, s, b)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, w, s, b = ctx.saved_tensors
        kernel_size, dilation, padding, use_kernel = ctx.geometry
        need_dx = ctx.needs_input_grad[0]
        # dw, ds and db come out of one pass
        need_dw = any(ctx.needs_input_grad[1:4])
        if use_kernel:
            grads = local_aggregate_bwd_affine_hopper(
                x, w, s, b, dy.contiguous(), kernel_size=kernel_size,
                dilation=dilation, padding=padding, need_dx=need_dx,
                need_dw=need_dw)
        else:
            ph, pw = padding
            grads = local_aggregate_bwd_affine_plain(
                _pad_input(x, padding, "zeros"), w, s, b, dy, kernel_size,
                dilation, need_dx=need_dx, need_dw=need_dw)
            if need_dx:
                grads = (grads[0][..., ph:ph + x.shape[2],
                                  pw:pw + x.shape[3]],) + grads[1:]
        grads = tuple(g if need else None
                      for g, need in zip(grads, ctx.needs_input_grad))
        return grads + (None, None, None, None)


def local_aggregate(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    kernel_size=3,
    stride=1,
    padding=None,
    dilation=1,
    pad_mode: str = "zeros",
    impl: str = "auto",
    w_scale: Optional[torch.Tensor] = None,
    w_bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Position-specific K x K weighted aggregation (the CoT "local conv").

    Args:
      x: ``[N, C, H, W]`` input features (NCHW).
      w: ``[N, heads, Cw, K*K, Ho, Wo]`` per-position weights, ``C % Cw == 0``.
      kernel_size / stride / padding / dilation: conv-style geometry.  Default
        padding is SAME-for-odd-K: ``(dilation * (K - 1) + 1) // 2``.
      pad_mode: ``'zeros'`` or ``'reflect'``.
      impl: ``'auto'`` (the kernel for CUDA tensors, the plain version for
        CPU tensors), ``'hopper'`` (the kernel; raises for a CPU tensor) or
        ``'torch'`` (the plain version).  The kernel computes stride 1 only:
        a strided call takes the plain version under ``'auto'`` (counted in
        ``PLAIN_CALLS``; on the card with a ``RuntimeWarning`` once per
        geometry, ``PLAIN_FALLBACKS``), as the JAX package's ``auto`` takes
        XLA at any stride above 1, and raises under ``'hopper'``.
      w_scale / w_bias: optional ``[N, heads, Cw, K*K]`` float32 affine
        applied to ``w`` inside the op (``w*scale + bias``), the GroupNorm
        fold: the normalized weight is never materialized.  Differentiable
        like x and w.

    Returns:
      ``[N, heads*C, Ho, Wo]``; output channel ``head*C + c`` aggregates input
      channel ``c`` with weight channel ``c % Cw``.
    """
    kernel_size, stride, dilation = (_pair(kernel_size), _pair(stride),
                                     _pair(dilation))
    padding = _default_padding(padding, kernel_size, dilation)
    n, c, hi, wi = x.shape
    nw, heads, cw, k2, ho, wo = w.shape
    if nw != n:
        raise ValueError(f"batch mismatch: x {n} vs w {nw}")
    if k2 != kernel_size[0] * kernel_size[1]:
        raise ValueError(f"w K^2 dim {k2} != {kernel_size[0]}*"
                         f"{kernel_size[1]}")
    if c % cw != 0:
        raise ValueError(f"x channels {c} not divisible by weight channels "
                         f"{cw}")
    expect = (out_size(hi, kernel_size[0], stride[0], padding[0], dilation[0]),
              out_size(wi, kernel_size[1], stride[1], padding[1], dilation[1]))
    if (ho, wo) != expect:
        raise ValueError(f"weight spatial {(ho, wo)} != derived output "
                         f"{expect}")
    if (w_scale is None) != (w_bias is None):
        raise ValueError("w_scale and w_bias must be given together")
    if w_scale is not None:
        shape = (n, heads, cw, k2)
        if tuple(w_scale.shape) != shape or tuple(w_bias.shape) != shape:
            raise ValueError(f"affine shape {tuple(w_scale.shape)}/"
                             f"{tuple(w_bias.shape)} != {shape}")
    if impl not in ("auto", "hopper", "torch"):
        raise ValueError(f"unknown impl {impl!r}")
    if pad_mode not in ("zeros", "reflect"):
        raise ValueError(f"unknown pad_mode {pad_mode!r}")

    on_cuda = x.device.type == "cuda"
    if impl == "hopper" and not on_cuda:
        raise ValueError("impl='hopper' launches the CUDA kernel: x must be "
                         "a CUDA tensor")
    if impl == "hopper" and stride != (1, 1):
        raise NotImplementedError(
            "the Hopper kernel computes stride 1 only; pass impl='auto' or "
            "'torch' for the plain version of a strided call")
    use_kernel = impl != "torch" and on_cuda
    if stride != (1, 1):
        # the plain version alone; autograd differentiates its slices
        if use_kernel:
            _warn_plain_fallback("local_aggregate", f"stride {stride}", (
                str(x.dtype), tuple(x.shape), tuple(w.shape), stride))
        xp = _pad_input(x, padding, pad_mode)
        return local_aggregate_plain(xp, w, kernel_size, stride, dilation,
                                     w_scale, w_bias)
    if pad_mode == "reflect":
        # the fused pad is zero; reflect pads outside (and is differentiated
        # there), as the JAX package does for its TPU kernels
        x, padding = _pad_input(x, padding, pad_mode), (0, 0)
    if w_scale is not None:
        return _AggregateStride1Affine.apply(
            x, w, w_scale, w_bias, kernel_size, dilation, padding, use_kernel)
    return _AggregateStride1.apply(x, w, kernel_size, dilation, padding,
                                   use_kernel)


def embed_gn_key(x, w_pre, groups, dilation, padding) -> tuple:
    """The key under which ``EMBED_GN_LAUNCHES_BY_SHAPE`` counts a launch."""
    return (str(x.dtype).replace("torch.", ""), tuple(x.shape),
            tuple(w_pre.shape), int(groups), tuple(dilation), tuple(padding))


def local_aggregate_embed_gn_plain(x, w_pre, w2, b2, gamma, beta, kernel_size,
                                   dilation, padding, eps: float = 1e-5,
                                   groups: int = 1):
    """``local_aggregate_embed_gn`` in plain PyTorch, with the arithmetic of
    the TPU kernel (``_fused_embed_kernel``): ``w_raw = w_pre @ w2 + b2``
    accumulated in f32 and rounded to x's dtype (what the embed conv would
    have written), one-pass f32 statistics of that rounded tensor per
    (image, group, cw) over (K2, H, W), ``var = max(E[w^2] - E[w]^2, 0)``,
    the normalize as ``(w_raw - mean) * (inv * gamma) + beta``, f32 taps and
    one rounding of the output.  Shapes as ``local_aggregate_embed_gn``
    takes them, already checked; w2 is ``[F, Cp]``."""
    global PLAIN_EMBED_GN_CALLS
    PLAIN_EMBED_GN_CALLS += 1
    n, c, _, _ = x.shape
    _, _, ho, wo = w_pre.shape
    f, cp = w2.shape
    k2 = kernel_size[0] * kernel_size[1]
    fg = f // groups
    cwg = fg // k2
    acc = _acc_dtype(x)
    wp = w_pre.reshape(n, groups, cp, ho * wo).to(acc)
    w2g = w2.to(x.dtype).to(acc).reshape(groups, fg, cp)
    w_raw = torch.matmul(w2g, wp) + b2.to(acc).view(groups, fg, 1)
    w_raw = w_raw.to(x.dtype).to(acc).view(n * groups, cwg, k2 * ho * wo)
    mean = w_raw.mean(-1, keepdim=True)
    var = (w_raw.square().mean(-1, keepdim=True)
           - mean.square()).clamp_min(0.0)
    inv = torch.rsqrt(var + eps)

    def per_tap(v):      # [F] -> [N*groups, Cwg, K2, 1], image-major
        return v.to(acc).view(1, groups, cwg, k2, 1).expand(
            n, -1, -1, -1, -1).reshape(n * groups, cwg, k2, 1)

    wn = ((w_raw - mean).view(n * groups, cwg, k2, ho * wo)
          * (inv[..., None] * per_tap(gamma)) + per_tap(beta))
    xp = _pad_input(x, padding, "zeros")
    out = _aggregate_taps(
        xp.reshape(n * groups, c // groups, *xp.shape[2:]),
        wn.view(n * groups, 1, cwg, k2, ho, wo), kernel_size, (1, 1),
        dilation)
    return out.view(n, c, ho, wo)


def local_aggregate_embed_gn_hopper(x, w_pre, w2, b2, gamma, beta, *,
                                    kernel_size, dilation, padding,
                                    eps: float = 1e-5, groups: int = 1):
    """Launch the fused Hopper kernels (``csrc/local_agg_embed_gn.cu``),
    which form ``w_raw`` in registers, so the weight tensor is never stored.
    On the tiled routes (``embed_gn_route``) the aggregation kernel runs on
    the forward's halo tiles and, where a block holds whole planes, takes
    their statistics itself; where a plane spans several row tiles, and on
    the pointwise route, a statistics kernel runs first and writes partial
    sums to a float32 workspace that is allocated here only then
    (``embed_gn_workspace_bytes``).  One ``EMBED_GN_LAUNCHES`` a call.

    x ``[N, C, Hi, Wi]``, w_pre ``[N, groups*Cp, Ho, Wo]`` and w2
    ``[F, Cp]`` contiguous CUDA tensors of one dtype (f32/f16/bf16); b2,
    gamma, beta ``[F]`` float32.  The shapes are checked by
    ``local_aggregate_embed_gn``; this checks what the kernel needs
    besides.  Returns ``[N, C, Ho, Wo]``; records no autograd graph."""
    global EMBED_GN_LAUNCHES
    _check_kernel_tensors("local_aggregate_embed_gn_hopper",
                          [x, w_pre, w2, b2, gamma, beta], (x, w_pre, w2))
    _check_f32("b2/gamma/beta", b2, gamma, beta)
    kh, kw = kernel_size
    if kh * kw not in _EMBED_GN_TAPS:
        raise NotImplementedError(
            f"the fused embed kernel is compiled for K*K in "
            f"{_EMBED_GN_TAPS}, not {kh}x{kw}; pass impl='torch' for the "
            "plain version")
    n, c, _, _ = x.shape
    _, _, ho, wo = w_pre.shape
    geometry = dict(kernel_size=kernel_size, dilation=dilation,
                    padding=padding, groups=groups)
    fn = _embed_gn_kernel()
    out = torch.empty(n, c, ho, wo, dtype=x.dtype, device=x.device)
    nbytes = embed_gn_workspace_bytes(x, w_pre, w2, **geometry)
    partials = (torch.empty(nbytes // 4, dtype=torch.float32,
                            device=x.device) if nbytes else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(_DTYPE_CODES[x.dtype], x.data_ptr(), w_pre.data_ptr(),
                 w2.data_ptr(), b2.data_ptr(), gamma.data_ptr(),
                 beta.data_ptr(),
                 None if partials is None else partials.data_ptr(),
                 out.data_ptr(),
                 *_embed_gn_geometry(x, w_pre, w2, kernel_size, dilation,
                                     padding, groups),
                 float(eps), stream)
    if err != 0:
        raise RuntimeError(f"local_agg_embed_gn launch failed: cudaError "
                           f"{err}")
    EMBED_GN_LAUNCHES += 1
    key = embed_gn_key(x, w_pre, groups, dilation, padding)
    EMBED_GN_LAUNCHES_BY_SHAPE[key] = \
        EMBED_GN_LAUNCHES_BY_SHAPE.get(key, 0) + 1
    return out


def local_aggregate_embed_gn(
    x: torch.Tensor,
    w_pre: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    *,
    kernel_size=3,
    padding=None,
    dilation=1,
    eps: float = 1e-5,
    groups: int = 1,
    impl: str = "auto",
) -> torch.Tensor:
    """Embed conv + sub-channel GroupNorm + aggregation, fused (eval path).

    Computes ``w = GN(conv1x1(w_pre; w2, b2))`` (GroupNorm per (image, cw)
    over (K^2, H, W) with the per-channel affine gamma/beta: the CoT embed
    normalize) and aggregates ``x`` with it, heads = 1, stride 1, zero
    padding.  The weight tensor is never stored.

    Args:
      x: ``[N, C, H, W]`` values.
      w_pre: ``[N, groups*Cp, Ho, Wo]`` embed mid-activation.
      w2: ``[F, Cp]`` or ``[F, Cp, 1, 1]``, the 1x1 conv's weight as torch
        keeps it, ``F = groups * Cw * K^2`` output channels in cw-major
        order; the conv is grouped when ``groups > 1``.
      b2, gamma, beta: ``[F]``.
      groups: the layer's channel groups (CoXtLayer's ``dw_group``): group
        g aggregates x's g-th ``C/groups`` channels with the weight made
        from w_pre's g-th Cp channels.  The groups run as ``groups``
        consecutive images of a batch ``N*groups``, a view of the same
        memory, in one launch.
      impl: ``'auto'`` (the kernels for CUDA tensors at a K*K they are
        compiled for, ``_EMBED_GN_TAPS``, else the plain version, counted
        in ``PLAIN_EMBED_GN_CALLS`` and on the card warned about once per
        geometry), ``'hopper'`` (the kernels; raises
        for a CPU tensor or another K*K) or ``'torch'``.

    Eval only, as in the JAX package (its TPU kernel has no VJP): a call
    that would record a gradient raises.  w2 is cast to x's dtype and b2,
    gamma, beta to float32, as the TPU wrapper does.
    """
    kernel_size, dilation = _pair(kernel_size), _pair(dilation)
    padding = _default_padding(padding, kernel_size, dilation)
    if impl not in ("auto", "hopper", "torch"):
        raise ValueError(f"unknown impl {impl!r}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w_pre, w2, b2, gamma, beta)):
        raise NotImplementedError(
            "local_aggregate_embed_gn is the eval fusion and has no "
            "backward: run it under torch.no_grad(), or train through the "
            "embed conv, the GroupNorm and local_aggregate")
    if w2.dim() == 4 and tuple(w2.shape[2:]) == (1, 1):
        w2 = w2.reshape(w2.shape[0], w2.shape[1])
    if x.dim() != 4 or w_pre.dim() != 4 or w2.dim() != 2:
        raise ValueError(f"shapes x {tuple(x.shape)}, w_pre "
                         f"{tuple(w_pre.shape)}, w2 {tuple(w2.shape)}: need "
                         "[N,C,H,W], [N,groups*Cp,Ho,Wo], [F,Cp]")
    n, c, hi, wi = x.shape
    f, cp = w2.shape
    k2 = kernel_size[0] * kernel_size[1]
    if groups < 1 or f % (groups * k2) or c % groups:
        raise ValueError(f"F {f} and C {c} must divide into {groups} groups "
                         f"of Cw*{k2} and C/groups channels")
    cwg = f // (groups * k2)
    if (c // groups) % cwg:
        raise ValueError(f"x channels per group {c // groups} not divisible "
                         f"by weight channels {cwg}")
    expect = (n, groups * cp,
              out_size(hi, kernel_size[0], 1, padding[0], dilation[0]),
              out_size(wi, kernel_size[1], 1, padding[1], dilation[1]))
    if tuple(w_pre.shape) != expect:
        raise ValueError(f"w_pre shape {tuple(w_pre.shape)} != {expect}")
    if any(tuple(v.shape) != (f,) for v in (b2, gamma, beta)):
        raise ValueError(f"b2/gamma/beta must have shape ({f},)")
    on_cuda = x.device.type == "cuda"
    if impl == "hopper" and not on_cuda:
        raise ValueError("impl='hopper' launches the CUDA kernels: x must "
                         "be a CUDA tensor")
    args = (x, w_pre, w2.to(x.dtype), b2.float(), gamma.float(), beta.float())
    geometry = dict(kernel_size=kernel_size, dilation=dilation,
                    padding=padding, eps=eps, groups=groups)
    # the kernel holds the taps in registers for the K*K in _EMBED_GN_TAPS
    # only: elsewhere 'auto' takes the plain version, as the JAX package's
    # embed op falls back to plain jnp where its Pallas plan does not apply
    compiled = k2 in _EMBED_GN_TAPS
    if impl == "hopper" or (impl == "auto" and on_cuda and compiled):
        return local_aggregate_embed_gn_hopper(
            *(t.contiguous() for t in args), **geometry)
    if impl == "auto" and on_cuda:
        _warn_plain_fallback("local_aggregate_embed_gn", f"{k2} taps", (
            str(x.dtype), tuple(x.shape), tuple(w_pre.shape), k2))
    return local_aggregate_embed_gn_plain(*args, **geometry)


# ---- the dual-kernel ("mix") aggregation -----------------------------------

# the fused geometry: a 3x3 and a 5x5 kernel, SAME zero pad, stride 1,
# dilation 1 (the reference's LocalConvolutionMix asserts it)
_MIX_TAPS = (9, 25)


def _mix_halves(w1, w2):
    """``(w1, w2)``; ``w2`` None means ``w1`` is the merged weight
    ``[N, heads, Cw, 9 + 25, H, W]``, whose two tap ranges are returned as
    views."""
    if w2 is None:
        return w1[:, :, :, :_MIX_TAPS[0]], w1[:, :, :, _MIX_TAPS[0]:]
    return w1, w2


def _mix_tap_offsets(kk):
    """(tap, row offset, col offset) of a kk x kk SAME kernel in x padded by
    2 on each side, taps in (kh, kw) order."""
    off = 2 - kk // 2
    return [(ikh * kk + ikw, off + ikh, off + ikw)
            for ikh in range(kk) for ikw in range(kk)]


def local_aggregate_mix_plain(x, w1, w2=None):
    """The fused-geometry mix in plain PyTorch: x ``[N, C, H, W]``, w1
    ``[N, heads, Cw, 9, H, W]``, w2 ``[N, heads, Cw, 25, H, W]`` (or w1 the
    merged weight and w2 None) -> ``[N, 2*heads*C, H, W]``, kernel-major.
    Each half as ``local_aggregate_plain`` computes it: f32 taps, one
    rounding per output."""
    global PLAIN_MIX_CALLS
    PLAIN_MIX_CALLS += 1
    w1, w2 = _mix_halves(w1, w2)
    return torch.cat([
        _aggregate_taps(_pad_input(x, (p, p), "zeros"), w, (k, k), (1, 1),
                        (1, 1))
        for w, k, p in ((w1, 3, 1), (w2, 5, 2))], dim=1)


def local_aggregate_mix_bwd_plain(x, w1, w2, dy, need_dx: bool = True,
                                  need_dw: bool = True):
    """Gradients of ``local_aggregate_mix_plain`` in plain PyTorch, with the
    TPU kernels' arithmetic (``_mix_dx_kernel``, ``_mix_dw_kernel``): dy
    ``[N, 2*heads*C, H, W]`` -> ``(dx, dw1, dw2)`` of the shapes and dtypes
    of x, w1 and w2, or ``(dx, dw, None)`` with dw merged when w2 is None.
    dx sums both halves in one f32 buffer and is rounded once; each dw tap
    is the f32 sum over the C/Cw channel groups.  What is not needed is
    None."""
    global PLAIN_MIX_CALLS
    PLAIN_MIX_CALLS += 1
    merged = w2 is None
    w1, w2 = _mix_halves(w1, w2)
    n, c, h, wd = x.shape
    _, heads, cw, _, _, _ = w1.shape
    g = c // cw
    acc = _acc_dtype(x)
    dyv = dy.to(acc).reshape(n, 2, heads, g, cw, h, wd)
    dxp = dws = None
    if need_dx:
        dxp = torch.zeros(n, g, cw, h + 4, wd + 4, dtype=acc, device=x.device)
    if need_dw:
        xv = _pad_input(x, (2, 2), "zeros").to(acc).reshape(
            n, 1, g, cw, h + 4, wd + 4)
        dws = []
    for half, (w, kk) in enumerate(((w1, 3), (w2, 5))):
        dyh = dyv[:, half]
        if need_dx:
            wf = w.to(acc)
        if need_dw:
            dw = torch.empty(w.shape, dtype=acc, device=x.device)
        for k, oh, ow in _mix_tap_offsets(kk):
            if need_dw:
                dw[:, :, :, k] = (xv[..., oh:oh + h, ow:ow + wd]
                                  * dyh).sum(2)
            if need_dx:
                dxp[..., oh:oh + h, ow:ow + wd] += (
                    wf[:, :, None, :, k] * dyh).sum(1)
        if need_dw:
            dws.append(dw.to(w.dtype))
    dx = dw1 = dw2 = None
    if need_dx:
        dx = dxp[..., 2:2 + h, 2:2 + wd].reshape(n, c, h, wd).to(x.dtype)
    if need_dw:
        dw1, dw2 = (torch.cat(dws, dim=3), None) if merged else dws
    return dx, dw1, dw2


def _mix_fwd_kernel(pointwise: bool = False):
    name = ("local_agg_mix_fwd_pointwise_launch" if pointwise
            else "local_agg_mix_fwd_launch")
    return _c_function(_MIX_LIB_NAME, name,
                       [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                        ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                        ctypes.c_void_p] + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])


def _mix_bwd_kernel(pointwise: bool = False):
    name = ("local_agg_mix_bwd_pointwise_launch" if pointwise
            else "local_agg_mix_bwd_launch")
    return _c_function(_MIX_LIB_NAME, name,
                       [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                        ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
                       + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])


def mix_key(x, w1, w2) -> tuple:
    """The key under which ``MIX_LAUNCHES_BY_SHAPE`` counts a launch: dtype,
    x shape, heads, Cw, and whether the weight was merged."""
    return (str(x.dtype).replace("torch.", ""), tuple(x.shape),
            int(w1.shape[1]), int(w1.shape[2]), w2 is None)


def mix_route(kernel: str, x, w1, w2=None) -> str:
    """The route (``"tiles"`` or ``"pointwise"``) that a launch of the mix's
    ``kernel`` (``"fwd"``, ``"dx"`` or ``"dw"``) takes for x
    ``[N, C, H, W]`` and the weights as ``local_aggregate_mix_hopper`` takes
    them, in x's dtype, as its launcher decides it from the geometry before
    it launches.  Reads only shapes and dtype; builds the kernels'
    library."""
    if kernel not in ("fwd", "dx", "dw"):
        raise ValueError(f"the mix's routed kernels are fwd, dx and dw, not "
                         f"{kernel!r}")
    _check_mix_shapes(x, w1, w2)
    fn = _c_function(_MIX_LIB_NAME, f"local_agg_mix_{kernel}_variant",
                     [ctypes.c_int] * 7)
    n, c, h, w = x.shape
    return ROUTES[fn(_DTYPE_CODES[x.dtype], n, c, h, w, int(w1.shape[1]),
                     int(w1.shape[2]))]


def _mix_pointers(t1, t2):
    """(pointer, taps per row) of each half of a weight or its gradient:
    the two tensors as they are, or one merged tensor's two tap ranges."""
    if t2 is None:
        plane = t1.shape[4] * t1.shape[5] * t1.element_size()
        rows = sum(_MIX_TAPS)
        return t1.data_ptr(), rows, t1.data_ptr() + _MIX_TAPS[0] * plane, rows
    return t1.data_ptr(), _MIX_TAPS[0], t2.data_ptr(), _MIX_TAPS[1]


def _check_mix_kernel_tensors(who, x, w1, w2, dy=None):
    """What the mix kernels take: contiguous CUDA tensors of one dtype, the
    shapes ``_check_mix_shapes`` takes, and dy's."""
    tensors = [t for t in (x, w1, w2, dy) if t is not None]
    _check_kernel_tensors(who, tensors, tensors)
    _check_mix_shapes(x, w1, w2)
    n, c, h, w = x.shape
    if dy is not None and tuple(dy.shape) != (n, 2 * w1.shape[1] * c, h, w):
        raise ValueError(f"{who}: dy shape {tuple(dy.shape)} != "
                         f"{(n, 2 * w1.shape[1] * c, h, w)}")


def _count_mix(kernel, key):
    MIX_LAUNCHES[kernel] += 1
    MIX_LAUNCHES_BY_SHAPE[(kernel, key)] = \
        MIX_LAUNCHES_BY_SHAPE.get((kernel, key), 0) + 1


def local_aggregate_mix_hopper(x, w1, w2=None, *, pointwise: bool = False):
    """Launch ``local_agg_mix_fwd`` (``csrc/local_agg_mix.cu``) on the route
    ``mix_route`` names (``pointwise=True``: on the pointwise route whatever
    the geometry, to hold the tiles against it): x ``[N, C, H, W]``, w1
    ``[N, heads, Cw, 9, H, W]``, w2 ``[N, heads, Cw, 25, H, W]``, or w1 the
    merged ``[N, heads, Cw, 34, H, W]`` and w2 None; contiguous CUDA tensors
    of one dtype (f32/f16/bf16).  Returns ``[N, 2*heads*C, H, W]``,
    kernel-major; records no autograd graph."""
    _check_mix_kernel_tensors("local_aggregate_mix_hopper", x, w1, w2)
    n, c, h, w = x.shape
    heads, cw = w1.shape[1], w1.shape[2]
    fn = _mix_fwd_kernel(pointwise)
    out = torch.empty(n, 2 * heads * c, h, w, dtype=x.dtype, device=x.device)
    p1, rows1, p2, rows2 = _mix_pointers(w1, w2)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(_DTYPE_CODES[x.dtype], x.data_ptr(), p1, rows1, p2, rows2,
                 out.data_ptr(), n, c, h, w, heads, cw, stream)
    if err != 0:
        raise RuntimeError(f"local_agg_mix_fwd launch failed: cudaError {err}")
    _count_mix("fwd", mix_key(x, w1, w2))
    return out


def local_aggregate_mix_bwd_hopper(x, w1, w2, dy, *, need_dx: bool = True,
                                   need_dw: bool = True,
                                   pointwise: bool = False):
    """Launch the mix backward kernels ``local_agg_mix_dx`` and
    ``local_agg_mix_dw``, each only when its gradient is needed, on the
    route ``mix_route`` names (``pointwise=True``: on the pointwise route
    whatever the geometry, to hold the tiles against it).  Tensors as
    ``local_aggregate_mix_hopper`` takes them, and dy
    ``[N, 2*heads*C, H, W]``.  Returns ``(dx, dw1, dw2)``, or
    ``(dx, dw, None)`` with dw merged when w2 is None; what is not needed
    is None."""
    _check_mix_kernel_tensors("local_aggregate_mix_bwd_hopper", x, w1, w2,
                              dy)
    if not (need_dx or need_dw):
        return None, None, None
    n, c, h, w = x.shape
    heads, cw = w1.shape[1], w1.shape[2]
    fn = _mix_bwd_kernel(pointwise)
    dx = torch.empty_like(x) if need_dx else None
    dw1 = dw2 = None
    if need_dw:
        dw1 = torch.empty_like(w1)
        dw2 = None if w2 is None else torch.empty_like(w2)
    p1, rows1, p2, rows2 = _mix_pointers(w1, w2)
    g1, _, g2, _ = _mix_pointers(dw1, dw2) if need_dw else (None,) * 4
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(_DTYPE_CODES[x.dtype], x.data_ptr(), p1, rows1, p2, rows2,
                 dy.data_ptr(), dx.data_ptr() if need_dx else None, g1, g2,
                 n, c, h, w, heads, cw, stream)
    if err != 0:
        raise RuntimeError(f"local_agg_mix backward launch failed: cudaError "
                           f"{err}")
    key = mix_key(x, w1, w2)
    for kernel, launched in (("dx", need_dx), ("dw", need_dw)):
        if launched:
            _count_mix(kernel, key)
    return dx, dw1, dw2


class _AggregateMix(torch.autograd.Function):
    """The fused-geometry mix as one autograd node: the Hopper kernels
    (``use_kernel``) or the plain versions, in forward and backward alike.
    ``w2`` None means ``w1`` is the merged weight, whose gradient then
    comes back merged.  Saves x, w1 and w2."""

    @staticmethod
    def forward(ctx, x, w1, w2, use_kernel):
        ctx.use_kernel = use_kernel
        if use_kernel:
            x, w1 = x.contiguous(), w1.contiguous()
            w2 = None if w2 is None else w2.contiguous()
            out = local_aggregate_mix_hopper(x, w1, w2)
        else:
            out = local_aggregate_mix_plain(x, w1, w2)
        ctx.save_for_backward(x, w1, w2)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, w1, w2 = ctx.saved_tensors
        need_dx, need_w1, need_w2 = ctx.needs_input_grad[:3]
        # one kernel writes both weight gradients
        kwargs = dict(need_dx=need_dx, need_dw=need_w1 or need_w2)
        if ctx.use_kernel:
            # autograd may hand over a strided gradient
            dx, dw1, dw2 = local_aggregate_mix_bwd_hopper(
                x, w1, w2, dy.contiguous(), **kwargs)
        else:
            dx, dw1, dw2 = local_aggregate_mix_bwd_plain(x, w1, w2, dy,
                                                         **kwargs)
        return (dx, dw1 if need_w1 else None, dw2 if need_w2 else None,
                None)


def _mix_use_kernel(x, impl):
    if impl not in ("auto", "hopper", "torch"):
        raise ValueError(f"unknown impl {impl!r}")
    on_cuda = x.device.type == "cuda"
    if impl == "hopper" and not on_cuda:
        raise ValueError("impl='hopper' launches the CUDA kernels: x must be "
                         "a CUDA tensor")
    return impl != "torch" and on_cuda


def _mix_fused_geometry(kernel_size1, kernel_size2, stride, padding1,
                        padding2, dilation, pad_mode) -> bool:
    """The geometry of the fused kernels (JAX ``local_agg.py:470-477``): 3x3
    and 5x5, SAME zero pad, stride 1, dilation 1."""
    return (pad_mode == "zeros" and _pair(stride) == (1, 1)
            and _pair(dilation) == (1, 1)
            and _pair(kernel_size1) == (3, 3)
            and _pair(kernel_size2) == (5, 5)
            and padding1 in (None, 1, (1, 1))
            and padding2 in (None, 2, (2, 2)))


def _check_mix_shapes(x, w1, w2):
    """w1 ``[N, heads, Cw, 9, H, W]`` and w2 ``[N, heads, Cw, 25, H, W]``
    for x ``[N, C, H, W]``, or w1 the merged ``[N, heads, Cw, 34, H, W]``
    and w2 None."""
    n, c, h, w = x.shape
    if w2 is None:
        want = [(n, w1.shape[1], w1.shape[2], sum(_MIX_TAPS), h, w)]
    else:
        want = [(n, w1.shape[1], w1.shape[2], k, h, w) for k in _MIX_TAPS]
    got = [tuple(t.shape) for t in (w1, w2) if t is not None]
    if got != want or c % w1.shape[2]:
        raise ValueError(f"x {tuple(x.shape)} with weights {got}: need "
                         f"{want} and Cw dividing C")


def local_aggregate_mix(
    x: torch.Tensor,
    w1: torch.Tensor,
    w2: torch.Tensor,
    *,
    kernel_size1=3,
    kernel_size2=5,
    stride=1,
    padding1=None,
    padding2=None,
    dilation=1,
    pad_mode: str = "zeros",
    impl: str = "auto",
) -> torch.Tensor:
    """Dual-kernel aggregation: ``x`` aggregated with the K1 x K1 weight
    ``w1`` and the K2 x K2 weight ``w2``, concatenated on channels.

    Args:
      x: ``[N, C, H, W]``.
      w1, w2: ``[N, heads, Cw, K1*K1, Ho, Wo]`` and
        ``[N, heads, Cw, K2*K2, Ho, Wo]``.
      kernel_size1/2, stride, padding1/2, dilation, pad_mode: as
        ``local_aggregate``'s, for each half.
      impl: ``'auto'`` (the kernels for CUDA tensors, the plain version for
        CPU tensors), ``'hopper'`` (the kernels; raises for a CPU tensor)
        or ``'torch'`` (the plain version).

    Returns:
      ``[N, 2*heads*C, Ho, Wo]``, kernel-major: channel
      ``(half*heads + head)*C + c``, half 0 the K1 aggregation.

    On the fused geometry (3x3 and 5x5, SAME zero pad, stride 1, dilation
    1) one launch per pass computes both halves (``_AggregateMix``): x is
    read once, the halves are written into one buffer, and dx sums both
    halves before its one rounding.  Any other geometry is two
    ``local_aggregate`` calls and a ``torch.cat``, as in the JAX package.
    """
    use_kernel = _mix_use_kernel(x, impl)
    if _mix_fused_geometry(kernel_size1, kernel_size2, stride, padding1,
                           padding2, dilation, pad_mode):
        _check_mix_shapes(x, w1, w2)
        return _AggregateMix.apply(x, w1, w2, use_kernel)
    common = dict(stride=stride, dilation=dilation, pad_mode=pad_mode,
                  impl=impl)
    return torch.cat([
        local_aggregate(x, w1, kernel_size=kernel_size1, padding=padding1,
                        **common),
        local_aggregate(x, w2, kernel_size=kernel_size2, padding=padding2,
                        **common)], dim=1)


def local_aggregate_mix_merge(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    kernel_size1=3,
    kernel_size2=5,
    stride=1,
    padding1=None,
    padding2=None,
    dilation=1,
    pad_mode: str = "zeros",
    impl: str = "auto",
) -> torch.Tensor:
    """``local_aggregate_mix`` with one packed weight ``w``
    ``[N, heads, Cw, K1*K1 + K2*K2, Ho, Wo]``, the K1 taps first.  On the
    fused geometry the kernels read (and the backward writes) the packed
    tensor in place: nothing is copied."""
    use_kernel = _mix_use_kernel(x, impl)
    if _mix_fused_geometry(kernel_size1, kernel_size2, stride, padding1,
                           padding2, dilation, pad_mode):
        _check_mix_shapes(x, w, None)
        return _AggregateMix.apply(x, w, None, use_kernel)
    k1sq = _pair(kernel_size1)[0] * _pair(kernel_size1)[1]
    return local_aggregate_mix(
        x, w[:, :, :, :k1sq], w[:, :, :, k1sq:], kernel_size1=kernel_size1,
        kernel_size2=kernel_size2, stride=stride, padding1=padding1,
        padding2=padding2, dilation=dilation, pad_mode=pad_mode, impl=impl)


def local_aggregate_dilated(
    x: torch.Tensor,
    w: torch.Tensor,
    dilations,
    *,
    kernel_size=3,
    stride=1,
    padding=None,
    pad_mode: str = "zeros",
    impl: str = "auto",
) -> torch.Tensor:
    """Per-weight-channel dilation: weight channel ``cw`` aggregates its
    neighbourhood at dilation ``dilations[cw]``, SAME-padded at that
    dilation, so every channel keeps the input's size (JAX
    ``local_agg.py:521-560``).  ``padding`` is ignored, as there.

    One ``local_aggregate`` per distinct dilation (on the card the forward
    kernel, and the backward kernels under autograd); each result is
    multiplied by its 0/1 channel mask and summed in f32 (f64 for f64), and
    the sum is cast once to x's dtype.  It has no kernel of its own: the
    JAX package has none either."""
    del padding
    dilations = tuple(int(d) for d in dilations)
    cw = w.shape[2]
    if len(dilations) != cw:
        raise ValueError(f"need one dilation per weight channel ({cw}), got "
                         f"{len(dilations)}")
    c = x.shape[1]
    heads = w.shape[1]
    acc = _acc_dtype(x)
    out = None
    for d in sorted(set(dilations)):
        yd = local_aggregate(x, w, kernel_size=kernel_size, stride=stride,
                             padding=None, dilation=d, pad_mode=pad_mode,
                             impl=impl)
        # output channel head*C + c uses dilation dilations[c % Cw]
        cw_mask = torch.tensor([dd == d for dd in dilations], dtype=acc,
                               device=x.device)
        mask = cw_mask.repeat(heads * c // cw).view(1, -1, 1, 1)
        out = yd * mask if out is None else out + yd * mask
    return out.to(x.dtype)
