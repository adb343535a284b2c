"""The plain aggregation at SAN19's K = 7 geometry class against the JAX package.

On the card the ``k7`` forward, dx and dw kernels (``csrc/k7_tiles.cuh``)
run at K = 7, dilation 1, zero padding 3, one head and Cw = C/8, and the
kernel phase of ``chip_smoke.py`` holds them against the plain version.
These tests pin that plain version to ``cotnet_tpu.ops.local_agg`` (its
XLA form, jitted, and ``jax.vjp`` of it) at SAN19's four maps and at the
tiles' edges, from the same seeded numpy inputs, in f32: within 1e-5 of
the reference's largest value (f32 sums in another order).  dx and dw
take their reference from one ``jax.vjp`` a geometry.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cotnet_tpu.ops.local_agg import local_aggregate as jax_aggregate  # noqa: E402
from cotnet_tpu_torch.ops import local_agg as la  # noqa: E402
from test_torch_hopper_gpu import make_inputs, to_nhwc, to_port  # noqa: E402

# (N, C, H, W): SAN19's stages 1-4 (56, 28, 14, 7) at N = 1 and C = 16-32,
# then the k7 tiles' edges: an odd map whose width is no multiple of the
# thread's four positions, and a map smaller than one row tile
K7_GEOMETRIES = {
    "san19_56x56": (1, 16, 56, 56),
    "san19_28x28": (1, 16, 28, 28),
    "san19_14x14": (1, 32, 14, 14),
    "san19_7x7": (1, 32, 7, 7),
    "odd_13x11": (2, 16, 13, 11),
    "small_5x5": (2, 16, 5, 5),
}


# the JAX package's XLA form at these taps, jitted where it is called: one
# compile a shape, not one for each of its 49 taps' pads and slices
_jax_k7 = functools.partial(jax_aggregate, kernel_size=7, padding=3,
                            impl="xla")


def _inputs(case, seed):
    n, c, h, w = K7_GEOMETRIES[case]
    x, wt, _, _, pad = make_inputs(seed, n=n, c=c, cw=c // 8, hi=h, wi=w,
                                   k=7)
    assert pad == 3
    return x, wt


def _close(got, ref, what):
    ref = np.asarray(ref)
    err = float(np.abs(got - ref).max())
    assert err <= 1e-5 * float(np.abs(ref).max()), (what, err)


@pytest.mark.parametrize("case", sorted(K7_GEOMETRIES))
def test_k7_plain_forward_matches_jax(case):
    """The plain forward (the card's oracle for the k7 forward) against
    the JAX package's XLA form."""
    x, w = _inputs(case, seed=70)
    ref = jax.jit(_jax_k7)(jnp.asarray(x), jnp.asarray(w))
    xt, wt, _, _ = to_port(x, w)
    calls = la.PLAIN_CALLS
    got = la.local_aggregate(xt, wt, kernel_size=7, padding=3, impl="torch")
    assert la.PLAIN_CALLS == calls + 1
    _close(to_nhwc(got), ref, "forward")


@functools.lru_cache(maxsize=None)
def _backward(case):
    """The inputs (seed 71), a seeded r (seed 72), the JAX gradients of
    ``sum(out * r)`` with respect to x and w from one ``jax.vjp`` of the
    XLA form, and the port's plain backward of the same sum through
    autograd: (jax dx, jax dw, port dx, port dw, the plain backward calls
    it made)."""
    x, w = _inputs(case, seed=71)
    r = np.random.RandomState(72).randn(*x.shape).astype(np.float32)
    backward = jax.jit(lambda x_, w_, r_: jax.vjp(_jax_k7, x_, w_)[1](r_))
    ref_dx, ref_dw = backward(jnp.asarray(x), jnp.asarray(w), jnp.asarray(r))
    xt, wt, _, _ = to_port(x, w)
    xt.requires_grad_()
    wt.requires_grad_()
    got = la.local_aggregate(xt, wt, kernel_size=7, padding=3, impl="torch")
    calls = la.PLAIN_BWD_CALLS
    (got * torch.from_numpy(np.ascontiguousarray(
        r.transpose(0, 3, 1, 2)))).sum().backward()
    return (np.asarray(ref_dx), np.asarray(ref_dw), xt.grad, wt.grad,
            la.PLAIN_BWD_CALLS - calls)


@pytest.mark.parametrize("case", sorted(K7_GEOMETRIES))
def test_k7_plain_dx_matches_jax_grad(case):
    """The plain backward's dx (the card's oracle for the k7 dx) against
    the gradient of the XLA form, for ``sum(out * r)`` with a seeded r."""
    ref_dx, _, got_dx, _, calls = _backward(case)
    assert calls == 1
    _close(to_nhwc(got_dx), ref_dx, "dx")


@pytest.mark.parametrize("case", sorted(K7_GEOMETRIES))
def test_k7_plain_dw_matches_jax_grad(case):
    """The plain backward's dw (the card's oracle for the k7 dw) against
    the gradient of the XLA form with respect to w, for the same sum."""
    _, ref_dw, _, got_dw, calls = _backward(case)
    assert calls == 1
    # cw-major back to the JAX package's k-major layout
    _close(got_dw.numpy().transpose(0, 4, 5, 1, 3, 2), ref_dw, "dw")
