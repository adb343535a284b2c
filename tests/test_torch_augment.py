"""Parity of the port's augmentation (``cotnet_tpu_torch.data``'s device ops,
RandAugment, AutoAugment, AugMix, RandomErasing and the host PIL policies)
with the JAX package's, on the CPU.

Random draws cannot match across the frameworks, so each device policy is
held *given JAX's draws*: the test repeats the JAX class's key splitting
(``rand_augment.py:299-335``, ``auto_augment.py:114-136, 154-188``,
``random_erasing.py:33-72``) to read the values it drew, hands them to the
port's ``apply`` and compares with the JAX class's output.  The port's own
draws are checked for their laws.

Tolerances on the 0-255 scale (``test_torch_hopper_gpu.aug_op_tol``, which
the card's tests share), by the rounding that sets them:
- exact: invert, posterize, solarize, solarize_add, equalize, cutout (the
  same integer-valued arithmetic), autocontrast (``(x - lo) * scale``: no
  product and sum for a compiler to fuse), the translations (whole-pixel
  and ``0.45 w`` shifts of integer inputs) and RandomErasing;
- the blends (color, contrast, brightness, sharpness): 4 ulps at 255,
  6.1e-5.  XLA's CPU backend contracts ``a + f * (b - a)`` (and ``lvl *
  1.8 + 0.1``) into one fused multiply-add, one rounding where torch
  makes two;
- the affine ops (rotate, shears, relative translations): four roundings
  of a sample coordinate, a sum up to twice the image size (the same
  fusion; rotate's cos and sin within an ulp), times the largest bilinear
  slope, 255 a pixel: 3.9e-3 at 17x23, 3.1e-2 at 224;
- the policies, chains of ops: three times the affine bound (a later
  enhance factor of up to 2.8 carries it), on all but 0.1% of the
  elements.  A value that differs by a rounding may cross a floor or a
  threshold of a later op (posterize's ``floor(x / q)``, solarize's
  threshold, equalize's integer bin, the gray's floor) and come out a
  step apart.
"""

import functools
import random
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
pytest.importorskip("PIL")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from PIL import Image  # noqa: E402

import cotnet_tpu.data.auto_augment as jax_aa  # noqa: E402
import cotnet_tpu.data.host_augment as jax_host  # noqa: E402
import cotnet_tpu.data.rand_augment as jax_ra  # noqa: E402
from cotnet_tpu.data.random_erasing import RandomErasing as JaxErasing  # noqa: E402
from cotnet_tpu_torch.data import auto_augment as port_aa  # noqa: E402
from cotnet_tpu_torch.data import host_augment as port_host  # noqa: E402
from cotnet_tpu_torch.data import policies  # noqa: E402
from cotnet_tpu_torch.data import rand_augment as port_ra  # noqa: E402
from cotnet_tpu_torch.data.random_erasing import RandomErasing  # noqa: E402
from test_torch_hopper_gpu import assert_chain_close, aug_op_tol  # noqa: E402

N, H, W = 4, 17, 23


def images(seed, n=N, h=H, w=W):
    """Seeded uint8-valued f32 images, NHWC."""
    return np.random.RandomState(seed).randint(
        0, 256, (n, h, w, 3)).astype(np.float32)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def to_nchw(y):
    return np.asarray(y).transpose(0, 3, 1, 2)


def tensors(**arrays):
    return {k: torch.from_numpy(np.array(v)) for k, v in arrays.items()}


def cutout_xy(key, h=H, w=W):
    """The centre JAX's cutout draws from its key (``rand_augment.py``'s
    ``cutout``)."""
    kx, ky = jax.random.split(key)
    return jnp.stack([
        jax.random.uniform(kx, (), minval=0.0, maxval=float(w)),
        jax.random.uniform(ky, (), minval=0.0, maxval=float(h))])


# ---- the 25 ops ------------------------------------------------------------

@functools.cache
def jax_apply_op():
    return jax.jit(jax.vmap(jax_ra._apply_op, in_axes=(None, 0, 0, 0, 0)))


@pytest.mark.parametrize("name", policies.OP_NAMES)
def test_apply_op_matches_jax(name):
    """Each of ``_apply_op``'s 25 branches at three levels (one past the
    RandAugment maximum of 10) and both signs, cutout at JAX's draws."""
    op = policies.OP_IDX[name]
    x = images(0)
    keys = jax.random.split(jax.random.PRNGKey(1), N)
    xy = torch.from_numpy(np.array(jax.vmap(cutout_xy)(keys)))
    for level in (2.0, 7.5, 13.7):
        for sign in (1.0, -1.0):
            lv = np.full(N, level, np.float32)
            sg = np.full(N, sign, np.float32)
            ref = to_nchw(jax_apply_op()(op, x, lv, sg, keys))
            got = port_ra.apply_op(op, nchw(x), torch.from_numpy(lv),
                                   torch.from_numpy(sg), xy).numpy()
            np.testing.assert_allclose(got, ref, rtol=0,
                                       atol=aug_op_tol(name, H, W),
                                       err_msg=f"{name} {level} {sign}")


def test_apply_ops_runs_each_op_on_its_samples():
    """``apply_ops`` with a different op per sample, and -1 (skipped),
    equals each sample through its own op."""
    x = nchw(images(2, n=6))
    ops = [3, -1, 1, 3, 15, 8]
    level = torch.tensor([5.0, 6.0, 7.0, 8.0, 9.0, 10.0])
    sign = torch.tensor([1.0, -1.0, 1.0, -1.0, 1.0, -1.0])
    xy = torch.rand((6, 2), generator=torch.Generator().manual_seed(0)) * 10
    got = port_ra.apply_ops(x, ops, level, sign, xy)
    for i, op in enumerate(ops):
        want = x[i:i + 1] if op < 0 else port_ra.apply_op(
            op, x[i:i + 1], level[i:i + 1], sign[i:i + 1], xy[i:i + 1])
        torch.testing.assert_close(got[i:i + 1], want, rtol=0, atol=0)
    assert port_ra.apply_ops(x, [-1] * 6, level, sign, xy) is x


# ---- the policies given JAX's draws ------------------------------------------

def rand_augment_draws(aug, rng, n=N):
    """JAX RandAugment's draws for a batch, ``[layers, n]`` as the port's
    ``RandAugment.draw`` returns them."""
    def one(key):
        out = []
        for _ in range(aug.num_layers):
            key, k_op, k_mag, k_sign, k_p1, k_p2, k_cut = jax.random.split(
                key, 7)
            if aug.weights is not None:
                op = jax.random.choice(k_op, jax_ra.N_BASE_OPS,
                                       p=jnp.asarray(aug.weights))
            else:
                op = jax.random.randint(k_op, (), 0, jax_ra.N_BASE_OPS)
            mag = aug.magnitude
            if aug.magnitude_std > 0:
                mag = mag + jax.random.normal(k_mag) * aug.magnitude_std
            mag = jnp.clip(mag, 0.0, aug.max_magnitude)
            sign = jnp.where(jax.random.bernoulli(k_sign), 1.0, -1.0)
            u1 = jax.random.uniform(k_p1)
            u2 = jax.random.uniform(k_p2, minval=aug.min_prob,
                                    maxval=aug.max_prob)
            out.append((op, mag, sign, u1 <= u2, cutout_xy(k_cut)))
        return [jnp.stack(v) for v in zip(*out)]

    op, mag, sign, gate, xy = (np.asarray(v).swapaxes(0, 1) for v in
                               jax.jit(jax.vmap(one))(
                                   jax.random.split(rng, n)))
    return tensors(op=op.astype(np.int64), mag=mag, sign=sign, apply=gate,
                   xy=xy)


@pytest.mark.parametrize("config", ["rand-m15-mstd0.5-n2", "rand-m9-n3-w0"])
def test_rand_augment_given_jax_draws(config):
    jax_aug = jax_ra.rand_augment_transform(config)
    aug = port_ra.rand_augment_transform(config)
    x = images(3, n=8)
    rng = jax.random.PRNGKey(4)
    ref = to_nchw(jax.jit(jax_aug)(rng, x))
    draws = rand_augment_draws(jax_aug, rng, n=8)
    assert_chain_close(aug.apply(nchw(x), draws).numpy(), ref)


def auto_augment_draws(aug, rng, n=N):
    def one(key):
        k_sub, k_ops = jax.random.split(key)
        sub = jax.random.randint(k_sub, (), 0, aug.n_sub)
        out = []
        for slot in range(2):
            k_ops, k_p, k_sign, k_cut = jax.random.split(k_ops, 4)
            mag = aug.mag[sub, slot]
            sign = jnp.where(jax.random.bernoulli(k_sign), 1.0, -1.0)
            if aug.magnitude_std > 0:
                k_ops, k_mag = jax.random.split(k_ops)
                mag = jnp.clip(mag + aug.magnitude_std
                               * jax.random.normal(k_mag), 0.0, 10.0)
            out.append((jax.random.uniform(k_p) < aug.prob[sub, slot], sign,
                        mag, cutout_xy(k_cut)))
        return [sub] + [jnp.stack(v) for v in zip(*out)]

    sub, gate, sign, mag, xy = (np.asarray(v) for v in jax.jit(jax.vmap(
        one))(jax.random.split(rng, n)))
    return tensors(sub=sub.astype(np.int64), apply=gate.T, sign=sign.T,
                   mag=mag.T, xy=xy.swapaxes(0, 1))


def test_auto_augment_given_jax_draws():
    jax_aug = jax_aa.auto_augment_transform("v0-mstd0.5")
    aug = port_aa.auto_augment_transform("v0-mstd0.5")
    x = images(5, n=8)
    rng = jax.random.PRNGKey(6)
    ref = to_nchw(jax.jit(jax_aug)(rng, x))
    assert_chain_close(aug.apply(nchw(x), auto_augment_draws(
        jax_aug, rng, n=8)).numpy(), ref)


def augmix_draws(aug, rng, n=N):
    depth = aug.depth if aug.depth > 0 else 3

    def one(key):
        k_w, k_m, *k_chains = jax.random.split(key, 2 + aug.width)
        ws = jax.random.dirichlet(k_w, jnp.full((aug.width,), aug.alpha))
        m = jax.random.beta(k_m, aug.alpha, aug.alpha)
        chains = []
        for i in range(aug.width):
            key, steps = k_chains[i], []
            for d in range(depth):
                key, k_op, k_sign, k_cut, k_keep = jax.random.split(key, 5)
                op = jax_aa._AUGMIX_IDX[jax.random.randint(
                    k_op, (), 0, len(jax_aa._AUGMIX_OPS))]
                keep = (d < jax.random.randint(k_keep, (), 1, 4)
                        if aug.depth <= 0 else jnp.asarray(True))
                steps.append((op, jnp.where(jax.random.bernoulli(k_sign),
                                            1.0, -1.0), keep,
                              cutout_xy(k_cut)))
            chains.append([jnp.stack(v) for v in zip(*steps)])
        return [ws, m] + [jnp.stack(v) for v in zip(*chains)]

    ws, m, op, sign, keep, xy = (np.asarray(v) for v in jax.jit(jax.vmap(
        one))(jax.random.split(rng, n)))
    # [n, width, depth, ...] -> [width, depth, n, ...]
    return tensors(ws=ws, m=m, op=np.moveaxis(op, 0, 2).astype(np.int64),
                   sign=np.moveaxis(sign, 0, 2), keep=np.moveaxis(keep, 0, 2),
                   xy=np.moveaxis(xy, 0, 2))


def test_augmix_given_jax_draws():
    jax_aug = jax_aa.augment_and_mix_transform("augmix-m5-w3")
    aug = port_aa.augment_and_mix_transform("augmix-m5-w3")
    x = images(7, n=8)
    rng = jax.random.PRNGKey(8)
    ref = to_nchw(jax.jit(jax_aug)(rng, x))
    assert_chain_close(aug.apply(nchw(x), augmix_draws(
        jax_aug, rng, n=8)).numpy(), ref)


def erasing_draws(erasing, rng, x):
    """JAX RandomErasing's draws for the NHWC batch ``x``, ``[count, n]``
    (the fill ``[count, n, C, H|1, W|1]``)."""
    n, h, w, c = x.shape

    def one(key, img):
        out = []
        for _ in range(erasing.count):
            key, k_en, k_a, k_r, k_y, k_x, k_fill = jax.random.split(key, 7)
            target = jax.random.uniform(
                k_a, (), minval=erasing.min_area,
                maxval=erasing.max_area) * float(h * w) / erasing.count
            aspect = jnp.exp(jax.random.uniform(
                k_r, (), minval=erasing.log_aspect[0],
                maxval=erasing.log_aspect[1]))
            eh = jnp.clip(jnp.round(jnp.sqrt(target * aspect)), 1,
                          h).astype(jnp.int32)
            ew = jnp.clip(jnp.round(jnp.sqrt(target / aspect)), 1,
                          w).astype(jnp.int32)
            y0 = jax.random.randint(k_y, (), 0, jnp.maximum(h - eh, 1))
            x0 = jax.random.randint(k_x, (), 0, jnp.maximum(w - ew, 1))
            shape = img.shape if erasing.mode == "pixel" else (1, 1, c)
            fill = jax.random.normal(k_fill, shape, img.dtype)
            out.append((jax.random.bernoulli(k_en, erasing.probability),
                        target, aspect, y0, x0, fill))
        return [jnp.stack(v) for v in zip(*out)]

    enabled, target, aspect, y0, x0, fill = (
        np.asarray(v) for v in jax.jit(jax.vmap(one))(
            jax.random.split(rng, n), x))
    draws = dict(enabled=enabled.T, target=target.T, aspect=aspect.T,
                 y0=y0.T, x0=x0.T)
    if erasing.mode != "const":
        draws["fill"] = fill.swapaxes(0, 1).transpose(0, 1, 4, 2, 3)
    return tensors(**draws)


@pytest.mark.parametrize("mode", ["const", "rand", "pixel"])
def test_random_erasing_given_jax_draws(mode):
    """Three rectangles a sample, the first of two splits kept clean."""
    jax_erasing = JaxErasing(0.7, mode=mode, count=3, num_splits=2)
    erasing = RandomErasing(0.7, mode=mode, count=3, num_splits=2)
    x = np.random.RandomState(9).randn(8, H, W, 3).astype(np.float32)
    rng = jax.random.PRNGKey(10)
    ref = to_nchw(jax_erasing(rng, x))
    got = erasing.apply(nchw(x), erasing_draws(jax_erasing, rng, x))
    np.testing.assert_array_equal(got.numpy(), ref)


# ---- the laws of the port's own draws ---------------------------------------

def test_rand_augment_draw_law():
    gen = torch.Generator().manual_seed(0)
    n = 4000
    d = port_ra.rand_augment_transform("rand-m9-mstd0.5-n2").draw(
        gen, n, H, W)
    freq = torch.bincount(d["op"].reshape(-1), minlength=16).float() / (2 * n)
    assert torch.all((freq - 1 / 16).abs() < 0.01), freq
    # the gate u1 <= U(0.2, 0.8) holds with probability E[u2] = 0.5
    assert abs(d["apply"].float().mean().item() - 0.5) < 0.02
    assert abs(d["mag"].mean().item() - 9.0) < 0.03
    assert abs(d["mag"].std().item() - 0.5) < 0.03
    assert set(d["sign"].unique().tolist()) == {-1.0, 1.0}
    assert abs(d["sign"].mean().item()) < 0.04
    xy = d["xy"].reshape(-1, 2)
    assert 0 <= xy.min() and xy[:, 0].max() < W and xy[:, 1].max() < H
    w0 = port_ra.rand_augment_transform("rand-m9-n2-w0").draw(gen, n, H, W)
    freq = torch.bincount(w0["op"].reshape(-1), minlength=16).float() / (2 * n)
    want = torch.tensor(policies.CHOICE_WEIGHTS_0)
    assert torch.all((freq - want / want.sum()).abs() < 0.015), freq
    assert freq[2] == 0 and freq[4] == 0  # weight 0: Invert, Posterize
    # m + N(0, 0.5) clipped to [0, 15] at m = 15
    d = port_ra.rand_augment_transform("rand-m15-mstd0.5-n2").draw(
        gen, n, H, W)
    assert d["mag"].max() == 15.0 and 0.4 < (d["mag"] == 15).float().mean()


def test_auto_augment_draw_law():
    gen = torch.Generator().manual_seed(1)
    aug = port_aa.auto_augment_transform("v0")
    n = 20000
    d = aug.draw(gen, n, H, W)
    freq = torch.bincount(d["sub"], minlength=25).float() / n
    assert torch.all((freq - 1 / 25).abs() < 0.006), freq
    prob = aug.prob[d["sub"]].T
    assert abs(d["apply"].float().mean() - prob.mean()) < 0.01
    torch.testing.assert_close(d["mag"], aug.mag[d["sub"]].T)
    noisy = port_aa.auto_augment_transform("v0-mstd0.5").draw(gen, n, H, W)
    assert 0 <= noisy["mag"].min() and noisy["mag"].max() <= 10


def test_augmix_draw_law():
    gen = torch.Generator().manual_seed(2)
    aug = port_aa.augment_and_mix_transform("augmix-m3-w3")
    n = 20000
    d = aug.draw(gen, n, H, W)
    torch.testing.assert_close(d["ws"].sum(1), torch.ones(n))
    # Dirichlet(1, 1, 1): each weight has mean 1/3; Beta(1, 1) mean 1/2
    assert torch.all((d["ws"].mean(0) - 1 / 3).abs() < 0.01)
    assert abs(d["m"].mean() - 0.5) < 0.01
    assert abs(d["m"].var() - 1 / 12) < 0.005
    # d < U{1, 2, 3} drawn at each step: kept with odds 1, 2/3, 1/3
    keep = d["keep"].float().mean((0, 2))
    torch.testing.assert_close(keep, torch.tensor([1.0, 2 / 3, 1 / 3]),
                               atol=0.01, rtol=0)
    allowed = {policies.OP_IDX[o] for o in policies.AUGMIX_OPS}
    assert set(d["op"].unique().tolist()) == allowed
    fixed = port_aa.augment_and_mix_transform("augmix-m3-w2-d2").draw(
        gen, 10, H, W)
    assert fixed["keep"].all() and fixed["op"].shape == (2, 2, 10)


def test_random_erasing_law():
    gen = torch.Generator().manual_seed(3)
    h, w = 40, 30
    erasing = RandomErasing(0.25, mode="pixel", count=3, num_splits=2)
    n = 4000
    d = erasing.draw(gen, n, 3, h, w)
    assert abs(d["enabled"].float().mean() - 0.25) < 0.02
    area = d["target"] * 3 / (h * w)
    assert 0.02 <= area.min() and area.max() <= 1 / 3
    assert abs(area.mean() - (0.02 + 1 / 3) / 2) < 0.01
    assert np.log(0.3) <= d["aspect"].log().min()
    assert d["aspect"].log().max() <= np.log(1 / 0.3)
    eh, ew = RandomErasing.rect_size(d["target"], d["aspect"], h, w)
    assert torch.all(d["y0"] + eh <= torch.clamp(eh, min=h))
    assert torch.all(d["x0"] + ew <= torch.clamp(ew, min=w))
    assert d["fill"].shape == (3, n, 3, h, w)
    x = torch.full((8, 3, h, w), 5.0)
    out = erasing(x, gen)
    assert torch.equal(out[:4], x[:4])  # the clean split
    assert (out[4:] != 5.0).any()
    assert RandomErasing(0.0)(x, gen) is x
    const = RandomErasing(1.0, mode="const")(x, gen)
    erased = (const == 0).float().mean((1, 2, 3))
    assert torch.all((0.02 <= erased) & (erased <= 1 / 3 + 0.05))


# ---- parsers and the host backend -------------------------------------------

RAND_KEYS = ("magnitude", "num_layers", "magnitude_std", "min_prob",
             "max_prob", "max_magnitude", "num_ops")


@pytest.mark.parametrize("config", ["rand-m15-mstd0.5-n2", "rand-m9-n3-w0",
                                    "rand-inc1-m7", "v0", "v0r-mstd0.5",
                                    "original", "originalr",
                                    "augmix-m5-w4-d2", "augmix-m3-a0.5"])
def test_parsers_match_jax(config):
    jax_aug = jax_aa.create_batch_augment(config)
    aug = port_aa.create_batch_augment(config)
    assert type(aug).__name__ == type(jax_aug).__name__
    if config.startswith("rand"):
        for key in RAND_KEYS:
            assert getattr(aug, key) == getattr(jax_aug, key), key
        assert (aug.weights is None) == (jax_aug.weights is None)
        if aug.weights is not None:
            np.testing.assert_array_equal(np.float32(aug.weights),
                                          np.asarray(jax_aug.weights))
        host, jax_h = (port_host.create_host_augment(config),
                       jax_host.create_host_augment(config))
        for key in RAND_KEYS:
            assert getattr(host, key) == getattr(jax_h, key), key
    elif config.startswith("augmix"):
        for key in ("magnitude", "width", "depth", "alpha"):
            assert getattr(aug, key) == getattr(jax_aug, key), key
        host, jax_h = (port_host.create_host_augment(config),
                       jax_host.create_host_augment(config))
        for key in ("magnitude", "width", "depth", "alpha", "ops"):
            assert getattr(host, key) == getattr(jax_h, key), key
    else:
        assert aug.magnitude_std == jax_aug.magnitude_std
        for key in ("op_idx", "prob", "mag"):
            np.testing.assert_array_equal(getattr(aug, key).numpy(),
                                          np.asarray(getattr(jax_aug, key)))
        name = config.split("-")[0]
        assert port_host.create_host_augment(name).policy == \
            jax_host.create_host_augment(name).policy
    assert port_aa.create_batch_augment(None) is None
    assert port_host.create_host_augment("") is None


def test_parsers_refuse_what_jax_refuses():
    with pytest.raises(ValueError):
        port_ra.rand_augment_transform("rand-m9-x3")
    with pytest.raises(ValueError):
        port_host.create_host_augment("rand-m9-x3")
    with pytest.raises(ValueError):
        port_host.create_host_augment("v9")
    with pytest.raises(KeyError):
        port_aa.auto_augment_transform("v9")


def test_tables_match_jax():
    assert policies.OP_NAMES == jax_ra.OP_NAMES
    assert policies.CHOICE_WEIGHTS_0 == jax_ra.CHOICE_WEIGHTS_0
    assert (policies.N_BASE_OPS, policies.MAX_LEVEL, policies.FILL,
            policies.TRANSLATE_CONST, policies.CUTOUT_CONST) == (
        jax_ra.N_BASE_OPS, jax_ra.MAX_LEVEL, jax_ra.FILL,
        jax_ra.TRANSLATE_CONST, jax_ra.CUTOUT_CONST)
    assert policies.POLICIES == jax_aa._POLICIES
    assert policies.AUGMIX_OPS == jax_aa._AUGMIX_OPS


def test_host_device_sampling_space_twinned():
    """Host and device RandAugment sample the same 16 base ops
    (``tests/test_augment.py``'s check, on the port)."""
    host = port_host.HostRandAugment()
    dev = port_ra.RandAugment()
    assert host.num_ops == dev.num_ops == policies.N_BASE_OPS
    assert len(policies.CHOICE_WEIGHTS_0) == policies.N_BASE_OPS
    out = port_ra.rand_augment_transform("rand-m9-n2-w0")(
        nchw(images(11, n=2)), torch.Generator().manual_seed(0))
    assert out.shape == (2, 3, H, W) and torch.isfinite(out).all()


def in_own_thread(fn):
    """``fn()`` on a thread of its own.  The host augments' per-sample RNG
    is thread-local: one installed on the test process's main thread
    would outlive the test, and the JAX package's own host tests, which
    may run after it in this process, draw from the global ``random``
    only where none is installed."""
    with ThreadPoolExecutor(1) as pool:
        return pool.submit(fn).result()


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_host_apply_op_matches_jax(sign):
    """Every host op on a PIL image gives the JAX host op's bytes."""
    im = Image.fromarray(np.random.RandomState(12).randint(
        0, 256, (48, 40, 3), np.uint8))

    def check():
        for name in policies.OP_NAMES:
            for level in (3.0, 10.0, 14.2):
                port_host.seed_sample_rng(5)
                jax_host.seed_sample_rng(5)
                got = np.asarray(port_host.apply_op(name, im, level, sign))
                ref = np.asarray(jax_host.apply_op(name, im, level, sign))
                np.testing.assert_array_equal(got, ref, err_msg=name)

    in_own_thread(check)


@pytest.mark.parametrize("config", ["rand-m15-mstd0.5-n2", "rand-m9-n3-w0",
                                    "augmix-m5-w4-d2", "augmix-m5-w3", "v0",
                                    "originalr"])
def test_host_policies_match_jax(config):
    """The host policies draw from the per-sample RNG the loader installs:
    the same seed gives the JAX package's bytes, whatever the global
    ``random`` holds."""
    im = Image.fromarray(np.random.RandomState(13).randint(
        0, 256, (40, 36, 3), np.uint8))
    port, ref = (port_host.create_host_augment(config),
                 jax_host.create_host_augment(config))

    def check():
        for s in range(6):
            random.seed(100 + s)
            port_host.seed_sample_rng(s)
            got = np.asarray(port(im))
            random.seed(200 + s)
            jax_host.seed_sample_rng(s)
            np.testing.assert_array_equal(got, np.asarray(ref(im)))

    in_own_thread(check)
