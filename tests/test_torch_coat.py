"""Parity of the port's CoaT (``models/coat.py``) with the JAX package, in
f32 on the CPU.

The same seeded numpy variables go into both sides (carried into the port
by ``jax_to_torch_state_dict(family="coat")``, which writes each of the
JAX model's stage-shared ``cpe{s}``/``crpe{s}`` and each parallel block's
``mlp`` under every name timm gives it), and the output and the gradients
of ``sum(out * r)`` in the input and in every parameter, under each of its
names, are held against ``jax.value_and_grad`` of the JAX module, jitted
once (``torch_family_parity.check_parity``), at ``1e-5 * max|ref|``: the
conv relative position encoding and the factorized attention on a 4x4 map
with its class token, the parallel blocks' resize against
``jax.image.resize`` (antialiased where it shrinks: 28->14, 28->7, 14->3,
and back up), forward and gradient, and reduced nets at 64 px (maps 16, 8,
4 and 2, eight heads): a lite CoaT and one with two parallel blocks over
stages 2-4, plain and ``features_only``.  A train step with an EMA keeps
one EMA tensor for each shared module and evaluates from it.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import linen as fnn  # noqa: E402
from torch import nn  # noqa: E402

from cotnet_tpu.models import coat as jcoat  # noqa: E402
from cotnet_tpu_torch.models import coat as pcoat  # noqa: E402
from torch_family_parity import check_parity, images  # noqa: E402

LITE = dict(embed_dims=(16, 16, 32, 32), serial_depths=(1, 1, 1, 1),
            mlp_ratios=(2, 2, 2, 2), num_classes=10)
PARALLEL = dict(embed_dims=(16, 24, 24, 24), serial_depths=(1, 1, 1, 1),
                parallel_depth=2, mlp_ratios=(2, 2, 2, 2), num_classes=10)
HW = (4, 4)


def tokens(shape, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape) * np.linspace(0.5, 2.0, shape[-1])).astype(
        np.float32)


class _JaxCrpe(fnn.Module):
    """CRPE on ``[2, N, h, L, dh]``: q and v stacked."""

    @fnn.compact
    def __call__(self, qv, training: bool = False):
        return jcoat.ConvRelPosEnc(8, name="crpe")(qv[0], qv[1], HW)


class _PortCrpe(nn.Module):
    def __init__(self, head_dim):
        super().__init__()
        self.crpe = pcoat.ConvRelPosEnc(head_dim, 8)

    def forward(self, qv):
        return self.crpe(qv[0], qv[1], HW)


@pytest.mark.parametrize("cls", [True, False])
def test_conv_rel_pos_enc_matches_jax(cls):
    """Each window's depthwise conv over its heads, times q; the class row
    zero where there is one."""
    qv = tokens((2, 2, 8, 16 + cls, 3), 0)
    check_parity(_PortCrpe(3), _JaxCrpe(), qv, 1, "coat")


def test_factor_attention_matches_jax():
    check_parity(pcoat.FactorAttn(32, 8, pcoat.ConvRelPosEnc(4, 8)),
                 jcoat.FactorAttn(8, crpe=jcoat.ConvRelPosEnc(8)),
                 tokens((2, 17, 32), 2), 3, "coat", args=(HW,))


@pytest.mark.parametrize("size,out", [(28, 14), (28, 7), (14, 3), (14, 28),
                                      (7, 28), (3, 14)])
def test_resize_matches_jax_image_resize(size, out):
    """The image tokens resized, the class token passed: the values and
    the gradient of ``sum(y * r)`` at 1e-6 of the largest."""
    x = tokens((2, 1 + size * size, 8), 4)
    r = tokens((2, 1 + out * out, 8), 5)
    want, vjp = jax.vjp(lambda a: jcoat._interpolate_tokens(
        a, (size, size), (out, out)), jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(r))
    xt = torch.from_numpy(x).requires_grad_()
    got = pcoat.interpolate_tokens(xt, (size, size), (out, out))
    (got * torch.from_numpy(r)).sum().backward()
    for g, w in ((got.detach().numpy(), want), (xt.grad.numpy(), want_dx)):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-6 * np.abs(w).max())


@pytest.mark.parametrize("net", ["lite", "parallel"])
@pytest.mark.parametrize("features_only", [False, True])
def test_reduced_coat_matches_jax(net, features_only):
    kw = dict(LITE if net == "lite" else PARALLEL,
              features_only=features_only)
    check_parity(pcoat.CoaT(**kw), jcoat.CoaT(**kw), images(2, 64), 6,
                 "coat", image=True)


def test_shared_modules_are_one_tensor_under_timm_names():
    port = pcoat.CoaT(**PARALLEL)
    sd = port.state_dict(keep_vars=True)
    assert sd["serial_blocks2.0.cpe.proj.weight"] is sd["cpe2.proj.weight"]
    assert sd["serial_blocks3.0.factoratt_crpe.crpe.conv_list.2.weight"] \
        is sd["crpe3.conv_list.2.weight"]
    assert sd["parallel_blocks.1.factoratt_crpe4.crpe.conv_list.0.bias"] \
        is sd["crpe4.conv_list.0.bias"]
    block = port.parallel_blocks[0]
    assert block.mlp2 is block.mlp3 is block.mlp4
    assert sd["parallel_blocks.0.mlp4.fc1.weight"] is \
        sd["parallel_blocks.0.mlp2.fc1.weight"]
    assert sd["aggregate.weight"].shape == (1, 3, 1)
    assert len(sd) > len(dict(port.named_parameters())) \
        + len(dict(port.named_buffers()))


def test_ema_keeps_one_tensor_per_shared_module():
    """Two train steps with an EMA, then the eval step from it: the EMA
    holds each shared tensor once, under every name, and moves it once a
    step."""
    from cotnet_tpu_torch.train.loss import cross_entropy
    from cotnet_tpu_torch.train.optim import create_optimizer
    from cotnet_tpu_torch.train.state import TrainState
    from cotnet_tpu_torch.train.step import make_eval_step, make_train_step

    model = pcoat.CoaT(**PARALLEL)
    opt = create_optimizer(dict(opt="sgd", momentum=0.9, weight_decay=0.0),
                           model.parameters())
    step = make_train_step(model, opt, lambda s: 0.1, cross_entropy,
                           ema_decay=0.5)
    state = TrainState.create(model, opt, ema=True)
    ema = state.ema
    assert ema["cpe2.proj.weight"] is ema["serial_blocks2.0.cpe.proj.weight"]
    start = ema["cpe2.proj.weight"].clone()
    batch = {"image": torch.from_numpy(images(2, 64)).permute(0, 3, 1, 2),
             "label": torch.tensor([1, 7])}
    live = []
    for _ in range(2):
        state, _ = step(state, batch)
        live.append(model.cpe2.proj.weight.detach().clone())
    torch.testing.assert_close(
        ema["cpe2.proj.weight"],
        0.25 * start + 0.25 * live[0] + 0.5 * live[1])
    out = make_eval_step(model)(batch, tensors=state.ema)
    assert float(out["n"]) == 2
