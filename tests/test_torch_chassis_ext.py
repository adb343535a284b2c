"""The port's ResNet chassis beyond output stride 32
(``cotnet_tpu_torch/models/resnet.py``) against the JAX chassis, in f32 on
the CPU, and the feature wrappers (``models/features.py``):

- ``output_stride`` 8 and 16 on reduced resnet50 (``Bottleneck``) and
  resnet18 (``BasicBlock``), with the 1x1 and the 3x3 (``down_kernel_size``)
  shortcut: train-mode logits and running statistics, eval logits after
  calibration;
- ``features_only`` with two ``out_indices`` sets: the features against the
  JAX chassis', and the stages beyond the largest index not built;
- the three wrappers and ``get_feature_info`` against
  ``tests/test_features.py``'s expectations and the JAX package's
  ``get_feature_info``;
- ``remat``: the loss, every gradient, the running statistics and the
  drop generator's state bit for bit those without it, with drop path,
  DropBlock and dropout on, in one process and under a simulated two-rank
  global-batch BN, where it must make the same collectives.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from cotnet_tpu.models import create_model as jax_create_model  # noqa: E402
from cotnet_tpu.models import resnet as jax_resnet  # noqa: E402
from cotnet_tpu.models.helpers import (  # noqa: E402
    get_feature_info as jax_feature_info)
from cotnet_tpu_torch.models import create_model  # noqa: E402
from cotnet_tpu_torch.models import resnet  # noqa: E402
from cotnet_tpu_torch.models.cotnet import CotBottleneck  # noqa: E402
from cotnet_tpu_torch.models.features import (  # noqa: E402
    FeatureDictNet, FeatureHookNet, FeatureInfo, FeatureListNet,
    build_feature_net)
from cotnet_tpu_torch.models.helpers import get_feature_info  # noqa: E402
from cotnet_tpu_torch.nn import norm, set_generator  # noqa: E402
from cotnet_tpu_torch.parallel import collectives  # noqa: E402
from torch_family_parity import (check_logits, images, load_port,  # noqa: E402
                                 nchw, random_variables, to_nhwc, unflatten)

BLOCKS = {"resnet50": (jax_resnet.Bottleneck, resnet.Bottleneck),
          "resnet18": (jax_resnet.BasicBlock, resnet.BasicBlock)}


@pytest.mark.parametrize("name,output_stride,down_ks", [
    ("resnet50", 8, 1), ("resnet50", 16, 3), ("resnet18", 8, 3),
    ("resnet18", 16, 1)])
def test_output_stride_matches_jax(name, output_stride, down_ks):
    jax_block, block = BLOCKS[name]
    kw = dict(layers=(1, 1, 1, 1), num_classes=10,
              output_stride=output_stride, down_kernel_size=down_ks)
    x = images(2, 64)
    model = jax_resnet.ResNet(block=jax_block, **kw)
    flat = random_variables(model, jnp.asarray(x), seed=1)
    port = resnet.ResNet(block, **kw)
    check_logits(model, port, flat, x)
    feats = port.eval().forward_features(nchw(x))
    # the stages past the output stride keep their map
    assert [f.shape[-1] for f in feats] == (
        [32, 16, 8, 8, 8] if output_stride == 8 else [32, 16, 8, 4, 4])


@pytest.mark.parametrize("out_indices", [(1, 3), (0, 2, 4)])
def test_features_only_matches_jax(out_indices):
    kw = dict(layers=(1, 1, 1, 1), features_only=True,
              out_indices=out_indices)
    x = images(2, 64)
    model = jax_resnet.ResNet(block=jax_resnet.Bottleneck, **kw)
    flat = random_variables(model, jnp.asarray(x), seed=2)
    want = model.apply(unflatten(flat), jnp.asarray(x), training=False)
    port = load_port(resnet.ResNet(resnet.Bottleneck, **kw), flat).eval()
    with torch.no_grad():
        got = port(nchw(x))
    assert len(got) == len(want) == len(out_indices)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(to_nhwc(g), w, rtol=0,
                                   atol=2e-5 * float(np.abs(w).max()))
    built = {n for n, _ in port.named_children()}
    assert (f"layer{max(out_indices)}" in built
            and f"layer{max(out_indices) + 1}" not in built
            and "fc" not in built)


def test_feature_wrappers():
    """``tests/test_features.py``'s expectations on cotnet50 and resnet18,
    and ``get_feature_info`` against the JAX package's."""
    info = [{"num_chs": c, "reduction": r, "module": f"stage{i}"}
            for i, (c, r) in enumerate([(64, 2), (256, 4), (512, 8),
                                        (1024, 16), (2048, 32)])]
    fi = FeatureInfo(info, (0, 1, 2, 3, 4))
    assert fi.channels(2) == 512 and fi.from_other((1, 3)).channels() == [
        256, 1024]
    assert fi.from_other((1, 3)).get_dicts(keys=["reduction"]) == [
        {"reduction": 4}, {"reduction": 16}]

    model = create_model("cotnet50", device="cpu")
    net = FeatureListNet(model)
    assert net.feature_info.channels() == [64, 256, 512, 1024, 2048]
    assert net.feature_info.reduction() == [2, 4, 8, 16, 32]
    assert get_feature_info(model) == jax_feature_info(
        jax_create_model("cotnet50"))
    x = torch.randn(1, 3, 64, 64)
    with torch.no_grad():
        outs = build_feature_net(model, "list", out_indices=(1, 3))(x)
        assert [o.shape[1] for o in outs] == [256, 1024]
        assert [64 // o.shape[-1] for o in outs] == [4, 16]
        feats = FeatureDictNet(model, out_indices=(2, 4))(x)
        assert list(feats) == ["stage2", "stage4"]
        assert feats["stage4"].shape[1] == 2048
        net = FeatureHookNet(create_model("resnet18", device="cpu",
                                          num_classes=5),
                             ["layer2.0", "fc"])
        feats, logits = net(x)
    assert list(feats) == ["layer2.0", "fc"]
    assert feats["layer2.0"].shape[1] == 128 and logits.shape == (1, 5)
    torch.testing.assert_close(feats["fc"], logits)


def _remat_run(block, remat):
    """One train-mode loss and backward of a reduced net with drop path,
    DropBlock and classifier dropout drawn from an explicit generator."""
    model = resnet.ResNet(block, (1, 1, 1, 1), num_classes=10,
                          base_width=16 if block is CotBottleneck else 64,
                          drop_rate=0.3, drop_path_rate=0.3,
                          drop_block_rate=0.2, remat=remat)
    gen = torch.Generator().manual_seed(0)
    for m in model.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(gen)
    drops = torch.Generator().manual_seed(3)
    set_generator(model.train(), drops)
    calls = []
    hooks = [m.register_forward_pre_hook(lambda *_: calls.append(1))
             for m in model.modules() if isinstance(m, norm.BatchNorm2d)]
    x = nchw(images(4, 64, seed=5))
    with collectives.CollectiveTimer() as timer:
        loss = model(x).square().mean()
        loss.backward()
    for h in hooks:
        h.remove()
    state = {k: v.clone() for k, v in model.state_dict().items()}
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    return loss.detach(), grads, state, drops.get_state(), len(calls), \
        dict(timer.by)


def _assert_same(a, b):
    assert torch.equal(a[0], b[0])
    for i in (1, 2):
        assert sorted(a[i]) == sorted(b[i])
        for k in a[i]:
            assert torch.equal(a[i][k], b[i][k]), k
    assert torch.equal(a[3], b[3])
    # the blocks' BNs ran again in the recompute
    assert b[4] > a[4]


@pytest.mark.parametrize("block", ["basic", "cot"])
def test_remat_is_bit_identical(block):
    block = resnet.BasicBlock if block == "basic" else CotBottleneck
    _assert_same(_remat_run(block, False), _remat_run(block, True))


def test_remat_makes_the_same_collectives(monkeypatch):
    """Global-batch BN over a simulated group of two identical ranks (the
    all-reduce doubles its tensor): the recompute takes the first pass's
    sums, so the same all-reduces run, forward and backward, and the bits
    are those without remat."""
    monkeypatch.setattr(collectives, "group_size", lambda group=None: 2)
    monkeypatch.setattr(norm, "group_size", lambda group=None: 2)
    monkeypatch.setattr(collectives.dist, "all_reduce",
                        lambda t, group=None: t.mul_(2))
    plain, remat = (_remat_run(resnet.BasicBlock, r) for r in (False, True))
    _assert_same(plain, remat)
    calls = plain[5]["all_reduce_sum"][0]
    # each BN's sums forward and their gradient backward
    assert calls == 2 * plain[4] and remat[5]["all_reduce_sum"][0] == calls
