"""The port's ``create_model`` and ``get_model_default_cfg`` against the
JAX package's (``cotnet_tpu/models/factory.py``, ``helpers.py``).

- Every ported key's default data config, asked for before any model is
  built (in a fresh process), equals the JAX package's: both fall back on
  the config the key's module registered.
- Each argument of the JAX factory, on ``resnet18``, ``cotnet50`` and
  ``efficientnet_b0``, does in the port what it does there: the batchnorm
  kwargs reach only the EfficientNet family (in torch's momentum
  convention), ``drop_connect_rate`` becomes ``drop_path_rate`` with the
  same warning, ``pretrained``, ``scriptable``, ``exportable`` and
  ``no_jit`` build the model, and a non-empty ``checkpoint_path`` raises
  ``ValueError``.
"""

import json
import os
import subprocess
import sys
import warnings

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from cotnet_tpu.models import create_model as jax_create_model  # noqa: E402
from cotnet_tpu_torch.models import create_model  # noqa: E402
from cotnet_tpu_torch.nn import BatchNorm2d, DropPath  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_FRESH = """
import json
from cotnet_tpu.models import get_model_default_cfg as jax_cfg
from cotnet_tpu_torch.models import get_model_default_cfg, list_models
from cotnet_tpu_torch.models.helpers import _default_cfg_by_model

assert not _default_cfg_by_model
names = list_models()
print(json.dumps({n: [get_model_default_cfg(n), jax_cfg(n)] for n in names}))
"""


def test_default_cfgs_match_the_jax_package_before_any_build():
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _FRESH], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    cfgs = json.loads(out.stdout.splitlines()[-1])
    assert len(cfgs) == 418
    differ = sorted(n for n, (port, jax_cfg) in cfgs.items()
                    if port != jax_cfg)
    assert not differ, differ[:10]
    # the keys whose data config is not the template
    assert cfgs["efficientnet_b7"][0]["input_size"] == [3, 600, 600]
    assert cfgs["cait_s24_384"][0]["input_size"] == [3, 384, 384]
    assert cfgs["BoTNetS1_59"][0]["input_size"] == [3, 256, 256]
    assert cfgs["tf_efficientnet_b0_ap"][0]["mean"] == [0.5, 0.5, 0.5]
    assert cfgs["fbnetc_100"][0]["interpolation"] == "bilinear"
    assert cfgs["xception"][0]["input_size"] == [3, 299, 299]
    assert cfgs["resnest269e"][0]["input_size"] == [3, 416, 416]
    assert cfgs["regnety_032"][0]["classifier"] == "head.fc"


MODELS = ("resnet18", "cotnet50", "efficientnet_b0")
ARGS = {
    "bn_tf": dict(bn_tf=True),
    "bn_momentum": dict(bn_momentum=0.05),
    "bn_eps": dict(bn_eps=1e-4),
    "drop_connect_rate": dict(drop_connect_rate=0.1),
    "drop_connect_and_path": dict(drop_connect_rate=0.1, drop_path_rate=0.2),
    "checkpoint_path_empty": dict(checkpoint_path=""),
    "checkpoint_path": dict(checkpoint_path="weights.pth.tar"),
    "pretrained": dict(pretrained=True),
    "scriptable": dict(scriptable=True),
    "exportable": dict(exportable=True),
    "no_jit": dict(no_jit=True),
}


def _outcome(build):
    """("built", model, warnings) or (the exception's type, None,
    warnings)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            model = build()
        except Exception as err:  # the outcome is what is compared
            return type(err).__name__, None, []
    return "built", model, sorted(str(w.message) for w in caught
                                  if "drop" in str(w.message))


def _drop_rates(model):
    return [m.rate for m in model.modules() if isinstance(m, DropPath)]


@pytest.mark.parametrize("arg", sorted(ARGS))
@pytest.mark.parametrize("name", MODELS)
def test_factory_argument_behaves_as_in_the_jax_package(name, arg):
    kwargs = ARGS[arg]
    want, jax_model, jax_warned = _outcome(
        lambda: jax_create_model(name, **kwargs))
    got, model, warned = _outcome(
        lambda: create_model(name, device="cpu", **kwargs))
    assert got == want and warned == jax_warned
    if want != "built":
        assert want == "ValueError" and arg == "checkpoint_path"
        return
    # the BNs take the JAX model's eps and momentum, in torch's convention
    bns = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    eps = getattr(jax_model, "bn_eps", 1e-5)
    momentum = 1 - getattr(jax_model, "bn_momentum", 0.9)
    assert bns and all(b.eps == eps for b in bns)
    assert all(abs(b.momentum - momentum) < 1e-12 for b in bns)
    if name == "efficientnet_b0" and arg.startswith("bn_"):
        assert (eps, round(momentum, 12)) != (1e-5, 0.1)
    # the drop path the JAX model was given
    rate = jax_model.drop_path_rate
    assert _drop_rates(model) == _drop_rates(
        create_model(name, device="cpu", drop_path_rate=rate))
    assert (max(_drop_rates(model), default=0.0) > 0) == (rate > 0)
