"""The port's config, training CLI and bench against the JAX package.

- Every recipe under ``cot_experiments/`` parses through the port's
  ``load_experiment`` to the JAX package's tree, and the sentinel pruning
  and numeric coercion agree case by case.
- ``cotnet_tpu_torch.train_cli`` runs end to end on the CPU at a toy size
  (config -> model -> loaders -> complexity report -> train epoch -> eval
  of the live weights and the EMA -> checkpoints); a second call recovers
  from the recovery checkpoint, and ``--eval-only`` evaluates a resumed
  checkpoint.
- ``cotnet_tpu_torch.bench.main`` at a toy size prints one JSON line with
  both sides of each pair.
"""

import contextlib
import glob
import io
import json
import os
import shutil

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from cotnet_tpu.config import config as jax_config  # noqa: E402
from cotnet_tpu_torch import bench, train_cli  # noqa: E402
from cotnet_tpu_torch.config import config as port_config  # noqa: E402
from cotnet_tpu_torch.models import is_model  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXP_DIR = os.path.join(REPO, "cot_experiments")
RECIPES = sorted(
    os.path.basename(os.path.dirname(p))
    for p in glob.glob(os.path.join(EXP_DIR, "*", "config.yaml")))


def test_seven_recipes():
    assert len(RECIPES) == 7, RECIPES


@pytest.mark.parametrize("name", RECIPES)
def test_recipe_parses_to_the_jax_tree(name):
    """Key for key and value for value, types included (a float stays a
    float, the '1e-5' strings become numbers on both sides)."""
    folder = os.path.join(EXP_DIR, name)
    port = port_config.load_experiment(folder)
    ref = jax_config.load_experiment(folder)
    assert port.to_dict() == ref.to_dict()

    def types(tree):
        return {k: types(v) if isinstance(v, dict) else type(v)
                for k, v in tree.items()}

    assert types(port.to_dict()) == types(ref.to_dict())
    assert is_model(port.model.name), port.model.name
    assert port.data_loader.batch_size > 0 and port.solver.epochs > 0


@pytest.mark.parametrize("value", [
    "1e-5", "0.00004", "3", "-1", "abc", "1.0e+2", "", "0x10", " 7 ", -1,
    -1.0, [], [1, 2], None, True, 0.5, {"a": 1}])
def test_coerce_matches_jax(value):
    got, ref = port_config._coerce(value), jax_config._coerce(value)
    assert got == ref and type(got) is type(ref)


SENTINEL_YAML = """
seed: 7
model:
  name: 'cotnet101'
  drop_path: -1
  drop: -1.0
  initial_checkpoint: ''
  mean: []
  model_ema_decay: '0.99'
  img_size: 256
solver:
  min_lr: 1e-6
  lr_noise: [0.4, 0.8]
  epochs: '300'
  opt: -1
new_section:
  key: 3
augmentation:
  scale: []
  ratio: [0.5, 2.0]
  aa: ''
"""


def test_sentinels_and_coercion_match_jax(tmp_path):
    """A recipe of sentinels (-1, -1.0, '', []) keeps the defaults, numeric
    strings become numbers, unknown sections are added: the same tree in
    both packages, from the defaults and from a given base."""
    path = tmp_path / "config.yaml"
    path.write_text(SENTINEL_YAML)
    port = port_config.load_config(str(path))
    ref = jax_config.load_config(str(path))
    assert port.to_dict() == ref.to_dict()
    assert port.model.drop_path is None and port.model.drop == 0.0
    assert port.solver.min_lr == 1e-6 and port.solver.epochs == 300
    assert port.augmentation.scale == [0.08, 1.0]
    base_p = port_config.load_config(str(path))
    base_j = jax_config.load_config(str(path))
    assert (port_config.load_config(str(path), base_p).to_dict()
            == jax_config.load_config(str(path), base_j).to_dict())
    assert port_config.default_config().to_dict() == \
        jax_config.default_config().to_dict()


def _experiment(tmp_path, recovery_interval=1):
    exp = tmp_path / "exp"
    exp.mkdir()
    text = open(os.path.join(EXP_DIR, "CoTNet-50-350epoch",
                             "config.yaml")).read()
    assert "recovery_interval: 10" in text
    (exp / "config.yaml").write_text(text.replace(
        "recovery_interval: 10", f"recovery_interval: {recovery_interval}"))
    return exp


CLI_ARGS = ["--device", "cpu", "--synthetic", "--steps", "2", "--epochs",
            "1", "--img-size", "32", "--batch-size", "2", "--model",
            "cotnet50"]


def test_cli_end_to_end_recovers_and_evaluates(tmp_path):
    """One epoch of two steps of cotnet50 at 32 px on the CPU, then a second
    call that recovers from the recovery checkpoint, then --eval-only from
    the best checkpoint (model.resume), which gives that epoch's eval."""
    exp = _experiment(tmp_path)
    try:
        out = train_cli.main(["--folder", str(exp)] + CLI_ARGS)
        log = (exp / "log.txt").read_text()
        assert "model cotnet50: 22.2M params" in log
        assert "eval epoch 1:" in log and "eval(ema) epoch 1:" in log
        assert "done; best top1:" in log
        ckpts = exp / "checkpoints"
        assert sorted(p.name for p in ckpts.iterdir()) == [
            "checkpoint-1.pth.tar", "index.json", "last.pth.tar",
            "recovery.json", "recovery.pth.tar"]
        assert os.readlink(ckpts / "last.pth.tar") == "checkpoint-1.pth.tar"
        assert json.loads((ckpts / "recovery.json").read_text()) == {
            "epoch": 1}
        assert out["state"].step == 2 and out["eval"]["samples"] == 2

        again = train_cli.main(["--folder", str(exp)] + CLI_ARGS)
        assert "recovered from epoch 1" in (exp / "log.txt").read_text()
        assert again["state"].step == 2 and again["eval"] is None
        for k, v in out["state"].model.state_dict().items():
            assert torch.equal(again["state"].model.state_dict()[k], v), k

        best = json.loads((ckpts / "index.json").read_text())[0]["path"]
        config = (exp / "config.yaml").read_text()
        (exp / "config.yaml").write_text(config.replace(
            "model:\n", f"model:\n  resume: '{best}'\n", 1))
        ev = train_cli.main(["--folder", str(exp), "--eval-only"] + CLI_ARGS)
        assert "resumed at epoch 1" in (exp / "log.txt").read_text()
        live = [line for line in (exp / "log.txt").read_text().splitlines()
                if "eval epoch 1:" in line]
        assert f"top1 {ev['eval']['top1']:.3f} top5 " \
               f"{ev['eval']['top5']:.3f}" in live[0]
        assert ev["best"] is None and ev["state"].step == 2
    finally:
        shutil.rmtree(exp / "checkpoints", ignore_errors=True)


def test_cli_kernel_impl_maps_to_the_port():
    """auto and pallas take the kernels (pallas always), xla the plain
    versions."""
    assert train_cli.IMPLS == {"auto": "auto", "pallas": "hopper",
                               "xla": "torch"}
    cfg = port_config.default_config()
    cfg["model"]["kernel_impl"] = "xla"
    cfg["model"]["name"] = "cotnet50"
    model, data_cfg = train_cli.build_model(cfg, "cpu")
    assert {m.impl for m in model.modules() if hasattr(m, "impl")} == {
        "torch"}
    assert data_cfg["input_size"] == (3, 224, 224)


def test_cli_step_seed_depends_on_seed_and_step_alone():
    seeds = {train_cli.step_seed(778, s) for s in range(100)}
    assert len(seeds) == 100
    assert train_cli.step_seed(778, 5) == train_cli.step_seed(778, 5)
    assert train_cli.step_seed(778, 5) != train_cli.step_seed(779, 5)


def test_cli_cuda_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    exp = _experiment(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(["--folder", str(exp), "--synthetic"])


def test_bench_toy_run_prints_one_json_line():
    """The bench's main() at a toy size on the CPU: one JSON line, both
    sides of the eval and train pairs with their spreads, platform cpu and
    no MFU (a device metric)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = bench.main(batch=2, size=32, iters=1, train_iters=1,
                            device="cpu")
    lines = buf.getvalue().strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == result
    assert result["metric"] == "cotnet50_32_bs2_bf16_infer_imgs_per_sec_chip"
    d = result["detail"]
    for key in ("pallas_ips", "xla_ips", "train_imgs_per_sec",
                "train_imgs_per_sec_xla"):
        assert 0 < d[key] < float("inf"), key
    for key in ("ms_per_batch_pallas_spread", "ms_per_batch_xla_spread",
                "train_ms_per_batch_spread", "train_ms_per_batch_xla_spread"):
        assert len(d[key]) == 2 and d[key][0] <= d[key][1], key
    assert result["vs_baseline"] == d["pallas_ips"] / d["xla_ips"]
    assert d["repeats"] == 3 and d["platform"] == "cpu" and d["mfu"] is None
    assert "ideal_traffic_gb" not in d


def test_bench_deadline_raises():
    with pytest.raises(TimeoutError):
        bench.main(batch=1, size=32, iters=1, train_iters=1, device="cpu",
                   deadline_s=-1.0)


def test_bench_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main()
