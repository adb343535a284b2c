"""Data parallelism of the PyTorch port on ``torch.distributed`` (gloo, CPU).

Two ranks are this file run as a script (``python test_torch_parallel.py
suite <rank> <world> <init_method> <dir>``): they join a gloo group over
localhost and run every two-rank check in one go, each writing its results
to ``<dir>/rank<r>.pt``; the tests read them and hold them against one
process computing the whole batch.  The children import no JAX.

- the ``tests/test_multiproc.py`` net (conv + BN + dense, 8 images, 3
  momentum-SGD steps) with its weights carried from flax: both ranks hold
  the same bits, and they match the JAX package's single-process oracle
  (``multiproc_child.oracle_steps``) at loss rtol 2e-5 and sums 1e-4;
- every collective at world size 1 (no group: the identity) and 2;
- global-batch BatchNorm, forward and gradient, against one process;
- mixup ``batch`` / ``pair`` / ``elem`` over two ranks against one process;
- the eval step's counts summed across ranks, and the ``Evaler``'s gathered
  top-k rows;
- rank-0-only checkpoint writes, and resume on both ranks;
- the loader's rank rows (train and padded eval, host and device draws),
  in one process through ``rank`` / ``world_size``;
- ``dryrun_multiproc(2, "cpu")``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch.nn.functional as F  # noqa: E402
from torch import nn  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from cotnet_tpu_torch.data.mixup import Mixup  # noqa: E402
from cotnet_tpu_torch.nn import BatchNorm2d, Conv2d  # noqa: E402
from cotnet_tpu_torch.parallel import collectives as coll  # noqa: E402
from cotnet_tpu_torch.parallel import mesh  # noqa: E402
from cotnet_tpu_torch.train.step import make_eval_step  # noqa: E402

WORLD = 2
MIX_MODES = ("batch", "pair", "elem")


class MpNet(nn.Module):
    """``multiproc_child.MpNet`` in the port: a 3x3 conv with bias (8
    channels), BN (flax momentum 0.9), relu, the spatial mean and a dense
    layer to 4 classes, under the flax names the converter gives."""

    def __init__(self):
        super().__init__()
        self.Conv_0 = Conv2d(3, 8, 3, bias=True)
        self.BatchNorm_0 = BatchNorm2d(8)
        self.Dense_0 = nn.Linear(8, 4)

    def forward(self, x):
        x = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        return self.Dense_0(x.mean((2, 3)))


def global_data():
    """The global batches of the two-rank checks, from a numpy seed."""
    rng = np.random.RandomState(5)
    contrast = np.linspace(0.3, 2.0, 8)[:, None, None, None]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))  # noqa: E731
    return {
        "bn_x": t(rng.randn(8, 6, 5, 5) * contrast + 0.5),
        "bn_r": t(rng.randn(8, 6, 5, 5)),
        "bn_w": t(0.5 + rng.rand(6)), "bn_b": t(0.1 * rng.randn(6)),
        "mix_images": t(rng.randn(8, 3, 6, 6)),
        "mix_labels": torch.from_numpy(rng.randint(0, 10, 8)),
        "eval_images": t(rng.randn(8, 3, 4, 4)),
        "eval_labels": torch.from_numpy(rng.randint(0, 10, 8)),
        "eval_valid": t((np.arange(8) < 5).astype(np.float32)),
    }


def eval_model():
    torch.manual_seed(0)
    return nn.Sequential(nn.Flatten(), nn.Linear(48, 10))


class RealLabelsStub:
    """Records what the ``Evaler`` hands to ReaL scoring."""

    def __init__(self):
        self.rows = []

    def reset(self):
        self.rows = []

    def add_result(self, topk):
        self.rows.append(np.asarray(topk))

    def get_accuracy(self, k):
        return 0.0


def bn_step(x, r, w, b, group=None):
    """BN in training on x, the gradient of ``sum(y * r)``."""
    bn = BatchNorm2d(x.shape[1], group=group).train()
    with torch.no_grad():
        bn.weight.copy_(w)
        bn.bias.copy_(b)
    x = x.clone().requires_grad_()
    y = bn(x)
    (y * r).sum().backward()
    return {"y": y.detach(), "dx": x.grad, "dw": bn.weight.grad,
            "db": bn.bias.grad, "mean": bn.running_mean.clone(),
            "var": bn.running_var.clone()}


# ---- the ranks' side -------------------------------------------------------

def rank_suite(rank, world, init_method, out_dir):
    from cotnet_tpu_torch.evaler import Evaler
    from cotnet_tpu_torch.train.loss import cross_entropy
    from cotnet_tpu_torch.train.optim import create_optimizer
    from cotnet_tpu_torch.train.state import TrainState
    from cotnet_tpu_torch.train.step import make_train_step
    from cotnet_tpu_torch.utils import checkpoint

    assert mesh.initialize_distributed(init_method, world, rank,
                                       device="cpu")
    assert (mesh.rank(), mesh.world_size()) == (rank, world)
    rows = mesh.rank_rows(8)
    data = global_data()
    out = {}

    # collectives
    t = torch.tensor([1.0, 2.0]) * (rank + 1)
    out["sum"] = coll.sum_tensor(t)
    out["mean"] = coll.reduce_tensor(t)
    out["scaled"] = torch.stack(coll.scaled_all_reduce([t, 2 * t]))
    out["gather"] = coll.all_gather_rows(t)
    out["partner"] = coll.partner_rows(t)
    x = t.clone().requires_grad_()
    (coll.all_reduce_sum(x) * (rank + 1)).sum().backward()
    out["sum_grad"] = x.grad
    bn = BatchNorm2d(3)
    with torch.no_grad():
        bn.running_mean.fill_(float(rank))
        bn.running_var.fill_(1.0 + rank)
    coll.sync_batch_stats(bn)
    out["synced"] = torch.stack([bn.running_mean, bn.running_var])
    params = [nn.Parameter(torch.zeros(n)) for n in (3, 5, 7)]
    for i, p in enumerate(params):
        p.grad = torch.full_like(p, float(rank + 1 + i))
    extra = coll.average_gradients(params, extra={"loss": torch.tensor(
        float(rank))})
    out["avg_grads"] = torch.cat([p.grad for p in params])
    out["avg_loss"] = extra["loss"]
    coll.barrier()
    # the timer's record, by the helper that ran each collective
    with coll.CollectiveTimer() as timer:
        coll.sum_tensor(t)
        coll.partner_rows(t)
        coll.all_gather_rows(t)
        coll.all_reduce_sum(t.clone().requires_grad_()).sum().backward()
        coll.average_tensors([t.clone(), torch.zeros(3)])
    out["timer"] = timer.by

    # global-batch BN
    for k, v in bn_step(data["bn_x"][rows], data["bn_r"][rows],
                        data["bn_w"], data["bn_b"]).items():
        out[f"bn_{k}"] = v

    # mixup over the global batch
    for mode in MIX_MODES:
        mix = Mixup(mixup_alpha=0.8, cutmix_alpha=1.0, mode=mode,
                    num_classes=10)
        images, targets = mix(data["mix_images"][rows],
                              data["mix_labels"][rows],
                              torch.Generator().manual_seed(7))
        out[f"mix_{mode}"], out[f"mix_{mode}_targets"] = images, targets

    # eval counts and the Evaler's gathered rows
    batch = {"image": data["eval_images"][rows],
             "label": data["eval_labels"][rows],
             "valid": data["eval_valid"][rows]}
    counts = make_eval_step(eval_model())(batch)
    out["counts"] = torch.stack([counts["top1_count"], counts["top5_count"],
                                 counts["n"]])
    stub = RealLabelsStub()
    Evaler(eval_model(), [batch], logger=None, real_labels=stub)(
        0, TrainState(model=None, optimizer=None))
    out["real_rows"] = torch.from_numpy(np.concatenate(stub.rows))

    # the multiproc net: 3 global steps from the flax weights
    mp = torch.load(os.path.join(out_dir, "mpnet.pt"))
    model = MpNet()
    model.load_state_dict(mp["state_dict"], strict=True)
    optimizer = create_optimizer(dict(opt="momentum", momentum=0.9,
                                      weight_decay=0.0), model.parameters())
    state = TrainState.create(model, optimizer)
    step = make_train_step(model, optimizer, lambda s: 0.1, cross_entropy)
    mp_rows = mesh.rank_rows(mp["images"].shape[0])
    mp_batch = {"image": mp["images"][mp_rows], "label": mp["labels"][mp_rows]}
    for _ in range(3):
        state, metrics = step(state, mp_batch, torch.Generator())
    out["mp_loss"] = metrics["loss"]
    out["mp_state"] = {k: v.detach().clone()
                       for k, v in model.state_dict().items()}

    # checkpoints: rank 0 alone writes, both ranks read
    writes = []
    real_save = checkpoint._save

    def counting_save(obj, path):
        writes.append(os.path.basename(path))
        real_save(obj, path)

    checkpoint._save = counting_save
    ckpt_dir = os.path.join(out_dir, "ckpt")
    saver = checkpoint.CheckpointSaver(ckpt_dir, recovery_interval=1)
    saver.save_recovery(state, 1)
    saver.save_checkpoint(state, 1, 0.5)
    checkpoint._save = real_save
    out["writes"] = writes
    out["files_after_barrier"] = sorted(os.listdir(ckpt_dir))
    fresh = MpNet()
    fresh_opt = create_optimizer(dict(opt="momentum", momentum=0.9,
                                      weight_decay=0.0), fresh.parameters())
    resumed = saver.restore(TrainState.create(fresh, fresh_opt))
    out["resumed_step"] = resumed.step
    out["resumed_equal"] = all(
        torch.equal(v, model.state_dict()[k])
        for k, v in fresh.state_dict().items())
    out["recovery"] = saver.find_recovery()["epoch"]

    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


# ---- the tests' side -------------------------------------------------------

def _mpnet_flax():
    """The JAX oracle's net and data, and its initial variables carried
    into the port's names."""
    import jax
    import jax.numpy as jnp
    from flax.traverse_util import flatten_dict

    sys.path.insert(0, HERE)
    from multiproc_child import _model_and_data

    from cotnet_tpu_torch.utils.convert import jax_to_torch_state_dict

    model, images, labels = _model_and_data()
    variables = model.init({"params": jax.random.PRNGKey(0)},
                           jnp.asarray(images), training=True)
    flat = {k: np.asarray(v) for k, v in
            flatten_dict(variables, sep="/").items()}
    sd = jax_to_torch_state_dict(flat)
    return {"state_dict": sd,
            "images": torch.from_numpy(np.ascontiguousarray(
                images.transpose(0, 3, 1, 2))),
            "labels": torch.from_numpy(labels.astype(np.int64))}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run the suite on two gloo ranks; their results by rank."""
    out_dir = tmp_path_factory.mktemp("ranks")
    torch.save(_mpnet_flax(), out_dir / "mpnet.pt")
    init = f"tcp://127.0.0.1:{mesh.free_port()}"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH", "")) if p))
    procs = [subprocess.Popen(
        [sys.executable, "-u", __file__, "suite", str(r), str(WORLD), init,
         str(out_dir)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env=env, text=True) for r in range(WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, f"rank failed:\n{o}"
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def rows_of(r):
    return mesh.rank_rows(8, r, WORLD)


def test_two_process_train_matches_jax_oracle(ranks):
    """``tests/test_multiproc.py`` in the port: both ranks hold the same
    bits after 3 global steps, and those match the JAX single-process
    oracle on the full batch (its fingerprints: the loss, the sum of
    |BN bias| and of |BN running mean|)."""
    a, b = ranks
    assert torch.equal(a["mp_loss"], b["mp_loss"])
    for k, v in a["mp_state"].items():
        assert torch.equal(v, b["mp_state"][k]), k
    sys.path.insert(0, HERE)
    from multiproc_child import oracle_steps
    loss, p_sum, b_sum = oracle_steps()
    got_p = float(a["mp_state"]["BatchNorm_0.bias"].double().abs().sum())
    got_b = float(a["mp_state"]["BatchNorm_0.running_mean"].double().abs()
                  .sum())
    np.testing.assert_allclose(float(a["mp_loss"]), loss, rtol=2e-5)
    np.testing.assert_allclose(got_p, p_sum, rtol=1e-4)
    np.testing.assert_allclose(got_b, b_sum, rtol=1e-4)


def test_collectives_at_world_size_two(ranks):
    for r, out in enumerate(ranks):
        torch.testing.assert_close(out["sum"], torch.tensor([3.0, 6.0]))
        torch.testing.assert_close(out["mean"], torch.tensor([1.5, 3.0]))
        torch.testing.assert_close(out["scaled"],
                                   torch.tensor([[1.5, 3.0], [3.0, 6.0]]))
        torch.testing.assert_close(out["gather"],
                                   torch.tensor([[1.0, 2.0], [2.0, 4.0]]))
        torch.testing.assert_close(out["partner"],
                                   torch.tensor([1.0, 2.0]) * (2 - r))
        # d/dx of sum_r' (r'+1) * sum(all_reduce(x)): 1 + 2 on every rank
        torch.testing.assert_close(out["sum_grad"], torch.full((2,), 3.0))
        torch.testing.assert_close(out["synced"], torch.tensor(
            [[0.5] * 3, [1.5] * 3]))
        torch.testing.assert_close(out["avg_grads"], torch.tensor(
            [1.5] * 3 + [2.5] * 5 + [3.5] * 7))
        torch.testing.assert_close(out["avg_loss"], torch.tensor(0.5))


def test_collective_timer_records_each_helper(ranks):
    """``CollectiveTimer`` counts each collective under the helper that ran
    it (the BN sums' forward and backward both under ``all_reduce_sum``),
    with the bytes a rank receives; CPU tensors on the host clock."""
    for out in ranks:
        by = out["timer"]
        assert {k: v[:2] for k, v in by.items()} == {
            "sum_tensor": [1, 8], "partner_rows": [1, 16],
            "all_gather_rows": [1, 16], "all_reduce_sum": [2, 16],
            "average_tensors": [1, 20]}, by
        assert all(v[2] >= 0.0 for v in by.values()), by


def test_collectives_at_world_size_one():
    """No process group: every collective is the identity, and the
    process is rank 0 of 1 with all the rows."""
    assert not torch.distributed.is_initialized()
    assert (mesh.rank(), mesh.world_size()) == (0, 1)
    assert mesh.rank_rows(8) == slice(0, 8)
    t = torch.tensor([1.0, 2.0])
    assert coll.sum_tensor(t) is t and coll.reduce_tensor(t) is t
    assert coll.scaled_all_reduce([t])[0] is t
    assert coll.all_reduce_sum(t) is t and coll.partner_rows(t) is t
    torch.testing.assert_close(coll.all_gather_rows(t), t[None])
    with coll.CollectiveTimer() as timer:  # records nothing at world 1
        coll.sum_tensor(t)
        coll.average_tensors([t])
    assert timer.by == {}
    p = nn.Parameter(torch.zeros(3))
    p.grad = torch.ones(3)
    assert coll.average_gradients([p], extra={"loss": t})["loss"] is t
    torch.testing.assert_close(p.grad, torch.ones(3))
    coll.barrier()
    bn = BatchNorm2d(2)
    coll.sync_batch_stats(bn)
    torch.testing.assert_close(bn.running_mean, torch.zeros(2))


def test_global_batch_bn_matches_one_process(ranks):
    """Each rank's BN output, input gradient and running stats equal one
    process's on the whole batch at its rows; the ranks' parameter
    gradients sum to the one process's (the step then averages them
    across ranks, as the global loss is their mean)."""
    data = global_data()
    full = bn_step(data["bn_x"], data["bn_r"], data["bn_w"], data["bn_b"])
    tol = dict(rtol=1e-5, atol=1e-5)
    for r, out in enumerate(ranks):
        torch.testing.assert_close(out["bn_y"], full["y"][rows_of(r)], **tol)
        torch.testing.assert_close(out["bn_dx"], full["dx"][rows_of(r)],
                                   **tol)
        torch.testing.assert_close(out["bn_mean"], full["mean"], **tol)
        torch.testing.assert_close(out["bn_var"], full["var"], **tol)
    for k in ("dw", "db"):
        torch.testing.assert_close(ranks[0][f"bn_{k}"] + ranks[1][f"bn_{k}"],
                                   full[k], **tol)


@pytest.mark.parametrize("mode", MIX_MODES)
def test_mixup_over_two_ranks_matches_one_process(ranks, mode):
    """Rank r's mixed rows and soft targets are the one-process mixup's at
    its rows: the flip pairs it with the other rank's rows, and the
    per-sample draws are the global batch's."""
    data = global_data()
    mix = Mixup(mixup_alpha=0.8, cutmix_alpha=1.0, mode=mode, num_classes=10)
    images, targets = mix(data["mix_images"], data["mix_labels"],
                          torch.Generator().manual_seed(7))
    for r, out in enumerate(ranks):
        torch.testing.assert_close(out[f"mix_{mode}"], images[rows_of(r)],
                                   rtol=0, atol=0)
        torch.testing.assert_close(out[f"mix_{mode}_targets"],
                                   targets[rows_of(r)], rtol=0, atol=0)


def test_eval_counts_are_summed_across_ranks(ranks):
    """The eval step's counts on two ranks are the one-process counts of
    the whole padded batch, on both ranks; the Evaler hands ReaL scoring
    the global batch's valid top-k rows."""
    data = global_data()
    batch = {"image": data["eval_images"], "label": data["eval_labels"],
             "valid": data["eval_valid"]}
    counts = make_eval_step(eval_model(), return_topk=True)(batch)
    want = torch.stack([counts["top1_count"], counts["top5_count"],
                        counts["n"]])
    for out in ranks:
        torch.testing.assert_close(out["counts"], want, rtol=0, atol=0)
        np.testing.assert_array_equal(out["real_rows"].numpy(),
                                      counts["topk"][:5].numpy())


def test_rank_zero_alone_writes_checkpoints(ranks):
    """Rank 0 writes the recovery file and the checkpoint, rank 1 writes
    nothing; after the barrier both see the files, and both restore the
    same state from them."""
    a, b = ranks
    assert a["writes"] == ["recovery.pth.tar", "checkpoint-1.pth.tar"]
    assert b["writes"] == []
    for out in ranks:
        assert {"checkpoint-1.pth.tar", "last.pth.tar", "recovery.pth.tar",
                "recovery.json", "index.json"} <= set(
                    out["files_after_barrier"])
        assert out["resumed_equal"] and out["resumed_step"] == 3
        assert out["recovery"] == 1


def test_initialize_distributed_explicit_failure_raises():
    """Explicit arguments that cannot form a group raise (rank outside
    the world, as ``multiproc_child.run_badinit``); nothing degrades to one
    process."""
    with pytest.raises(ValueError, match="outside world_size"):
        mesh.initialize_distributed("tcp://127.0.0.1:1", 1, 1, device="cpu")
    with pytest.raises(ValueError, match="need world_size and rank"):
        mesh.initialize_distributed("tcp://127.0.0.1:1", device="cpu")
    assert not torch.distributed.is_initialized()


def test_initialize_distributed_without_arguments_stays_one_process(
        monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
              "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert mesh.initialize_distributed(device="cpu") is False
    assert not torch.distributed.is_initialized()
    assert mesh.default_backend("cpu") == "gloo"
    assert mesh.default_backend() == "nccl"
    assert mesh.local_device() == torch.device("cuda", 0)
    with pytest.raises(ValueError, match="does not split"):
        mesh.rank_rows(7, 0, 2)


# ---- the loader's rank rows -------------------------------------------------

@pytest.fixture(scope="module")
def image_tree(tmp_path_factory):
    """3 classes of 5 small images, PNG and JPEG."""
    from PIL import Image

    root = tmp_path_factory.mktemp("imgs")
    rng = np.random.RandomState(1)
    for ci in range(3):
        d = root / f"class_{ci}"
        d.mkdir()
        for i in range(5):
            arr = rng.randint(0, 255, (36 + 3 * i, 40 + ci, 3),
                              dtype=np.uint8)
            Image.fromarray(arr).save(
                d / (f"img{i}.png" if i % 2 else f"img{i}.jpg"))
    return str(root)


LOADER_CASES = {
    # the host stage on worker processes (seeded per sample place), the
    # device policy and erasing drawn for the global batch
    "train": dict(train=True, worker_procs=True, workers=2,
                  auto_augment="rand-m9-n2", aug_backend="device",
                  reprob=0.5),
    "train_splits": dict(train=True, worker_procs=True, workers=2,
                         auto_augment="augmix-m3-w2", num_aug_splits=2,
                         reprob=0.5, remode="rand"),
    "eval": dict(train=False, workers=1),
}


@pytest.mark.parametrize("case", sorted(LOADER_CASES))
def test_loader_rank_rows_equal_one_process_rows(image_tree, case):
    """Each rank's batches are bitwise the one-process batches at its rows
    (``rank_rows``); eval pads the final global batch (15 images, batch 4)
    and each rank's ``valid`` is its slice of the global mask."""
    pytest.importorskip("PIL")
    from cotnet_tpu_torch.data import dataset
    from cotnet_tpu_torch.data import loader as port_loader

    kw = dict(LOADER_CASES[case])

    def batches(**rank_kw):
        ds = dataset.ImageFolderDataset(image_tree)
        loader = port_loader.Loader(ds, batch_size=4, image_size=16, seed=3,
                                    device="cpu", **kw, **rank_kw)
        loader.set_epoch(1)
        try:
            return list(loader)
        finally:
            loader.close()

    full = batches()
    splits = kw.get("num_aug_splits", 0) or 1
    for r in range(WORLD):
        got = batches(rank=r, world_size=WORLD)
        assert len(got) == len(full)
        rows = mesh.rank_rows(4, r, WORLD)
        for g, f in zip(got, full):
            want = torch.cat([f["image"][s * 4:(s + 1) * 4][rows]
                              for s in range(splits)])
            torch.testing.assert_close(g["image"], want, rtol=0, atol=0)
            torch.testing.assert_close(g["label"], f["label"][rows])
            torch.testing.assert_close(g["valid"], f["valid"][rows])
    if case == "eval":
        assert [int(b["valid"].sum()) for b in full] == [4, 4, 4, 3]


def test_synthetic_loader_rank_rows():
    from cotnet_tpu_torch.data.loader import SyntheticLoader

    full = next(iter(SyntheticLoader(8, 8, 10, steps=1, device="cpu")))
    for r in range(WORLD):
        got = next(iter(SyntheticLoader(8, 8, 10, steps=1, device="cpu",
                                        rank=r, world_size=WORLD)))
        for k in ("image", "label", "valid"):
            torch.testing.assert_close(got[k], full[k][rows_of(r)], rtol=0,
                                       atol=0)


def test_cli_trains_on_two_cpu_ranks_under_torchrun(tmp_path):
    """``python -m torch.distributed.run --nproc_per_node 2 -m
    cotnet_tpu_torch.train_cli --device cpu --synthetic``: cotnet50 at 32
    px, global batch 4 (2 a rank), one epoch of 2 steps.  Rank 0 alone
    writes the log and the checkpoints; the eval counts the global batch."""
    text = open(os.path.join(REPO, "cot_experiments", "CoTNet-50-350epoch",
                             "config.yaml")).read()
    exp = tmp_path / "exp"
    exp.mkdir()
    (exp / "config.yaml").write_text(text.replace("recovery_interval: 10",
                                                  "recovery_interval: 1"))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH", "")) if p))
    p = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
         "--nproc_per_node", "2", "--master_addr", "127.0.0.1",
         "--master_port", str(mesh.free_port()), "-m",
         "cotnet_tpu_torch.train_cli", "--folder", str(exp), "--device",
         "cpu", "--synthetic", "--steps", "2", "--epochs", "1",
         "--img-size", "32", "--batch-size", "4", "--model", "cotnet50"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True,
        timeout=240, cwd=str(tmp_path))
    assert p.returncode == 0, p.stdout
    log = (exp / "log.txt").read_text()
    assert log.count("eval epoch 1: ") == 1, log
    assert "(4 samples)" in log and "done; best top1:" in log
    assert sorted(x.name for x in (exp / "checkpoints").iterdir()) == [
        "checkpoint-1.pth.tar", "index.json", "last.pth.tar",
        "recovery.json", "recovery.pth.tar"]
    ckpt = torch.load(exp / "checkpoints" / "checkpoint-1.pth.tar",
                      weights_only=False)
    assert ckpt["step"] == 2 and "state_dict" in ckpt


def test_dryrun_multiproc_two_cpu_ranks(monkeypatch):
    """cotnet50 and se_cotnetd_50 at 64 px, global batch 16, nesterov SGD
    with norm clipping, the EMA and mixup, on two spawned gloo ranks: the
    loss falls, the ranks agree, and the padded eval counts its 14 valid
    rows of 16."""
    from cotnet_tpu_torch.parallel.dryrun import FAMILIES, dryrun_multiproc

    # the spawned ranks write c10d's warnings past pytest's capture, onto
    # the run's progress lines (a host without a resolvable name warns once
    # a rank); errors still show
    monkeypatch.setenv("TORCH_CPP_LOG_LEVEL", "ERROR")

    results = dryrun_multiproc(2, "cpu")
    assert [r["name"] for r in results] == list(FAMILIES)
    for r in results:
        assert r["eval"]["n"] == 14.0
        assert np.mean(r["losses"][-3:]) < np.mean(r["losses"][:3])


if __name__ == "__main__":
    if sys.argv[1] != "suite":
        raise SystemExit(f"unknown mode {sys.argv[1]}")
    rank_suite(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
