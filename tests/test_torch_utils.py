"""The port's utils, flop counter and evaler against the JAX package.

- ``accuracy_counts`` and the meters' log lines equal the JAX package's
  byte for byte on the same inputs; the timer, the logger's rank-0 gate and
  ``log.txt``.
- ``utils.profiler``: ``trace`` writes a Chrome trace holding the
  annotated region; ``start_server`` has no PyTorch counterpart and raises.
- ``ops.flops``: cotnet50's parameter count exactly and the published 3.3
  GMACs within 3% (the count leaves elementwise work out, as the paper's
  does); the CoT op's multiply-adds N * C * H * W * K^2 from shapes at
  each call, the mix op's two halves and the fused embed op's product; the
  count runs on the meta device and calls no plain version.
- ``Evaler``: the EMA evaluated without touching the live weights, equal to
  a model that holds the EMA; the eval padding dropped before ReaL scoring.
"""

import contextlib
import json
import logging
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from cotnet_tpu.utils import meters as jax_meters  # noqa: E402
from cotnet_tpu_torch.data.real_labels import RealLabelsImagenet  # noqa: E402
from cotnet_tpu_torch.evaler import Evaler  # noqa: E402
from cotnet_tpu_torch.models import create_model  # noqa: E402
from cotnet_tpu_torch.models.cotnet import CotBottleneck  # noqa: E402
from cotnet_tpu_torch.models.resnet import ResNet  # noqa: E402
from cotnet_tpu_torch.ops import flops  # noqa: E402
from cotnet_tpu_torch.ops import local_agg as la  # noqa: E402
from cotnet_tpu_torch.train.optim import create_optimizer  # noqa: E402
from cotnet_tpu_torch.train.state import TrainState  # noqa: E402
from cotnet_tpu_torch.utils import logger as port_logger  # noqa: E402
from cotnet_tpu_torch.utils import meters, profiler  # noqa: E402
from cotnet_tpu_torch.utils.timer import Timer  # noqa: E402
from test_torch_cotnet import SMALL_NET  # noqa: E402


class _Lines:
    def __init__(self):
        self.lines = []

    def info(self, msg):
        self.lines.append(msg)


@pytest.mark.parametrize("seed", range(3))
def test_accuracy_counts_match_jax(seed):
    rng = np.random.RandomState(seed)
    logits = rng.randn(32, 20).astype(np.float32)
    labels = rng.randint(0, 20, size=32)
    for topk in ((1, 5), (1,), (2, 3, 7)):
        assert meters.accuracy_counts(logits, labels, topk) == \
            jax_meters.accuracy_counts(logits, labels, topk)


def test_meter_log_lines_match_jax():
    """TrainMeter's line at each log interval and TestMeter's line, given
    the same losses, LRs and iteration times (0 MiB of device memory on
    both sides, the CPU having no card statistics)."""
    lines = {}
    for name, mod in (("port", meters), ("jax", jax_meters)):
        log = _Lines()
        meter = mod.TrainMeter(epoch_iters=10, max_epoch=3, log_interval=4,
                               logger=log, batch_size=80)
        rng = np.random.RandomState(0)
        for it in range(10):
            meter.iter_time.add_value(0.1 + 0.01 * rng.rand())
            meter.update(2.0 + rng.rand(), 0.25 * (1 - it / 10))
            meter.log_iter_stats(1, it)
        test = mod.TestMeter(log)
        test.update(37.0, 90.0, 128.0)
        test.update(5.0, 30.0, 37.0)
        test.log_stats(2)
        test.log_stats(2, tag="(ema)")
        lines[name] = log.lines
    assert lines["port"] == lines["jax"]
    assert len(lines["port"]) == 4
    assert lines["port"][-1] == ("eval(ema) epoch 3: top1 25.455 top5 "
                                 "72.727 (165 samples)")
    assert meters.device_mem_mb() == 0.0


def test_scalar_and_average_meters():
    s = meters.ScalarMeter(window_size=3)
    for v in (1.0, 5.0, 2.0, 8.0):
        s.add_value(v)
    assert s.get_win_median() == 5.0 and s.get_win_avg() == 5.0
    assert s.get_global_avg() == 4.0
    a = meters.AverageMeter()
    a.update(2.0, n=3)
    a.update(6.0)
    assert a.avg == 3.0


def test_timer():
    t = Timer()
    t.tic()
    assert t.toc() >= 0.0 and t.calls == 1
    with pytest.raises(RuntimeError):
        t.toc()


def test_logger_writes_log_txt_on_rank_zero(tmp_path):
    assert port_logger.is_master_process()
    log = port_logger.setup_default_logging(str(tmp_path), name="t_utils")
    port_logger.logger_info(log, "hello from rank 0")
    for handler in log.handlers:
        handler.flush()
    assert "hello from rank 0" in (tmp_path / "log.txt").read_text()
    # a second setup closes the first file handler instead of leaking it
    old = [h for h in log.handlers if isinstance(h, logging.FileHandler)]
    port_logger.setup_default_logging(str(tmp_path), name="t_utils")
    assert all(h.stream is None for h in old)


@contextlib.contextmanager
def _fds_into(path):
    """File descriptors 1 and 2 into ``path`` for the block: the profiler's
    C++ side logs its start and stop there, past pytest's capture, where
    the lines would break the run's progress lines."""
    sys.stdout.flush()
    sys.stderr.flush()
    saved = [os.dup(1), os.dup(2)]
    with open(path, "w") as f:
        os.dup2(f.fileno(), 1)
        os.dup2(f.fileno(), 2)
        try:
            yield
        finally:
            sys.stdout.flush()
            sys.stderr.flush()
            for fd, old in zip((1, 2), saved):
                os.dup2(old, fd)
                os.close(old)


def test_profiler_trace_and_annotation(tmp_path):
    with _fds_into(tmp_path / "profiler.log"), \
            profiler.trace(str(tmp_path)) as prof:
        with profiler.annotate("cot region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "cot region" for e in events)
    assert any("mm" in e.key for e in prof.key_averages())
    with pytest.raises(NotImplementedError, match="live-capture"):
        profiler.start_server(9999)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            profiler.device_memory_profile(str(tmp_path / "mem.pickle"))


# ---- the flop counter -----------------------------------------------------

# (C, map, layers) of cotnet50's CoT layers at 224
COTNET50_COT = ((64, 56, 3), (128, 28, 4), (256, 14, 6), (512, 7, 3))
# the paper's table (reference README.md:45-52): cotnet50 3.3 GFLOPs
# (multiply-adds) and 22.2M parameters; the count here leaves out the
# elementwise work, so it is held to 3% of the rounded figure
PUBLISHED_GMACS = 3.3
GMACS_RTOL = 0.03


def test_cotnet50_complexity():
    model = create_model("cotnet50", device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    plain = (la.PLAIN_CALLS, la.LAUNCHES)
    gmacs, params = flops.get_model_complexity(model)
    assert params == 22222416 == sum(p.numel() for p in model.parameters())
    assert round(params / 1e6, 1) == 22.2
    assert abs(gmacs - PUBLISHED_GMACS) <= GMACS_RTOL * PUBLISHED_GMACS
    assert (la.PLAIN_CALLS, la.LAUNCHES) == plain
    assert not model.training
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    # the op's share: 16 aggregations of N*C*H*W*9 at batch 2
    with flops._count_op_macs() as op_macs:
        tensors = {k: torch.empty_like(v, device="meta")
                   for k, v in model.state_dict().items()}
        torch.func.functional_call(
            model, tensors, (torch.empty(2, 3, 224, 224, device="meta"),))
    assert op_macs[0] == 2 * sum(c * hw * hw * 9 * n
                                 for c, hw, n in COTNET50_COT)
    # the entry points are back in place
    from cotnet_tpu_torch.models import cotnet
    assert cotnet.local_aggregate is la.local_aggregate


class _OpCalls(torch.nn.Module):
    """Calls each of the op's entry points through the module attribute."""

    def __init__(self, which):
        super().__init__()
        self.which = which
        self.scale = torch.nn.Parameter(torch.ones(1))

    def forward(self, x):
        n, c, h, w = x.shape
        if self.which == "aggregate":
            wt = x.new_zeros(n, 2, c // 4, 25, h, w)
            return la.local_aggregate(x, wt, kernel_size=5) * self.scale
        if self.which == "mix":
            w1 = x.new_zeros(n, 1, c // 4, 9, h, w)
            w2 = x.new_zeros(n, 1, c // 4, 25, h, w)
            return la.local_aggregate_mix(x, w1, w2)
        if self.which == "mix_merge":
            wt = x.new_zeros(n, 1, c // 4, 34, h, w)
            return la.local_aggregate_mix_merge(x, wt)
        w_pre = x.new_zeros(n, 6, h, w)
        f = (c // 8) * 9
        return la.local_aggregate_embed_gn(
            x, w_pre, x.new_zeros(f, 6), x.new_zeros(f), x.new_ones(f),
            x.new_zeros(f), kernel_size=3)


@pytest.mark.parametrize("which, macs", [
    ("aggregate", 3 * 2 * 16 * 7 * 5 * 25),     # N * heads * C * H * W * K^2
    ("mix", 3 * 16 * 7 * 5 * (9 + 25)),          # both halves
    ("mix_merge", 3 * 16 * 7 * 5 * (9 + 25)),
    ("embed_gn", 3 * 7 * 5 * 18 * 6 + 3 * 16 * 7 * 5 * 9),  # product + agg
])
def test_op_macs_from_shapes(which, macs):
    gmacs, params = flops.get_model_complexity(_OpCalls(which),
                                               (3, 16, 7, 5))
    assert params == 1
    assert gmacs * 1e9 * 3 == pytest.approx(macs, rel=1e-12)
    assert la.local_aggregate_mix.__name__ == "local_aggregate_mix"


# ---- the evaler -----------------------------------------------------------

def _small_state(seed):
    torch.manual_seed(seed)
    model = ResNet(block=CotBottleneck, **SMALL_NET)
    opt = create_optimizer(dict(opt="sgd"), model.parameters(), lr=0.1)
    state = TrainState.create(model, opt, ema=True)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for v in state.ema.values():
            v.add_(0.3 * torch.randn(v.shape, generator=gen)).abs_()
    return state


def _batches(n=2, valid_last=3):
    gen = torch.Generator().manual_seed(7)
    out = []
    for i in range(n):
        valid = torch.ones(4)
        if i == n - 1:
            valid[valid_last:] = 0
        out.append({"image": torch.randn(4, 3, 64, 64, generator=gen),
                    "label": torch.randint(0, 10, (4,), generator=gen),
                    "valid": valid})
    return out


def test_evaler_ema_leaves_the_live_weights():
    """Evaler(use_ema=True) equals the eval of a model holding the EMA, and
    the live weights stay as they were."""
    state = _small_state(0)
    live = {k: v.clone() for k, v in state.model.state_dict().items()}
    batches = _batches()
    log = _Lines()
    got = Evaler(state.model, batches, log, use_ema=True)(0, state)
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, live[k]), k
    twin = ResNet(block=CotBottleneck, **SMALL_NET)
    twin.load_state_dict({**live, **state.ema})
    ref = Evaler(twin, batches, _Lines())(0, state)
    assert got == ref and got["samples"] == 7.0
    assert log.lines[0].startswith("eval(ema) epoch 1:")
    plain = Evaler(state.model, batches, _Lines())(0, state)
    assert plain["samples"] == 7.0
    with pytest.raises(ValueError, match="EMA"):
        Evaler(state.model, batches, use_ema=True)(
            0, TrainState(state.model, state.optimizer))


def test_evaler_real_labels_drop_padding(tmp_path):
    """ReaL scoring sees only the valid rows: 7 images over two batches of
    4, the last padded by one."""
    state = _small_state(1)
    batches = _batches()
    names = [f"ILSVRC2012_val_{i + 1:08d}.JPEG" for i in range(7)]
    # each image's ReaL set: its label and one other class
    labels = [int(b["label"][j]) for b in batches for j in range(4)][:7]
    real = [[lab, (lab + 1) % 10] for lab in labels]
    path = tmp_path / "real.json"
    path.write_text(json.dumps(real))
    evaler = Evaler(state.model, batches, _Lines(),
                    real_labels=RealLabelsImagenet(names, str(path)))
    out = evaler(0, state)
    assert evaler.real_labels.sample_idx == 7
    assert 0.0 <= out["real_top1"] <= 100.0
    assert out["real_top5"] >= out["top5"]
    # a second pass starts afresh
    assert evaler(0, state)["real_top1"] == out["real_top1"]
