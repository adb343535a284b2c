"""Evaluator, counterpart of ``cotnet_tpu/evaler.py`` (reference
evaler/evaler.py): top-1/top-5 over a validation loader, of the live
weights or of the EMA, optionally with horizontal-flip TTA and ImageNet
ReaL labels.

The loader pads its last batch and marks the padding in ``valid``, so the
counts are exact; the padded rows are dropped before ReaL scoring.  The
EMA is evaluated through ``make_eval_step``'s ``tensors``: the live weights
stay as they are.  Data parallel: the step's counts are global, and for
ReaL scoring ``topk`` and ``valid`` are gathered from every rank in rank
order, the global batch's rows.
"""

from __future__ import annotations

from cotnet_tpu_torch.parallel.collectives import all_gather_rows
from cotnet_tpu_torch.train.step import make_eval_step
from cotnet_tpu_torch.utils.meters import TestMeter


class Evaler:
    def __init__(self, model, loader, logger=None, use_ema: bool = False,
                 tta_hflip: bool = False, real_labels=None):
        self.loader = loader
        self.logger = logger
        self.eval_step = make_eval_step(model, tta_hflip=tta_hflip,
                                        return_topk=real_labels is not None)
        self.use_ema = use_ema
        self.real_labels = real_labels  # RealLabelsImagenet, optional

    def __call__(self, epoch: int, state) -> dict:
        if self.use_ema and state.ema is None:
            raise ValueError("Evaler(use_ema=True) needs a state with an EMA")
        tensors = state.ema if self.use_ema else None
        meter = TestMeter(self.logger)
        if self.real_labels is not None:
            self.real_labels.reset()
        for batch in self.loader:
            m = self.eval_step(batch, tensors)
            meter.update(m["top1_count"], m["top5_count"], m["n"])
            if self.real_labels is not None:
                topk = all_gather_rows(m["topk"]).flatten(0, 1)
                if "valid" in batch:  # drop the eval padding rows
                    valid = all_gather_rows(batch["valid"]).flatten()
                    topk = topk[:int(valid.sum())]
                self.real_labels.add_result(topk.cpu().numpy())
        meter.log_stats(epoch, tag="(ema)" if self.use_ema else "")
        out = {"top1": meter.top1_pct, "top5": meter.top5_pct,
               "samples": meter.n}
        if self.real_labels is not None:
            out["real_top1"] = self.real_labels.get_accuracy(1)
            out["real_top5"] = self.real_labels.get_accuracy(5)
        return out
