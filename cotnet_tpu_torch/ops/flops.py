"""Model complexity, counterpart of ``cotnet_tpu/ops/flops.py`` (reference
utils/flops_counter.py:24-60).

``torch.utils.flop_counter.FlopCounterMode`` counts the convolutions and
matrix products of a forward.  It does not see the CoT op: on the card its
kernels are bound with ctypes, and its plain version is elementwise
products.  So for the length of a count, each of the op's entry points is
replaced, in every module of this package that holds it, by a shape
function that adds the op's multiply-adds and returns an empty output:

- ``local_aggregate``: N * heads * C * Ho * Wo * K^2;
- ``local_aggregate_mix`` / ``_mix_merge``: both halves, K1^2 + K2^2 taps;
- ``local_aggregate_embed_gn``: the embed 1x1 product and the
  aggregation.

The count runs on the ``meta`` device, so it computes nothing and
launches no kernel and no plain version.  Elementwise work (norms,
activations, the softmax) is not counted, as the reference's hooks and the
paper's MAC counts leave it out; the JAX package takes XLA's cost
analysis, which counts it too, so its figure is larger by definition.
"""

from __future__ import annotations

import contextlib
import sys
from typing import Tuple

import torch
from torch.func import functional_call
from torch.utils.flop_counter import FlopCounterMode

from cotnet_tpu_torch.ops import local_agg


def count_params(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def aggregation_macs(x_shape, w_shape) -> int:
    """Multiply-adds of ``local_aggregate(x, w)``: each of the
    ``[N, heads*C, Ho, Wo]`` outputs sums K^2 products."""
    n, heads, _, k2, ho, wo = w_shape
    return n * heads * x_shape[1] * ho * wo * k2


def embed_gn_macs(x_shape, w_pre_shape, w2_shape, k2: int) -> int:
    """Multiply-adds of ``local_aggregate_embed_gn``: the grouped 1x1
    product (F outputs a pixel, each of Cp inputs) and the aggregation of
    x's C channels over K^2 taps."""
    n, _, ho, wo = w_pre_shape
    f, cp = w2_shape[0], w2_shape[1]
    return n * ho * wo * (f * cp + x_shape[1] * k2)


def _stand_ins(total: list) -> dict:
    """The op's entry points -> functions of their shapes that add their
    multiply-adds to ``total[0]``."""

    def aggregate(x, w, **_):
        total[0] += aggregation_macs(x.shape, w.shape)
        n, heads, _, _, ho, wo = w.shape
        return x.new_empty(n, heads * x.shape[1], ho, wo)

    def mix(x, w1, w2, **_):
        total[0] += (aggregation_macs(x.shape, w1.shape)
                     + aggregation_macs(x.shape, w2.shape))
        n, heads, _, _, ho, wo = w1.shape
        return x.new_empty(n, 2 * heads * x.shape[1], ho, wo)

    def mix_merge(x, w, **_):
        # the packed weight holds both halves' taps
        total[0] += aggregation_macs(x.shape, w.shape)
        n, heads, _, _, ho, wo = w.shape
        return x.new_empty(n, 2 * heads * x.shape[1], ho, wo)

    def embed_gn(x, w_pre, w2, b2, gamma, beta, *, kernel_size=3, **_):
        kh, kw = local_agg._pair(kernel_size)
        total[0] += embed_gn_macs(x.shape, w_pre.shape, w2.shape, kh * kw)
        return x.new_empty(*x.shape[:2], *w_pre.shape[2:])

    return {local_agg.local_aggregate: aggregate,
            local_agg.local_aggregate_mix: mix,
            local_agg.local_aggregate_mix_merge: mix_merge,
            local_agg.local_aggregate_embed_gn: embed_gn}


@contextlib.contextmanager
def _count_op_macs():
    """Replace the op's entry points in every loaded module of this package
    for the length of the block; yields ``[macs]``."""
    total = [0]
    stand_ins = _stand_ins(total)
    swapped = []
    for name, module in list(sys.modules.items()):
        if not name.startswith("cotnet_tpu_torch") or module is None:
            continue
        for attr, value in list(vars(module).items()):
            if callable(value) and value in stand_ins:
                swapped.append((module, attr, value))
                setattr(module, attr, stand_ins[value])
    try:
        yield total
    finally:
        for module, attr, value in swapped:
            setattr(module, attr, value)


def get_model_complexity(model: torch.nn.Module,
                         input_size=(1, 3, 224, 224),
                         dtype: torch.dtype = torch.float32
                         ) -> Tuple[float, int]:
    """``(GMACs per image, parameters)`` of an eval forward at
    ``input_size`` (NCHW), counted on the ``meta`` device: the model's own
    tensors are not touched, and nothing runs on its device."""
    tensors = {k: torch.empty_like(v, device="meta")
               for k, v in list(model.named_parameters())
               + list(model.named_buffers())}
    x = torch.empty(input_size, dtype=dtype, device="meta")
    was_training = model.training
    model.eval()
    try:
        with _count_op_macs() as op_macs, \
                FlopCounterMode(display=False) as counter, torch.no_grad():
            functional_call(model, tensors, (x,))
    finally:
        model.train(was_training)
    macs = counter.get_total_flops() / 2 + op_macs[0]
    return macs / input_size[0] / 1e9, count_params(model)
