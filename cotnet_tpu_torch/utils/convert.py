"""JAX (flax) variables -> the port's state_dict, and the reference's
checkpoint files into the port.

The inverse of ``cotnet_tpu.utils.convert.convert_torch_state_dict``
(``cotnet_tpu/utils/convert.py:475-605``) for the names the CoT family
uses, so
weights made by the JAX package load into the port, and the port's
state_dict is the reference's torch layout:

- conv kernels HWIO -> OIHW; the classifier Dense ``[I, O]`` -> Linear
  ``[O, I]``; the CotLayer SE Dense layers and those of a block's
  attention module (``se/fc1``, ``se/fc2``, ``se/fc``) -> 1x1 convs
  ``[O, I, 1, 1]`` (the reference's ``se.0``/``se.3``, ``se.fc1`` ...);
  ECA's 1-D kernel ``[k, 1, 1]`` -> Conv1d ``[1, 1, k]``;
- norm ``scale``/``bias`` -> ``weight``/``bias``; BN ``mean``/``var`` ->
  ``running_mean``/``running_var`` with ``num_batches_tracked`` = 0;
- ``layer1_0`` -> ``layer1.0``, ``head/fc`` -> ``fc``,
  ``downsample/{conv,bn}`` -> ``downsample.{0,1}`` (``downsample.{1,2}``
  with ``avg_down``, behind the avg-pool), CotLayer children by the
  reference's Sequential indices, the deep stem's ``conv1_0`` ...
  ``conv1_2`` by those of ``conv1``; SplitAttn children (``conv``,
  ``bn0``, ``fc1``, ``bn1``, ``fc2``) keep their names;
- the attention-embed producer (``embed_conv2`` and ``embed_gn``) has its
  output channels permuted from the JAX package's k-major order
  (k*Cw + cw) back to the reference's cw-major order (cw*K^2 + k), within
  each of the layer's ``dw_group`` channel groups (2 for CoTNeXt).

The port's state_dict keys are the reference's, so a reference
``.pth.tar`` needs no key conversion: ``load_checkpoint_into`` reads it
(``module.`` stripped, ``state_dict_ema`` under ``use_ema``) and loads it,
with the first conv adapted to ``in_chans`` and a fresh classifier where the
class count differs (``surgery``), as
``cotnet_tpu/utils/convert.py:40-62, 608-641`` do for the JAX package.
"""

from __future__ import annotations

import argparse
import re
from typing import Dict

import numpy as np
import torch

# CotLayer submodule names -> the reference's Sequential paths
# (models/cotnet.py:43-77); the same table as the JAX package's converter
_COT = {"key_embed_conv": "key_embed.0", "key_embed_bn": "key_embed.1",
        "embed_conv1": "embed.0", "embed_bn1": "embed.1",
        "embed_conv2": "embed.3", "embed_gn": "embed.4",
        "conv1x1_conv": "conv1x1.0", "conv1x1_bn": "conv1x1.1",
        "bn": "bn", "se_fc1": "se.0", "se_bn": "se.1", "se_fc2": "se.3"}
_SE_DENSE = ("se_fc1", "se_fc2")
# the deep stem's convs and BNs -> the reference's conv1 Sequential indices
# (the same table as the JAX package's converter)
_DEEP_STEM = {"conv1_0": "conv1.0", "bn1_0": "conv1.1",
              "conv1_1": "conv1.3", "bn1_1": "conv1.4",
              "conv1_2": "conv1.6"}
_EMBED_PRODUCER = ("embed_conv2", "embed_gn")


def _kmajor_perm(n: int, k2: int, groups: int = 1) -> np.ndarray:
    """cw-major -> k-major channel permutation, per group: k-major channel i
    holds cw-major channel perm[i] (within a group, torch channel
    cw*k2 + k, the JAX package's k*cw_g + cw)."""
    per = n // groups
    cw_g = per // k2
    return np.asarray([g * per + c * k2 + k for g in range(groups)
                       for k in range(k2) for c in range(cw_g)])


def _module_path(parts, avg_down: bool = False) -> str:
    out = []
    i = 0
    down = {"conv": "1", "bn": "2"} if avg_down else {"conv": "0", "bn": "1"}
    while i < len(parts):
        p = parts[i]
        if i == 0 and p in _DEEP_STEM:
            out.append(_DEEP_STEM[p])
        elif i == 0 and p.startswith("layer") and "_" in p:
            stage, blk = p.split("_", 1)
            out.append(f"{stage}.{blk}")
        elif p == "head":
            pass  # chassis ClassifierHead nesting: head/fc -> fc
        elif p == "downsample":
            out.append("downsample." + down[parts[i + 1]])
            i += 1
        elif p in _COT:
            out.append(_COT[p])
        else:
            out.append(p)
        i += 1
    return ".".join(out)


def jax_to_torch_state_dict(flat: Dict[str, np.ndarray], *,
                            kernel_size: int = 3, dw_group: int = 1,
                            avg_down: bool = False
                            ) -> Dict[str, torch.Tensor]:
    """``{"params/.../kernel": array, "batch_stats/.../mean": array, ...}``
    (the JAX ``{params, batch_stats}`` flattened to '/'-joined keys) -> the
    port's state_dict of float32 tensors.  ``dw_group`` is 2 for the
    CoTNeXt models (CoXtLayer), else 1; ``avg_down`` is True for the
    SE-CoTNetD models (the ResNet-D shortcut)."""
    k2 = kernel_size * kernel_size
    sd = {}
    for key, val in flat.items():
        collection, *parts, leaf = key.split("/")
        val = np.asarray(val, dtype=np.float32)
        mod = _module_path(parts, avg_down)
        owner = parts[-1]
        if collection == "batch_stats":
            sd[f"{mod}.running_{leaf}"] = val
            sd[f"{mod}.num_batches_tracked"] = np.zeros((), np.int64)
            continue
        if collection != "params":
            raise KeyError(f"unknown collection in {key!r}")
        if leaf == "kernel":
            if val.ndim == 4:
                val = np.transpose(val, (3, 2, 0, 1))
            elif val.ndim == 3:  # ECA's Conv1d
                val = np.transpose(val, (2, 1, 0))
            elif owner in _SE_DENSE or parts[-2:-1] == ["se"]:
                val = val.T[:, :, None, None]
            else:
                val = val.T
            name = "weight"
        elif leaf == "scale":
            name = "weight"
        elif leaf == "bias":
            name = "bias"
        else:
            raise KeyError(f"unknown leaf in {key!r}")
        if owner in _EMBED_PRODUCER:
            val = val[np.argsort(_kmajor_perm(val.shape[0], k2, dw_group))]
        sd[f"{mod}.{name}"] = val
    # own, writable memory: arrays that come from JAX are read-only
    return {k: torch.from_numpy(np.require(v, requirements="CW"))
            for k, v in sd.items()}


def load_torch_checkpoint(path: str, use_ema: bool = False,
                          map_location="cpu") -> Dict[str, torch.Tensor]:
    """A checkpoint file's state_dict in the reference's dict layout
    (models/helpers.py:23-43): ``state_dict_ema`` where ``use_ema`` and the
    file has one, else ``state_dict``, else ``model``, else the file itself;
    keys with the ``module.`` prefix of a DataParallel model stripped.

    Read with ``weights_only=True``: tensors, containers and numbers, and
    the ``argparse.Namespace`` the reference's saver stores as ``args``;
    nothing else in the file is unpickled."""
    with torch.serialization.safe_globals([argparse.Namespace]):
        ckpt = torch.load(path, map_location=map_location, weights_only=True)
    sd = ckpt
    if isinstance(ckpt, dict):
        key = "state_dict_ema" if use_ema and "state_dict_ema" in ckpt else (
            "state_dict" if "state_dict" in ckpt else None)
        if key is not None:
            sd = ckpt[key]
        elif "model" in ckpt:
            sd = ckpt["model"]
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in sd.items()}


def adapt_input_conv(weight: torch.Tensor, in_chans: int) -> torch.Tensor:
    """First-conv surgery for ``in_chans`` != the weight's (reference
    helpers.py:91-126), OIHW: one channel is the sum over RGB; other
    counts tile the channels and rescale by ``cin / in_chans``."""
    cin = weight.shape[1]
    if in_chans == cin:
        return weight
    if in_chans == 1:
        return weight.sum(dim=1, keepdim=True)
    reps = -(-in_chans // cin)
    return weight.repeat(1, reps, 1, 1)[:, :in_chans] * (cin / in_chans)


def surgery(state_dict: Dict[str, torch.Tensor],
            model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """``state_dict`` against ``model``'s own shapes (reference
    load_pretrained, helpers.py:127-153): a conv whose input channels
    differ is adapted (``adapt_input_conv``), any other tensor of another
    shape (the classifier of another class count) is left out, so the
    model keeps its fresh one; keys the model does not have are dropped."""
    out = {}
    for key, ref in model.state_dict().items():
        v = state_dict.get(key)
        if v is None:
            continue
        if tuple(v.shape) != tuple(ref.shape):
            if v.dim() == 4 and v.shape[0] == ref.shape[0] \
                    and v.shape[2:] == ref.shape[2:]:
                v = adapt_input_conv(v, ref.shape[1])
            else:
                continue
        out[key] = v
    return out


def model_avg_down(model_name: str) -> bool:
    """Whether the family uses the avg-pool shortcut (ResNet-D), whose
    downsample keys sit at ``.1``/``.2`` instead of ``.0``/``.1``: the
    SE-CoTNetD models do (cotnet_hybrid.py make_blocks); CoTNet and CoTNeXt
    do not, and a cardinality suffix like ``2x48d`` is no ResNet-D
    marker."""
    if "cotnext" in model_name or re.search(r"\d+x\d+d$", model_name):
        return False
    return "cotnetd" in model_name or model_name.endswith("d")


def load_checkpoint_into(model: torch.nn.Module, path: str,
                         use_ema: bool = False, strict: bool = True,
                         in_chans: int = 3):
    """Load a reference-layout checkpoint file into ``model`` in place, on
    the model's device.  With ``in_chans`` != 3 the state_dict goes through
    ``surgery`` first and loads without ``strict`` (a fresh classifier may
    stay), as ``cotnet_tpu.utils.convert.convert_torch_checkpoint`` does.
    Returns ``load_state_dict``'s missing and unexpected keys."""
    device = next(model.parameters()).device
    sd = load_torch_checkpoint(path, use_ema=use_ema, map_location=device)
    if in_chans != 3:
        sd = surgery(sd, model)
    return model.load_state_dict(sd, strict=strict and in_chans == 3)
