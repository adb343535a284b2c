"""JAX (flax) variables -> the port's state_dict.

The inverse of ``cotnet_tpu.utils.convert.convert_torch_state_dict``
(``cotnet_tpu/utils/convert.py:475-605``) for the names the CoT family
uses, so
weights made by the JAX package load into the port, and the port's
state_dict is the reference's torch layout:

- conv kernels HWIO -> OIHW; the classifier Dense ``[I, O]`` -> Linear
  ``[O, I]``; the CotLayer SE Dense layers -> 1x1 convs ``[O, I, 1, 1]``
  (the reference's ``se.0``/``se.3``);
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
"""

from __future__ import annotations

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
            elif owner in _SE_DENSE:
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
