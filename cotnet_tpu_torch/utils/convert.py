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
  each of the layer's ``dw_group`` channel groups (2 for CoTNeXt);
- the comparison families (``family``, from ``model_family``), the inverse
  of the JAX converter's ``FAMILY_ADAPTERS``
  (``cotnet_tpu/utils/convert.py:231-259``): SAN's ``conv_w_*`` and
  ``key_embed_*`` to their Sequential indices, ``sam/conv`` to
  ``sam.conv.0``, and SAM's K^2 weight producer ``conv_w_conv2`` back to
  cw-major; BoTNet's ``mhsa`` and ``conv2`` to ``conv2.0``, ``bn2`` to
  ``conv2.1``, the projections to ``q_proj.w`` ...; LambdaNet's
  ``to_q``/``bn_q`` and ``to_v``/``bn_v`` to ``to_q.{0,1}`` and
  ``to_v.{0,1}``, its ``embeddings`` ``[dim_k, r, r]`` to the conv3d
  kernel ``[dim_k, 1, 1, r, r]``; ResNet-DW's ``conv2_{pw,bn,dw}`` to
  ``conv2.{0,1,3}``.  Other raw parameters (LR-Net's ``pos_h`` and
  ``pos_w``, BoTNet's ``rel_emb_h``/``rel_emb_w``) are copied as they are;
- the transformer core, the inverse of the JAX converter's ``vit``,
  ``resnetv2`` and ``vit_hybrid`` adapters (``cotnet_tpu/utils/convert.py:
  84, 201, 280-311``): ViT's ``patch_embed`` to ``patch_embed.proj`` and
  ``blocks_{i}`` to ``blocks.{i}``, its Dense kernels transposed and its
  token parameters (``cls_token``, ``dist_token``, ``pos_embed``) copied as
  they are; ResNetV2's ``stage{S}_block{B}`` to ``stages.{S-1}.blocks.{B-1}``,
  a block's ``c1/conv`` ... to ``conv1``/``norm1`` ..., ``downsample`` to
  ``downsample.conv``/``.norm``, the stems to ``stem.conv``/``stem.norm``
  (``stem.conv1``/``norm1`` ... in the deep ones) and ``fc`` to
  ``head.fc``; the hybrids' ``backbone`` to ``patch_embed.backbone``, with
  the R+Ti stem's ``conv``/``norm`` right under it and the ResNet-D
  backbones under the chassis' names (``conv1.0``, ``layer1.0``,
  ``downsample.1/2``);
- the ViT-built families, the inverse of the ``swin``, ``xcit``, ``cait``
  and ``pit`` adapters (``cotnet_tpu/utils/convert.py:202-216,
  352-383``), by ``_FAMILY_RULES``: CaiT's ``blocks_token_only_{i}``,
  XCiT's ``patch_conv{i}``/``patch_bn{i}`` to ``patch_embed.proj.{2i}.{0,1}``,
  its class-attention modules and top-level gammas to
  ``cls_attn_blocks.{i}``, Swin's ``layers_{s}_{b}`` and ``merge_*{s}`` to
  ``layers.{s-1}.downsample`` with the merge's channel groups 1 and 2
  swapped back, PiT's ``pool{s}_*`` to ``transformers.{s-1}.pool`` and its
  NHWC ``pos_embed`` to timm's NCHW;
- the last ViT-built families, the inverse of the ``tnt``, ``twins``,
  ``coat``, ``levit`` and ``visformer`` adapters
  (``cotnet_tpu/utils/convert.py:217-353``; ConViT takes the ``vit``
  rules): TNT's fused ``qkv`` rows split back into timm's ``qk`` and ``v``
  and its token-major ``pixel_pos`` to ``[1, C, 4, 4]``; Twins'
  ``patch_embed{s}``/``embed_norm{s}`` to ``patch_embeds.{s}``,
  ``pos_block{s}`` to ``pos_block.{s}.proj.0``, ``sr_norm`` to ``norm``;
  CoaT's ``conv{i}`` to ``conv_list.{i}``, the lite models' ``norm`` to
  ``norm4``, the ``aggregate`` Dense to a Conv1d kernel, and each shared
  module under all of timm's names (``_coat_aliases``); LeViT's blocks to
  timm's flat ``blocks.{i}`` (``_levit_blocks``), ``linear``/``fc1``/
  ``fc2``/``proj``/``q`` to ``c``/``0``/``2``/``proj.1``/``q.1``, with an
  ``attention_bias_idxs`` beside each bias table; Visformer's stem to
  ``stem.{0,1}`` and its NHWC ``pos_embed{s}`` to NCHW;
- the EfficientNet superfamily, the inverse of the ``efficientnet``
  adapter (``cotnet_tpu/utils/convert.py:83, 199-200, 547-554``):
  ``blocks_{s}_{i}`` to ``blocks.{s}.{i}``, the SE's Dense ``fc1``/``fc2``
  to the 1x1 convs ``se.conv_reduce``/``se.conv_expand``, a MixedConv's
  ``conv_{i}`` to its bare index, CondConv's ``experts`` ``[E, kh, kw,
  I/g, O]`` to the flat ``weight`` ``[E, O*I/g*kh*kw]``;
- the CNN tail, the inverse of the ``psresnet``, ``sknet``, ``res2net``,
  ``regnet``, ``densenet``, ``rexnet`` and ``xception`` adapters
  (``cotnet_tpu/utils/convert.py:87-170, 260-279, 384-407``): PSConv's
  raw HWIO ``conv_kernel`` to ``conv.weight``; the SK conv's ``path_{i}``
  to ``paths.{i}``, its ``fc_reduce`` / ``bn`` / ``fc_select`` (Dense
  kernels to 1x1 convs) under ``attn``, an SK block's plain
  ``conv{i}`` / ``bn{i}`` to ``conv{i}.conv`` / ``.bn``; Res2Net's
  ``convs_{i}`` / ``bns_{i}``; RegNet's ``s{i}_b{j}``, ``conv{i}`` /
  ``bn{i}`` to ``conv{i}.conv`` / ``.bn`` and ``stem``, ``downsample``,
  ``head.fc``; DenseNet's blocks, transitions and top-level stem under
  ``features``; ReXNet's ``block_{i}`` to ``features.{i}`` and its head
  to ``features.{num_blocks}``; Xception's ``sep{k}`` to the ``rep``
  indices behind the leading ReLU (``block1`` has none), ``conv3`` /
  ``conv4``'s BN to ``bn3`` / ``bn4``.  ResNeSt and ResNet-RS take the
  chassis' names (the ResNet-D shortcut: ``avg_down`` from the variant
  table, not ``model_avg_down``).

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
# the comparison families' renames of a module name on the JAX side
# (FAMILY_ADAPTERS' name_map and pair_map), and of a raw parameter's name
_FAMILY_NAMES = {
    "san": {"conv_w_bn1": "conv_w.0", "conv_w_conv1": "conv_w.2",
            "conv_w_bn2": "conv_w.3", "conv_w_conv2": "conv_w.5",
            "key_embed_bn": "key_embed.0", "key_embed_conv": "key_embed.2",
            "conv_w_bn": "conv_w.0", "conv_w_conv": "conv_w.2"},
    "botnet": {"mhsa": "conv2.0", "conv2": "conv2.0", "bn2": "conv2.1"},
    "lambdanet": {"to_q": "to_q.0", "bn_q": "to_q.1", "to_v": "to_v.0",
                  "bn_v": "to_v.1"},
    "resnet_dw": {"conv2_pw": "conv2.0", "conv2_bn": "conv2.1",
                  "conv2_dw": "conv2.3"},
}
_FAMILY_PAIRS = {"san": {("sam", "conv"): "sam.conv.0"}}
_FAMILY_LEAVES = {"botnet": {"q_proj": "q_proj.w", "k_proj": "k_proj.w",
                             "v_proj": "v_proj.w"}}
# SAN19's weight channels Cw by stage (the JAX converter's _san_wperm)
_SAN_CW = (2, 8, 16, 32, 64)
# the registry modules of the families (the JAX converter's model_adapter)
_FAMILY_MODULES = (("san", "san"), ("botnet", "botnet"),
                   ("lambda_net", "lambdanet"), ("resnet_dw", "resnet_dw"),
                   ("vision_transformer", "vit"), ("resnetv2", "resnetv2"),
                   ("vision_transformer_hybrid", "vit_hybrid"),
                   ("cait", "cait"), ("xcit", "xcit"),
                   ("swin_transformer", "swin"), ("pit", "pit"),
                   ("convit", "vit"), ("tnt", "tnt"), ("twins", "twins"),
                   ("visformer", "visformer"), ("levit", "levit"),
                   ("coat", "coat"), ("efficientnet", "efficientnet"),
                   ("psresnet", "psresnet"), ("sknet", "sknet"),
                   ("res2net", "res2net"), ("regnet", "regnet"),
                   ("densenet", "densenet"), ("rexnet", "rexnet"),
                   ("xception", "xception"))
# the families on the ResNet chassis: each JAX module name renamed by the
# first rule that matches it whole (Res2Net's lists, the SK conv's paths
# and its attention's 1x1 convs)
_CHASSIS_RULES = {
    "res2net": ((r"convs_(\d+)", r"convs.\1"), (r"bns_(\d+)", r"bns.\1")),
    "sknet": ((r"path_(\d+)", r"paths.\1"),
              (r"fc_(reduce|select)", r"attn.fc_\1")),
}
# the SK attention's Dense layers, the reference's 1x1 convs
_CONV_DENSE = {"sknet": ("fc_reduce", "fc_select")}
# the only block of the reference's Xception without a ReLU ahead of its
# first separable conv
_XCEPTION_PLAIN_START = ("block1",)
# the ViT-built families: each JAX module name (and each top-level raw
# parameter name) renamed by the first rule that matches it whole, the
# inverse of the JAX converter's FAMILY_ADAPTERS entries
_FAMILY_RULES = {
    "cait": ((r"patch_embed", "patch_embed.proj"),
             (r"blocks_token_only_(\d+)", r"blocks_token_only.\1"),
             (r"blocks_(\d+)", r"blocks.\1")),
    "xcit": ((r"patch_conv(\d)",
              lambda m: f"patch_embed.proj.{2 * int(m[1])}.0"),
             (r"patch_bn(\d)", lambda m: f"patch_embed.proj.{2 * int(m[1])}.1"),
             (r"pos_proj", "pos_embed.token_projection"),
             (r"blocks_(\d+)", r"blocks.\1"),
             (r"cls_attn_(\d+)", r"cls_attn_blocks.\1.attn"),
             (r"ca_norm(\d+)", r"cls_attn_blocks.\1.norm1"),
             (r"ca_norm_mlp(\d+)", r"cls_attn_blocks.\1.norm2"),
             (r"ca_mlp(\d+)", r"cls_attn_blocks.\1.mlp"),
             (r"ca_gamma([12])_(\d+)", r"cls_attn_blocks.\2.gamma\1")),
    # the JAX model's merge_*{s} opens stage s, timm's PatchMerging closes
    # stage s-1
    "swin": ((r"patch_embed", "patch_embed.proj"),
             (r"patch_norm", "patch_embed.norm"),
             (r"layers_(\d+)_(\d+)", r"layers.\1.blocks.\2"),
             (r"merge_(norm|reduction)(\d)",
              lambda m: f"layers.{int(m[2]) - 1}.downsample.{m[1]}")),
    # likewise PiT's pool{s} and timm's ConvHeadPooling
    "pit": ((r"patch_embed", "patch_embed.conv"),
            (r"transformers_(\d+)_blocks_(\d+)",
             r"transformers.\1.blocks.\2"),
            (r"pool(\d)_(conv|fc)",
             lambda m: f"transformers.{int(m[1]) - 1}.pool.{m[2]}")),
    "tnt": ((r"pixel_embed", "pixel_embed.proj"),
            (r"proj_embed", "proj"),
            (r"blocks_(\d+)", r"blocks.\1")),
    "twins": ((r"patch_embed(\d+)", r"patch_embeds.\1.proj"),
              (r"embed_norm(\d+)", r"patch_embeds.\1.norm"),
              (r"pos_block(\d+)", r"pos_block.\1.proj.0"),
              (r"blocks_(\d+)_(\d+)", r"blocks.\1.\2"),
              (r"sr_norm", "norm")),
    "visformer": ((r"stem_conv", "stem.0"), (r"stem_bn", "stem.1"),
                  (r"patch_embed(\d)", r"patch_embed\1.proj"),
                  (r"embed_norm(\d)", r"patch_embed\1.norm"),
                  (r"stage(\d)_(\d+)", r"stage\1.\2")),
    # the flat blocks.{i} of LeViT are numbered by _levit_blocks
    "levit": ((r"linear", "c"), (r"fc1", "0"), (r"fc2", "2"),
              (r"proj", "proj.1"), (r"q", "q.1"),
              (r"stem(\d)", lambda m: f"patch_embed.{2 * int(m[1])}.c"),
              (r"stem_bn(\d)", lambda m: f"patch_embed.{2 * int(m[1])}.bn"),
              (r"head_bn", "head.bn"), (r"head", "head.l"),
              (r"head_dist", "head_dist.l")),
    "coat": ((r"patch_embed(\d)", r"patch_embed\1.proj"),
             (r"embed_norm(\d)", r"patch_embed\1.norm"),
             (r"serial_blocks(\d)_(\d+)", r"serial_blocks\1.\2"),
             (r"parallel_blocks_(\d+)", r"parallel_blocks.\1"),
             (r"conv(\d)", r"conv_list.\1"),
             # the lite models' last norm is timm's norm4 (coat.py:440)
             (r"norm", "norm4")),
    # the SE's Dense fc1/fc2 are the reference's conv_reduce/conv_expand;
    # a MixedConv's groups are children by bare index
    "efficientnet": ((r"blocks_(\d+)_(\d+)", r"blocks.\1.\2"),
                     (r"conv_(\d+)", r"\1"), (r"fc1", "conv_reduce"),
                     (r"fc2", "conv_expand")),
    # the CNNs off the chassis, whose plain convs are ConvBnActs
    "regnet": ((r"stem_(conv|bn)", r"stem.\1"),
               (r"s(\d+)_b(\d+)", r"s\1.b\2"),
               (r"conv(\d)", r"conv\1.conv"), (r"bn(\d)", r"conv\1.bn"),
               (r"downsample_(conv|bn)", r"downsample.\1"),
               (r"fc", "head.fc")),
    "densenet": ((r"denseblock(\d+)_layer(\d+)",
                  r"features.denseblock\1.denselayer\2"),
                 (r"transition(\d+)_(conv|norm)", r"features.transition\1.\2")),
    # rexnet's head ConvBnAct (features.{num_blocks}) is placed by
    # _rexnet_head
    "rexnet": ((r"stem_(conv|bn)", r"stem.\1"),
               (r"block_(\d+)", r"features.\1"),
               (r"conv_(exp|dw|pwl)", r"conv_\1.conv"),
               (r"bn_(exp|dw|pwl)", r"conv_\1.bn"), (r"fc", "head.fc")),
    "xception": ((r"skip_conv", "skip"), (r"skip_bn", "skipbn")),
}
# the families off the ResNet chassis
_OFF_CHASSIS = ("vit", "resnetv2", "vit_hybrid", *_FAMILY_RULES)


def _xception_sep(m) -> str:
    """An Xception block's ``sep{k}/{dw,pw,bn}`` -> its ``rep`` indices:
    the k-th separable conv at ``3k + 1`` behind a ReLU (``3k`` in a
    block that starts without one), its BN after it (the inverse of the
    JAX converter's ``_xception_infer``)."""
    p = 3 * int(m[2]) + (m[1] not in _XCEPTION_PLAIN_START)
    return {"dw": f"{m[1]}.rep.{p}.conv1",
            "pw": f"{m[1]}.rep.{p}.pointwise",
            "bn": f"{m[1]}.rep.{p + 1}"}[m[3]]


# renames of a whole module path, after the per-name ones (the JAX
# converter's post_regex_map): the SK blocks' plain convs and BNs to their
# ConvBnActs and the SK conv's BN to its attention's; DenseNet's top-level
# stem and last norm under features; Xception's separable convs
_FAMILY_POST = {
    "sknet": ((r"^(layer\d+\.\d+\.conv\d)\.bn$", r"\1.attn.bn"),
              (r"^(layer\d+\.\d+\.)(conv|bn)(\d)$",
               lambda m: f"{m[1]}conv{m[3]}.{m[2]}")),
    "densenet": ((r"^(conv|norm)(\d+)$", r"features.\1\2"),),
    "xception": ((r"^(block\d+)\.sep(\d+)\.(dw|pw|bn)$", _xception_sep),
                 (r"^conv([34])\.dw$", r"conv\1.conv1"),
                 (r"^conv([34])\.pw$", r"conv\1.pointwise"),
                 (r"^conv([34])\.bn$", r"bn\1")),
}


def _post(path: str, family) -> str:
    for pattern, repl in _FAMILY_POST.get(family, ()):
        path = re.sub(pattern, repl, path)
    return path


def _kmajor_perm(n: int, k2: int, groups: int = 1) -> np.ndarray:
    """cw-major -> k-major channel permutation, per group: k-major channel i
    holds cw-major channel perm[i] (within a group, torch channel
    cw*k2 + k, the JAX package's k*cw_g + cw)."""
    per = n // groups
    cw_g = per // k2
    return np.asarray([g * per + c * k2 + k for g in range(groups)
                       for k in range(k2) for c in range(cw_g)])


def model_family(model_name: str):
    """The family whose names ``jax_to_torch_state_dict`` maps for
    ``model_name`` (``"san"``, ``"botnet"``, ``"lambdanet"``,
    ``"resnet_dw"``, ``"vit"`` (ConViT's too), ``"resnetv2"``,
    ``"vit_hybrid"``, ``"cait"``, ``"xcit"``, ``"swin"``, ``"pit"``,
    ``"tnt"``, ``"twins"``, ``"visformer"``, ``"levit"``, ``"coat"``,
    ``"efficientnet"``, ``"psresnet"``, ``"sknet"``, ``"res2net"``,
    ``"regnet"``, ``"densenet"``, ``"rexnet"``, ``"xception"``), or None
    for the chassis' default mapping (ResNeSt's and ResNet-RS's too)."""
    from cotnet_tpu_torch.models.registry import is_model_in_modules

    for module, family in _FAMILY_MODULES:
        if model_name and is_model_in_modules(model_name, [module]):
            return family
    return None


def _module_path(parts, avg_down: bool = False, family=None) -> str:
    out = []
    i = 0
    down = {"conv": "1", "bn": "2"} if avg_down else {"conv": "0", "bn": "1"}
    names = _FAMILY_NAMES.get(family, {})
    pairs = _FAMILY_PAIRS.get(family, {})
    while i < len(parts):
        p = parts[i]
        if tuple(parts[i:i + 2]) in pairs:
            out.append(pairs[tuple(parts[i:i + 2])])
            i += 1
        elif p in names:
            out.append(names[p])
        elif i == 0 and p in _DEEP_STEM:
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
            out.append(_rename(p, family, _CHASSIS_RULES))
        i += 1
    return ".".join(out)


def _resnetv2_path(parts, stem_only: bool = False) -> str:
    """A ResNetV2 module path, JAX names -> timm's; ``stem_only`` for the
    hybrids' stem-only backbone, whose conv and norm have no ``stem.``."""
    out = []
    i = 0
    while i < len(parts):
        p = parts[i]
        m = re.match(r"stage(\d+)_block(\d+)$", p)
        if m:
            out.append(f"stages.{int(m.group(1)) - 1}.blocks."
                       f"{int(m.group(2)) - 1}")
        elif p in ("stem_conv", "stem_conv3"):
            out.append("stem." + p[len("stem_"):])
        elif re.match(r"stem_c\d?$", p):
            child = parts[i + 1] + p[len("stem_c"):]
            out.append(child if stem_only else f"stem.{child}")
            i += 1
        elif p in ("c1", "c2", "c3"):
            out.append(parts[i + 1] + p[1])
            i += 1
        elif p == "downsample":
            out.append("downsample." + (parts[i + 1] if i + 1 < len(parts)
                                        else "conv"))
            i += 1
        elif p == "fc":
            out.append("head.fc")
        else:
            out.append(p)
        i += 1
    return ".".join(out)


def _rename(name: str, family: str, rules=None) -> str:
    """``name`` by the first of the family's ``rules`` (``_FAMILY_RULES``)
    that matches it whole, else as it is."""
    for pattern, repl in (rules or _FAMILY_RULES).get(family, ()):
        new, hits = re.subn(f"^{pattern}$", repl, name)
        if hits:
            return new
    return name


def _swin_merge_perm(val: np.ndarray) -> np.ndarray:
    """Channel groups 1 and 2 of a patch merge's 4C axis (axis 0) swapped:
    the JAX model concatenates the 2x2 neighbours in raster order, timm in
    ``(x0, x1, x2, x3)`` order (the JAX converter's ``_swin_merge_perm``,
    its own inverse)."""
    c = val.shape[0] // 4
    return val[np.concatenate([np.arange(c) + g * c for g in (0, 2, 1, 3)])]


def _levit_blocks(flat) -> Dict[str, str]:
    """LeViT's JAX block names -> timm's flat ``blocks.{i}`` paths: per
    stage its attention and MLP blocks in turn, then its subsampling and
    the MLP after it (the inverse of the JAX converter's ``_levit_infer``,
    ``cotnet_tpu/utils/convert.py:113-148``)."""
    names = {key.split("/")[1] for key in flat}
    out, i, si = {}, 0, 0
    while f"attn_{si}_0" in names:
        bi = 0
        while f"attn_{si}_{bi}" in names:
            out[f"attn_{si}_{bi}"] = f"blocks.{i}.m"
            out[f"mlp_{si}_{bi}"] = f"blocks.{i + 1}.m"
            i += 2
            bi += 1
        if f"downsample_{si}" in names:
            out[f"downsample_{si}"] = f"blocks.{i}"
            out[f"ds_mlp_{si}"] = f"blocks.{i + 1}.m"
            i += 2
        si += 1
    return out


def _rexnet_head(flat) -> Dict[str, str]:
    """ReXNet's head ``ConvBnAct`` after its blocks: ``head_conv`` and
    ``head_bn`` -> ``features.{num_blocks}.conv`` / ``.bn`` (the inverse
    of the JAX converter's ``_rexnet_infer``)."""
    n = len({m[1] for key in flat
             for m in [re.match(r"[^/]+/block_(\d+)/", key)] if m})
    return {"head_conv": f"features.{n}.conv",
            "head_bn": f"features.{n}.bn"}


def _levit_bias_indices(sd) -> Dict[str, np.ndarray]:
    """An ``attention_bias_idxs`` beside each of LeViT's
    ``attention_biases``: the grid follows from the table's size (a
    ``res x res`` grid has ``res^2`` distinct offsets, from the queries of
    the subsampling's stride-2 grid too), the stride from the module (a
    subsampling has ``kv``, an attention ``qkv``)."""
    from cotnet_tpu_torch.models.levit import bias_index

    out = {}
    for key, val in sd.items():
        if key.endswith("attention_biases"):
            prefix = key[:-len("attention_biases")]
            res = int(round(val.shape[1] ** 0.5))
            stride = 2 if f"{prefix}kv.c.weight" in sd else 1
            out[f"{prefix}attention_bias_idxs"] = bias_index(
                (res - 1) // stride + 1, res, stride)[0]
    return out


def _coat_aliases(sd) -> Dict[str, np.ndarray]:
    """CoaT's shared modules under each of timm's names: each stage's
    ``cpe{s}`` and ``crpe{s}`` in its serial blocks and ``crpe{2,3,4}`` in
    the parallel blocks, and a parallel block's one ``mlp`` as ``mlp2``,
    ``mlp3`` and ``mlp4``."""
    serial = {m.groups() for k in sd
              for m in [re.match(r"serial_blocks(\d)\.(\d+)\.", k)] if m}
    parallel = {m.group(1) for k in sd
                for m in [re.match(r"parallel_blocks\.(\d+)\.", k)] if m}
    out = {}
    for key, val in sd.items():
        m = re.match(r"(parallel_blocks\.\d+)\.mlp\.(.*)", key)
        if m:
            for i in (2, 3, 4):
                out[f"{m.group(1)}.mlp{i}.{m.group(2)}"] = val
            continue
        out[key] = val
        m = re.match(r"(cpe|crpe)(\d)\.(.*)", key)
        if m:
            kind, s, rest = m.groups()
            inner = "cpe" if kind == "cpe" else "factoratt_crpe.crpe"
            for stage, b in serial:
                if stage == s:
                    out[f"serial_blocks{s}.{b}.{inner}.{rest}"] = val
            if kind == "crpe" and s != "1":
                for p in parallel:
                    out[f"parallel_blocks.{p}.factoratt_crpe{s}.crpe."
                        f"{rest}"] = val
    return out


def _transformer_path(parts, family: str, stem_only: bool,
                      blocks: Dict[str, str]) -> str:
    """The module path of the transformer families (``vit``, ``resnetv2``,
    ``vit_hybrid`` and those of ``_FAMILY_RULES``); "" for a top-level raw
    parameter.  ``blocks`` renames whole JAX module names (LeViT's)."""
    if family in _FAMILY_RULES:
        return ".".join(blocks.get(p) or _rename(p, family) for p in parts)
    if family == "resnetv2":
        return _resnetv2_path(parts)
    if parts and parts[0] == "backbone":
        rest = parts[1:]
        if rest and re.match(r"(conv1_\d|bn1|layer\d)", rest[0]):
            inner = _module_path(rest, avg_down=True)
        else:
            inner = _resnetv2_path(rest, stem_only)
        return "patch_embed.backbone." + inner
    out = []
    for p in parts:
        m = re.match(r"blocks_(\d+)$", p)
        out.append("patch_embed.proj" if p == "patch_embed" else
                   f"blocks.{m.group(1)}" if m else p)
    return ".".join(out)


def jax_to_torch_state_dict(flat: Dict[str, np.ndarray], *,
                            kernel_size: int = 3, dw_group: int = 1,
                            avg_down: bool = False, family=None
                            ) -> Dict[str, torch.Tensor]:
    """``{"params/.../kernel": array, "batch_stats/.../mean": array, ...}``
    (the JAX ``{params, batch_stats}`` flattened to '/'-joined keys) -> the
    port's state_dict of float32 tensors.  ``dw_group`` is 2 for the
    CoTNeXt models (CoXtLayer), else 1; ``avg_down`` is True for the
    SE-CoTNetD models (the ResNet-D shortcut); ``family`` is
    ``model_family(name)`` for the comparison families."""
    k2 = kernel_size * kernel_size
    # the hybrids' R+Ti backbone is the stem alone, without timm's 'stem.'
    stem_only = not any("/backbone/stage" in k for k in flat)
    blocks = (_levit_blocks(flat) if family == "levit" else
              _rexnet_head(flat) if family == "rexnet" else {})
    sd = {}
    for key, val in flat.items():
        collection, *parts, leaf = key.split("/")
        val = np.asarray(val, dtype=np.float32)
        mod = _post(_transformer_path(parts, family, stem_only, blocks)
                    if family in _OFF_CHASSIS else
                    _module_path(parts, avg_down, family), family)
        owner = parts[-1] if parts else leaf
        if family == "swin" and owner.startswith("merge_"):
            val = _swin_merge_perm(val)
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
            elif (owner in _SE_DENSE or parts[-2:-1] == ["se"]
                  or owner in _CONV_DENSE.get(family, ())):
                val = val.T[:, :, None, None]
            else:
                val = val.T
            name = "weight"
        elif leaf == "scale":
            name = "weight"
        elif leaf == "bias":
            name = "bias"
        else:
            # a raw parameter: copied as it is, but for LambdaNet's conv3d
            # kernel
            name = _FAMILY_LEAVES.get(family, {}).get(leaf, leaf)
            if not parts:   # top level: XCiT's class-attention gammas
                name = _rename(name, family)
            if leaf == "experts":
                # CondConv's bank [E, kh, kw, I/g, O] -> the reference's
                # flat rows [E, O*I/g*kh*kw]
                name = "weight"
                val = np.transpose(val, (0, 4, 3, 1, 2)).reshape(
                    val.shape[0], -1)
            if family == "psresnet" and leaf == "conv_kernel":
                # PSConv's masked dense conv, a raw HWIO kernel in JAX
                name = "conv.weight"
                val = np.transpose(val, (3, 2, 0, 1))
            if family == "lambdanet" and leaf == "embeddings":
                val = val.reshape(val.shape[0], 1, 1, *val.shape[1:])
            if (family == "pit" and leaf == "pos_embed") or (
                    family == "visformer" and leaf.startswith("pos_embed")):
                val = np.transpose(val, (0, 3, 1, 2))   # NHWC -> timm's NCHW
            if family == "tnt" and leaf == "pixel_pos":
                # token-major [1, P, C] -> timm's [1, C, sqrt P, sqrt P]
                side = int(round(val.shape[1] ** 0.5))
                val = np.transpose(val, (0, 2, 1)).reshape(
                    1, -1, side, side)
        if owner in _EMBED_PRODUCER:
            val = val[np.argsort(_kmajor_perm(val.shape[0], k2, dw_group))]
        if family == "san" and owner == "conv_w_conv2":
            cw = _SAN_CW[int(re.match(r"layer(\d)_", parts[0]).group(1))]
            val = val[np.argsort(_kmajor_perm(val.shape[0],
                                              val.shape[0] // cw))]
        if family == "tnt" and owner == "qkv":
            # timm's TNT attention keeps q and k fused apart from v
            d = val.shape[1]
            sd[f"{mod[:-len('qkv')]}qk.weight"] = val[:2 * d]
            sd[f"{mod[:-len('qkv')]}v.weight"] = val[2 * d:]
            continue
        if family == "coat" and owner == "aggregate" and leaf == "kernel":
            val = val[:, :, None]   # Dense [3, 1] -> Conv1d [1, 3, 1]
        sd[f"{mod}.{name}" if mod else name] = val
    if family == "levit":
        sd.update(_levit_bias_indices(sd))
    if family == "coat":
        sd = _coat_aliases(sd)
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
