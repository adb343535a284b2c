"""ResNet-RS (reference models/resnet_rs.py), counterpart of
``cotnet_tpu/models/resnet_rs.py``: the chassis with the deep stem and no
stem pool (``replace_stem_pool``: every stage strides 2), and
``Bottleneck`` blocks with SE at reduction 4.  Names are the chassis'
(``conv1.{0,1,3,4,6}``, ``layerX.Y``, a block's ``se.fc1``/``se.fc2``)."""

from __future__ import annotations

from cotnet_tpu_torch.models.helpers import (build_model_with_cfg,
                                             default_cfg,
                                             register_variant_table)
from cotnet_tpu_torch.models.resnet import Bottleneck, ResNet

default_cfgs = {}


def _create_resnet_rs(model_name: str, pretrained: bool = False, **kwargs):
    return build_model_with_cfg(ResNet, model_name, default_cfgs[model_name],
                                **kwargs)


def _rs(layers, stem_width=64):
    return dict(block=Bottleneck, layers=layers, stem_type="deep",
                stem_width=stem_width, replace_stem_pool=True,
                block_args=dict(attn_layer="se",
                                attn_kwargs=dict(reduction=4)))


# stem width 32 for rs50, 64 for the deeper rows (reference
# resnet_rs.py:303-328)
RESNET_RS_VARIANTS = {
    "resnet_rs50": _rs((3, 4, 6, 3), stem_width=32),
    "resnet_rs101": _rs((3, 4, 23, 3)),
    "resnet_rs101L": _rs((3, 4, 23, 3)),
    "resnet_rs270": _rs((4, 29, 53, 4)),
}
for _name in RESNET_RS_VARIANTS:
    default_cfgs[_name] = default_cfg(first_conv="conv1.0")

register_variant_table(__name__, _create_resnet_rs, RESNET_RS_VARIANTS)
