from cotnet_tpu_torch.nn.activations import (get_act_fn, list_act_fns, relu,
                                             swish)
from cotnet_tpu_torch.nn.attn import (CbamModule, EcaModule,
                                      EffectiveSEModule, SEModule,
                                      create_attn)
from cotnet_tpu_torch.nn.blur_pool import BlurPool2d
from cotnet_tpu_torch.nn.classifier import ClassifierHead
from cotnet_tpu_torch.nn.config import (is_exportable, is_no_jit,
                                        is_scriptable, set_layer_config)
from cotnet_tpu_torch.nn.conv import (Conv2d, ConvBnAct, DenseGroupedConv,
                                      StdConv2d, get_padding,
                                      normalize_padding, pad_same)
from cotnet_tpu_torch.nn.drop import (
    DropBlock2d,
    DropPath,
    Dropout,
    drop_block_2d,
    drop_path,
    dropout,
    set_generator,
)
from cotnet_tpu_torch.nn.extra import (CondConv2d, EvoNorm2dB0, EvoNorm2dS0,
                                       Kerv2d, MixedConv2d,
                                       SelectiveKernelConv, Shiftlution,
                                       SpaceToDepth, SplitBatchNorm, TBConv,
                                       group_std, instance_std,
                                       space_to_depth, test_time_pool)
from cotnet_tpu_torch.nn.linear import Linear
from cotnet_tpu_torch.nn.norm import (BatchNorm2d, GroupNorm, LayerNorm,
                                      SubChannelGroupNorm, TokenBatchNorm)
from cotnet_tpu_torch.nn.pool import (avg_pool2d, avg_pool2d_same,
                                      global_pool2d, max_pool2d,
                                      max_pool2d_same, median_pool2d)
from cotnet_tpu_torch.nn.split_attn import SplitAttnConv2d, radix_softmax

__all__ = [
    "BatchNorm2d", "BlurPool2d", "CbamModule", "ClassifierHead",
    "CondConv2d", "Conv2d", "ConvBnAct", "DenseGroupedConv", "DropBlock2d",
    "DropPath", "Dropout", "EcaModule", "EffectiveSEModule", "EvoNorm2dB0",
    "EvoNorm2dS0", "GroupNorm", "Kerv2d", "LayerNorm", "Linear",
    "MixedConv2d", "SEModule", "SelectiveKernelConv", "Shiftlution",
    "SpaceToDepth", "SplitAttnConv2d", "SplitBatchNorm", "StdConv2d",
    "SubChannelGroupNorm", "TBConv", "TokenBatchNorm", "avg_pool2d",
    "avg_pool2d_same", "create_attn", "drop_block_2d", "drop_path",
    "dropout", "get_act_fn", "get_padding", "global_pool2d", "group_std",
    "instance_std", "is_exportable", "is_no_jit", "is_scriptable",
    "list_act_fns", "max_pool2d", "max_pool2d_same", "median_pool2d",
    "normalize_padding", "pad_same", "radix_softmax", "relu",
    "set_generator", "set_layer_config", "space_to_depth", "swish",
    "test_time_pool",
]
