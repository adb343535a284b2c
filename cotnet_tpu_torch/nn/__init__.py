from cotnet_tpu_torch.nn.activations import (get_act_fn, list_act_fns, relu,
                                             swish)
from cotnet_tpu_torch.nn.attn import (CbamModule, EcaModule,
                                      EffectiveSEModule, SEModule,
                                      create_attn)
from cotnet_tpu_torch.nn.blur_pool import BlurPool2d
from cotnet_tpu_torch.nn.classifier import ClassifierHead
from cotnet_tpu_torch.nn.conv import (Conv2d, ConvBnAct, StdConv2d,
                                      get_padding, pad_same)
from cotnet_tpu_torch.nn.drop import (
    DropBlock2d,
    DropPath,
    Dropout,
    drop_block_2d,
    drop_path,
    dropout,
    set_generator,
)
from cotnet_tpu_torch.nn.extra import (CondConv2d, MixedConv2d,
                                       SelectiveKernelConv)
from cotnet_tpu_torch.nn.linear import Linear
from cotnet_tpu_torch.nn.norm import (BatchNorm2d, GroupNorm, LayerNorm,
                                      SubChannelGroupNorm, TokenBatchNorm)
from cotnet_tpu_torch.nn.pool import (avg_pool2d, global_pool2d, max_pool2d,
                                      max_pool2d_same)
from cotnet_tpu_torch.nn.split_attn import SplitAttnConv2d, radix_softmax

__all__ = [
    "BatchNorm2d", "BlurPool2d", "CbamModule", "ClassifierHead",
    "CondConv2d", "Conv2d", "ConvBnAct", "DropBlock2d", "DropPath",
    "Dropout", "EcaModule", "EffectiveSEModule", "GroupNorm", "LayerNorm",
    "Linear", "MixedConv2d", "SEModule", "SelectiveKernelConv",
    "SplitAttnConv2d", "StdConv2d", "SubChannelGroupNorm", "TokenBatchNorm",
    "avg_pool2d", "create_attn", "drop_block_2d", "drop_path", "dropout",
    "get_act_fn", "get_padding", "global_pool2d", "list_act_fns",
    "max_pool2d", "max_pool2d_same", "pad_same", "radix_softmax", "relu",
    "set_generator", "swish",
]
