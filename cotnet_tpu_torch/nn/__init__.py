from cotnet_tpu_torch.nn.activations import get_act_fn, relu, swish
from cotnet_tpu_torch.nn.blur_pool import BlurPool2d
from cotnet_tpu_torch.nn.classifier import ClassifierHead
from cotnet_tpu_torch.nn.conv import Conv2d, get_padding
from cotnet_tpu_torch.nn.drop import (
    DropBlock2d,
    DropPath,
    Dropout,
    drop_block_2d,
    drop_path,
    dropout,
    set_generator,
)
from cotnet_tpu_torch.nn.norm import BatchNorm2d, SubChannelGroupNorm
from cotnet_tpu_torch.nn.pool import avg_pool2d, global_pool2d, max_pool2d
from cotnet_tpu_torch.nn.split_attn import SplitAttnConv2d, radix_softmax

__all__ = [
    "BatchNorm2d", "BlurPool2d", "ClassifierHead", "Conv2d",
    "DropBlock2d", "DropPath", "Dropout", "SplitAttnConv2d",
    "SubChannelGroupNorm", "avg_pool2d", "drop_block_2d", "drop_path",
    "dropout", "get_act_fn", "get_padding", "global_pool2d", "max_pool2d",
    "radix_softmax", "relu", "set_generator", "swish",
]
