from cotnet_tpu_torch.config.config import (
    Config,
    default_config,
    load_config,
    load_experiment,
)
from cotnet_tpu_torch.models.helpers import (
    IMAGENET_DEFAULT_MEAN,
    IMAGENET_DEFAULT_STD,
    resolve_data_config,
)

__all__ = ["Config", "IMAGENET_DEFAULT_MEAN", "IMAGENET_DEFAULT_STD",
           "default_config", "load_config", "load_experiment",
           "resolve_data_config"]
