from cotnet_tpu_torch.config.config import (
    Config,
    default_config,
    load_config,
    load_experiment,
)

__all__ = ["Config", "default_config", "load_config", "load_experiment"]
