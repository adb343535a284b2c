"""Data parallelism on ``torch.distributed``, counterpart of
``cotnet_tpu/parallel/``."""
