"""Logging, counterpart of ``cotnet_tpu/utils/logger.py`` (reference
utils/logger.py:9-33): stdout and ``<exp_dir>/log.txt``, with a rank-0
gate for multi-process runs."""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional

import torch.distributed as dist


def is_master_process() -> bool:
    """Rank 0 of an initialised ``torch.distributed`` group, else True
    (reference utils/distributed.py:10-17)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return True


def setup_default_logging(output_dir: Optional[str] = None,
                          level=logging.INFO, name: str = "cotnet_tpu_torch"):
    logger = logging.getLogger(name)
    logger.setLevel(level)
    for handler in logger.handlers:
        handler.close()
    logger.handlers.clear()
    fmt = logging.Formatter(
        "%(asctime)s %(levelname)s %(name)s: %(message)s", "%H:%M:%S")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if output_dir and is_master_process():
        os.makedirs(output_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(output_dir, "log.txt"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    logger.propagate = False
    return logger


def logger_info(logger, msg: str):
    """Info on rank 0 only (reference logger.py:30-33)."""
    if is_master_process():
        logger.info(msg)
