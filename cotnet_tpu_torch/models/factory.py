"""create_model — registry name -> initialized ``nn.Module``, counterpart of
``cotnet_tpu/models/factory.py`` (reference models/factory.py:6-64)."""

from __future__ import annotations

import torch

from cotnet_tpu_torch.models.registry import is_model, model_entrypoint


def create_model(model_name: str, num_classes: int = 1000,
                 in_chans: int = 3, *, device="cuda",
                 dtype: torch.dtype = torch.float32, seed: int = 0,
                 **kwargs):
    """Build a registered model with weights from a seeded generator.

    ``dtype`` is the compute dtype, as flax's ``dtype=``: parameters and BN
    running stats stay float32 (the state_dict the converter maps) and each
    weight is cast to ``dtype`` where it is used.  Extra kwargs go to the
    entrypoint (e.g. ``drop_rate=``, ``drop_path_rate=``,
    ``block_args=dict(impl=...)``, and for the CoT family
    ``gn_fold_train=`` and ``mega_fuse=``, see ``models/cotnet.py``); None
    values are pruned.  The model is
    returned on ``device`` in eval mode; call ``model.train()`` to train it
    (``train/step.py`` does).
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("create_model(device='cuda') needs a CUDA device; "
                           "pass device='cpu' to run the plain versions")
    if not is_model(model_name):
        raise RuntimeError(f"Unknown model ({model_name})")
    kwargs = {k: v for k, v in kwargs.items() if v is not None}
    model = model_entrypoint(model_name)(num_classes=num_classes,
                                         in_chans=in_chans, dtype=dtype,
                                         **kwargs)
    generator = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(generator)
    return model.to(device).eval()
