"""Layer-config context manager, counterpart of ``cotnet_tpu/nn/config.py``
(reference models/layers/config.py:115).

The reference builds scriptable, exportable or no-JIT variants of some
layers for TorchScript and ONNX.  No layer of the port has such a variant,
so the three flags change nothing that a model computes; they are kept
with the reference's API, and ``create_model`` builds inside
``set_layer_config`` as the reference's factory does.  No code of the port
may branch on them: a layer that did would make them a hidden switch.
"""

from __future__ import annotations

import contextlib

_config = {"scriptable": False, "exportable": False, "no_jit": False}


def is_scriptable() -> bool:
    return _config["scriptable"]


def is_exportable() -> bool:
    return _config["exportable"]


def is_no_jit() -> bool:
    return _config["no_jit"]


@contextlib.contextmanager
def set_layer_config(scriptable=None, exportable=None, no_jit=None):
    """Set the flags that are not None for the duration of the block; the
    previous values come back on exit, an exception included."""
    prev = dict(_config)
    if scriptable is not None:
        _config["scriptable"] = scriptable
    if exportable is not None:
        _config["exportable"] = exportable
    if no_jit is not None:
        _config["no_jit"] = no_jit
    try:
        yield
    finally:
        _config.update(prev)
