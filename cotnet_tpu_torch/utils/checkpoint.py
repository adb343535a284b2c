"""Checkpointing, counterpart of ``cotnet_tpu/utils/checkpoint.py``
(reference utils/checkpoint_saver.py:18-157 and models/helpers.py:23-88
resume).

``CheckpointSaver`` keeps the JAX package's rules:
- the top ``max_history`` checkpoints ranked by a metric
  (checkpoint_saver.py:59-101), never pruning the one just saved;
- ``last``, a link to the newest checkpoint;
- a recovery checkpoint every ``recovery_interval`` epochs
  (``save_recovery``, :135-147) and ``find_recovery`` (:149-156);
- ``restore`` puts the whole train state back: the model, the optimizer
  (Lookahead's slow weights and the chains' step counts included), the
  EMA, ``step`` and ``lr_scale``.

A checkpoint is one ``torch.save`` file in the reference's dict layout:
``epoch``, ``arch``, ``state_dict``, ``optimizer``, ``state_dict_ema`` (the
EMA as a full state_dict, the model's integer buffers filling what the EMA
does not keep) and ``metric``, plus ``step`` and ``lr_scale``.  Every file is
written under a temporary name, flushed to disk and moved into place with
``os.replace``, so a save cut short leaves the previous file whole.  The
ranking lives in ``index.json`` beside the files.

Data parallel: every rank keeps the ranking in memory, rank 0 alone writes
the files (the reference's rule, SURVEY.md:287), and each save ends at a
barrier, so no rank reads a checkpoint before it is whole.  Every rank
reads on restore.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import torch

from cotnet_tpu_torch.parallel.collectives import barrier
from cotnet_tpu_torch.parallel.mesh import rank
from cotnet_tpu_torch.utils.convert import load_torch_checkpoint


def _replace_atomically(path: str, write):
    """``write(f)`` into ``path + ".tmp"``, fsync, then ``os.replace``."""
    tmp = path + ".tmp"
    try:
        with open(tmp, "wb") as f:
            write(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def _save(obj, path: str):
    _replace_atomically(path, lambda f: torch.save(obj, f))


def _save_json(obj, path: str):
    _replace_atomically(
        path, lambda f: f.write(json.dumps(obj, indent=1).encode()))


def ema_state_dict(state) -> Optional[Dict[str, torch.Tensor]]:
    """The EMA as a full state_dict of the model: its tensors where the EMA
    keeps one, the model's own elsewhere (the BN batch counters)."""
    if state.ema is None:
        return None
    return {k: state.ema.get(k, v)
            for k, v in state.model.state_dict().items()}


def checkpoint_dict(state, epoch: int, metric: Optional[float] = None,
                    arch: str = "") -> dict:
    return {"epoch": epoch, "arch": arch,
            "state_dict": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "state_dict_ema": ema_state_dict(state),
            "metric": metric, "step": state.step,
            "lr_scale": state.lr_scale}


class CheckpointSaver:
    """Top-N + last + recovery checkpoint management."""

    def __init__(self, directory: str, max_history: int = 10,
                 metric_mode: str = "max", recovery_interval: int = 0,
                 arch: str = ""):
        self.dir = os.path.abspath(directory)
        self.max_history = max_history
        self.mode = metric_mode
        self.recovery_interval = recovery_interval
        self.arch = arch
        self.writes = rank() == 0
        if self.writes:
            os.makedirs(self.dir, exist_ok=True)
        self.index_path = os.path.join(self.dir, "index.json")
        self.index = []
        if os.path.exists(self.index_path):
            with open(self.index_path) as f:
                self.index = json.load(f)

    # -- helpers -----------------------------------------------------------
    def _ckpt_path(self, epoch: int) -> str:
        return os.path.join(self.dir, f"checkpoint-{epoch}.pth.tar")

    def _worst_first(self):
        return sorted(self.index, key=lambda e: e["metric"],
                      reverse=(self.mode == "min"))

    # -- public API --------------------------------------------------------
    def save_checkpoint(self, state, epoch: int, metric: float) -> None:
        """Save, rank by metric, prune beyond ``max_history``
        (checkpoint_saver.py:71-101), point ``last`` at it."""
        path = self._ckpt_path(epoch)
        if self.writes:
            _save(checkpoint_dict(state, epoch, float(metric), self.arch),
                  path)
        self.index = [e for e in self.index if e["epoch"] != epoch]
        self.index.append({"epoch": epoch, "metric": float(metric),
                           "path": path})
        while len(self.index) > self.max_history:
            # never prune the epoch just saved: 'last' must point at a live
            # checkpoint (the reference keeps last.pth.tar outside the
            # ranked set)
            worst = next(e for e in self._worst_first()
                         if e["epoch"] != epoch)
            self.index.remove(worst)
            if self.writes and os.path.exists(worst["path"]):
                os.remove(worst["path"])
        if self.writes:
            _save_json(self.index, self.index_path)
            last = os.path.join(self.dir, "last.pth.tar")
            tmp = last + ".tmp"
            if os.path.lexists(tmp):
                os.remove(tmp)
            os.symlink(os.path.basename(path), tmp)
            os.replace(tmp, last)
        barrier()

    def save_recovery(self, state, epoch: int) -> None:
        if not (self.recovery_interval
                and epoch % self.recovery_interval == 0):
            return
        if self.writes:
            _save(checkpoint_dict(state, epoch, arch=self.arch),
                  os.path.join(self.dir, "recovery.pth.tar"))
            _save_json({"epoch": epoch},
                       os.path.join(self.dir, "recovery.json"))
        barrier()

    def find_recovery(self) -> Optional[dict]:
        meta = os.path.join(self.dir, "recovery.json")
        path = os.path.join(self.dir, "recovery.pth.tar")
        if os.path.exists(meta) and os.path.exists(path):
            with open(meta) as f:
                info = json.load(f)
            info["path"] = path
            return info
        return None

    def best(self) -> Optional[dict]:
        if not self.index:
            return None
        return self._worst_first()[-1]

    def restore(self, state, path: Optional[str] = None):
        """Restore a ``TrainState`` in place from ``path`` or ``last``,
        mapped to the model's device; returns it."""
        if path is None:
            path = os.path.join(self.dir, "last.pth.tar")
        return restore(state, path)


def restore(state, path: str):
    """Load a checkpoint file written by ``CheckpointSaver`` into
    ``state``: the model, the optimizer, the EMA, ``step`` and
    ``lr_scale``.  Returns ``state``."""
    device = next(state.model.parameters()).device
    ckpt = torch.load(os.path.realpath(path), map_location=device,
                      weights_only=True)
    state.model.load_state_dict(ckpt["state_dict"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    if state.ema is not None:
        if ckpt.get("state_dict_ema") is None:
            raise KeyError(f"{path} holds no EMA for a state that keeps one")
        with torch.no_grad():
            for k, v in state.ema.items():
                v.copy_(ckpt["state_dict_ema"][k])
    state.step = int(ckpt["step"])
    state.lr_scale = float(ckpt["lr_scale"])
    return state


def save_weights(path: str, state_dict: Dict[str, torch.Tensor],
                 ema_state_dict: Optional[Dict[str, torch.Tensor]] = None):
    """Inference weights only, in the layout of a published ``.pth.tar``:
    ``state_dict`` and, where given, ``state_dict_ema``."""
    obj = {"state_dict": state_dict}
    if ema_state_dict is not None:
        obj["state_dict_ema"] = ema_state_dict
    _save(obj, path)


def load_weights(path: str, use_ema: bool = False,
                 map_location="cpu") -> Dict[str, torch.Tensor]:
    """Inference weights; the EMA where ``use_ema`` and the file has one
    (helpers.py:26-35)."""
    return load_torch_checkpoint(path, use_ema=use_ema,
                                 map_location=map_location)
