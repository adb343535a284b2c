"""Training losses, counterpart of ``cotnet_tpu/train/loss.py`` (reference
loss/cross_entropy.py, loss/jsd.py).

All take logits ``[N, K]`` and either int labels ``[N]``, soft targets
``[N, K]`` or (the multi-label asymmetric loss) 0/1 targets ``[N, K]``, and
return a scalar loss in f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _log_softmax(logits):
    return F.log_softmax(logits.float(), dim=-1)


def cross_entropy(logits, labels):
    logp = _log_softmax(logits)
    return -logp.gather(-1, labels[:, None])[:, 0].mean()


def label_smoothing_cross_entropy(logits, labels, smoothing: float = 0.1):
    """Reference loss/cross_entropy.py:6-26."""
    logp = _log_softmax(logits)
    nll = -logp.gather(-1, labels[:, None])[:, 0]
    smooth = -logp.mean(-1)
    return ((1.0 - smoothing) * nll + smoothing * smooth).mean()


def soft_target_cross_entropy(logits, target):
    """Soft targets from mixup/cutmix (reference loss/cross_entropy.py:29-36)."""
    return (-target.float() * _log_softmax(logits)).sum(-1).mean()


def jsd_cross_entropy(logits_splits, labels, num_splits: int = 3,
                      alpha: float = 12.0, smoothing: float = 0.1):
    """JSD consistency loss for AugMix training (reference loss/jsd.py:8-39):
    CE on the clean split + alpha * JS divergence across all splits.

    logits_splits: ``[num_splits * N, K]``, the clean split first.
    """
    split = logits_splits.float().chunk(num_splits, dim=0)
    if smoothing > 0:
        ce = label_smoothing_cross_entropy(split[0], labels, smoothing)
    else:
        ce = cross_entropy(split[0], labels)
    probs = [F.softmax(s, dim=-1) for s in split]
    logm = (sum(probs) / len(probs)).clamp(1e-7, 1.0).log()
    kl = sum((p * (p.clamp(1e-7, 1.0).log() - logm)).sum(-1)
             for p in probs) / len(probs)
    return ce + alpha * kl.mean()


def asymmetric_loss_multilabel(logits, target, gamma_neg: float = 4.0,
                               gamma_pos: float = 1.0, clip: float = 0.05,
                               eps: float = 1e-8):
    """ASL for multi-label targets (reference asymmetric_loss.py:5-52):
    the negatives' probability shifted by ``clip``, each term weighted by
    ``(1 - pt)^gamma``; the sum over the batch, as the reference returns."""
    p = torch.sigmoid(logits.float())
    target = target.float()
    pn = (1.0 - p + clip).clamp(max=1.0) if clip else 1.0 - p
    loss = (target * p.clamp(min=eps).log()
            + (1.0 - target) * pn.clamp(min=eps).log())
    pt = p * target + pn * (1.0 - target)
    gamma = gamma_pos * target + gamma_neg * (1.0 - target)
    return -(loss * (1.0 - pt).pow(gamma)).sum()


def asymmetric_loss_single_label(logits, labels, gamma_neg: float = 4.0,
                                 gamma_pos: float = 0.0,
                                 smoothing: float = 0.1, eps: float = 0.1):
    """ASL for single-label targets (reference asymmetric_loss.py:55-97):
    focal weights ``(1 - pt)^gamma`` on the (``eps``-smoothed) one-hot
    cross-entropy; ``smoothing`` is accepted and unused, as in the JAX
    package."""
    logp = _log_softmax(logits)
    k = logp.shape[-1]
    onehot = F.one_hot(labels, k).float()
    if eps > 0:
        onehot = onehot * (1 - eps) + eps / k
    p = logp.exp()
    pt = p * onehot + (1.0 - p) * (1.0 - onehot)
    gamma = gamma_pos * onehot + gamma_neg * (1.0 - onehot)
    return (-onehot * logp * (1.0 - pt).pow(gamma)).sum(-1).mean()


def create_loss_fn(cfg_loss: dict, mixup_active: bool = False):
    """Loss selection mirroring the reference's train.py:198-209.

    Returns ``(train_loss_fn(logits, target), eval_loss_fn(logits,
    labels))``.  The train target is soft ``[N, K]`` when mixup is active,
    int labels otherwise.
    """
    jsd = cfg_loss.get("jsd", False)
    smoothing = cfg_loss.get("smoothing", 0.0)
    aug_splits = cfg_loss.get("aug_splits", 0)
    if jsd:
        if aug_splits <= 1:
            raise ValueError("JSD needs aug splits")

        def train_fn(logits, labels):
            return jsd_cross_entropy(logits, labels, num_splits=aug_splits,
                                     smoothing=smoothing)
    elif mixup_active:
        train_fn = soft_target_cross_entropy
    elif smoothing:
        def train_fn(logits, labels):
            return label_smoothing_cross_entropy(logits, labels, smoothing)
    else:
        train_fn = cross_entropy
    return train_fn, cross_entropy
