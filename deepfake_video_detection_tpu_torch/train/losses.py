"""Loss functions of the trainers, in f32 whatever the model's compute dtype.

Counterpart of ``deepfake_video_detection_tpu/train/losses.py``: weighted
cross-entropy with label smoothing, focal loss over smoothed targets, and
BCE-with-logits. Every per-sample loss is reduced by the torch-semantics
weighted mean ``sum(w·x) / sum(w)``, ``w`` the class weight times the
validity mask, so the loader's padded slots carry no gradient. Within
``parallel.mesh.reducing`` the denominator ``sum(w)`` is the global
batch's (summed over the ranks holding other rows), so each rank's loss is
its rows' share of the global mean and the shares add up to it.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from deepfake_video_detection_tpu_torch.parallel.mesh import rows_sum

Weights = Optional[Union[torch.Tensor, np.ndarray, Sequence[float]]]


def _smoothed_one_hot(labels: torch.Tensor, num_classes: int,
                      smoothing: float) -> torch.Tensor:
    one = F.one_hot(labels.long(), num_classes).to(torch.float32)
    if smoothing > 0.0:
        one = one * (1.0 - smoothing) + smoothing / num_classes
    return one


def _weighted_mean(per_sample: torch.Tensor, labels: torch.Tensor,
                   class_weights: Weights, sample_mask: Optional[torch.Tensor]
                   ) -> torch.Tensor:
    w = torch.ones_like(per_sample)
    if class_weights is not None:
        cw = torch.as_tensor(class_weights, dtype=torch.float32,
                             device=per_sample.device)
        w = w * cw[labels.long()]
    if sample_mask is not None:
        w = w * sample_mask.to(torch.float32)
    return torch.sum(per_sample * w) / torch.clamp(rows_sum(torch.sum(w)), min=1e-8)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       class_weights: Weights = None,
                       label_smoothing: float = 0.0,
                       sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Weighted-mean CE over the batch."""
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    targets = _smoothed_one_hot(labels, logits.shape[-1], label_smoothing)
    ce = -torch.sum(targets * logp, dim=-1)
    return _weighted_mean(ce, labels, class_weights, sample_mask)


def focal_loss(logits: torch.Tensor, labels: torch.Tensor, alpha: float = 1.0,
               gamma: float = 2.0, label_smoothing: float = 0.1,
               class_weights: Weights = None,
               sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``alpha * (1 - p_t)^gamma * CE`` over smoothed targets, p_t the
    true-class probability."""
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    targets = _smoothed_one_hot(labels, logits.shape[-1], label_smoothing)
    ce = -torch.sum(targets * logp, dim=-1)
    pt = torch.exp(-ce)
    loss = alpha * torch.pow(1.0 - pt, gamma) * ce
    return _weighted_mean(loss, labels, class_weights, sample_mask)


def binary_cross_entropy_with_logits(logits: torch.Tensor,
                                     targets: torch.Tensor) -> torch.Tensor:
    """Numerically stable BCE-with-logits, mean-reduced."""
    x = logits.to(torch.float32)
    t = targets.to(torch.float32)
    return torch.mean(torch.clamp(x, min=0) - x * t
                      + torch.log1p(torch.exp(-torch.abs(x))))


def inverse_frequency_class_weights(labels, num_classes: int = 2) -> np.ndarray:
    """Host-side inverse-frequency weights ``w_c = N / (C · count_c)``,
    normalised to mean 1."""
    labels = np.asarray(labels)
    counts = np.maximum(np.bincount(labels, minlength=num_classes)
                        .astype(np.float64), 1.0)
    w = labels.shape[0] / (num_classes * counts)
    return (w / w.mean()).astype(np.float32)
