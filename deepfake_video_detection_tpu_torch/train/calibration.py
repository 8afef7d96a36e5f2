"""Confidence calibration and uncertainty estimation.

Counterpart of ``deepfake_video_detection_tpu/train/calibration.py``:

* :class:`ConfidenceCalibrator`: temperature scaling. The NLL of
  ``softmax(logits / T)`` is minimised over log T by damped Newton steps,
  with the JAX version's step count, tolerance, clip and gradient fallback;
  the value, gradient and Hessian come from torch autograd in f32.
* :class:`UncertaintyEstimator`: ensemble disagreement (std of the members'
  fake probabilities) and decision-margin uncertainty, in numpy.

Both take and return numpy arrays and compute on the host: a fit is a
scalar problem over one validation set's logits.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _nll(log_t: torch.Tensor, logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits / torch.exp(log_t), dim=-1)
    return -torch.mean(torch.gather(logp, -1, labels[:, None]))


class ConfidenceCalibrator:
    """Temperature scaling: minimise the NLL of ``softmax(logits / T)``."""

    def __init__(self, init_temperature: float = 1.0):
        self.temperature = float(init_temperature)

    def fit(self, logits: np.ndarray, labels: np.ndarray,
            steps: int = 50, tol: float = 1e-6) -> float:
        logits = torch.as_tensor(np.asarray(logits, np.float32))
        labels = torch.as_tensor(np.asarray(labels), dtype=torch.int64)
        log_t = torch.tensor(float(np.log(self.temperature)), dtype=torch.float32)
        for _ in range(steps):
            x = log_t.clone().requires_grad_()
            (g,) = torch.autograd.grad(_nll(x, logits, labels), x, create_graph=True)
            (h,) = torch.autograd.grad(g, x)
            g = g.detach()
            # damped Newton with a gradient fallback when curvature is tiny
            step = torch.clamp(torch.where(torch.abs(h) > 1e-6, g / h, g), -1.0, 1.0)
            new_log_t = log_t - step
            if float(torch.abs(new_log_t - log_t)) < tol:
                log_t = new_log_t
                break
            log_t = new_log_t
        self.temperature = float(torch.exp(log_t))
        return self.temperature

    def calibrate(self, logits: np.ndarray) -> np.ndarray:
        z = np.asarray(logits, np.float64) / self.temperature
        z = z - z.max(axis=-1, keepdims=True)
        e = np.exp(z)
        return e / e.sum(axis=-1, keepdims=True)


class UncertaintyEstimator:
    """Disagreement and margin uncertainty over ensemble member outputs."""

    def __init__(self, fake_index: int = 1):
        self.fake_index = fake_index

    def member_fake_probs(self, member_logits: np.ndarray) -> np.ndarray:
        """(M, B, C) logits → (M, B) fake probabilities."""
        z = np.asarray(member_logits, np.float64)
        z = z - z.max(-1, keepdims=True)
        e = np.exp(z)
        probs = e / e.sum(-1, keepdims=True)
        return probs[..., self.fake_index]

    def disagreement(self, member_logits: np.ndarray) -> np.ndarray:
        """Std of member fake-probs per sample: (M, B, C) → (B,)."""
        return self.member_fake_probs(member_logits).std(axis=0)

    def margin(self, ensemble_probs: np.ndarray,
               threshold: float = 0.5) -> np.ndarray:
        """1 − 2·|p − thr|: high near the decision boundary. (B, C) → (B,)."""
        pf = np.asarray(ensemble_probs)[..., self.fake_index]
        return 1.0 - 2.0 * np.abs(pf - threshold)

    def combined(self, member_logits: np.ndarray,
                 ensemble_probs: np.ndarray,
                 threshold: float = 0.5) -> Dict[str, np.ndarray]:
        d = self.disagreement(member_logits)
        m = self.margin(ensemble_probs, threshold)
        return {"disagreement": d, "margin": m,
                "uncertainty": np.clip(0.5 * d * 2.0 + 0.5 * m, 0.0, 1.0)}
