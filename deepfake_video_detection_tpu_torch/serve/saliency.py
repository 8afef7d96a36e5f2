"""Input-gradient saliency for serving: where in each frame the detector
sees manipulation.

Counterpart of ``deepfake_video_detection_tpu/serve/saliency.py``: a
per-frame map of |d score / d pixel| pooled to a coarse grid, taken with
autograd through the same forward the verdict used.

* The uint8 frames are normalised by the fused-normalize kernel (K1) with
  f32 output, and that f32 tensor is the leaf the gradient is taken for
  (uint8 is not differentiable); a bf16 model casts it on entry, so the
  gradient comes back through the cast. On the card every ViT or temporal
  block runs the flash forward (K2) and, in the backward, the flash
  backward (K4).
* The gradient is ``torch.autograd.grad`` of the score for the input
  alone, so no parameter's ``.grad`` builds up across requests. It runs
  with autograd on even when the caller serves under
  ``torch.inference_mode()``.
* Per-frame max normalisation keeps the map scale-free: each frame's
  hottest cell is 1.0.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from deepfake_video_detection_tpu_torch.ops.preprocess import fused_normalize

__all__ = ["make_saliency_fn", "saliency_payload"]


def make_saliency_fn(model: Any, grid: Tuple[int, int] = (14, 14),
                     fake_idx: Optional[int] = None
                     ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Build ``frames_u8 (B, T, H, W, 3) -> (B, T, gh, gw)``: per-frame
    saliency grids in [0, 1], on the frames' device.

    ``model(x)`` returns ``(logits, frame_scores)`` for normalised frames
    ``x`` (``BackboneDetector``, ``EnsembleDetector``,
    ``TemporalTransformerDetector``). The score is class-contrastive,
    ``logit[fake] - logit[real]`` (the fake logit alone when there are not
    two classes), summed over the batch, so each sample's gradient is its
    own. ``fake_idx``: the class to explain; None reads
    ``FAKE_CLASS_INDEX`` at every call.

    A ``voting`` ensemble's combined logits are a one-hot majority whose
    input gradient is zero, so the map differentiates the mean of the
    member logits instead. The grid never exceeds the input's resolution;
    trailing pixels that do not divide evenly are cropped (224 px on a
    14 x 14 grid: 16 x 16 pixels a cell).
    """
    mean_members = getattr(model, "ensemble_method", None) == "voting"

    def fake_logit_mass(x: torch.Tensor) -> torch.Tensor:
        if mean_members:
            _, _, member_logits = model(x, return_member_logits=True)
            logits = member_logits.to(torch.float32).mean(dim=0)
        else:
            logits = model(x)[0].to(torch.float32)
        c = logits.shape[-1]
        if fake_idx is None:
            from deepfake_video_detection_tpu_torch.serve.predict import (
                _get_fake_class_index)
            idx = _get_fake_class_index(c)
        else:
            idx = fake_idx
        score = logits[:, idx] - logits[:, 1 - idx] if c == 2 else logits[:, idx]
        return score.sum()

    def saliency(frames_u8: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode(False), torch.enable_grad():
            x = fused_normalize(frames_u8, out_dtype=torch.float32).requires_grad_()
            (g,) = torch.autograd.grad(fake_logit_mass(x), x)
        sal = g.abs().sum(dim=-1)                       # (B, T, H, W)
        b, t, h, w = sal.shape
        gh, gw = min(grid[0], h), min(grid[1], w)
        ph, pw = h // gh, w // gw
        sal = sal[:, :, : gh * ph, : gw * pw]
        sal = sal.reshape(b, t, gh, ph, gw, pw).mean(dim=(3, 5))
        mx = sal.amax(dim=(2, 3), keepdim=True)
        return sal / mx.clamp_min(1e-12)

    return saliency


def saliency_payload(grids) -> dict:
    """JSON payload for one clip's saliency: ``grids`` (T, gh, gw) → the
    additive ``result["saliency"]`` key."""
    a = np.asarray(grids, np.float64)
    t, gh, gw = a.shape
    return {
        "grid": [int(gh), int(gw)],
        "frames": [[round(float(v), 3) for v in frame.ravel()]
                   for frame in a],
    }
