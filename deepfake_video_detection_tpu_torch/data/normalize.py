"""ImageNet normalisation constants and the plain op.

Counterpart of ``deepfake_video_detection_tpu/data/normalize.py``.
Channel-last tensors (``(..., H, W, 3)``), uint8 [0, 255] or float [0, 1].
"""

from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def imagenet_normalize(x: torch.Tensor, scaled: bool = False) -> torch.Tensor:
    """``x``: (..., H, W, 3) uint8 [0,255] (or float [0,1] with
    ``scaled=True``) → float32 normalised, on ``x``'s device."""
    x = x.to(torch.float32)
    if not scaled:
        x = x / 255.0
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
    return (x - mean) / std


CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def clip_normalize(x: torch.Tensor, scaled: bool = False) -> torch.Tensor:
    """The CLIP mean/std normalisation, otherwise as :func:`imagenet_normalize`."""
    x = x.to(torch.float32)
    if not scaled:
        x = x / 255.0
    mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(CLIP_STD, dtype=torch.float32, device=x.device)
    return (x - mean) / std
