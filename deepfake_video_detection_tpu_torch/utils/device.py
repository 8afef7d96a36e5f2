"""Device and compute-dtype choice shared by the models, ``Predictor`` and
``Trainer``.

Every entry point of the port runs on the card unless its caller names
another device (the CPU tests pass ``device="cpu"``), and asking for CUDA
where there is none raises: nothing falls back to the CPU silently.
"""

from __future__ import annotations

import logging
from typing import Any

import torch

from deepfake_video_detection_tpu_torch.utils.config import env_str

logger = logging.getLogger(__name__)


def resolve_device(device: Any = "cuda") -> torch.device:
    """``device`` as a ``torch.device`` (``None`` means ``"cuda"``); raises if
    CUDA is asked for and there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} was asked for but CUDA is not "
                           f"available")
    return dev


def serving_dtype(device: Any = "cuda") -> torch.dtype:
    """Compute dtype for a served model: ``COMPUTE_DTYPE`` (``auto`` by
    default: bf16 on the card, f32 on the CPU). Unknown values serve f32
    with a warning."""
    name = (env_str("COMPUTE_DTYPE", "auto") or "auto").lower()
    if name == "auto":
        name = "bfloat16" if torch.device(device).type == "cuda" else "float32"
    if name in ("bfloat16", "bf16"):
        return torch.bfloat16
    if name not in ("float32", "f32"):
        logger.warning("COMPUTE_DTYPE=%r not supported "
                       "(bfloat16|float32|auto); serving in float32", name)
    return torch.float32
