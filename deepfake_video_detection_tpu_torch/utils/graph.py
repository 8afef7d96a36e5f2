"""Graph and adjacency math for the frame-graph and patch-graph models.

Counterpart of ``deepfake_video_detection_tpu/utils/graph.py``: the chain
and fully connected adjacency constructors are numpy copies, and
:func:`normalize_adjacency` computes the same symmetric normalisation in
torch, f32, batched over any leading axes.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def normalize_adjacency(A: Any) -> torch.Tensor:
    """``D^-1/2 (A + I) D^-1/2`` in f32 for an ``(N, N)`` or batched
    ``(..., N, N)`` adjacency (a tensor or an array); a row of degree 0
    stays 0. The result lies on the input tensor's device (the CPU for an
    array)."""
    A = torch.as_tensor(A, dtype=torch.float32)
    A = A + torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    deg = A.sum(dim=-1)
    dis = torch.where(deg > 0, 1.0 / torch.sqrt(deg), torch.zeros_like(deg))
    return A * dis[..., :, None] * dis[..., None, :]


def chain_adjacency(n: int) -> np.ndarray:
    """Temporal chain graph over ``n`` frames: frame t ↔ frame t+1."""
    A = np.zeros((n, n), dtype=np.float32)
    idx = np.arange(n - 1)
    A[idx, idx + 1] = 1.0
    A[idx + 1, idx] = 1.0
    return A


def fully_connected_adjacency(n: int, self_loops: bool = False) -> np.ndarray:
    """Dense all-to-all graph over ``n`` nodes."""
    A = np.ones((n, n), dtype=np.float32)
    if not self_loops:
        np.fill_diagonal(A, 0.0)
    return A
