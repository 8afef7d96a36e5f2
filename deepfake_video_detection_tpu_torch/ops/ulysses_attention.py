"""Ulysses attention: sequence parallelism through head/sequence all-to-alls.

Counterpart of ``deepfake_video_detection_tpu/ops/ulysses_attention.py``
(DeepSpeed-Ulysses, arXiv:2309.14509). An all-to-all over the mesh's
``seq`` axis turns this rank's ``(B, H, N/s, d)`` blocks into ``(B, H/s, N,
d)`` (its head group over the whole sequence), the rank runs the port's
``flash_attention`` over them (K2/K3 forward, K4/K5/K6 backward on the
card; the plain version on the CPU, where JAX computes plain ``jnp``), and
a second all-to-all restores the sequence split. The all-to-all is its
own adjoint (``parallel/mesh.py::all_to_all``), so the backward runs the
same exchanges in reverse around the flash backward.

Requires H % s == 0 and N % s == 0 (JAX's two ``ValueError``s).
"""

from __future__ import annotations

from typing import Optional

import torch

from deepfake_video_detection_tpu_torch.ops.attention import flash_attention
from deepfake_video_detection_tpu_torch.parallel.mesh import all_to_all, axis_group, axis_size


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                      seq_axis: str = "model", batch_axis: Optional[str] = "data",
                      seq_len: Optional[int] = None) -> torch.Tensor:
    """Exact ``softmax(QKᵀ/√d)V`` with N split over ``seq_axis``. ``q, k,
    v``: this rank's ``(B, H, N/s, d)`` blocks; ``seq_len`` the global N
    (default ``s · N/s``). Differentiable in q, k and v."""
    h = q.shape[1]
    s = axis_size(mesh, seq_axis)
    if h % s != 0:
        raise ValueError(
            f"ulysses needs num_heads ({h}) divisible by the seq-parallel "
            f"degree ({s}); use ring_attention otherwise")
    n = seq_len if seq_len is not None else q.shape[2] * s
    if n % s != 0:
        raise ValueError(
            f"ulysses needs the global sequence length ({n}) divisible by "
            f"the seq-parallel degree ({s}) — pad the sequence or pick a "
            f"mesh whose '{seq_axis}' axis divides it")
    group = axis_group(mesh, seq_axis)
    B, _, nl, d = q.shape

    def to_heads(x):
        # (B, H, n, d) → (s, B, H/s, n, d) → a2a → (B, H/s, s·n, d)
        x = x.reshape(B, s, h // s, nl, d).transpose(0, 1)
        x = all_to_all(x, group)
        return x.permute(1, 2, 0, 3, 4).reshape(B, h // s, s * nl, d)

    out = flash_attention(to_heads(q), to_heads(k), to_heads(v))
    # (B, H/s, s·n, d) → (s, B, H/s, n, d) → a2a → (B, H, n, d)
    out = out.reshape(B, h // s, s, nl, d).permute(2, 0, 1, 3, 4)
    out = all_to_all(out, group)
    return out.transpose(0, 1).reshape(B, h, nl, d)
