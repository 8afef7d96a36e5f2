"""Flash attention forward: O = softmax(QKᵀ/√d)·V and the row logsumexp (K2).

Counterpart of ``deepfake_video_detection_tpu/ops/attention.py``'s forward
(``_flash_impl`` → ``_short_attn_kernel`` for n_pad ≤ 512, ``_attn_kernel``
above). On CUDA tensors :func:`flash_attention_fwd` launches the
hand-written kernel ``csrc/flash_fwd.cu``, which streams 64-key tiles with
an online softmax and so covers both TPU regimes with one kernel. On CPU
tensors it takes :func:`flash_attention_plain`, a dense f32 softmax.

Layout is the JAX one, ``(B, H, N, d)``. The kernel takes element strides
for B, H and N (the last axis must be contiguous), so the q/k/v views that
``nn.layers.multi_head_attention`` cuts from its fused QKV projection go in
without a copy. O comes back as a ``(B, H, N, d)`` view of a ``(B, N, H, d)``
buffer, so merging the heads afterwards is free.

Forward only: the backward kernels (K4–K6) come with training. A CUDA input
that would need a gradient raises.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Tuple

import torch

from deepfake_video_detection_tpu_torch.ops import _build

_SOURCE = "flash_fwd.cu"
_MAX_HEAD_DIM = 256
_count_lock = threading.Lock()


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version, in f32: returns ``(out, lse)``, out in
    q's dtype ``(B, H, N, d)``, lse f32 ``(B, H, N)``."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.to(torch.float32) * scale,
                     k.to(torch.float32).transpose(-1, -2))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.matmul(p, v.to(torch.float32)) / l
    return out.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def _library() -> ctypes.CDLL:
    lib = _build.load(_SOURCE)
    fn = lib.dfdt_flash_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"flash attention takes q, k, v of one (B, H, N, d) "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) \
            or q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"flash attention takes bf16 or f32 q, k, v of one "
                         f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash attention: q, k, v on different devices")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``q, k, v``: ``(B, H, N, d)``, bf16 or f32, d ≤ 256, any N ≥ 1.
    Returns ``(out, lse)``: out ``(B, H, N, d)`` in q's dtype, lse f32
    ``(B, H, N)``, the logsumexp of the scaled scores of each query row."""
    _check_inputs(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention: no kernel for {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "flash attention on CUDA is forward-only: the backward kernels "
            "(K4-K6) are not ported yet")
    B, H, N, d = q.shape
    if not 1 <= d <= _MAX_HEAD_DIM or N < 1 or B * H < 1:
        raise ValueError(f"flash attention kernel takes 1 <= d <= 256 and "
                         f"N >= 1, got {tuple(q.shape)}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash attention kernel needs the last axis of q, "
                         "k, v contiguous")
    out = torch.empty((B, N, H, d), dtype=q.dtype,
                      device=q.device).permute(0, 2, 1, 3)
    lse = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    lib = _library()
    status = lib.dfdt_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B, H, N, d, int(q.dtype == torch.bfloat16),
        ctypes.addressof(strides), 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, status, "flash_attention_fwd")
    with _count_lock:
        flash_attention_fwd.launches += 1
    return out, lse


# kernel launches since the last reset (a plain integer, set to 0 by callers)
flash_attention_fwd.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                    ) -> torch.Tensor:
    """``softmax(QKᵀ/√d)·V`` for ``(B, H, N, d)`` inputs, in q's dtype."""
    return flash_attention_fwd(q, k, v)[0]
