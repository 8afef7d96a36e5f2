"""Functional layers with the JAX package's numerics and layouts.

Counterpart of ``deepfake_video_detection_tpu/nn/layers.py`` for what the
ViT, EfficientNet, ResNet, tinyconv and temporal-transformer paths need.
Activations are channel-last (NHWC) at the public functions, as in the JAX
package; weights are torch's (``(out, in)`` linears, OIHW convs). Each
function casts its weights to the activation's dtype, as the JAX layers
cast their f32 params, and ``layer_norm`` computes in f32.

NHWC is only a memory format here: a contiguous NHWC activation permuted to
NCHW is a channels-last view, cuDNN takes it and returns channels-last, and
the permute back is a view again, so a conv net stays channels-last from
layer to layer without a copy.

Attention differs from the JAX layer on purpose: the JAX package reads
``VIT_FUSED_ATTN`` (and, in the temporal transformer, an N threshold) to
choose between XLA and its Pallas kernel, a choice measured on a TPU. Here
a CUDA input always goes through the hand-written flash kernel and a CPU
input through its plain version.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from deepfake_video_detection_tpu_torch.ops import attention as A


def _cast(t: Optional[torch.Tensor], dtype: torch.dtype) -> Optional[torch.Tensor]:
    return None if t is None else t.to(dtype)


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """torch.nn.Linear: weight (out, in), y = x @ Wᵀ + b."""
    return F.linear(x, weight.to(x.dtype), _cast(bias, x.dtype))


def conv2d(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None,
           stride: Union[int, Tuple[int, int]] = 1,
           padding: Union[int, Tuple[int, int]] = 0,
           groups: int = 1) -> torch.Tensor:
    """2-D cross-correlation, ``x`` NHWC in and out, ``weight`` OIHW
    (``(O, C/groups, kH, kW)``)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight.to(x.dtype),
                 _cast(bias, x.dtype), stride, padding, 1, groups)
    return y.permute(0, 2, 3, 1)


def batch_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               running_mean: torch.Tensor, running_var: torch.Tensor,
               train: bool = False, eps: float = 1e-5, momentum: float = 0.1
               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """BatchNorm over the last axis (NHWC) with torch semantics: in
    training the biased batch variance normalises and the unbiased one
    enters the running update. Returns ``(y, (new_mean, new_var))``; in
    eval the running stats pass through. Either way the normalisation is
    folded into one scale and shift computed in f32 and cast to x's dtype,
    as in the JAX layer."""
    if train:
        dims = tuple(range(x.ndim - 1))
        xf = x.to(torch.float32)
        mean = xf.mean(dim=dims)
        var = (xf * xf).mean(dim=dims) - mean * mean
        n = x.numel() // x.shape[-1]
        unbiased = var * (n / max(n - 1, 1))
        new_stats = ((1 - momentum) * running_mean + momentum * mean,
                     (1 - momentum) * running_var + momentum * unbiased)
    else:
        mean, var = running_mean, running_var
        new_stats = (running_mean, running_var)
    inv = torch.rsqrt(var.to(torch.float32) + eps) * weight.to(torch.float32)
    shift = bias.to(torch.float32) - mean.to(torch.float32) * inv
    return torch.addcmul(shift.to(x.dtype), x, inv.to(x.dtype)), new_stats


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis, computed in f32, returned in x's dtype."""
    y = F.layer_norm(x.to(torch.float32), (x.shape[-1],),
                     weight.to(torch.float32), bias.to(torch.float32), eps)
    return y.to(x.dtype)


def max_pool2d(x: torch.Tensor, kernel: int, stride: int, padding: int = 0
               ) -> torch.Tensor:
    """torch.nn.MaxPool2d on NHWC; the padding counts as −inf."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), kernel, stride, padding)
    return y.permute(0, 2, 3, 1)


def avg_pool2d(x: torch.Tensor, kernel: int, stride: int, padding: int = 0
               ) -> torch.Tensor:
    """Window sums taken in f32 over ``kernel²`` (the padding counts as
    zeros, as in the JAX layer), returned in x's dtype. NHWC."""
    y = F.avg_pool2d(x.permute(0, 3, 1, 2).to(torch.float32), kernel, stride,
                     padding, count_include_pad=True)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """AdaptiveAvgPool2d(1) + flatten on NHWC: (N, H, W, C) → (N, C), the
    mean taken in f32 (accumulated in f32, without an f32 copy of x)."""
    return x.mean(dim=(1, 2), dtype=torch.float32).to(x.dtype)


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout; identity unless ``train`` with ``rate`` > 0. The
    generator must live on x's device."""
    if not train or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def drop_path(x: torch.Tensor, rate: float, train: bool,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Stochastic depth: each sample of the batch (axis 0) is zeroed with
    probability ``rate`` and the rest scaled by 1/(1 − rate); identity
    unless ``train`` with ``rate`` > 0. The generator lives on x's device."""
    if not train or rate <= 0.0:
        return x
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def multi_head_attention(x: torch.Tensor, qkv_weight: torch.Tensor,
                         qkv_bias: Optional[torch.Tensor],
                         proj_weight: torch.Tensor,
                         proj_bias: Optional[torch.Tensor],
                         num_heads: int) -> torch.Tensor:
    """timm-style fused-QKV self-attention. ``x``: (B, N, C).

    q, k and v are strided views of the QKV projection, fed to the flash
    kernel without a copy; its output merges heads as a view."""
    B, N, C = x.shape
    head = C // num_heads
    qkv = linear(x, qkv_weight, qkv_bias).reshape(B, N, 3, num_heads, head)
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)      # each (B, nh, N, hd)
    out = A.flash_attention(q, k, v)                    # (B, nh, N, hd)
    out = out.transpose(1, 2).reshape(B, N, C)
    return linear(out, proj_weight, proj_bias)
