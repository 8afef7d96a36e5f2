"""Functional layers with the JAX package's numerics and layouts.

Counterpart of ``deepfake_video_detection_tpu/nn/layers.py`` for what the
ViT, EfficientNet, ResNet, tinyconv, temporal-transformer and legacy
(CNN+LSTM, logic RNN, graph) paths need.
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

import contextlib
import contextvars
from typing import Iterator, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from deepfake_video_detection_tpu_torch.ops import attention as A
from deepfake_video_detection_tpu_torch.parallel.mesh import (
    tokens_count, tokens_reduced, tokens_sum)


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
    as in the JAX layer. Within ``parallel.mesh.reducing`` the moments and
    the count are the global batch's (JAX's mean over a sharded batch),
    summed over the ranks holding other frames, the backward through that
    sum."""
    if train:
        dims = tuple(range(x.ndim - 1))
        xf = x.to(torch.float32)
        n = x.numel() // x.shape[-1]
        if tokens_reduced():
            sums = tokens_sum(torch.stack([xf.sum(dim=dims), (xf * xf).sum(dim=dims)]))
            n = tokens_count(n)
            mean, var = sums[0] / n, sums[1] / n - (sums[0] / n) ** 2
        else:
            mean = xf.mean(dim=dims)
            var = (xf * xf).mean(dim=dims) - mean * mean
        unbiased = var * (n / max(n - 1, 1))
        new_stats = ((1 - momentum) * running_mean + momentum * mean,
                     (1 - momentum) * running_var + momentum * unbiased)
    else:
        mean, var = running_mean, running_var
        new_stats = (running_mean, running_var)
    inv = torch.rsqrt(var.to(torch.float32) + eps) * weight.to(torch.float32)
    shift = bias.to(torch.float32) - mean.to(torch.float32) * inv
    return torch.addcmul(shift.to(x.dtype), x, inv.to(x.dtype)), new_stats


_FROZEN_STATS = contextvars.ContextVar("frozen_running_stats", default=False)


@contextlib.contextmanager
def frozen_running_stats(frozen: bool = True) -> Iterator[None]:
    """Within this context batch-norm modules leave their running stats as
    they are in training: a forward that ``torch.utils.checkpoint`` runs
    again in the backward must not apply the momentum update twice."""
    token = _FROZEN_STATS.set(frozen)
    try:
        yield
    finally:
        _FROZEN_STATS.reset(token)


def running_stats_frozen() -> bool:
    return _FROZEN_STATS.get()


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


def lstm(x: torch.Tensor,
         layers: Sequence[Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]],
         dropout_rate: float = 0.0, train: bool = False,
         generator: Optional[torch.Generator] = None
         ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Multi-layer LSTM matching ``torch.nn.LSTM(batch_first=True)``, gate
    order i, f, g, o. ``layers``: per layer ``(weight_ih (4H, in),
    weight_hh (4H, H), bias_ih, bias_hh)``; ``x``: (B, T, F).

    As in the JAX layer, the input projection over the whole sequence is one
    matmul with ``bias_ih + bias_hh`` added in f32, and the recurrent product
    and the cell run per step in f32. Between layers, dropout at
    ``dropout_rate`` when ``train`` and a ``generator`` is given (the JAX
    layer drops only with an rng). Returns ``(outputs (B, T, H) in x's
    dtype, (h_n (L, B, H), c_n (L, B, H)) f32)``."""
    B = x.shape[0]
    h_ns, c_ns = [], []
    for k, (w_ih, w_hh, b_ih, b_hh) in enumerate(layers):
        H = w_hh.shape[1]
        zx = F.linear(x, w_ih.to(x.dtype)).to(torch.float32) \
            + (b_ih.to(torch.float32) + b_hh.to(torch.float32))
        w_hh32 = w_hh.to(torch.float32)
        h = torch.zeros((B, H), dtype=torch.float32, device=x.device)
        c = torch.zeros_like(h)
        ys = []
        for t in range(zx.shape[1]):
            z = zx[:, t] + F.linear(h, w_hh32)
            i, f, g, o = z.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            ys.append(h)
        x = torch.stack(ys, dim=1).to(x.dtype)
        h_ns.append(h)
        c_ns.append(c)
        if k < len(layers) - 1 and generator is not None:
            x = dropout(x, dropout_rate, train, generator)
    return x, (torch.stack(h_ns), torch.stack(c_ns))


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
