"""Int8 weight-only quantization for serving: weights at rest in int8.

Counterpart of ``deepfake_video_detection_tpu/nn/quant.py``. The scheme is
the JAX package's: symmetric per-output-channel, ``s = max|w| / 127`` over
the non-output axes (``s = 1`` for an all-zero channel) and
``q = clip(rint(w / s), -127, 127)``, computed in numpy on the host so that
``q`` and ``s`` are byte for byte the JAX package's. The port holds torch
layouts, ``(out, in)`` linears and OIHW convs, so the output channel is
axis 0 of both (the JAX package's HWIO axis 3 is the same channel).

Which weights: parameters named ``…weight``, of 2 or 4 dimensions, floating,
with at least ``min_elems`` elements (4096): the matmul and conv weights.
Norms, biases, the small heads and the ensemble's mixing ``weights`` stay
f32.

How a layer reads one: every layer of ``nn/layers.py`` reads a weight once,
as ``weight.to(x.dtype)``. :func:`quantize_module` replaces each chosen
``nn.Parameter`` with an :class:`Int8Weight` submodule under the same name,
whose ``to`` dequantizes (``q * s`` in f32, one elementwise kernel) and then
casts, as the JAX ``Int8Weight.astype`` does, so a bf16 model does not
round its scales. No layer changes. The f32 weight is gone from the module:
``q`` (int8) and ``s`` (f32) are its buffers and follow ``model.to(device)``.
The products stay cuBLAS/cuDNN through torch; dequantizing adds one
elementwise launch per quantized weight and forward in f32, two in bf16.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn as nn

_QMAX = 127.0


class Int8Weight(nn.Module):
    """An int8 weight that reads as the weight it stands for.

    ``q``: int8, the weight's shape. ``scale``: f32, size 1 on every axis
    but the output channel's (axis 0). ``to(dtype)`` returns the
    dequantized weight as a tensor (the layers' one read); a parent's
    ``model.to(device)`` moves the buffers as it moves any submodule's.
    """

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        super().__init__()
        self.register_buffer("q", q)
        self.register_buffer("scale", scale)

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    def to(self, *args, **kwargs) -> torch.Tensor:
        """The dequantized weight, then ``Tensor.to(*args, **kwargs)``: the
        multiply in f32 before the cast."""
        return (self.q * self.scale).to(*args, **kwargs)

    def extra_repr(self) -> str:
        return f"shape={tuple(self.q.shape)}"


def quantize_weight(w: torch.Tensor) -> Int8Weight:
    """Symmetric per-output-channel int8 of one weight (axis 0 is the
    output channel), on the host in numpy; the result on ``w``'s device."""
    wf = w.detach().to("cpu", torch.float32).numpy()
    reduce_axes = tuple(range(1, wf.ndim))
    amax = np.max(np.abs(wf), axis=reduce_axes, keepdims=True)
    scale = np.where(amax > 0, amax / _QMAX, np.float32(1.0)).astype(np.float32)
    q = np.clip(np.rint(wf / scale), -_QMAX, _QMAX).astype(np.int8)
    return Int8Weight(torch.from_numpy(q).to(w.device),
                      torch.from_numpy(scale).to(w.device))


def _is_quantizable(name: str, p: torch.Tensor, min_elems: int) -> bool:
    return (name.endswith("weight") and p.ndim in (2, 4)
            and p.is_floating_point() and p.numel() >= min_elems)


@torch.no_grad()
def quantize_module(model: nn.Module, min_elems: int = 4096) -> int:
    """Replace every matmul/conv weight of ``model`` (in place) with an
    :class:`Int8Weight`; returns how many. Batch-norm statistics and
    everything else stay as they are."""
    chosen = [(mod, name, p) for mod in model.modules()
              for name, p in mod.named_parameters(recurse=False)
              if _is_quantizable(name, p, min_elems)]
    for mod, name, p in chosen:
        delattr(mod, name)
        setattr(mod, name, quantize_weight(p))
    return len(chosen)


@torch.no_grad()
def dequantize(model: nn.Module) -> int:
    """The inverse view, in place: every :class:`Int8Weight` back to an f32
    ``nn.Parameter`` (lossy: the quantized values, not the originals).
    Returns how many."""
    chosen = [(mod, name, child) for mod in model.modules()
              for name, child in mod.named_children() if isinstance(child, Int8Weight)]
    for mod, name, child in chosen:
        delattr(mod, name)
        mod.register_parameter(name, nn.Parameter(child.to(torch.float32)))
    return len(chosen)


def quantized_bytes(model: nn.Module) -> Tuple[int, int]:
    """``(bytes now, bytes if f32)`` over the parameters and the int8
    weights (``q`` and ``scale``): the saving at rest. As in the JAX
    package, the scales count in the f32 figure too."""
    tensors = list(model.parameters()) + [
        t for m in model.modules() if isinstance(m, Int8Weight) for t in (m.q, m.scale)]
    now = sum(t.numel() * t.element_size() for t in tensors)
    return now, sum(t.numel() * 4 for t in tensors)
