"""Weights from the seed, made on the device in two draws: one normal draw
for every parameter, one uniform draw for every batch-norm statistic, each
leaf a scaled slice of them. The benchmark hands the same state dict to the
program and, made again from the seed, to the reference.

Rules (the configuration files list them under ``assumed``): a matrix or
convolution weight N(0, 1/fan_in); a norm's scale 1 + N(0, 0.1); a bias, a
token or a position embedding N(0, 0.02); batch norm's running means and
variances U(0.5, 1.5), so that eval-mode batch norm does work.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch

Shapes = Sequence[Tuple[str, Tuple[int, ...]]]


def _rule(name: str, shape: Tuple[int, ...]) -> Tuple[float, float]:
    """(mean, std) of one parameter."""
    if name.endswith("weight") and len(shape) >= 2:
        return 0.0, 1.0 / math.sqrt(math.prod(shape[1:]))
    if name.endswith("weight"):
        return 1.0, 0.1
    return 0.0, 0.02


def make_state(params: Shapes, buffers: Shapes, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter and buffer, float32 on ``device``, from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out: Dict[str, torch.Tensor] = {}
    flat = torch.randn(sum(math.prod(s) for _, s in params), generator=gen, device=device)
    off = 0
    for name, shape in params:
        n = math.prod(shape)
        mean, std = _rule(name, shape)
        out[name] = flat[off:off + n].view(shape).mul(std).add_(mean)
        off += n
    if buffers:
        flat = torch.rand(sum(math.prod(s) for _, s in buffers), generator=gen, device=device)
        off = 0
        for name, shape in buffers:
            n = math.prod(shape)
            out[name] = flat[off:off + n].view(shape).add(0.5)
            off += n
    return out
