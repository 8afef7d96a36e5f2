"""Parameter initialisers with PyTorch-default semantics, on a ``torch.Generator``.

Counterpart of ``deepfake_video_detection_tpu/nn/init.py``: the same
distributions (the JAX package reproduces torch's defaults). Values are drawn
on the generator's device in float32; a CPU generator gives the same weights
whatever device the model then lives on. Conv weights here are **OIHW**
(torch layout), where the JAX package keeps HWIO; the fans are the same.

Inside :func:`shapes_only` every draw is an empty tensor on the ``meta``
device: a model built there on ``device="meta"`` is a template of shapes
that costs neither memory nor random numbers (``serve/loader.py`` scores
checkpoints against such templates).
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Iterator, Sequence, Tuple, Union

import torch

Shape = Sequence[int]

_SHAPES_ONLY = contextvars.ContextVar("shapes_only", default=False)


@contextlib.contextmanager
def shapes_only() -> Iterator[None]:
    """Draw nothing: every initialiser returns an empty ``meta`` tensor."""
    token = _SHAPES_ONLY.set(True)
    try:
        yield
    finally:
        _SHAPES_ONLY.reset(token)


def _draw(fn, shape: Shape, generator: torch.Generator) -> torch.Tensor:
    if _SHAPES_ONLY.get():
        return torch.empty(tuple(shape), device="meta")
    return fn(tuple(shape), generator=generator, device=generator.device)


def _fans(shape: Shape) -> Tuple[int, int]:
    """(fan_in, fan_out) of an OIHW conv weight or an (out, in) linear one."""
    if len(shape) == 4:  # O, I, H, W
        rf = shape[2] * shape[3]
        return shape[1] * rf, shape[0] * rf
    if len(shape) == 2:  # (out, in)
        return shape[1], shape[0]
    raise ValueError(f"unsupported weight shape {tuple(shape)}")


def _uniform(shape: Shape, generator: torch.Generator, lo: float, hi: float
             ) -> torch.Tensor:
    return _draw(torch.rand, shape, generator) * (hi - lo) + lo


def kaiming_uniform(shape: Shape, generator: torch.Generator,
                    a: float = math.sqrt(5)) -> torch.Tensor:
    """torch's default conv/linear weight init."""
    fan_in, _ = _fans(shape)
    gain = math.sqrt(2.0 / (1 + a * a))
    bound = gain * math.sqrt(3.0 / fan_in)
    return _uniform(shape, generator, -bound, bound)


def kaiming_normal(shape: Shape, generator: torch.Generator,
                   mode: str = "fan_out") -> torch.Tensor:
    fan_in, fan_out = _fans(shape)
    std = math.sqrt(2.0 / (fan_out if mode == "fan_out" else fan_in))
    return std * _draw(torch.randn, shape, generator)


def uniform_bias(shape: Shape, fan_in: int, generator: torch.Generator
                 ) -> torch.Tensor:
    """torch's default bias init: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    return _uniform(shape, generator, -bound, bound)


def normal(shape: Shape, generator: torch.Generator, std: float = 0.01
           ) -> torch.Tensor:
    return std * _draw(torch.randn, shape, generator)


def trunc_normal(shape: Shape, generator: torch.Generator, std: float = 0.02
                 ) -> torch.Tensor:
    """``std`` × a standard normal truncated to [-2, 2] (inverse CDF)."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
    u = _uniform(shape, generator, lo, hi)
    x = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)
    return std * x.clamp(-2.0, 2.0)


def zeros(shape: Union[int, Shape]) -> torch.Tensor:
    return torch.zeros(shape)


def ones(shape: Union[int, Shape]) -> torch.Tensor:
    return torch.ones(shape)


def default_linear(d_in: int, d_out: int, generator: torch.Generator, device
                   ) -> torch.nn.Linear:
    """An f32 ``nn.Linear`` on ``device`` with torch's default init
    (kaiming_uniform weight, U(±1/sqrt(fan_in)) bias), drawn from
    ``generator``: the JAX legacy models' ``_lin_init``."""
    lin = torch.nn.utils.skip_init(torch.nn.Linear, d_in, d_out, device=device,
                                   dtype=torch.float32)
    with torch.no_grad():
        lin.weight.copy_(kaiming_uniform((d_out, d_in), generator))
        lin.bias.copy_(uniform_bias((d_out,), d_in, generator))
    return lin
