"""EfficientNet b0-b4 as an ``nn.Module``.

Counterpart of ``deepfake_video_detection_tpu/models/efficientnet.py``: the
same stage table and channel rounding, the same parameter names (timm's
``state_dict`` keys: ``conv_stem``, ``bn1``, ``blocks.<stage>.<block>.
{conv_dw, conv_pw, conv_pwl, bn1-3, se.conv_reduce, se.conv_expand}``,
``conv_head``, ``bn2``), the same init distributions on a
``torch.Generator``. NHWC in, ``(N, head_ch)`` pooled features out (or
logits with ``num_classes`` > 0), in the compute dtype. Parameters are f32;
each op casts them to the activations' dtype.

Batch norm keeps the JAX tree's names and nothing else: ``weight`` and
``bias`` parameters, ``running_mean`` and ``running_var`` buffers, no
``num_batches_tracked``, so a JAX tree crosses through
``checkpoint.bridge.state_dict_from_jax`` into ``load_state_dict(strict=True)``.
In training the running stats are updated in place, once a forward
(not again when ``torch.utils.checkpoint`` recomputes it:
``nn.layers.frozen_running_stats``). Drop-path draws from the
generator passed to ``forward``; its rate grows linearly over the blocks.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.nn.utils import skip_init

from deepfake_video_detection_tpu_torch.nn import init as I
from deepfake_video_detection_tpu_torch.nn import layers as L
from deepfake_video_detection_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True)
class BlockSpec:
    kind: str          # 'ds' (depthwise-separable) or 'ir' (inverted residual)
    in_ch: int
    out_ch: int
    kernel: int
    stride: int
    expand: int
    se_ratio: float = 0.25


# EfficientNet-B0 stage table: (kind, out_ch, repeats, stride, kernel, expand)
_B0_STAGES = [
    ("ds", 16, 1, 1, 3, 1),
    ("ir", 24, 2, 2, 3, 6),
    ("ir", 40, 2, 2, 5, 6),
    ("ir", 80, 3, 2, 3, 6),
    ("ir", 112, 3, 1, 5, 6),
    ("ir", 192, 4, 2, 5, 6),
    ("ir", 320, 1, 1, 3, 6),
]

_VARIANTS = {
    # width_mult, depth_mult, head feature dim
    "b0": (1.0, 1.0, 1280),
    "b1": (1.0, 1.1, 1280),
    "b2": (1.1, 1.2, 1408),
    "b3": (1.2, 1.4, 1536),
    "b4": (1.4, 1.8, 1792),
}


def _round_channels(ch: float, multiplier: float, divisor: int = 8) -> int:
    """EfficientNet channel rounding (multiples of 8, never below 90 %)."""
    ch *= multiplier
    new_ch = max(divisor, int(ch + divisor / 2) // divisor * divisor)
    if new_ch < 0.9 * ch:
        new_ch += divisor
    return int(new_ch)


def build_specs(variant: str) -> Tuple[int, List[List[BlockSpec]], int]:
    """``(stem channels, stages of block specs, head channels)``."""
    width, depth, head_ch = _VARIANTS[variant]
    stem_ch = _round_channels(32, width)
    stages: List[List[BlockSpec]] = []
    in_ch = stem_ch
    for kind, out, repeats, stride, kernel, expand in _B0_STAGES:
        out_ch = _round_channels(out, width)
        blocks = []
        for j in range(int(math.ceil(repeats * depth))):
            blocks.append(BlockSpec(kind, in_ch, out_ch, kernel,
                                    stride if j == 0 else 1, expand))
            in_ch = out_ch
        stages.append(blocks)
    return stem_ch, stages, head_ch


class BatchNorm(nn.Module):
    """BN parameters and running stats under the JAX tree's names; the
    arithmetic is ``nn.layers.batch_norm``. NHWC."""

    def __init__(self, ch: int, device, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(ch, device=device))
        self.bias = nn.Parameter(torch.zeros(ch, device=device))
        self.register_buffer("running_mean", torch.zeros(ch, device=device))
        self.register_buffer("running_var", torch.ones(ch, device=device))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y, (mean, var) = L.batch_norm(x, self.weight, self.bias, self.running_mean,
                                      self.running_var, train, self.eps, self.momentum)
        if train and not L.running_stats_frozen():
            with torch.no_grad():
                self.running_mean.copy_(mean)
                self.running_var.copy_(var)
        return y


def conv(cin: int, cout: int, k: int, g: torch.Generator, device,
         groups: int = 1, bias: bool = False) -> nn.Conv2d:
    """An ``nn.Conv2d`` holder (OIHW weight, f32) with the JAX init:
    kaiming_normal fan_out weights, zero bias."""
    c = skip_init(nn.Conv2d, cin, cout, k, groups=groups, bias=bias,
                  device=device, dtype=torch.float32)
    with torch.no_grad():
        c.weight.copy_(I.kaiming_normal(c.weight.shape, g))
        if bias:
            c.bias.zero_()
    return c


class SqueezeExcite(nn.Module):
    def __init__(self, ch: int, rd: int, g: torch.Generator, device):
        super().__init__()
        self.conv_reduce = conv(ch, rd, 1, g, device, bias=True)
        self.conv_expand = conv(rd, ch, 1, g, device, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Global pool (the mean in f32) → reduce, SiLU → expand, sigmoid gate."""
        pooled = x.mean(dim=(1, 2), keepdim=True, dtype=torch.float32).to(x.dtype)
        s = F.silu(L.conv2d(pooled, self.conv_reduce.weight, self.conv_reduce.bias))
        s = L.conv2d(s, self.conv_expand.weight, self.conv_expand.bias)
        return x * torch.sigmoid(s)


class MBBlock(nn.Module):
    """A depthwise-separable ('ds') or inverted-residual ('ir') block."""

    def __init__(self, spec: BlockSpec, g: torch.Generator, device, eps: float,
                 momentum: float):
        super().__init__()
        self.spec = spec
        mid = spec.in_ch * spec.expand
        rd = max(1, int(spec.in_ch * spec.se_ratio))
        bn = lambda ch: BatchNorm(ch, device, eps, momentum)  # noqa: E731
        if spec.kind == "ds":
            self.conv_dw = conv(spec.in_ch, spec.in_ch, spec.kernel, g, device,
                                groups=spec.in_ch)
            self.bn1 = bn(spec.in_ch)
            self.se = SqueezeExcite(spec.in_ch, rd, g, device)
            self.conv_pw = conv(spec.in_ch, spec.out_ch, 1, g, device)
            self.bn2 = bn(spec.out_ch)
        else:
            self.conv_pw = conv(spec.in_ch, mid, 1, g, device)
            self.bn1 = bn(mid)
            self.conv_dw = conv(mid, mid, spec.kernel, g, device, groups=mid)
            self.bn2 = bn(mid)
            self.se = SqueezeExcite(mid, rd, g, device)
            self.conv_pwl = conv(mid, spec.out_ch, 1, g, device)
            self.bn3 = bn(spec.out_ch)

    def forward(self, x: torch.Tensor, train: bool, dp_rate: float,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        s = self.spec
        pad = s.kernel // 2
        if s.kind == "ds":
            y = L.conv2d(x, self.conv_dw.weight, stride=s.stride, padding=pad,
                         groups=s.in_ch)
            y = self.se(F.silu(self.bn1(y, train)))
            y = self.bn2(L.conv2d(y, self.conv_pw.weight), train)
        else:
            y = F.silu(self.bn1(L.conv2d(x, self.conv_pw.weight), train))
            y = L.conv2d(y, self.conv_dw.weight, stride=s.stride, padding=pad,
                         groups=self.conv_dw.weight.shape[0])
            y = self.se(F.silu(self.bn2(y, train)))
            y = self.bn3(L.conv2d(y, self.conv_pwl.weight), train)
        if s.stride == 1 and s.in_ch == s.out_ch:
            y = L.drop_path(y, dp_rate, train, generator) + x
        return y


class EfficientNet(nn.Module):
    """``num_classes=0`` → pooled features (``feature_dim`` = head channels)."""

    def __init__(self, variant: str = "b0", num_classes: int = 0,
                 bn_eps: float = 1e-5, bn_momentum: float = 0.1,
                 drop_path_rate: float = 0.2,
                 compute_dtype: torch.dtype = torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator or torch.Generator().manual_seed(0)
        dev = resolve_device(device)
        self.variant, self.num_classes = variant, num_classes
        self.drop_path_rate = drop_path_rate
        self.compute_dtype = compute_dtype
        self.stem_ch, stages, self.head_ch = build_specs(variant)
        self.feature_dim = self.head_ch
        self.num_blocks = sum(len(s) for s in stages)
        self.conv_stem = conv(3, self.stem_ch, 3, g, dev)
        self.bn1 = BatchNorm(self.stem_ch, dev, bn_eps, bn_momentum)
        self.blocks = nn.ModuleList(
            nn.ModuleList(MBBlock(spec, g, dev, bn_eps, bn_momentum) for spec in stage)
            for stage in stages)
        self.conv_head = conv(stages[-1][-1].out_ch, self.head_ch, 1, g, dev)
        self.bn2 = BatchNorm(self.head_ch, dev, bn_eps, bn_momentum)
        # tensor parallelism (BackboneDetector.tensor_parallel): this rank's
        # (group, rank, size); conv_head computes its slice of the channels
        self.head_split = None
        if num_classes > 0:
            self.classifier = skip_init(nn.Linear, self.head_ch, num_classes,
                                        device=dev, dtype=torch.float32)
            with torch.no_grad():
                self.classifier.weight.copy_(I.kaiming_uniform(
                    self.classifier.weight.shape, g))
                self.classifier.bias.zero_()

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x.to(self.compute_dtype)
        x = F.silu(self.bn1(L.conv2d(x, self.conv_stem.weight, stride=2, padding=1),
                            train))
        i = 0
        for stage in self.blocks:
            for block in stage:
                dp = self.drop_path_rate * i / max(self.num_blocks - 1, 1)
                x = block(x, train, dp, generator)
                i += 1
        if self.head_split is not None:
            x = self._head_slice(x, train)
        else:
            x = F.silu(self.bn2(L.conv2d(x, self.conv_head.weight), train))
        feats = L.global_avg_pool(x)
        if self.num_classes > 0:
            feats = L.linear(feats, self.classifier.weight, self.classifier.bias)
        return feats

    def _head_slice(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        """conv_head → bn2 → SiLU on this rank's slice of the output
        channels; bn2's running stats of every slice are gathered over the
        group so each rank keeps them whole."""
        from deepfake_video_detection_tpu_torch.parallel.mesh import all_gather

        group, rank, size = self.head_split
        per = self.head_ch // size
        sl = slice(rank * per, (rank + 1) * per)
        bn = self.bn2
        y, (mean, var) = L.batch_norm(
            L.conv2d(x, self.conv_head.weight[sl]), bn.weight[sl], bn.bias[sl],
            bn.running_mean[sl], bn.running_var[sl], train, bn.eps, bn.momentum)
        if train and not L.running_stats_frozen():
            with torch.no_grad():
                for buf, part in ((bn.running_mean, mean), (bn.running_var, var)):
                    buf.copy_(all_gather(part, group))
        return F.silu(y)
