"""ResNet-18/34/50 as an ``nn.Module``.

Counterpart of ``deepfake_video_detection_tpu/models/resnet.py``: torchvision's
``state_dict`` key names (``conv1``, ``bn1``, ``layer{1-4}.<i>.{conv1-3,
bn1-3, downsample.0, downsample.1}``), the v1.5 bottleneck (the stride on
the 3×3 conv), the JAX package's init distributions. NHWC in, ``(N, 512)``
or ``(N, 2048)`` pooled features out in the compute dtype; f32 parameters,
batch norm as in ``models/efficientnet.py``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
from torch.nn.utils import skip_init

from deepfake_video_detection_tpu_torch.models.efficientnet import BatchNorm, conv
from deepfake_video_detection_tpu_torch.nn import init as I
from deepfake_video_detection_tpu_torch.nn import layers as L
from deepfake_video_detection_tpu_torch.utils.device import resolve_device

SPECS = {
    # block type, blocks per stage, expansion, feature dim
    "resnet18": ("basic", (2, 2, 2, 2), 1, 512),
    "resnet34": ("basic", (3, 4, 6, 3), 1, 512),
    "resnet50": ("bottleneck", (3, 4, 6, 3), 4, 2048),
}


class ResBlock(nn.Module):
    def __init__(self, kind: str, in_ch: int, width: int, expansion: int,
                 stride: int, g: torch.Generator, device):
        super().__init__()
        self.kind, self.stride = kind, stride
        out_ch = width * expansion
        if kind == "basic":
            self.conv1 = conv(in_ch, width, 3, g, device)
            self.bn1 = BatchNorm(width, device)
            self.conv2 = conv(width, width, 3, g, device)
            self.bn2 = BatchNorm(width, device)
        else:
            self.conv1 = conv(in_ch, width, 1, g, device)
            self.bn1 = BatchNorm(width, device)
            self.conv2 = conv(width, width, 3, g, device)
            self.bn2 = BatchNorm(width, device)
            self.conv3 = conv(width, out_ch, 1, g, device)
            self.bn3 = BatchNorm(out_ch, device)
        if stride != 1 or in_ch != out_ch:
            self.downsample = nn.Sequential(conv(in_ch, out_ch, 1, g, device),
                                            BatchNorm(out_ch, device))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if self.kind == "basic":
            y = torch.relu(self.bn1(L.conv2d(x, self.conv1.weight, stride=self.stride,
                                             padding=1), train))
            y = self.bn2(L.conv2d(y, self.conv2.weight, padding=1), train)
        else:
            y = torch.relu(self.bn1(L.conv2d(x, self.conv1.weight), train))
            y = torch.relu(self.bn2(L.conv2d(y, self.conv2.weight, stride=self.stride,
                                             padding=1), train))
            y = self.bn3(L.conv2d(y, self.conv3.weight), train)
        if hasattr(self, "downsample"):
            ds_conv, ds_bn = self.downsample
            x = ds_bn(L.conv2d(x, ds_conv.weight, stride=self.stride), train)
        return torch.relu(y + x)


class ResNet(nn.Module):
    def __init__(self, variant: str = "resnet18", num_classes: int = 0,
                 compute_dtype: torch.dtype = torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator or torch.Generator().manual_seed(0)
        dev = resolve_device(device)
        self.variant, self.num_classes = variant, num_classes
        self.compute_dtype = compute_dtype
        kind, sizes, expansion, self.feature_dim = SPECS[variant]
        self.conv1 = conv(3, 64, 7, g, dev)
        self.bn1 = BatchNorm(64, dev)
        in_ch = 64
        for li, n_blocks in enumerate(sizes):
            width = 64 * 2 ** li
            blocks = []
            for bi in range(n_blocks):
                stride = 2 if li > 0 and bi == 0 else 1
                blocks.append(ResBlock(kind, in_ch, width, expansion, stride, g, dev))
                in_ch = width * expansion
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))
        if num_classes > 0:
            self.fc = skip_init(nn.Linear, self.feature_dim, num_classes,
                                device=dev, dtype=torch.float32)
            with torch.no_grad():
                self.fc.weight.copy_(I.kaiming_uniform(self.fc.weight.shape, g))
                self.fc.bias.zero_()

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x.to(self.compute_dtype)
        x = torch.relu(self.bn1(L.conv2d(x, self.conv1.weight, stride=2, padding=3),
                                train))
        x = L.max_pool2d(x, 3, 2, 1)
        for li in range(1, 5):
            for block in getattr(self, f"layer{li}"):
                x = block(x, train)
        feats = L.global_avg_pool(x)
        if self.num_classes > 0:
            feats = L.linear(feats, self.fc.weight, self.fc.bias)
        return feats
