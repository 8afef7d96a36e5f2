"""ViT-patch-graph classifier as ``nn.Module``s.

Counterpart of ``deepfake_video_detection_tpu/models/vit_gnn.py``: the
patch tokens of one image (``ViTEncoder``: the ViT's post-norm tokens
without CLS) are the nodes of a fully connected graph, a 2-layer GNN
(``SimpleGNN``: ``ReLU(fc(A_norm @ H))`` twice, then a global mean pool)
passes messages over its normalised adjacency, and a linear head
classifies. ``FallbackModel`` is the small conv net used where no ViT is
wanted. Parameter names are the JAX tree's: ``vit.*``, ``gnn.conv1``,
``gnn.conv2``, ``head`` (the fallback: ``conv1``, ``conv2``, ``head``).

The adjacency is a non-persistent buffer (it is not in the state dict, as
it is not in the JAX tree), cast to the activations' dtype before each
product. Every block's attention runs the flash kernels on the card.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from deepfake_video_detection_tpu_torch.models.vit import VisionTransformer
from deepfake_video_detection_tpu_torch.nn import init as I
from deepfake_video_detection_tpu_torch.nn import layers as L
from deepfake_video_detection_tpu_torch.utils.device import resolve_device
from deepfake_video_detection_tpu_torch.utils.graph import (
    fully_connected_adjacency, normalize_adjacency)


class ViTEncoder(nn.Module):
    """A ViT (``vit.*``) returning patch tokens (B, N, C)."""

    def __init__(self, variant: str = "vit_small_patch16_224", img_size: int = 224,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.vit = VisionTransformer(variant=variant, img_size=img_size,
                                     num_classes=0, device=device, generator=generator)
        self.feature_dim = self.vit.feature_dim
        self.num_patches = self.vit.num_patches

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.vit(x, return_tokens=True)


class SimpleGNN(nn.Module):
    """2 message-passing layers + global mean pool."""

    def __init__(self, in_channels: int, hidden: int = 128, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator or torch.Generator().manual_seed(0)
        self.conv1 = I.default_linear(in_channels, hidden, g, device)
        self.conv2 = I.default_linear(hidden, hidden, g, device)

    def forward(self, x: torch.Tensor, A_norm: torch.Tensor) -> torch.Tensor:
        """``x`` (B, N, C), ``A_norm`` (B, N, N) or (N, N)."""
        A = A_norm.to(x.dtype)
        h = torch.relu(L.linear(torch.matmul(A, x), self.conv1.weight, self.conv1.bias))
        h = torch.relu(L.linear(torch.matmul(A, h), self.conv2.weight, self.conv2.bias))
        return h.mean(dim=1)


class ViTGNNModel(ViTEncoder):
    """Patches of each image as graph nodes over a fully connected,
    normalised adjacency. It extends the encoder rather than holding one,
    so that the ViT's parameters sit at ``vit.*``, where the JAX tree keeps
    them."""

    def __init__(self, vit_variant: str = "vit_small_patch16_224",
                 gnn_hidden: int = 128, out_classes: int = 2, img_size: int = 224,
                 device=None, generator: Optional[torch.Generator] = None):
        g = generator or torch.Generator().manual_seed(0)
        dev = resolve_device(device)
        super().__init__(vit_variant, img_size, dev, g)
        self.out_classes = out_classes
        self.gnn_hidden = gnn_hidden
        self.gnn = SimpleGNN(self.feature_dim, gnn_hidden, device=dev, generator=g)
        self.head = I.default_linear(gnn_hidden, out_classes, g, dev)
        A = normalize_adjacency(fully_connected_adjacency(self.num_patches))
        self.register_buffer("A_norm", A.to(dev), persistent=False)

    def forward(self, images: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``images``: (B, H, W, 3). Returns logits (B, out_classes), f32."""
        pooled = self.gnn(super().forward(images), self.A_norm[None])
        return L.linear(pooled, self.head.weight, self.head.bias).to(torch.float32)


class FallbackModel(nn.Module):
    """Two 3×3 stride-2 convs with bias, ReLU, global average pool, linear
    head."""

    def __init__(self, out_classes: int = 2, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator or torch.Generator().manual_seed(0)
        dev = resolve_device(device)
        self.out_classes = out_classes
        for name, cin, cout in (("conv1", 3, 16), ("conv2", 16, 32)):
            conv = torch.nn.utils.skip_init(nn.Conv2d, cin, cout, 3, device=dev,
                                            dtype=torch.float32)
            with torch.no_grad():
                conv.weight.copy_(I.kaiming_uniform((cout, cin, 3, 3), g))
                conv.bias.zero_()
            setattr(self, name, conv)
        self.head = I.default_linear(32, out_classes, g, dev)

    def forward(self, images: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = images.to(torch.float32)
        x = torch.relu(L.conv2d(x, self.conv1.weight, self.conv1.bias, 2, 1))
        x = torch.relu(L.conv2d(x, self.conv2.weight, self.conv2.bias, 2, 1))
        return L.linear(L.global_avg_pool(x), self.head.weight, self.head.bias
                        ).to(torch.float32)
