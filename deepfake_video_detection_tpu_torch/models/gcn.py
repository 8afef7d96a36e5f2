"""Frame-graph (ViT + GCN) detector as an ``nn.Module``.

Counterpart of ``deepfake_video_detection_tpu/models/gcn.py``: frames are
the nodes of a graph; a ViT embeds each frame (its CLS feature), a
projection brings the embedding to ``vit_out`` where the ViT is narrower, a
2-layer spectral GCN (``H' = ReLU(fc(A_norm @ H))``) passes messages over
the pre-normalised frame graph (``utils/graph.py``), then a mean pool and
an MLP classify. Parameter names are the JAX tree's: ``vit.*`` (timm's),
``vit_proj``, ``gcn.fc1``, ``gcn.fc2``, ``classifier.0``, ``classifier.3``.

As in the JAX model, ``A_norm`` is cast to the activations' dtype before
its product (bf16 when serving on the card, summed in f32 by the matmul),
and dropout draws only when ``train`` and a generator is given. Every
block's attention runs the flash kernels on the card. ``backbone``
``"clip"`` or ``"dinov2"`` takes the ViT of ``models/feature_extractors.py``'s
wrapper (``.vit``, not the wrapper: the trainer normalises the frames once,
with the CLIP statistics for ``clip``); the flavour picks that
normalisation and the key layout of the HF importer, and the encoder and
its weights are the ``timm`` flavour's.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from deepfake_video_detection_tpu_torch.models.feature_extractors import build_feature_extractor
from deepfake_video_detection_tpu_torch.nn import init as I
from deepfake_video_detection_tpu_torch.nn import layers as L
from deepfake_video_detection_tpu_torch.utils.device import resolve_device


class SimpleGCN(nn.Module):
    """2-layer message passing: fc(A@H) → ReLU → dropout → fc → ReLU."""

    def __init__(self, in_dim: int, hid_dim: int = 256, out_dim: int = 128,
                 dropout: float = 0.3, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator or torch.Generator().manual_seed(0)
        self.in_dim, self.hid_dim, self.out_dim = in_dim, hid_dim, out_dim
        self.dropout = dropout
        self.fc1 = I.default_linear(in_dim, hid_dim, g, device)
        self.fc2 = I.default_linear(hid_dim, out_dim, g, device)

    def forward(self, H: torch.Tensor, A_norm: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``H``: (B, N, F); ``A_norm``: (B, N, N)."""
        H = torch.matmul(A_norm.to(H.dtype), H)
        H = torch.relu(L.linear(H, self.fc1.weight, self.fc1.bias))
        H = L.dropout(H, self.dropout, train and generator is not None, generator)
        return torch.relu(L.linear(H, self.fc2.weight, self.fc2.bias))


class FrameGraphDetector(nn.Module):
    def __init__(self, vit_out: int = 768, gcn_hid: int = 256, gcn_out: int = 128,
                 num_classes: int = 2, vit_variant: str = "vit_base_patch16_224",
                 img_size: int = 224, compute_dtype: torch.dtype = torch.float32,
                 backbone: str = "timm", device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator or torch.Generator().manual_seed(0)
        dev = resolve_device(device)
        self.vit_out = vit_out
        self.gcn_out = gcn_out
        self.num_classes = num_classes
        self.vit_variant = vit_variant
        self.backbone_flavor = backbone
        self.compute_dtype = compute_dtype
        # every flavour's encoder is the same ViT, drawn the same way
        self.vit = build_feature_extractor(backbone, vit_variant, img_size,
                                           compute_dtype, dev, g).vit
        self.needs_proj = self.vit.feature_dim != vit_out
        if self.needs_proj:
            self.vit_proj = I.default_linear(self.vit.feature_dim, vit_out, g, dev)
        self.gcn = SimpleGCN(vit_out, gcn_hid, gcn_out, device=dev, generator=g)
        self.classifier = nn.ModuleDict({"0": I.default_linear(gcn_out, 64, g, dev),
                                         "3": I.default_linear(64, num_classes, g, dev)})

    def forward(self, images: torch.Tensor, A_norm: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``images``: (B, N, H, W, C) normalised frames; ``A_norm``:
        (B, N, N) pre-normalised. Returns logits (B, num_classes), f32."""
        B, N = images.shape[0], images.shape[1]
        feats = self.vit(images.reshape((B * N,) + tuple(images.shape[2:])))
        if self.needs_proj:
            feats = L.linear(feats, self.vit_proj.weight, self.vit_proj.bias)
        feats = feats.reshape(B, N, self.vit_out)
        pooled = self.gcn(feats, A_norm, train, generator).mean(dim=1)
        c0, c3 = self.classifier["0"], self.classifier["3"]
        h = torch.relu(L.linear(pooled, c0.weight, c0.bias))
        h = L.dropout(h, 0.3, train and generator is not None, generator)
        return L.linear(h, c3.weight, c3.bias).to(torch.float32)
