"""Per-frame backbone + temporal-attention detector, and its ensemble, as
``nn.Module``s.

Counterpart of ``deepfake_video_detection_tpu/models/backbone_detector.py``
(``TinyConvBackbone``, ``build_backbone``, ``BackboneDetector``,
``EnsembleDetector``):
per-frame backbone features →
temporal attention MLP (feat→64→1, sigmoid, softmax over T) →
attention-weighted pooling → dropout + fc(feat→256→num_classes). Input
``(B, T, H, W, C)`` of normalised frames; returns ``(logits (B, C) f32,
frame_scores (B, T))``. The backbone runs over the flattened ``B·T`` frames.
Parameters are f32 and ``compute_dtype`` is the activations' dtype, as in
the ViT; the model lives on ``device``, the card unless the caller names
another. ``train=True`` applies dropout with draws from the generator the
caller passes (its numbers differ from ``jax.random``'s).

Backbones: EfficientNet b0-b4, ResNet-18/34/50, the ViTs and the JAX
package's ``tinyconv`` stub (two convs, the backbone of its cheap long-clip
tests). Every backbone takes ``(x, train, generator)``: batch norm and
drop-path read them, the ViT and tinyconv ignore them.

``EnsembleDetector`` runs its members (``models.<i>.…``) one after another
and combines their logits by ``average``, ``weighted`` (a softmax over the
learnt ``weights``) or ``voting`` (the one-hot majority class). The JAX
package ``vmap``s members of one architecture to hand XLA one program; here
a loop is the same computation.

``BackboneDetector.trainable_mask`` is the progressive fine-tuner's freeze
mask (``train/progressive.py``), keyed by parameter name.

``BackboneDetector.tensor_parallel`` is the JAX plan's ``--mesh model=N``
(``parallel/strategy.py::tp_param_pspec``: ``fc1.weight`` on its input
features, ``conv_head.weight`` on its output channels). Each rank of the
mesh's ``model`` axis computes its slice of the F features (conv_head's
output channels, bn2 and SiLU per channel; a backbone without conv_head
slices its features), and the two layers that contract over F, the
temporal attention's ``ta0`` and ``fc1``, sum their partial products over
the axis with one autograd-aware all-reduce each: where GSPMD puts the
collectives for JAX. The dropout on the pooled features draws the whole
(B, F) mask and takes its slice, as one device would.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
from torch.nn.utils import skip_init

from deepfake_video_detection_tpu_torch.models.efficientnet import EfficientNet
from deepfake_video_detection_tpu_torch.models.resnet import ResNet
from deepfake_video_detection_tpu_torch.models.vit import _VARIANTS, VisionTransformer
from deepfake_video_detection_tpu_torch.nn import init as I
from deepfake_video_detection_tpu_torch.nn import layers as L
from deepfake_video_detection_tpu_torch.utils.device import resolve_device


class TinyConvBackbone(nn.Module):
    """Two 3×3 stride-2 convs (no bias) with ReLU, then a global average
    pool: the JAX package's stub backbone, ``feature_dim`` 32. NHWC in,
    ``(N, 32)`` out in the compute dtype."""

    feature_dim = 32

    def __init__(self, compute_dtype: torch.dtype = torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator or torch.Generator().manual_seed(0)
        self.compute_dtype = compute_dtype
        kw = {"device": resolve_device(device), "dtype": torch.float32,
              "bias": False}
        self.conv1 = skip_init(nn.Conv2d, 3, 16, 3, **kw)
        self.conv2 = skip_init(nn.Conv2d, 16, self.feature_dim, 3, **kw)
        with torch.no_grad():
            for conv in (self.conv1, self.conv2):
                conv.weight.copy_(I.kaiming_normal(conv.weight.shape, g))

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x.to(self.compute_dtype)
        x = torch.relu(L.conv2d(x, self.conv1.weight, stride=2, padding=1))
        x = torch.relu(L.conv2d(x, self.conv2.weight, stride=2, padding=1))
        return L.global_avg_pool(x)


def build_backbone(name: str, compute_dtype: torch.dtype = torch.float32,
                   device=None, generator: Optional[torch.Generator] = None
                   ) -> nn.Module:
    """Backbone factory with the JAX package's name dispatch."""
    name = name.lower()
    kw = {"compute_dtype": compute_dtype, "device": device, "generator": generator}
    if name == "tinyconv":
        return TinyConvBackbone(compute_dtype, device, generator)
    if name.startswith("resnet"):
        return ResNet(variant=name, **kw)
    if name.startswith("efficientnet"):
        return EfficientNet(variant=name.split("_")[-1] if "_" in name else "b0", **kw)
    if name.startswith("vit"):
        variant = name if name in _VARIANTS else "vit_base_patch16_224"
        return VisionTransformer(variant=variant, **kw)
    raise ValueError(f"Unsupported backbone: {name}")


class BackboneDetector(nn.Module):
    def __init__(self, backbone_name: str = "efficientnet_b0",
                 num_classes: int = 2, dropout_rate: float = 0.5,
                 use_temporal_attention: bool = True,
                 compute_dtype: torch.dtype = torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator or torch.Generator().manual_seed(0)
        self.backbone_name = backbone_name
        self.num_classes = num_classes
        self.dropout_rate = dropout_rate
        self.use_temporal_attention = use_temporal_attention
        self.compute_dtype = compute_dtype
        self.backbone = build_backbone(backbone_name, compute_dtype, device, g)
        self.feature_dim = F = self.backbone.feature_dim
        kw = {"device": resolve_device(device), "dtype": torch.float32}
        if use_temporal_attention:
            self.temporal_attention = nn.Sequential(
                skip_init(nn.Linear, F, 64, **kw), nn.ReLU(),
                skip_init(nn.Linear, 64, 1, **kw))
        self.fc1 = skip_init(nn.Linear, F, 256, **kw)
        self.fc2 = skip_init(nn.Linear, 256, num_classes, **kw)
        self._init_head(g)
        self.tp = None

    def tensor_parallel(self, mesh, axis: str = "model") -> None:
        """Compute this rank's slice of the features over ``axis`` of
        ``mesh`` (a ``DeviceMesh``) from now on."""
        from deepfake_video_detection_tpu_torch.parallel.mesh import axis_group, axis_rank, axis_size

        size = axis_size(mesh, axis)
        if self.feature_dim % size:
            raise ValueError(f"{self.feature_dim} features do not split over {axis}={size}")
        self.tp = (axis_group(mesh, axis), axis_rank(mesh, axis), size)
        if hasattr(self.backbone, "head_split"):
            self.backbone.head_split = self.tp

    @torch.no_grad()
    def _init_head(self, g: torch.Generator) -> None:
        """The JAX ``init`` distributions for the head: torch defaults for
        the temporal MLP, kaiming_normal fan_out for fc1, N(0, 0.01) for fc2,
        zero head biases."""
        F = self.feature_dim
        if self.use_temporal_attention:
            ta0, ta2 = self.temporal_attention[0], self.temporal_attention[2]
            ta0.weight.copy_(I.kaiming_uniform((64, F), g))
            ta0.bias.copy_(I.uniform_bias((64,), F, g))
            ta2.weight.copy_(I.kaiming_uniform((1, 64), g))
            ta2.bias.copy_(I.uniform_bias((1,), 64, g))
        self.fc1.weight.copy_(I.kaiming_normal((256, F), g, mode="fan_out"))
        self.fc1.bias.copy_(I.zeros((256,)))
        self.fc2.weight.copy_(I.normal((self.num_classes, 256), g, std=0.01))
        self.fc2.bias.copy_(I.zeros((self.num_classes,)))

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``x``: (B, T, H, W, C) normalised frames. ``generator`` drives
        dropout when ``train`` (on x's device)."""
        B, T = x.shape[0], x.shape[1]
        feats = self.backbone(x.reshape((B * T,) + tuple(x.shape[2:])), train, generator)
        if self.tp is not None:
            return self._forward_tp(feats.reshape(B, T, -1), train, generator)
        feats = feats.reshape(B, T, self.feature_dim)
        if self.use_temporal_attention:
            ta0, ta2 = self.temporal_attention[0], self.temporal_attention[2]
            a = torch.relu(L.linear(feats, ta0.weight, ta0.bias))
            a = torch.sigmoid(L.linear(a, ta2.weight, ta2.bias))[..., 0]  # (B, T)
            attn = torch.softmax(a.to(torch.float32), dim=1).to(feats.dtype)
            frame_scores = attn
            pooled = torch.sum(feats * attn[..., None], dim=1)        # (B, F)
        else:
            pooled = feats.mean(dim=1)
            frame_scores = torch.full((B, T), 1.0 / T, dtype=feats.dtype,
                                      device=feats.device)
        h = L.dropout(pooled, self.dropout_rate, train, generator)
        h = torch.relu(L.linear(h, self.fc1.weight, self.fc1.bias))
        h = L.dropout(h, self.dropout_rate, train, generator)
        logits = L.linear(h, self.fc2.weight, self.fc2.bias).to(torch.float32)
        return logits, frame_scores

    def _forward_tp(self, feats: torch.Tensor, train: bool,
                    generator: Optional[torch.Generator]):
        """The head on this rank's feature slice ``feats`` (B, T, F/size),
        or on the whole F (then sliced here)."""
        from deepfake_video_detection_tpu_torch.parallel.mesh import all_reduce

        group, rank, size = self.tp
        per = self.feature_dim // size
        sl = slice(rank * per, (rank + 1) * per)
        if feats.shape[-1] == self.feature_dim:
            feats = feats[..., sl]
        B, T = feats.shape[:2]

        def contract(h, lin):     # h · W[:, slice]ᵀ summed over the ranks, + b
            part = L.linear(h, lin.weight[:, sl])
            return all_reduce(part, group) + lin.bias.to(part.dtype)

        if self.use_temporal_attention:
            ta0, ta2 = self.temporal_attention[0], self.temporal_attention[2]
            a = torch.relu(contract(feats, ta0))
            a = torch.sigmoid(L.linear(a, ta2.weight, ta2.bias))[..., 0]
            attn = torch.softmax(a.to(torch.float32), dim=1).to(feats.dtype)
            frame_scores = attn
            pooled = torch.sum(feats * attn[..., None], dim=1)
        else:
            pooled = feats.mean(dim=1)
            frame_scores = torch.full((B, T), 1.0 / T, dtype=feats.dtype,
                                      device=feats.device)
        if train and self.dropout_rate > 0.0:
            keep = 1.0 - self.dropout_rate
            mask = torch.rand((B, self.feature_dim), generator=generator,
                              device=pooled.device)[:, sl] < keep
            pooled = torch.where(mask, pooled / keep, torch.zeros_like(pooled))
        h = torch.relu(contract(pooled, self.fc1))
        h = L.dropout(h, self.dropout_rate, train, generator)
        logits = L.linear(h, self.fc2.weight, self.fc2.bias).to(torch.float32)
        return logits, frame_scores

    # -- fine-tuning support -------------------------------------------------

    def trainable_mask(self, freeze_backbone: bool = False,
                       unfreeze_blocks: int = 0) -> Dict[str, bool]:
        """Parameter name → trainable, the JAX pytree mask flattened to the
        port's names (what ``train/optim.py`` reads). The head is always
        trainable; ``unfreeze_blocks=N`` keeps the last N entries of
        ``backbone.blocks`` (sorted as ints: B0's stages, a ViT's blocks)
        trainable when the backbone is frozen, or for a ResNet the last N
        ``layer*`` (sorted by name); ``-1`` (or ``freeze_backbone=False``)
        makes everything trainable. Everything else in the backbone (B0's
        ``conv_head``/``bn2``, a ViT's ``norm``) stays frozen."""
        names = [n for n, _ in self.named_parameters()]
        if not freeze_backbone or unfreeze_blocks == -1:
            return {n: True for n in names}
        keep: Tuple[str, ...] = ()
        if unfreeze_blocks > 0:
            bb = self.backbone
            if isinstance(getattr(bb, "blocks", None), nn.Module):
                keys = sorted((k for k, _ in bb.blocks.named_children()), key=int)
                keep = tuple(f"backbone.blocks.{k}." for k in keys[-unfreeze_blocks:])
            else:
                keys = sorted(k for k, _ in bb.named_children() if k.startswith("layer"))
                keep = tuple(f"backbone.{k}." for k in keys[-unfreeze_blocks:])
        # the trailing dot: "blocks.1." never catches "blocks.10."
        return {n: not n.startswith("backbone.") or n.startswith(keep) for n in names}


class EnsembleDetector(nn.Module):
    def __init__(self, backbone_names: Sequence[str] = ("efficientnet_b0", "resnet18"),
                 num_classes: int = 2, dropout_rate: float = 0.5,
                 ensemble_method: str = "average",
                 compute_dtype: torch.dtype = torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if ensemble_method not in ("average", "weighted", "voting"):
            raise ValueError(f"Unknown ensemble method: {ensemble_method}")
        g = generator or torch.Generator().manual_seed(0)
        self.backbone_names = tuple(backbone_names)
        self.num_classes = num_classes
        self.ensemble_method = ensemble_method
        self.compute_dtype = compute_dtype
        self.models = nn.ModuleList(
            BackboneDetector(n, num_classes, dropout_rate, True, compute_dtype, device, g)
            for n in self.backbone_names)
        if ensemble_method == "weighted":
            n = len(self.backbone_names)
            self.weights = nn.Parameter(torch.full((n,), 1.0 / n,
                                                   device=resolve_device(device)))

    @property
    def members(self) -> nn.ModuleList:
        return self.models

    def tensor_parallel(self, mesh, axis: str = "model") -> None:
        """Every member's :meth:`BackboneDetector.tensor_parallel`."""
        for m in self.models:
            m.tensor_parallel(mesh, axis)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                return_member_logits: bool = False):
        """``(logits, frame_scores)``, and with ``return_member_logits`` the
        members' logits ``(M, B, C)`` as a third output."""
        outs = [m(x, train, generator) for m in self.models]
        logits = torch.stack([o[0] for o in outs])          # (M, B, C) f32
        scores = torch.stack([o[1] for o in outs])          # (M, B, T)
        if self.ensemble_method == "average":
            out_logits, out_scores = logits.mean(dim=0), scores.mean(dim=0)
        elif self.ensemble_method == "weighted":
            w = torch.softmax(self.weights, dim=0)
            out_logits = torch.sum(logits * w[:, None, None], dim=0)
            out_scores = torch.sum(scores * w[:, None, None].to(scores.dtype), dim=0)
        else:  # voting: the majority class, one-hot
            votes = torch.nn.functional.one_hot(logits.argmax(-1), self.num_classes)
            out_logits = torch.nn.functional.one_hot(
                votes.sum(dim=0).argmax(-1), self.num_classes).to(torch.float32)
            out_scores = scores.mean(dim=0)
        if return_member_logits:
            return out_logits, out_scores, logits
        return out_logits, out_scores
