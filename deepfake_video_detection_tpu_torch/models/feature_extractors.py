"""Per-frame feature extractor wrappers (ViT / CLIP-vision / DINOv2 styles)
and the HF checkpoint key importers.

Counterpart of ``deepfake_video_detection_tpu/models/feature_extractors.py``.
Each wrapper runs the port's ``VisionTransformer`` (its weights are the
ViT's, at ``.vit``; no head) and differs only in its input normalisation
(``CLIPVisionFeatureExtractor``: the CLIP statistics; the others:
ImageNet's) and in the key layout its importer reads (timm, HF
``CLIPVisionModel``, HF ``Dinov2Model``). The features are the post-norm
CLS embedding in every flavour.

``import_hf_vision_state_dict`` rewrites an HF CLIP-vision or DINOv2 state
dict into timm-style keys, fusing the separate q/k/v projections into
``qkv``; the result is byte for byte the JAX importer's and loads into a
``VisionTransformer`` through ``checkpoint.torch_bridge.import_into_model``
(shape-filtered, non-strict). As in the reference, CLIP's ``pre_layrnorm``
and DINOv2's layer scale and mask token are dropped, and the ViT's MLP runs
exact GELU (CLIP runs quick-GELU), so an imported HF checkpoint does not
compute HF's features; a CLIP dict carries no patch-embedding bias, which
keeps its init value.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from deepfake_video_detection_tpu_torch.data.normalize import clip_normalize, imagenet_normalize
from deepfake_video_detection_tpu_torch.models.vit import VisionTransformer


class _VitWrapperBase(nn.Module):
    normalize = staticmethod(imagenet_normalize)
    use_cls = True

    def __init__(self, variant: str = "vit_base_patch16_224", img_size: int = 224,
                 compute_dtype: torch.dtype = torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.vit = VisionTransformer(variant=variant, img_size=img_size, num_classes=0,
                                     compute_dtype=compute_dtype, device=device,
                                     generator=generator)
        self.feature_dim = self.vit.feature_dim

    def forward(self, images_01: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``images_01``: (B, H, W, 3) float in [0, 1] (or uint8) → (B, D)."""
        x = self.normalize(images_01, scaled=images_01.is_floating_point())
        return self.vit(x, train, generator)


class ViTFeatureExtractor(_VitWrapperBase):
    """timm ViT: ImageNet normalisation, CLS features."""


class CLIPVisionFeatureExtractor(_VitWrapperBase):
    """CLIP vision tower: CLIP normalisation, CLS features."""

    normalize = staticmethod(clip_normalize)


class DINOv2VisionFeatureExtractor(_VitWrapperBase):
    """DINOv2: ImageNet normalisation, CLS token."""


# ---------------------------------------------------------------------------
# HF checkpoint key-layout importers → the ViT's (timm-style) keys
# ---------------------------------------------------------------------------

# HF CLIPVisionModel → timm-style key rewrites
_CLIP_MAP = [
    (r"^vision_model\.embeddings\.class_embedding$", "cls_token"),
    (r"^vision_model\.embeddings\.position_embedding\.weight$", "pos_embed"),
    (r"^vision_model\.embeddings\.patch_embedding\.weight$",
     "patch_embed.proj.weight"),
    (r"^vision_model\.post_layernorm\.(weight|bias)$", r"norm.\1"),
    (r"^vision_model\.encoder\.layers\.(\d+)\.layer_norm1\.(weight|bias)$",
     r"blocks.\1.norm1.\2"),
    (r"^vision_model\.encoder\.layers\.(\d+)\.layer_norm2\.(weight|bias)$",
     r"blocks.\1.norm2.\2"),
    (r"^vision_model\.encoder\.layers\.(\d+)\.mlp\.fc1\.(weight|bias)$",
     r"blocks.\1.mlp.fc1.\2"),
    (r"^vision_model\.encoder\.layers\.(\d+)\.mlp\.fc2\.(weight|bias)$",
     r"blocks.\1.mlp.fc2.\2"),
    (r"^vision_model\.encoder\.layers\.(\d+)\.self_attn\.out_proj\.(weight|bias)$",
     r"blocks.\1.attn.proj.\2"),
]

# HF Dinov2Model → timm-style
_DINO_MAP = [
    (r"^embeddings\.cls_token$", "cls_token"),
    (r"^embeddings\.position_embeddings$", "pos_embed"),
    (r"^embeddings\.patch_embeddings\.projection\.(weight|bias)$",
     r"patch_embed.proj.\1"),
    (r"^layernorm\.(weight|bias)$", r"norm.\1"),
    (r"^encoder\.layer\.(\d+)\.norm1\.(weight|bias)$", r"blocks.\1.norm1.\2"),
    (r"^encoder\.layer\.(\d+)\.norm2\.(weight|bias)$", r"blocks.\1.norm2.\2"),
    (r"^encoder\.layer\.(\d+)\.mlp\.fc1\.(weight|bias)$", r"blocks.\1.mlp.fc1.\2"),
    (r"^encoder\.layer\.(\d+)\.mlp\.fc2\.(weight|bias)$", r"blocks.\1.mlp.fc2.\2"),
    (r"^encoder\.layer\.(\d+)\.attention\.output\.dense\.(weight|bias)$",
     r"blocks.\1.attn.proj.\2"),
]

# where each flavour keeps its separate q/k/v projections
_QKV = {
    "clip": {
        "probe": r"^vision_model\.encoder\.layers\.(\d+)\.self_attn\.q_proj\.weight$",
        "q": "vision_model.encoder.layers.{i}.self_attn.q_proj",
        "k": "vision_model.encoder.layers.{i}.self_attn.k_proj",
        "v": "vision_model.encoder.layers.{i}.self_attn.v_proj",
    },
    "dinov2": {
        "probe": r"^encoder\.layer\.(\d+)\.attention\.attention\.query\.weight$",
        "q": "encoder.layer.{i}.attention.attention.query",
        "k": "encoder.layer.{i}.attention.attention.key",
        "v": "encoder.layer.{i}.attention.attention.value",
    },
}


def _apply_map(key: str, table) -> Optional[str]:
    for pat, repl in table:
        if re.match(pat, key):
            return re.sub(pat, repl, key)
    return None


def _merge_qkv(sd: Dict[str, np.ndarray], layer_fmt: Dict[str, str],
               out: Dict[str, np.ndarray]) -> None:
    """Fuse separate q/k/v projections into timm's fused ``qkv``; a layer
    missing one of the three weights is skipped, and the bias is fused only
    when all three biases are there."""
    layers = set()
    for k in sd:
        m = re.match(layer_fmt["probe"], k)
        if m:
            layers.add(int(m.group(1)))
    for i in sorted(layers):
        try:
            qw = sd[layer_fmt["q"].format(i=i) + ".weight"]
            kw = sd[layer_fmt["k"].format(i=i) + ".weight"]
            vw = sd[layer_fmt["v"].format(i=i) + ".weight"]
        except KeyError:
            continue
        out[f"blocks.{i}.attn.qkv.weight"] = np.concatenate([qw, kw, vw], 0)
        qb = sd.get(layer_fmt["q"].format(i=i) + ".bias")
        kb = sd.get(layer_fmt["k"].format(i=i) + ".bias")
        vb = sd.get(layer_fmt["v"].format(i=i) + ".bias")
        if qb is not None and kb is not None and vb is not None:
            out[f"blocks.{i}.attn.qkv.bias"] = np.concatenate([qb, kb, vb], 0)


def import_hf_vision_state_dict(sd: Dict[str, np.ndarray],
                                flavor: str) -> Dict[str, np.ndarray]:
    """Rewrite an HF CLIP-vision (``flavor="clip"``) or DINOv2 (any other
    flavour) state dict of numpy arrays into the ViT's timm-style keys."""
    table = _CLIP_MAP if flavor == "clip" else _DINO_MAP
    out: Dict[str, np.ndarray] = {}
    for k, v in sd.items():
        nk = _apply_map(k, table)
        if nk is not None:
            arr = np.asarray(v)
            if nk == "cls_token":
                arr = arr.reshape(1, 1, -1)
            if nk == "pos_embed" and arr.ndim == 2:
                arr = arr[None]
            out[nk] = arr
    _merge_qkv(sd, _QKV["clip" if flavor == "clip" else "dinov2"], out)
    return out


def build_feature_extractor(backbone: str = "timm", variant: str = "vit_base_patch16_224",
                            img_size: int = 224,
                            compute_dtype: torch.dtype = torch.float32, device=None,
                            generator: Optional[torch.Generator] = None) -> _VitWrapperBase:
    """``"timm"`` | ``"clip"`` | ``"dinov2"`` (any other name: timm)."""
    cls = {"clip": CLIPVisionFeatureExtractor,
           "dinov2": DINOv2VisionFeatureExtractor}.get(backbone, ViTFeatureExtractor)
    return cls(variant, img_size, compute_dtype, device, generator)
