"""Vision Transformer as an ``nn.Module``.

Counterpart of ``deepfake_video_detection_tpu/models/vit.py``, with the same
four ``_VARIANTS`` and timm's parameter names (``cls_token``, ``pos_embed``,
``patch_embed.proj``, ``blocks.N.attn.qkv`` …), so a JAX tree loads with
``load_state_dict(strict=True)`` after ``checkpoint.bridge``. Input is NHWC
``(B, H, W, 3)``; the output is the post-norm CLS embedding
(``num_classes=0``, the backbone mode), the head's logits, or with
``return_tokens`` the post-norm patch tokens (the ViT-GNN's graph nodes).

Parameters are f32, as in the JAX package; ``compute_dtype`` (bf16 on the
card) is the activations' dtype, and each op casts its weights to it
(``nn.layers``), so a bf16 model trains f32 weights. Every block's attention
runs the flash kernels on CUDA, forward and backward
(``nn.layers.multi_head_attention``). The model lives on ``device``, the
card unless the caller names another.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.nn.utils import skip_init

from deepfake_video_detection_tpu_torch.nn import init as I
from deepfake_video_detection_tpu_torch.nn import layers as L
from deepfake_video_detection_tpu_torch.utils.device import resolve_device

_VARIANTS = {
    # embed_dim, depth, heads, mlp_ratio
    "vit_tiny_patch16_224": (192, 12, 3, 4.0),
    "vit_small_patch16_224": (384, 12, 6, 4.0),
    "vit_base_patch16_224": (768, 12, 12, 4.0),
    "vit_large_patch16_224": (1024, 24, 16, 4.0),
}


def _linear(d_in: int, d_out: int, **kw) -> nn.Linear:
    return skip_init(nn.Linear, d_in, d_out, **kw)


def _norm(dim: int, **kw) -> nn.LayerNorm:
    return skip_init(nn.LayerNorm, dim, **kw)


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, dim: int, **kw):
        super().__init__()
        self.patch_size = patch_size
        self.proj = skip_init(nn.Conv2d, 3, dim, patch_size, stride=patch_size,
                              **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) → (B, N, D), tokens in row-major patch order."""
        y = L.conv2d(x, self.proj.weight, self.proj.bias, stride=self.patch_size)
        return y.reshape(y.shape[0], -1, y.shape[-1])


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, **kw):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = _linear(dim, 3 * dim, **kw)
        self.proj = _linear(dim, dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return L.multi_head_attention(x, self.qkv.weight, self.qkv.bias,
                                      self.proj.weight, self.proj.bias,
                                      self.num_heads)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, **kw):
        super().__init__()
        self.fc1 = _linear(dim, hidden, **kw)
        self.fc2 = _linear(hidden, dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.gelu(L.linear(x, self.fc1.weight, self.fc1.bias))
        return L.linear(h, self.fc2.weight, self.fc2.bias)


class Block(nn.Module):
    """Pre-norm transformer block: ``y + attn(LN(y))``, then
    ``y + fc2(gelu(fc1(LN(y))))`` (exact GELU). The temporal transformer
    reuses it with its own width, and passes its MoE feed-forward as
    ``mlp`` in place of the ``fc1``/``fc2`` pair."""

    def __init__(self, dim: int, num_heads: int, hidden: int, eps: float,
                 mlp: Optional[nn.Module] = None, **kw):
        super().__init__()
        self.eps = eps
        self.norm1 = _norm(dim, **kw)
        self.attn = Attention(dim, num_heads, **kw)
        self.norm2 = _norm(dim, **kw)
        self.mlp = mlp if mlp is not None else Mlp(dim, hidden, **kw)

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        y = y + self.attn(L.layer_norm(y, self.norm1.weight, self.norm1.bias,
                                       self.eps))
        return y + self.mlp(L.layer_norm(y, self.norm2.weight, self.norm2.bias,
                                         self.eps))


class VisionTransformer(nn.Module):
    def __init__(self, variant: str = "vit_base_patch16_224", img_size: int = 224,
                 patch_size: int = 16, num_classes: int = 0,
                 compute_dtype: torch.dtype = torch.float32,
                 embed_dim: Optional[int] = None, depth: Optional[int] = None,
                 num_heads: Optional[int] = None, mlp_ratio: float = 4.0,
                 ln_eps: float = 1e-6, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        d, dep, nh, mr = _VARIANTS.get(variant, (768, 12, 12, 4.0))
        self.variant = variant
        self.embed_dim = embed_dim or d
        self.depth = depth or dep
        self.num_heads = num_heads or nh
        self.mlp_ratio = mlp_ratio or mr
        self.img_size = img_size
        self.patch_size = patch_size
        self.num_patches = (img_size // patch_size) ** 2
        self.num_classes = num_classes
        self.compute_dtype = compute_dtype
        self.ln_eps = ln_eps
        self.feature_dim = self.embed_dim

        D = self.embed_dim
        kw = {"device": resolve_device(device), "dtype": torch.float32}
        self.cls_token = nn.Parameter(torch.empty(1, 1, D, **kw))
        self.pos_embed = nn.Parameter(torch.empty(1, self.num_patches + 1, D, **kw))
        self.patch_embed = PatchEmbed(patch_size, D, **kw)
        self.blocks = nn.ModuleList(
            Block(D, self.num_heads, int(D * self.mlp_ratio), ln_eps, **kw)
            for _ in range(self.depth))
        self.norm = _norm(D, **kw)
        self.head = _linear(D, num_classes, **kw) if num_classes > 0 else None
        self.init_weights(generator)

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None) -> None:
        """The JAX ``init`` distributions, drawn from ``generator`` (a CPU
        generator seeded 0 when none is given)."""
        g = generator or torch.Generator().manual_seed(0)
        D = self.embed_dim
        self.cls_token.copy_(I.trunc_normal(self.cls_token.shape, g, std=1e-6))
        self.pos_embed.copy_(I.trunc_normal(self.pos_embed.shape, g, std=0.02))
        proj = self.patch_embed.proj
        proj.weight.copy_(I.trunc_normal(proj.weight.shape, g, std=0.02))
        proj.bias.copy_(I.zeros(D))
        for blk in self.blocks:
            for norm in (blk.norm1, blk.norm2):
                norm.weight.copy_(I.ones(D))
                norm.bias.copy_(I.zeros(D))
            for lin in (blk.attn.qkv, blk.attn.proj, blk.mlp.fc1, blk.mlp.fc2):
                lin.weight.copy_(I.trunc_normal(lin.weight.shape, g, std=0.02))
                lin.bias.copy_(I.zeros(lin.bias.shape))
        self.norm.weight.copy_(I.ones(D))
        self.norm.bias.copy_(I.zeros(D))
        if self.head is not None:
            self.head.weight.copy_(I.trunc_normal(self.head.weight.shape, g, std=0.02))
            self.head.bias.copy_(I.zeros(self.num_classes))

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                return_tokens: bool = False) -> torch.Tensor:
        """``x``: (B, H, W, 3) NHWC. Returns CLS features (B, D), or logits,
        or with ``return_tokens`` the post-norm patch tokens (B, N, D)
        without CLS. ``train`` and ``generator`` are taken as every backbone
        takes them; the ViT draws nothing."""
        x = x.to(self.compute_dtype)
        y = self.patch_embed(x)
        cls = self.cls_token.to(y.dtype).expand(y.shape[0], -1, -1)
        y = torch.cat([cls, y], dim=1) + self.pos_embed.to(y.dtype)
        for blk in self.blocks:
            y = blk(y)
        y = L.layer_norm(y, self.norm.weight, self.norm.bias, self.ln_eps)
        if return_tokens:
            return y[:, 1:, :]
        feats = y[:, 0, :]
        if self.head is not None:
            feats = L.linear(feats, self.head.weight, self.head.bias)
        return feats
