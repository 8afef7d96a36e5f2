"""Temporal transformer detector as an ``nn.Module``: the long-clip family.

Counterpart of ``deepfake_video_detection_tpu/models/temporal_transformer.py``
in its single-device loop layout. Per-frame backbone features (over the
flattened ``B·T`` frames) → linear projection to ``d_model`` → sinusoidal
time encoding → cls token → ``depth`` pre-norm blocks over the frame axis →
final LayerNorm → cls (or mean) pooling → dropout → head. Returns
``(logits (B, C) f32, frame_scores (B, T) f32)``, the frame scores being the
softmax over T of each frame token's L2 norm.

The blocks are :class:`TemporalBlock`, a ``models/vit.py::Block`` (the same
keys ``blocks.i.norm1``, ``attn.qkv``, ``attn.proj``, ``norm2``,
``mlp.fc1``, ``mlp.fc2``). Their
attention goes through ``nn.layers.multi_head_attention``: a CUDA input
always takes the flash kernels, forward and backward, and a CPU input
their plain version; the JAX model takes its Pallas kernel only on a TPU
above an N threshold measured there (``:275``), a rule the port does not
carry over (ROADMAP Queue 3). ``use_flash=False`` is the JAX model's dense
attention (``:279-284``), on every device: scores and P·V accumulated in
f32, the softmax in f32 cast to the activations' dtype; it launches no
flash kernel.

``moe_experts > 0`` makes every block's MLP a top-1-routed mixture of
experts (``nn/moe.py``, keys ``mlp.router.weight``, ``mlp.w1``,
``mlp.w2``), computed densely as the JAX model does on one device. In
training the forward then returns a third element, ``{"moe_load_balance":
aux}``, the switch load-balance loss averaged over the blocks, which
``train/steps.py`` weights into the loss (the JAX model reports it in its
new state under ``aux_losses`` and its step pops it); it is never a
parameter, buffer or ``state_dict`` key. The MoE output is f32 (its
parameters are, and the JAX package promotes), so with bf16 activations
the residual stream turns f32 after block 0 and every later block runs in
f32, as in the JAX model.

Parameters are f32 and ``compute_dtype`` is the activations' dtype; the
time encoding is computed in f32 and the cls token cast, so the first
block sees ``compute_dtype``. Dropout draws from the generator the caller
passes. The JAX package's sequence-parallel, pipeline and expert-parallel
modes (``mesh``, ``seq_axis``, ``stage_axis``, ``expert_axis``) raise
``NotImplementedError`` (ROADMAP items 18(b)-(d));
:func:`normalize_state_dict` turns a pipeline-layout checkpoint into the
loop layout this model loads.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn as nn
from torch.nn.utils import skip_init

from deepfake_video_detection_tpu_torch.models.backbone_detector import build_backbone
from deepfake_video_detection_tpu_torch.models.vit import Block
from deepfake_video_detection_tpu_torch.nn import init as I
from deepfake_video_detection_tpu_torch.nn import layers as L
from deepfake_video_detection_tpu_torch.nn.moe import MoEMLP
from deepfake_video_detection_tpu_torch.utils.device import resolve_device
from deepfake_video_detection_tpu_torch.utils.tree import flatten_dotted, unflatten_dotted

_LN_EPS = 1e-6


def stack_blocks(blocks: Dict[str, Any]) -> Dict[str, Any]:
    """Loop layout ``{"0": {...}, "1": {...}}`` → pipeline layout (numpy
    leaves stacked on a leading depth axis)."""
    flat = [flatten_dotted(blocks[str(i)]) for i in range(len(blocks))]
    return unflatten_dotted({k: np.stack([np.asarray(f[k]) for f in flat])
                             for k in flat[0]})


def unstack_blocks(stacked: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    """Pipeline layout → loop layout (inverse of :func:`stack_blocks`)."""
    flat = {k: np.asarray(v) for k, v in flatten_dotted(stacked).items()}
    depth = next(iter(flat.values())).shape[0]
    return {str(i): unflatten_dotted({k: v[i] for k, v in flat.items()})
            for i in range(depth)}


def normalize_state_dict(sd: Dict[str, Any]) -> Dict[str, Any]:
    """A pipeline-layout FLAT state dict (``blocks.attn.qkv.weight`` with a
    leading depth axis) → the loop layout (``blocks.0.attn.qkv.weight``).
    No-op for loop-layout dicts."""
    if not any(k.startswith("blocks.") and not k.split(".")[1].isdigit()
               for k in sd):
        return sd
    out: Dict[str, Any] = {}
    for k, v in sd.items():
        parts = k.split(".")
        if parts[0] == "blocks" and not parts[1].isdigit():
            arr = np.asarray(v)
            for i in range(arr.shape[0]):
                out[".".join(["blocks", str(i)] + parts[1:])] = arr[i]
        else:
            out[k] = v
    return out


def infer_mlp_kwargs(sd: Dict[str, Any], d_model: int,
                     cfg: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Constructor kwargs for a checkpoint's block MLP: the exact hidden
    width from ``blocks.0.mlp.fc1.weight`` (the dim that is not
    ``d_model``), or ``moe_experts`` and the hidden width from an
    expert-stacked ``blocks.0.mlp.w1`` (E, D, H)."""
    cfg = cfg or {}
    w1 = sd.get("blocks.0.mlp.w1")
    if w1 is not None and np.ndim(w1) == 3:
        e, _, h = (int(s) for s in np.shape(w1))
        return {"moe_experts": cfg.get("moe_experts", e), "mlp_hidden": h}
    fc1 = sd.get("blocks.0.mlp.fc1.weight")
    if fc1 is not None and np.ndim(fc1) == 2:
        dims = [int(s) for s in np.shape(fc1)]
        return {"mlp_hidden": next((s for s in dims if s != d_model), dims[0])}
    return {}


def time_encoding(T: int, D: int, device: Any) -> torch.Tensor:
    """(T, D) f32: ``pos / 10000^(2·i/D)`` with sin and cos concatenated on
    the last axis (not interleaved), as the JAX model builds it."""
    pos = torch.arange(T, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(D // 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(torch.tensor(10000.0, device=device), 2 * dim / D)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


def dense_attention(x: torch.Tensor, attn: nn.Module) -> torch.Tensor:
    """The JAX model's attention off the flash kernel (``use_flash=False``):
    ``x`` (B, N, D) through ``attn.qkv`` (``models/vit.py::Attention``),
    scores ``q·kᵀ`` accumulated in f32 and scaled by 1/√hd, the softmax in
    f32 cast to x's dtype, P·V accumulated in f32 and cast back, then
    ``attn.proj``."""
    B, N, D = x.shape
    nh = attn.num_heads
    hd = D // nh
    qkv = L.linear(x, attn.qkv.weight, attn.qkv.bias).reshape(B, N, 3, nh, hd)
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)      # each (B, nh, N, hd)
    s = torch.matmul(q.to(torch.float32), k.to(torch.float32).transpose(-1, -2))
    a = torch.softmax(s * (1.0 / math.sqrt(hd)), dim=-1).to(x.dtype)
    out = torch.matmul(a.to(torch.float32), v.to(torch.float32)).to(x.dtype)
    return L.linear(out.transpose(1, 2).reshape(B, N, D), attn.proj.weight, attn.proj.bias)


class TemporalBlock(Block):
    """``models/vit.py::Block`` with the temporal model's two options: the
    dense attention (``use_flash=False``) and an MoE feed-forward, with
    which it returns ``(y, load-balance loss)``."""

    def __init__(self, dim: int, num_heads: int, hidden: int, eps: float, use_flash: bool,
                 mlp: Optional[MoEMLP] = None, **kw):
        super().__init__(dim, num_heads, hidden, eps, mlp=mlp, **kw)
        self.use_flash = use_flash

    def forward(self, y: torch.Tensor):
        h = L.layer_norm(y, self.norm1.weight, self.norm1.bias, self.eps)
        y = y + (self.attn(h) if self.use_flash else dense_attention(h, self.attn))
        h = L.layer_norm(y, self.norm2.weight, self.norm2.bias, self.eps)
        if not isinstance(self.mlp, MoEMLP):
            return y + self.mlp(h)
        out, aux = self.mlp(h.reshape(-1, h.shape[-1]), with_aux=True)
        return y + out.reshape(h.shape), aux


_UNPORTED = {"mesh": "18(b): data parallelism, FSDP and tensor parallelism",
             "seq_axis": "18(c): sequence and expert parallelism",
             "expert_axis": "18(c): sequence and expert parallelism",
             "stage_axis": "18(d): pipeline parallelism"}


class TemporalTransformerDetector(nn.Module):
    def __init__(self, backbone_name: str = "efficientnet_b0", num_classes: int = 2,
                 d_model: int = 256, depth: int = 4, num_heads: int = 4,
                 mlp_ratio: float = 4.0, mlp_hidden: Optional[int] = None,
                 dropout_rate: float = 0.1, use_flash: bool = True, use_cls: bool = True,
                 mesh: Optional[Any] = None, seq_axis: Optional[str] = None,
                 moe_experts: int = 0, expert_axis: Optional[str] = None,
                 stage_axis: Optional[str] = None,
                 compute_dtype: torch.dtype = torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        for name, val in (("mesh", mesh), ("seq_axis", seq_axis),
                          ("expert_axis", expert_axis), ("stage_axis", stage_axis)):
            if val:
                raise NotImplementedError(
                    f"temporal transformer {name}={val!r} is not ported yet "
                    f"(ROADMAP item {_UNPORTED[name]})")
        g = generator or torch.Generator().manual_seed(0)
        self.backbone_name = backbone_name
        self.num_classes = num_classes
        self.d_model = D = d_model
        self.depth = depth
        self.num_heads = num_heads
        self.mlp_hidden = (int(mlp_hidden) if mlp_hidden is not None
                           else int(d_model * mlp_ratio))
        self.dropout_rate = dropout_rate
        self.use_flash = use_flash
        self.use_cls = use_cls
        self.moe_experts = moe_experts
        self.compute_dtype = compute_dtype
        self.backbone = build_backbone(backbone_name, compute_dtype, device, g)
        self.feature_dim = self.backbone.feature_dim
        kw = {"device": resolve_device(device), "dtype": torch.float32}
        self.proj = skip_init(nn.Linear, self.feature_dim, D, **kw)
        # the JAX tree holds cls_token whether or not use_cls reads it
        self.cls_token = nn.Parameter(torch.empty(1, 1, D, **kw))
        self.blocks = nn.ModuleList(
            TemporalBlock(D, num_heads, self.mlp_hidden, _LN_EPS, use_flash,
                          mlp=(MoEMLP(D, self.mlp_hidden, moe_experts, device=device,
                                      generator=g) if moe_experts else None), **kw)
            for _ in range(depth))
        self.norm = skip_init(nn.LayerNorm, D, **kw)
        self.head = skip_init(nn.Linear, D, num_classes, **kw)
        self._init_weights(g)

    @torch.no_grad()
    def _init_weights(self, g: torch.Generator) -> None:
        """The JAX ``init`` distributions: trunc_normal(0.02) linears and
        cls token, zero biases, ones/zeros LayerNorms."""
        lins = [self.proj, self.head]
        norms = [self.norm]
        for blk in self.blocks:
            lins += [blk.attn.qkv, blk.attn.proj]
            if not self.moe_experts:            # the experts drew their own
                lins += [blk.mlp.fc1, blk.mlp.fc2]
            norms += [blk.norm1, blk.norm2]
        for lin in lins:
            lin.weight.copy_(I.trunc_normal(lin.weight.shape, g, std=0.02))
            lin.bias.copy_(I.zeros(lin.bias.shape))
        for norm in norms:
            norm.weight.copy_(I.ones(self.d_model))
            norm.bias.copy_(I.zeros(self.d_model))
        self.cls_token.copy_(I.trunc_normal(self.cls_token.shape, g, std=0.02))

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """``x``: (B, T, H, W, C) normalised frames. ``generator`` drives
        dropout when ``train`` (on x's device). Returns ``(logits,
        frame_scores)``, and an MoE model in training also its aux losses
        (:meth:`forward_temporal`)."""
        B, T = x.shape[0], x.shape[1]
        feats = self.backbone(x.reshape((B * T,) + tuple(x.shape[2:])), train, generator)
        return self.forward_temporal(feats.reshape(B, T, self.feature_dim),
                                     train, generator)

    def forward_temporal(self, feats: torch.Tensor, train: bool = False,
                         generator: Optional[torch.Generator] = None):
        """The model after the backbone: ``feats`` (B, T, feature_dim) in
        the compute dtype → ``(logits, frame_scores)``; with ``moe_experts``
        in training, ``(logits, frame_scores, {"moe_load_balance": aux})``,
        aux the blocks' mean load-balance loss (f32)."""
        B, T, _ = feats.shape
        y = L.linear(feats, self.proj.weight, self.proj.bias)
        y = y + time_encoding(T, self.d_model, y.device).to(y.dtype)
        if self.use_cls:
            cls = self.cls_token.to(y.dtype).expand(B, -1, -1)
            y = torch.cat([cls, y], dim=1)
        moe_aux = 0.0
        for blk in self.blocks:
            y = blk(y)
            if self.moe_experts:
                y, aux = y
                moe_aux = moe_aux + aux
        y = L.layer_norm(y, self.norm.weight, self.norm.bias, _LN_EPS)
        if self.use_cls:
            pooled, tokens = y[:, 0], y[:, 1:]
        else:
            pooled, tokens = y.mean(dim=1), y
        pooled = L.dropout(pooled, self.dropout_rate, train, generator)
        logits = L.linear(pooled, self.head.weight, self.head.bias).to(torch.float32)
        norms = torch.linalg.vector_norm(tokens.to(torch.float32), dim=-1)
        scores = torch.softmax(norms, dim=-1)
        if self.moe_experts and train:
            return logits, scores, {"moe_load_balance": moe_aux / self.depth}
        return logits, scores
