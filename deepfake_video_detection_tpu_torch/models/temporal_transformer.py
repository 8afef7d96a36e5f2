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
passes. :func:`normalize_state_dict` turns a pipeline-layout checkpoint
into the loop layout this model loads.

The JAX model's multi-device modes take a ``DeviceMesh``
(``parallel/strategy.py::build_plan`` gives the kwargs); the model then
sees this rank's part of the batch:

* ``seq_axis`` (sequence parallelism, ``use_cls=False``): each rank holds
  T/S frames; the time encoding takes their global positions, every
  attention runs through ``ops/ring_attention.py`` (``seq_strategy``
  ``"ring"``) or ``ops/ulysses_attention.py`` (``"ulysses"``), the pooling
  is the mean over all T frames (a sum over the ``seq`` axis) and the
  frame scores the softmax over all T.
* ``expert_axis`` (with ``moe_experts``): every block's MoE runs
  ``MoEMLP.apply_expert_parallel``.
* ``stage_axis``: the blocks run as a GPipe pipeline of
  ``pp_microbatches`` microbatches (``parallel/pipeline.py``); stage s
  applies blocks s·depth/S … The model is built whole; the plan's
  placement (:meth:`TemporalTransformerDetector.keep_stage_blocks`) then
  frees the other stages' blocks, as JAX's ``pp_param_pspec`` places them,
  and each block keeps its loop-layout name (``blocks.i.…``), so a
  checkpoint gathered from the stages loads in both packages' loaders as a
  loop-layout one.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
from torch.nn.utils import skip_init

from deepfake_video_detection_tpu_torch.models.backbone_detector import build_backbone
from deepfake_video_detection_tpu_torch.models.vit import Block
from deepfake_video_detection_tpu_torch.nn import init as I
from deepfake_video_detection_tpu_torch.nn import layers as L
from deepfake_video_detection_tpu_torch.nn.moe import MoEMLP
from deepfake_video_detection_tpu_torch.ops.ring_attention import ring_attention
from deepfake_video_detection_tpu_torch.ops.ulysses_attention import ulysses_attention
from deepfake_video_detection_tpu_torch.parallel.mesh import (
    all_reduce, axis_group, axis_rank, axis_size, solo)
from deepfake_video_detection_tpu_torch.parallel.pipeline import pipeline_blocks
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


def time_encoding(T: int, D: int, device: Any, offset: int = 0) -> torch.Tensor:
    """(T, D) f32 at positions ``offset … offset+T−1``: ``pos /
    10000^(2·i/D)`` with sin and cos concatenated on the last axis (not
    interleaved), as the JAX model builds it."""
    pos = torch.arange(offset, offset + T, dtype=torch.float32, device=device)[:, None]
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


def split_attention(x: torch.Tensor, attn: nn.Module, fn) -> torch.Tensor:
    """``attn.qkv`` → ``fn(q, k, v)`` over (B, nh, N, hd) → ``attn.proj``:
    the sequence-parallel attentions on this rank's frames."""
    B, N, D = x.shape
    nh = attn.num_heads
    qkv = L.linear(x, attn.qkv.weight, attn.qkv.bias).reshape(B, N, 3, nh, D // nh)
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
    out = fn(q, k, v)
    return L.linear(out.transpose(1, 2).reshape(B, N, D), attn.proj.weight, attn.proj.bias)


class TemporalBlock(Block):
    """``models/vit.py::Block`` with the temporal model's options: the
    dense attention (``use_flash=False``), a sequence-parallel attention
    (``seq_attention(q, k, v)``), and an MoE feed-forward, with which it
    returns ``(y, load-balance loss)``, expert-parallel under
    ``expert_mesh`` (a ``(mesh, axis, batch_axis)`` triple)."""

    def __init__(self, dim: int, num_heads: int, hidden: int, eps: float, use_flash: bool,
                 mlp: Optional[MoEMLP] = None, seq_attention=None, expert_mesh=None, **kw):
        super().__init__(dim, num_heads, hidden, eps, mlp=mlp, **kw)
        self.use_flash = use_flash
        self.seq_attention = seq_attention
        self.expert_mesh = expert_mesh

    def forward(self, y: torch.Tensor):
        h = L.layer_norm(y, self.norm1.weight, self.norm1.bias, self.eps)
        if self.seq_attention is not None:
            y = y + split_attention(h, self.attn, self.seq_attention)
        else:
            y = y + (self.attn(h) if self.use_flash else dense_attention(h, self.attn))
        h = L.layer_norm(y, self.norm2.weight, self.norm2.bias, self.eps)
        if not isinstance(self.mlp, MoEMLP):
            return y + self.mlp(h)
        flat = h.reshape(-1, h.shape[-1])
        if self.expert_mesh is not None:
            mesh, axis, batch_axis = self.expert_mesh
            out, aux = self.mlp.apply_expert_parallel(flat, mesh, axis, True, batch_axis)
        else:
            out, aux = self.mlp(flat, with_aux=True)
        return y + out.reshape(h.shape), aux


def _seq_softmax(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Softmax over the last axis split over the ``axis`` ranks (no grad)."""
    group = axis_group(mesh, axis)
    m = x.amax(dim=-1, keepdim=True)
    if not solo(group):
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    e = torch.exp(x - m)
    return e / all_reduce(e.sum(dim=-1, keepdim=True), group)


class _HeldElsewhere(nn.Module):
    """The place of a block that another pipeline stage holds: no
    parameters, and no forward."""

    def forward(self, x):
        raise RuntimeError("this block is held by another pipeline stage")


class TemporalTransformerDetector(nn.Module):
    def __init__(self, backbone_name: str = "efficientnet_b0", num_classes: int = 2,
                 d_model: int = 256, depth: int = 4, num_heads: int = 4,
                 mlp_ratio: float = 4.0, mlp_hidden: Optional[int] = None,
                 dropout_rate: float = 0.1, use_flash: bool = True, use_cls: bool = True,
                 mesh: Optional[Any] = None, seq_axis: Optional[str] = None,
                 seq_strategy: str = "ring", batch_axis: Optional[str] = "data",
                 moe_experts: int = 0, expert_axis: Optional[str] = None,
                 stage_axis: Optional[str] = None, pp_microbatches: int = 2,
                 compute_dtype: torch.dtype = torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if seq_strategy not in ("ring", "ulysses"):
            raise ValueError(f"unknown seq_strategy {seq_strategy!r}")
        if mesh is not None and seq_axis and use_cls:
            raise ValueError("sequence-parallel mode needs use_cls=False "
                             "(the +1 cls token breaks even T sharding)")
        if stage_axis:
            if mesh is None:
                raise ValueError("pipeline-parallel mode needs a mesh")
            if moe_experts or seq_axis:
                raise ValueError("stage_axis is mutually exclusive with "
                                 "moe_experts/seq_axis")
            if depth % axis_size(mesh, stage_axis) != 0:
                raise ValueError(
                    f"depth {depth} must divide over the {stage_axis} axis "
                    f"({axis_size(mesh, stage_axis)} stages)")
        self.mesh = mesh
        self.seq_axis = seq_axis if mesh is not None else None
        self.seq_strategy = seq_strategy
        self.batch_axis = batch_axis
        self.stage_axis = stage_axis
        self.pp_microbatches = pp_microbatches
        seq_attention = expert_mesh = None
        if self.seq_axis:
            seq_attention = functools.partial(
                ulysses_attention if seq_strategy == "ulysses" else ring_attention,
                mesh=mesh, seq_axis=seq_axis, batch_axis=batch_axis)
        if mesh is not None and expert_axis and moe_experts:
            expert_mesh = (mesh, expert_axis, batch_axis)
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
                                      generator=g) if moe_experts else None),
                          seq_attention=seq_attention, expert_mesh=expert_mesh, **kw)
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

    def keep_stage_blocks(self) -> None:
        """Under ``stage_axis``: free the blocks the other stages apply
        (their parameters, and so their gradients and optimizer slots),
        keeping this stage's, ``pipeline_blocks``' s·depth/S …, under their
        ``blocks.i`` names; the others' places hold :class:`_HeldElsewhere`."""
        S, s = axis_size(self.mesh, self.stage_axis), axis_rank(self.mesh, self.stage_axis)
        L = self.depth
        for i in range(L):
            if not s * L // S <= i < (s + 1) * L // S:
                self.blocks[i] = _HeldElsewhere()

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
        seq = axis_size(self.mesh, self.seq_axis) if self.seq_axis else 1
        offset = axis_rank(self.mesh, self.seq_axis) * T if self.seq_axis else 0
        y = L.linear(feats, self.proj.weight, self.proj.bias)
        y = y + time_encoding(T, self.d_model, y.device, offset).to(y.dtype)
        if self.use_cls:
            cls = self.cls_token.to(y.dtype).expand(B, -1, -1)
            y = torch.cat([cls, y], dim=1)
        moe_aux = 0.0
        if self.stage_axis:
            M = self.pp_microbatches
            if B % M != 0:
                raise ValueError(f"batch {B} % microbatches {M} != 0")
            N = y.shape[1]
            y = pipeline_blocks(lambda blk, xm: blk(xm), list(self.blocks),
                                y.reshape(M, B // M, N, self.d_model), self.mesh,
                                self.stage_axis, self.batch_axis).reshape(B, N, self.d_model)
        else:
            for blk in self.blocks:
                y = blk(y)
                if self.moe_experts:
                    y, aux = y
                    moe_aux = moe_aux + aux
        y = L.layer_norm(y, self.norm.weight, self.norm.bias, _LN_EPS)
        if self.use_cls:
            pooled, tokens = y[:, 0], y[:, 1:]
        elif self.seq_axis:     # the mean over every rank's frames
            pooled = all_reduce(y.sum(dim=1, dtype=torch.float32),
                                axis_group(self.mesh, self.seq_axis))
            pooled, tokens = (pooled / (T * seq)).to(y.dtype), y
        else:
            pooled, tokens = y.mean(dim=1), y
        pooled = L.dropout(pooled, self.dropout_rate, train, generator)
        logits = L.linear(pooled, self.head.weight, self.head.bias).to(torch.float32)
        norms = torch.linalg.vector_norm(tokens.to(torch.float32), dim=-1)
        scores = (_seq_softmax(norms.detach(), self.mesh, self.seq_axis) if self.seq_axis
                  else torch.softmax(norms, dim=-1))
        if self.moe_experts and train:
            return logits, scores, {"moe_load_balance": moe_aux / self.depth}
        return logits, scores
